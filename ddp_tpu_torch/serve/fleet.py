"""Replica fleet: N serving engines behind one router, hot-swappable
(counterpart of ``ddp_tpu/serve/fleet.py``, with ``device=`` where the JAX
package takes ``mesh=``).

The fleet owns what the :class:`~ddp_tpu_torch.serve.router.Router` only
routes over — replica construction, the checkpoint they serve, and the
zero-downtime path that changes it:

- :class:`LocalReplica` — one in-process (engine, batcher) pair.  The
  pair reference is swapped ATOMICALLY under a lock: after a swap, new
  requests land on the new pair immediately while the OLD batcher
  drains — every request it already accepted is served by the engine
  that accepted it, so no response is ever computed from a batch
  spanning two checkpoints.  Admission never stops; "never drain" means
  the *fleet front door*, not the retiring batcher.

- :class:`HTTPReplica` — the same replica protocol over a remote
  ``python -m ddp_tpu_torch.serve`` (or ``python -m ddp_tpu.serve``)
  process (stdlib urllib; HTTP status codes mapped back onto the serve
  exception taxonomy so the router's retry/shed/breaker logic is
  transport-agnostic).

- :class:`ServeFleet` — loads the newest verifiable snapshot ONCE
  (``lineage.latest_verifiable``, which reads v1 files and v2 sharded sets
  alike, the single-engine path's walk), builds N warmed replicas, each
  with its own copy of the model and its own engine, starts the router,
  and runs the hot-swap watcher: a poll of ``lineage.head_fingerprint``
  (a ~1 KB manifest read, no checkpoint bytes) detects a new publish; the
  full sha-verified lineage walk then loads it, ``swap_warm`` builds and
  warms new engines (on the card: every bucket run eagerly, then captured
  as a CUDA graph in ``thread_local`` capture mode, so the replicas still
  serving on other threads may synchronise and copy while it captures;
  the ``warm()`` count bound still asserted — a swap must not smuggle
  unbounded captures into serving), and ``swap_commit`` rotates each
  replica to the new pair.  A torn or unverifiable publish is SKIPPED
  with a named ``swap_skipped`` event in the swap history (the lineage
  walk falls back to the snapshot already serving, which is never
  "newer") — serving is never degraded by a bad publish.

Each replica carries its own engine (its own CUDA graphs, its own copy of
the weights): replicas fail, swap, and serve independently, which is the
point of a fleet.  One :class:`~ddp_tpu_torch.obs.registry.
MetricsRegistry` is shared fleet-wide — the router's counters plus each
replica's engine/batcher series under a ``replica`` label, with
fleet-rollup series (``ddp_fleet_healthy_replicas``,
``ddp_fleet_swap_commits_total``) — so one ``/metrics`` scrape reads the
whole fleet.  On one card this costs N weight copies and N sets of
graphs: the price of blast-radius isolation.

``generate=True`` makes a generative fleet of the ``tinylm`` decoder: each
replica is a :class:`~ddp_tpu_torch.serve.kvcache.KVCacheEngine` (its own
KV cache and graphs) behind a
:class:`~ddp_tpu_torch.serve.token_batcher.TokenBatcher`, streams are
routed by the router's sticky sessions, and hot swap works as for
classifiers (the warm check holds each engine to its ``compile_bound``).
A classifier fleet serves replicated at any ``model_axis``, as the JAX
fleet's classifier branch does; a generative fleet with a serving model
axis above 1 (heads split across ranks a decode step) is refused with
:class:`~ddp_tpu_torch.serve.http.NotPorted` (ROADMAP A12b).
"""
from __future__ import annotations

import copy
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs.registry import MetricsRegistry
from ..obs.tracer import get_tracer
from .batcher import Draining, DynamicBatcher, QueueFull
from .engine import RequestTooLarge, ServeEngine
from .http import NotPorted
from .router import ReplicaCrashed, Router


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.stderr.flush()


class LocalReplica:
    """One in-process (engine, batcher) pair implementing the router's
    replica protocol; :meth:`swap` is the zero-downtime rotation point.

    ``crashed`` is a fault-injection latch (resilience/faults.py): once
    set, submits and health probes fail like a dead process would, and
    the router's prober ejects this replica.
    """

    def __init__(self, replica_id: str, engine: ServeEngine,
                 batcher: DynamicBatcher):
        self.replica_id = replica_id
        self._t0 = time.monotonic()
        # A bool latch, set once by fault injection; read without a lock.
        self.crashed = False
        self._pair_lock = threading.Lock()
        # The three below are read and written under _pair_lock.
        self.engine = engine
        self.batcher = batcher
        self.swaps = 0

    def _pair(self):
        with self._pair_lock:
            return self.engine, self.batcher

    def submit(self, images, timeout: Optional[float] = None,
               req: Optional[str] = None):
        if self.crashed:
            raise ReplicaCrashed(
                f"replica {self.replica_id} is down (crash fault latched)")
        _, batcher = self._pair()
        # The batcher reference is pinned BEFORE submit: a swap landing
        # mid-call drains this (old) batcher, which still serves every
        # request it accepted — the consistent-snapshot guarantee.
        return batcher.submit(images, timeout=timeout, req_id=req)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None,
                 req: Optional[str] = None,
                 session: Optional[str] = None):
        """The generative leg of the replica protocol: one blocking stream
        on this replica's token batcher, pinned before the call as
        :meth:`submit` pins.  A classifier replica (a
        :class:`DynamicBatcher`) raises :class:`TypeError`, which rides
        the router's no-retry ladder."""
        if self.crashed:
            raise ReplicaCrashed(
                f"replica {self.replica_id} is down (crash fault latched)")
        _, batcher = self._pair()
        if not hasattr(batcher, "generate"):
            # A classifier replica: the CLIENT asked the wrong fleet.
            raise TypeError(
                f"replica {self.replica_id} serves a classifier "
                "(DynamicBatcher); start the fleet with generate=True "
                "for token streams")
        return batcher.generate(prompt, max_new_tokens=max_new_tokens,
                                timeout=timeout, req_id=req,
                                session=session)

    def queue_depth(self) -> int:
        _, batcher = self._pair()
        return batcher.queue_depth()

    def health(self) -> dict:
        """The single-replica /healthz body; RAISES when the replica is
        dead (the router's probe treats any exception as a failed
        probe — like a refused TCP connect to a remote replica)."""
        if self.crashed:
            raise ReplicaCrashed(
                f"replica {self.replica_id} is down (crash fault latched)")
        engine, batcher = self._pair()
        draining = batcher.draining
        return {
            "status": "draining" if draining else "ok",
            "replica_id": self.replica_id,
            "checkpoint_step": engine.checkpoint_step,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "queue_depth": batcher.queue_depth(),
        }

    def stats(self) -> dict:
        engine, batcher = self._pair()
        with self._pair_lock:
            swaps = self.swaps
        return {"replica_id": self.replica_id, "swaps": swaps,
                "engine": engine.stats(), "batcher": batcher.stats()}

    def swap(self, new_engine: ServeEngine, new_batcher: DynamicBatcher,
             drain_timeout: float = 30.0) -> bool:
        """Atomically rotate to the new (warmed) pair, then drain the
        retired batcher so its accepted requests finish on the engine
        that accepted them.  New requests are admitted by the new pair
        from the instant the lock releases — admission never pauses."""
        with self._pair_lock:
            old_batcher = self.batcher
            self.engine = new_engine
            self.batcher = new_batcher
            self.swaps += 1
        return old_batcher.drain(timeout=drain_timeout)

    def close(self, timeout: float = 30.0) -> bool:
        _, batcher = self._pair()
        return batcher.drain(timeout=timeout)


class HTTPReplica:
    """The replica protocol over a remote serve process (stdlib urllib).

    Status codes map back onto the serve exception taxonomy so the
    router treats remote and in-process replicas identically: 503 ->
    :class:`Draining` when the message says "drain", else
    :class:`QueueFull` (re-route, no breaker hit), 400/413 -> the client's
    own error (no retry), transport failures (refused/reset/DNS) ->
    :class:`ReplicaCrashed` (retry elsewhere, breaker-counted), and
    timeouts — transport or replica-side 504 — -> :class:`TimeoutError`,
    the same no-retry deadline path a :class:`LocalReplica` batcher
    timeout takes.  Either package's server speaks this wire format.
    """

    def __init__(self, replica_id: str, base_url: str, *,
                 probe_timeout_s: float = 5.0):
        self.replica_id = replica_id
        self.base_url = base_url.rstrip("/")
        self.probe_timeout_s = float(probe_timeout_s)
        self._lock = threading.Lock()
        # Last queue depth seen on a health probe (under _lock):
        # queue_depth() must not cost an HTTP round trip per routing
        # decision.
        self._last_depth = 0

    def _call(self, http_req, timeout: Optional[float]):
        """One POST with the error taxonomy of :meth:`_map_http_error` and
        the transport's failures mapped as the class docstring says."""
        try:
            with urllib.request.urlopen(
                    http_req, timeout=timeout if timeout is not None
                    else 30.0) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            raise self._map_http_error(e) from None
        except urllib.error.URLError as e:
            # A connect timeout arrives wrapped as the URLError reason;
            # the deadline budget died, so take the router's no-retry
            # TimeoutError path exactly like a LocalReplica would.
            if isinstance(e.reason, (socket.timeout, TimeoutError)):
                raise TimeoutError(
                    f"replica {self.replica_id} transport timeout: "
                    f"{e.reason}") from None
            raise ReplicaCrashed(
                f"replica {self.replica_id} transport failure: "
                f"{type(e).__name__}: {e}") from None
        except (socket.timeout, TimeoutError) as e:
            raise TimeoutError(
                f"replica {self.replica_id} transport timeout: "
                f"{e}") from None
        except (OSError, ConnectionError) as e:
            raise ReplicaCrashed(
                f"replica {self.replica_id} transport failure: "
                f"{type(e).__name__}: {e}") from None

    @staticmethod
    def _request(url: str, payload: dict, req: Optional[str]):
        headers = {"Content-Type": "application/json"}
        if req is not None:
            headers["X-Request-Id"] = req
        return urllib.request.Request(url, data=json.dumps(payload).encode(),
                                      headers=headers)

    def submit(self, images, timeout: Optional[float] = None,
               req: Optional[str] = None):
        out = self._call(self._request(
            self.base_url + "/predict",
            {"instances": np.asarray(images).tolist()}, req), timeout)
        return np.asarray(out["logits"], np.float32)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None,
                 req: Optional[str] = None,
                 session: Optional[str] = None):
        """POST /generate on the remote replica; the same error taxonomy
        as :meth:`submit`."""
        payload = {"prompt": np.asarray(prompt).tolist()}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = int(max_new_tokens)
        if session is not None:
            payload["session"] = session
        return self._call(self._request(self.base_url + "/generate",
                                        payload, req), timeout)

    def _map_http_error(self, e: "urllib.error.HTTPError"):
        try:
            msg = json.load(e).get("error", "")
        except Exception:
            msg = ""
        msg = msg or f"HTTP {e.code} from {self.base_url}"
        if e.code == 413:
            return RequestTooLarge(msg)
        if e.code == 400:
            return ValueError(msg)
        if e.code == 503:
            return (Draining(msg) if "drain" in msg.lower()
                    else QueueFull(msg))
        if e.code == 504:
            # The remote batcher timed out THIS request's budget — the
            # LocalReplica equivalent raises TimeoutError (no retry).
            return TimeoutError(f"replica-side timeout: {msg}")
        return ReplicaCrashed(msg)

    def health(self) -> dict:
        try:
            with urllib.request.urlopen(self.base_url + "/healthz",
                                        timeout=self.probe_timeout_s) as r:
                h = json.load(r)
        except urllib.error.HTTPError as e:
            # 503-draining still carries a JSON body worth returning —
            # the router reads status != "ok" as unhealthy either way.
            try:
                h = json.load(e)
            except Exception:
                raise ReplicaCrashed(
                    f"health probe HTTP {e.code}") from None
        if isinstance(h, dict):
            with self._lock:
                self._last_depth = int(h.get("queue_depth", 0) or 0)
            h.setdefault("replica_id", self.replica_id)
        return h

    def queue_depth(self) -> int:
        with self._lock:
            return self._last_depth

    def stats(self) -> dict:
        try:
            with urllib.request.urlopen(self.base_url + "/stats",
                                        timeout=self.probe_timeout_s) as r:
                return json.load(r)
        except Exception as e:
            return {"replica_id": self.replica_id,
                    "error": f"{type(e).__name__}: {e}"}


class ServeFleet:
    """N warmed replicas + router + checkpoint hot-swap watcher on one
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, snapshot_path: str, model_name: str, *,
                 device: DeviceLike = "cuda", n_replicas: int = 2,
                 buckets=(1, 8, 32, 128),
                 compute_dtype: Optional[torch.dtype] = None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0, queue_depth: int = 256,
                 drain_timeout_s: float = 30.0, tracer=None,
                 router_kwargs: Optional[dict] = None, registry=None,
                 generate: bool = False, slots: int = 8,
                 prompt_buckets=(16, 64), max_new_tokens: int = 32,
                 model_axis: int = 1):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.generative = bool(generate)
        if self.generative:
            from ..models import transformer as tfm
            if model_name != tfm.LM_NAME:
                raise ValueError(
                    f"generative fleets serve the {tfm.LM_NAME!r} decoder "
                    f"(models/transformer.py), got {model_name!r}")
        self.device = resolve_device(device)
        self.snapshot_path = snapshot_path
        self.model_name = model_name
        self.model_axis = int(model_axis)
        self.buckets = buckets
        self.slots = slots
        self.prompt_buckets = prompt_buckets
        self.max_new_tokens = max_new_tokens
        self.compute_dtype = compute_dtype
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.queue_depth = queue_depth
        self.drain_timeout_s = float(drain_timeout_s)
        self.tracer = tracer if tracer is not None else get_tracer()
        # One registry fleet-wide: router counters + replica-labelled
        # engine/batcher series + the rollup series below, all behind
        # one /metrics scrape.
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self._t0 = time.monotonic()
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._swap_lock = threading.Lock()
        # The four below are read and written under _swap_lock.
        self.swap_history: List[dict] = []
        self._current_file = None
        self._current_epoch = None
        self._current_step = None
        # Two side streams a replica (card), made once: a replica's engines
        # alternate between them across swaps, so a swap warms and captures
        # on the stream its serving engine does not use, and the fleet never
        # takes more streams from PyTorch's pool however many swaps come
        # (a new pool stream can alias a live one once the pool wraps, and
        # PyTorch keeps cuBLAS workspace for every stream a product ran on).
        # _slot[rid] is the index of the serving engine's stream.
        self._streams = {}
        self._slot = {}

        from ..resilience.lineage import head_fingerprint
        ckpt, used = self._load_snapshot()
        # Written by the watcher thread only after construction (tests
        # drive poll_once single-threaded instead of starting it).
        self._last_fp = head_fingerprint(self.snapshot_path)
        engines = self._make_engines(ckpt, used,
                                     [f"r{i}" for i in range(n_replicas)])
        self._warm_all(engines)
        self.replicas = [
            LocalReplica(f"r{i}", eng,
                         self._make_batcher(eng, f"r{i}").start())
            for i, eng in enumerate(engines)]
        self._slot = {f"r{i}": 0 for i in range(n_replicas)}
        self._current_file = used
        self._current_epoch = int(ckpt.epoch)
        self._current_step = int(ckpt.step)
        self.router = Router(self.replicas, tracer=self.tracer,
                             registry=self.registry,
                             **(router_kwargs or {}))
        self.registry.gauge(
            "ddp_fleet_healthy_replicas",
            "Replicas currently routable (not ejected, breaker not open)"
        ).set_function(lambda: float(self.router.healthy_count()))
        self.registry.counter(
            "ddp_fleet_swap_commits_total",
            "Checkpoint hot-swaps committed fleet-wide"
        ).set_function(self._swap_commit_count)

    # -- construction helpers ---------------------------------------------

    def _load_snapshot(self):
        """The full sha-verified lineage walk (v1 files and v2 sharded
        sets alike) — the single choke point the ``torn_publish`` fault
        wraps."""
        from ..resilience.lineage import latest_verifiable
        from ..train.checkpoint import CheckpointError
        loaded = latest_verifiable(self.snapshot_path)
        if loaded is None:
            raise CheckpointError(
                f"no checkpoint found under {self.snapshot_path!r}; the "
                "fleet needs a trained snapshot (run training with "
                "--snapshot_path first)")
        return loaded

    def _make_engines(self, ckpt, used: str, replica_ids: List[str]):
        """One engine a replica, from one host copy of the snapshot's
        weights: each engine gets its own copy of the model.  A generative
        fleet's engines are KV-cache engines, which alone consult the
        serving plan."""
        from ..models import get_model
        from ..train.checkpoint import CheckpointError, restore
        if self.generative:
            self._serving_plan(ckpt)
        model = get_model(self.model_name)
        try:
            restore(ckpt, model)
        except CheckpointError as e:
            raise CheckpointError(f"checkpoint {used!r}: {e}") from None
        engines = []
        for rid in replica_ids:
            common = dict(device=self.device,
                          compute_dtype=self.compute_dtype,
                          tracer=self.tracer, registry=self.registry,
                          metric_labels={"replica": rid},
                          stream=self._idle_stream(rid))
            if self.generative:
                from .kvcache import KVCacheEngine
                eng = KVCacheEngine(copy.deepcopy(model), slots=self.slots,
                                    prompt_buckets=self.prompt_buckets,
                                    **common)
            else:
                eng = ServeEngine(copy.deepcopy(model),
                                  buckets=self.buckets, **common)
            eng.checkpoint_file = used
            eng.checkpoint_epoch = int(ckpt.epoch)
            eng.checkpoint_step = int(ckpt.step)
            engines.append(eng)
        return engines

    def _idle_stream(self, rid: str) -> Optional[torch.cuda.Stream]:
        """The stream of ``rid``'s pair its serving engine does not use (the
        first, before the replica serves); None on the CPU."""
        if self.device.type != "cuda":
            return None
        pair = self._streams.get(rid)
        if pair is None:
            pair = self._streams[rid] = [torch.cuda.Stream(self.device)
                                         for _ in range(2)]
        return pair[1 - self._slot.get(rid, 1)]

    def _serving_plan(self, ckpt):
        """The generative engines' layout plan (the JAX fleet calls it on
        its generative branch only): None at ``model_axis`` 1, where a
        checkpoint trained with tensor parallelism serves replicated.  A
        serving model axis above 1 splits the heads across ranks a decode
        step, which is not ported yet (ROADMAP A12b)."""
        if self.model_axis <= 1:
            return None
        raise NotPorted(
            f"ServeFleet(generate=True, model_axis={self.model_axis}): the "
            "KV-cache engine's serving model axis (heads split across "
            "ranks) is not ported yet (ROADMAP queue A12b)")

    def _make_batcher(self, engine, replica_id: str):
        if self.generative:
            from .token_batcher import TokenBatcher
            return TokenBatcher(engine,
                                max_new_tokens=self.max_new_tokens,
                                queue_depth=self.queue_depth,
                                tracer=self.tracer,
                                registry=self.registry,
                                metric_labels={"replica": replica_id})
        return DynamicBatcher(engine, max_batch=self.max_batch,
                              max_wait_ms=self.max_wait_ms,
                              queue_depth=self.queue_depth,
                              tracer=self.tracer, registry=self.registry,
                              metric_labels={"replica": replica_id})

    def _swap_commit_count(self) -> float:
        with self._swap_lock:
            return float(sum(1 for e in self.swap_history
                             if e["event"] == "swap_commit"))

    def _warm_all(self, engines) -> int:
        """Make every program on every engine (on the card: one CUDA graph
        each); each engine's count must equal its bound (a classifier's
        bucket count, a KV-cache engine's ``compile_bound``) or the fleet
        refuses to (hot-)start — a swap must never smuggle unbounded
        captures into serving."""
        total = 0
        for eng in engines:
            compiled = eng.warm()
            bound = getattr(eng, "compile_bound", None) or len(eng.buckets)
            if compiled != bound:
                raise RuntimeError(
                    f"compile bound violated: {compiled} executables, "
                    f"bound {bound}")
            total += compiled
        return total

    # -- hot-swap watcher --------------------------------------------------

    def start(self, poll_s: float = 2.0) -> "ServeFleet":
        """Start the router's health prober and the checkpoint watcher
        (``poll_s <= 0`` starts the prober only; idempotent)."""
        self.router.start()
        if poll_s > 0 and self._watch_thread is None:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, args=(float(poll_s),),
                daemon=True, name="fleet-ckpt-watch")
            self._watch_thread.start()
        return self

    def _watch_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self.poll_once()
            except Exception as e:  # the watcher must never die silently
                _log(f"WARNING: checkpoint watcher poll failed "
                     f"({type(e).__name__}: {e}); serving is unaffected, "
                     "next poll continues")

    def poll_once(self) -> Optional[str]:
        """One watcher iteration; returns the swap-history event name it
        recorded (``"swap_commit"`` / ``"swap_skipped"``) or None when
        nothing new was published.  Callable directly for deterministic
        tests and single-threaded embedders."""
        from ..resilience.lineage import head_fingerprint
        from ..train.checkpoint import CheckpointError
        fp = head_fingerprint(self.snapshot_path)
        if fp is None or fp == self._last_fp:
            return None
        # Consume the fingerprint BEFORE attempting the load: a bad
        # publish must not be re-tried every poll (the next PUBLISH
        # changes the fingerprint again and re-arms the watcher).
        self._last_fp = fp
        try:
            ckpt, used = self._load_snapshot()
        except CheckpointError as e:
            return self._record("swap_skipped",
                                reason=f"no verifiable snapshot: {e}")
        with self._swap_lock:
            cur_step = self._current_step
        if cur_step is not None and int(ckpt.step) <= cur_step:
            # The lineage walk fell back past a torn/unverifiable head
            # to a snapshot no newer than the one already serving.
            return self._record(
                "swap_skipped", file=used, step=int(ckpt.step),
                reason=f"head torn or stale: newest verifiable snapshot "
                       f"{used!r} (step {int(ckpt.step)}) is not newer "
                       f"than serving step {cur_step}")
        self._swap_to(ckpt, used)
        return "swap_commit"

    def _swap_to(self, ckpt, used: str) -> None:
        t0 = time.monotonic()
        with self.tracer.span("swap_warm"):
            engines = self._make_engines(
                ckpt, used, [r.replica_id for r in self.replicas])
            compiled = self._warm_all(engines)
        warm_s = time.monotonic() - t0
        with self.tracer.span("swap_commit"):
            clean = True
            for replica, eng in zip(self.replicas, engines):
                rid = replica.replica_id
                drained = replica.swap(
                    eng, self._make_batcher(eng, rid).start(),
                    drain_timeout=self.drain_timeout_s)
                old = self._slot[rid]
                self._slot[rid] = 1 - old
                if not drained and rid in self._streams:
                    # The retired batcher may still run on its stream: the
                    # next swap must not capture there.
                    self._streams[rid][old] = torch.cuda.Stream(self.device)
                clean &= drained
            with self._swap_lock:
                from_step = self._current_step
                self._current_file = used
                self._current_epoch = int(ckpt.epoch)
                self._current_step = int(ckpt.step)
        self._record("swap_commit", file=used, epoch=int(ckpt.epoch),
                     step=int(ckpt.step), from_step=from_step,
                     warm_s=round(warm_s, 3), compiled_executables=compiled,
                     old_drained_clean=clean)

    def _record(self, event: str, **fields) -> str:
        entry = {"event": event, "t": round(time.time(), 3), **fields}
        with self._swap_lock:
            self.swap_history.append(entry)
        _log(f"fleet: {event} " + " ".join(
            f"{k}={v}" for k, v in fields.items()))
        return event

    # -- front-door API ----------------------------------------------------

    def submit(self, images, timeout: Optional[float] = None):
        return self.router.submit(images, timeout=timeout)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None,
                 session: Optional[str] = None):
        """Fleet front door for one generative stream, sticky-routed by
        ``session`` (:meth:`Router.generate`); a classifier fleet's
        replicas answer :class:`TypeError`."""
        return self.router.generate(prompt,
                                    max_new_tokens=max_new_tokens,
                                    timeout=timeout, session=session)

    def health(self) -> dict:
        """The fleet /healthz body: ok while ANY replica can take
        traffic; per-replica detail for humans and probes."""
        reps = self.router.replica_health()
        healthy = sum(1 for r in reps
                      if r.get("status") == "ok" and not r.get("ejected")
                      and r.get("breaker") != "open")
        draining = self._draining.is_set()
        with self._swap_lock:
            ck = {"file": self._current_file, "epoch": self._current_epoch,
                  "step": self._current_step}
        return {
            "status": ("draining" if draining
                       else "ok" if healthy else "unavailable"),
            "replicas": reps,
            "healthy_replicas": healthy,
            "checkpoint": ck,
            "checkpoint_step": ck["step"],
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "queue_depth": sum(int(r.get("queue_depth", 0) or 0)
                               for r in reps),
        }

    def stats(self) -> dict:
        with self._swap_lock:
            swaps = list(self.swap_history)
        return {"router": self.router.stats(),
                "replicas": [r.stats() for r in self.replicas],
                "swaps": swaps}

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def close(self, timeout: float = 30.0) -> bool:
        """Stop watcher + prober, drain every replica.  Idempotent."""
        self._draining.set()
        self._stop.set()
        t = self._watch_thread
        if t is not None:
            t.join(timeout=10.0)
            self._watch_thread = None
        self.router.close()
        ok = True
        for replica in self.replicas:
            ok &= replica.close(timeout=timeout)
        return ok
