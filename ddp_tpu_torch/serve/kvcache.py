"""KV-cached generative decoding: the serve engine for ``tinylm``
(counterpart of ``ddp_tpu/serve/kvcache.py`` at one device).

A generative model needs three program families, still a small fixed set
made at start-up (``warm()``), so no stream waits on a build:

- ``prefill``, one a padded PROMPT-length bucket: the causal forward of
  one stream's prompt, its next-token logits and the prompt's key/value
  stacks (``TinyLM.prefill``);
- ``cache_write``, one a prompt bucket: the prefilled keys and values
  copied into the stream's cache SLOT at positions ``0..bucket-1``;
- ``decode``, ONE for the whole run: every slot advances one token
  (``TinyLM.decode_step``: each slot's key/value written in place at its
  position, attention over its valid prefix).  Slots nobody reads compute
  garbage that is never read, which keeps the shape, and so the program
  count, fixed whatever streams are live.

On the card each program is one CUDA graph over static input tensors (the
prompt's tokens, the slot, the decode step's ``tokens`` and ``positions``),
captured at ``warm()`` and replayed a call: the counterpart of the JAX
engine's compiled executables, and ``trace_count`` counts the captures.
Each is a ``train/step.py::GraphProgram``, as the classifier engine's are:
on the card a program that was not captured raises, never runs eagerly.
On the CPU the same three programs run eagerly and each is counted once,
at its first run.  ``compile_bound`` is ``2 * len(prompt buckets) + 1``.

The cache, ``[n_layers, slots, T_MAX, n_heads, head_dim]`` twice (K and V)
in the compute dtype, is allocated once and written in place by the
cache-write and decode programs, the counterpart of the JAX engine's
donated cache buffers: no step makes a second cache.  The JAX engine also
shards the slots over a data axis; the port's slots stay on one device.

**A serving model axis** (``plan=``, ``group=``; the JAX engine's
``_wiring``/``_cache_specs`` under a plan): the engine is one rank of a
:class:`~ddp_tpu_torch.serve.model_group.ModelGroup` of M ranks, each
holding its ``qkv``/``fc1`` column slices and ``out``/``fc2`` row slices
(``from_shard``) and its heads' slice of the cache, ``[n_layers, slots,
T_MAX, n_heads / M, head_dim]``.  Each program runs the model's
tensor-parallel forward, its row sums over the group's gloo ``sums``.
Rank 0 is the engine the batcher calls; each of its calls (``warm``,
``start_stream``, ``decode``, ``release``) first reaches the followers as a
header (``model_group.py``), which run it with the same arguments
(:meth:`follow`).  A gloo sum cannot sit inside a CUDA graph, so on the card
each prefill and the decode are chains of captured segments, split at the
sums, which run on the host between two replays (``GraphProgram``'s
``sums``); the cache write has no sum and is one graph.  ``compile_bound``
stays ``2 * len(prompt buckets) + 1`` programs, none of which runs
uncaptured on the card, and ``stats()["model_group"]`` says the segments,
the backend and the host ms spent in the sums.

Greedy choice is the first maximum of the float32 logits on the host,
as ``np.argmax`` picks.  Calls run on the engine's one side stream on its
device, whichever thread calls; the token batcher's engine thread is the
one caller by design, and a lock serialises misuse.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, dtype_name, resolve_device
from ..obs.registry import MetricsRegistry
from ..obs.tracer import get_tracer
from ..train.step import GraphProgram
from .engine import RequestTooLarge, ServeError  # noqa: F401 (re-export)
from .model_group import OP_DECODE, OP_RELEASE, OP_START, OP_WARM


def resolve_prompt_buckets(buckets: Sequence[int],
                           t_max: int) -> Tuple[int, ...]:
    """The padded prompt-length buckets: deduplicated, ascending, clamped
    into ``[1, t_max]``."""
    if not buckets:
        raise ValueError("need at least one prompt bucket")
    if any(b < 1 for b in buckets):
        raise ValueError(f"prompt buckets must be >= 1, got {list(buckets)}")
    return tuple(sorted({min(int(b), t_max) for b in buckets}))


class SlotsExhausted(ServeError):
    """Every KV-cache slot is occupied: admission-level backpressure; the
    token batcher queues behind this, never the engine."""


class KVCacheEngine:
    """Slot-managed generative decoding of ``model`` (a ``TinyLM``) on
    ``device`` in ``compute_dtype`` (float32 when None), over a fixed set
    of programs.  ``metric_labels`` (a fleet's ``{"replica": "r0"}``)
    label every series it registers; ``stream`` is the side stream it
    captures and runs on (card; a new one when None)."""

    def __init__(self, model, *, device: DeviceLike = "cuda",
                 slots: int = 8, prompt_buckets: Sequence[int] = (16, 64),
                 compute_dtype: Optional[torch.dtype] = None, tracer=None,
                 registry=None, metric_labels=None,
                 stream: Optional[torch.cuda.Stream] = None, plan=None,
                 group=None, gen: int = 0):
        from ..models import transformer as tfm
        from ..parallel.tp.plan import recipe_override
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # The serving model axis: this rank's group, its engine generation
        # (a fleet's hot swaps count them) and the forward's TP arguments.
        m = 1 if plan is None else int(plan.model_size)
        if (m > 1) != (group is not None) or \
                (group is not None and group.size != m):
            raise ValueError(
                f"a serving model axis needs a plan and a model group of "
                f"its size (plan model_size {m}, group "
                f"{None if group is None else group.size})")
        self.group, self.gen, self.model_axis = group, int(gen), m
        self.lead = group is None or group.lead
        self._tp = ({} if group is None else
                    {"tp_group": group.sums,
                     "tp_recipe": recipe_override(plan)})
        self._owns_group = False
        self.compute_dtype = compute_dtype
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.vocab = int(tfm.VOCAB)
        self.t_max = int(tfm.T_MAX)
        self.prompt_buckets = resolve_prompt_buckets(prompt_buckets,
                                                     self.t_max)
        self.max_prompt = self.prompt_buckets[-1]
        # Protocol alias: the fleet's surfaces report these as buckets.
        self.buckets = self.prompt_buckets
        self.compile_bound = 2 * len(self.prompt_buckets) + 1
        self.trace_count = 0  # captured graphs (card) / programs run (CPU)
        self.tracer = tracer if tracer is not None else get_tracer()
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        labels = dict(metric_labels or {})
        labelnames = tuple(sorted(labels))
        prefills = self.registry.counter(
            "ddp_kvcache_prefills_total",
            "Prompt prefills executed, by padded prompt bucket",
            labelnames + ("bucket",))
        self._prefill_children = {
            b: prefills.labels(bucket=str(b), **labels)
            for b in self.prompt_buckets}
        self._c_decode_steps = self.registry.counter(
            "ddp_kvcache_decode_steps_total",
            "Decode steps executed (all slots advance together)",
            labelnames).labels(**labels)
        self._g_active = self.registry.gauge(
            "ddp_kvcache_active_slots",
            "KV-cache slots currently bound to live streams",
            labelnames).labels(**labels)
        self._g_slots = self.registry.gauge(
            "ddp_kvcache_slots", "Total KV-cache slots",
            labelnames).labels(**labels)
        self._g_slots.set(self.slots)
        self._g_compiled = self.registry.gauge(
            "ddp_engine_compiled_executables",
            "Executables compiled so far (the compile-bound contract)",
            labelnames).labels(**labels)

        self._cuda = self.device.type == "cuda"
        if stream is None and self._cuda:
            stream = torch.cuda.Stream(self.device)
        self._stream = stream
        self._done = torch.cuda.Event() if self._cuda else None
        cd = compute_dtype or torch.float32
        shape = (int(tfm.N_LAYERS), self.slots, self.t_max,
                 int(tfm.N_HEADS) // m, int(tfm.HEAD_DIM))
        self._k = torch.zeros(shape, dtype=cd, device=self.device)
        self._v = torch.zeros(shape, dtype=cd, device=self.device)
        # Set by warm() once every program is made (and captured, card).
        self._prefill: Dict[int, GraphProgram] = {}
        self._write: Dict[int, GraphProgram] = {}
        self._decode: Optional[GraphProgram] = None
        # Host tensors requests are staged through (pinned on the card).
        self._host: Dict[str, torch.Tensor] = {}

        self._lock = threading.Lock()        # the pipeline
        self._stats_lock = threading.Lock()  # counters (probe-readable)
        self._free = list(range(self.slots))
        self._pos: Dict[int, int] = {}       # slot -> next write position
        self.prefills = 0
        self.decode_steps = 0
        self.tokens_out = 0
        # Host seconds in decode runs (staging, replays, sums, the copy).
        self.decode_seconds = 0.0
        self.warmed = False
        self.checkpoint_file: Optional[str] = None
        self.checkpoint_epoch: Optional[int] = None
        self.checkpoint_step: Optional[int] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_shard(cls, ckpt, plan, group, gen: int = 0,
                   **kwargs) -> "KVCacheEngine":
        """Model index ``group.rank``'s engine of generation ``gen`` from
        ``ckpt``, its slices under ``plan`` (``ckpt_shard.load_for_mesh``
        or ``shard_checkpoint``)."""
        from ..models import get_model
        from ..models import transformer as tfm
        from ..parallel.tp.plan import shard_module_
        from ..train.checkpoint import restore
        model = get_model(tfm.LM_NAME)
        shard_module_(model, plan, group.rank)
        restore(ckpt, model)
        return cls(model, plan=plan, group=group, gen=gen, **kwargs)

    @classmethod
    def from_checkpoint(cls, snapshot_path: str, model_name: str, *,
                        device: DeviceLike = "cuda", slots: int = 8,
                        prompt_buckets=(16, 64),
                        compute_dtype: Optional[torch.dtype] = None,
                        tracer=None, registry=None, metric_labels=None,
                        stream: Optional[torch.cuda.Stream] = None,
                        model_axis: int = 1) -> "KVCacheEngine":
        """An engine on the newest verifiable checkpoint under
        ``snapshot_path``, through the classifier engine's lineage walk (a
        v1 file or a v2 set, from any training layout).  At ``model_axis``
        M > 1 it is rank 0 of a new model group of M ranks (the
        ``tinylm`` plan at M; ``model_group.ModelGroup.spawn``), which
        :meth:`close` stops."""
        from ..models import get_model
        from ..models import transformer as tfm
        from ..resilience.lineage import latest_verifiable
        from ..train.checkpoint import CheckpointError, restore
        if model_name != tfm.LM_NAME:
            raise ValueError(
                f"generative serving supports the {tfm.LM_NAME!r} decoder "
                f"(models/transformer.py), got {model_name!r}")
        loaded = latest_verifiable(snapshot_path)
        if loaded is None:
            raise CheckpointError(
                f"no checkpoint found under {snapshot_path!r}; train the "
                "LM first (python -m ddp_tpu_torch.train.lm "
                "--snapshot_path)")
        ckpt, used = loaded
        kwargs = dict(device=device, slots=slots,
                      prompt_buckets=prompt_buckets,
                      compute_dtype=compute_dtype, tracer=tracer,
                      registry=registry, metric_labels=metric_labels,
                      stream=stream)
        if model_axis > 1:
            from ..parallel.tp.plan import plan_for_model
            from ..train.ckpt_shard import shard_checkpoint
            from .model_group import ModelGroup
            plan = plan_for_model(tfm.LM_NAME,
                                  get_model(tfm.LM_NAME, device="meta"),
                                  model_size=model_axis)
            group = ModelGroup.spawn(model_axis,
                                     device=resolve_device(device),
                                     slots=slots,
                                     prompt_buckets=prompt_buckets,
                                     compute_dtype=compute_dtype)
            try:
                eng = group.load(0, used, ckpt.step, ckpt.epoch,
                                 lambda: cls.from_shard(
                                     shard_checkpoint(ckpt, plan, 0), plan,
                                     group, 0, **kwargs))
            except BaseException:
                group.close()
                raise
            eng._owns_group = True
        else:
            model = get_model(tfm.LM_NAME)
            try:
                restore(ckpt, model)
            except CheckpointError as e:
                raise CheckpointError(f"checkpoint {used!r}: {e}") from None
            eng = cls(model, **kwargs)
        eng.checkpoint_file = used
        eng.checkpoint_epoch = int(ckpt.epoch)
        eng.checkpoint_step = int(ckpt.step)
        return eng

    def _on_trace(self) -> None:
        with self._stats_lock:
            self.trace_count += 1
        self._g_compiled.inc()

    def _make_programs(self):
        """The programs, their static inputs and the host staging buffers,
        as ``(prefill, write, decode, host)``; nothing is set on the
        engine."""
        model, cd, dev = self.model, self.compute_dtype, self.device
        tp = self._tp
        sums = None if self.group is None else self.group.sums
        prefill: Dict[int, GraphProgram] = {}
        write: Dict[int, GraphProgram] = {}
        host: Dict[str, torch.Tensor] = {}
        pin = self._cuda

        def prefill_fn(tokens):
            def fn():
                with torch.no_grad():
                    logits, k, v = model.prefill(tokens[None],
                                                 compute_dtype=cd, **tp)
                return logits[0], k[:, 0], v[:, 0]
            return fn

        def write_fn(bucket, slot, prog):
            def fn():
                _, k, v = prog.output
                self._k[:, :, :bucket].index_copy_(
                    1, slot, k[:, None].to(self._k.dtype))
                self._v[:, :, :bucket].index_copy_(
                    1, slot, v[:, None].to(self._v.dtype))
            return fn

        for b in self.prompt_buckets:
            tokens = torch.zeros(b, dtype=torch.long, device=dev)
            slot = torch.zeros(1, dtype=torch.long, device=dev)
            prefill[b] = GraphProgram(prefill_fn(tokens), dev,
                                      f"the {b}-token prefill",
                                      {"tokens": tokens}, sums=sums)
            write[b] = GraphProgram(write_fn(b, slot, prefill[b]), dev,
                                    f"the {b}-token cache write",
                                    {"slot": slot})
            host[f"tokens{b}"] = torch.zeros(b, dtype=torch.long,
                                             pin_memory=pin)
        tokens = torch.zeros(self.slots, dtype=torch.long, device=dev)
        positions = torch.zeros(self.slots, dtype=torch.long, device=dev)

        def decode_fn():
            with torch.no_grad():
                return model.decode_step(tokens, positions, self._k,
                                         self._v, compute_dtype=cd, **tp)

        decode = GraphProgram(decode_fn, dev, "the decode",
                              {"tokens": tokens, "positions": positions},
                              sums=sums)
        host["slot"] = torch.zeros(1, dtype=torch.long, pin_memory=pin)
        host["step"] = torch.zeros((2, self.slots), dtype=torch.long,
                                   pin_memory=pin)
        host["row"] = torch.zeros(self.vocab, dtype=torch.float32,
                                  pin_memory=pin)
        host["logits"] = torch.zeros((self.slots, self.vocab),
                                     dtype=torch.float32, pin_memory=pin)
        return prefill, write, decode, host

    def warm(self) -> int:
        """Make every program now: prefill and cache-write for each prompt
        bucket and the one decode (on the card: each run eagerly, then
        each captured as a CUDA graph, or a chain of them under a model
        group; on the CPU: each run once).  Returns ``trace_count``
        (``compile_bound`` from a cold engine); calling it again makes
        nothing new.  The engine takes the programs, and counts them, only
        once all of them are made on every rank of its group: a failed run
        or capture raises and leaves it cold (every rank's), so the next
        call makes them all again (a cold engine's programs never run)."""
        with self._lock:
            if self._decode is None:
                with self._call(OP_WARM):
                    self._warm_programs()
        with self._stats_lock:
            self.warmed = True
            return self.trace_count

    def _warm_programs(self) -> None:
        """:meth:`warm`'s work on this rank, ended by the group's vote."""
        err = None
        try:
            prefill, write, decode, host = self._make_programs()
            progs = [p for b in self.prompt_buckets
                     for p in (prefill[b], write[b])] + [decode]
            # The eager runs set each output: a cache write reads its
            # prefill's (the graph's static one once captured, so the
            # prefills are captured before the writes).
            with self._on_device():
                for prog in progs:
                    prog.output = prog.eager()
            if self._cuda:
                self._stream.synchronize()
                with torch.cuda.device(self.device):
                    for prog in progs:
                        prog.capture(self._stream)
                self._stream.synchronize()
        except Exception as e:
            err = e
        agreed = self.group is None or self.group.agree(err is None)
        if err is not None:
            raise err
        if not agreed:
            raise ServeError(f"a rank of the model group failed to warm its "
                             f"programs (see its stderr); the engine stays "
                             f"cold")
        self._prefill, self._write, self._host = prefill, write, host
        self._decode = decode
        for _ in progs:
            self._on_trace()

    @contextlib.contextmanager
    def _call(self, op: int, ints=(), payload=None):
        """Around a call's device work on the lead of a model group: its
        header goes to the followers first, and the group's lock is held
        to the end (the work's sums and votes are then the next on the
        group).  Nothing on a follower or without a group."""
        if self.group is None or not self.lead:
            yield
            return
        with self.group.lock:
            self.group.send(op, self.gen, ints, payload)
            yield

    def follow(self, op: int, ints: np.ndarray, payload: np.ndarray
               ) -> None:
        """A follower's run of rank 0's call ``op``, from its header:
        the same device work, on this rank's slices; its slot bookkeeping
        mirrors rank 0's (a position that differs is a lost header, and
        fails the follower)."""
        if op == OP_WARM:
            try:
                with self._lock:
                    if self._decode is None:
                        self._warm_programs()
            except ServeError:
                pass  # the vote failed: cold on every rank
            except Exception as e:
                print(f"model group rank {self.group.rank}: warm failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr,
                      flush=True)
            return
        if op == OP_START:
            slot, n, bucket = (int(v) for v in ints[:3])
            with self._stats_lock:
                self._free.remove(slot)
            with self._lock:
                self._prefill_into(slot, payload[:n], bucket)
            with self._stats_lock:
                self._pos[slot] = n
        elif op == OP_DECODE:
            tokens, positions = payload[:self.slots], \
                payload[self.slots:2 * self.slots]
            live = {int(i): int(tokens[i])
                    for i in np.flatnonzero(tokens >= 0)}
            with self._stats_lock:
                for slot in live:
                    if self._pos.get(slot) != int(positions[slot]):
                        raise ServeError(
                            f"model group rank {self.group.rank}: slot "
                            f"{slot} at position {self._pos.get(slot)}, "
                            f"rank 0's at {int(positions[slot])}")
            with self._lock:
                self._decode_into(np.stack([np.maximum(tokens[:self.slots],
                                                       0), positions]))
            with self._stats_lock:
                for slot in live:
                    self._pos[slot] += 1
        elif op == OP_RELEASE:
            self._release_local(int(ints[0]))
        else:
            raise ServeError(f"unknown model group op {op}")

    def _on_device(self):
        if not self._cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _wait(self) -> None:
        if self._cuda:
            self._done.record(self._stream)
            self._done.synchronize()

    # -- slot lifecycle ----------------------------------------------------

    def free_slots(self) -> int:
        with self._stats_lock:
            return len(self._free)

    def active_slots(self) -> int:
        with self._stats_lock:
            return self.slots - len(self._free)

    def bucket_for(self, n_tokens: int) -> int:
        for b in self.prompt_buckets:
            if n_tokens <= b:
                return b
        raise RequestTooLarge(
            f"{n_tokens} prompt tokens exceed the largest prompt bucket "
            f"{self.max_prompt}; shorten the prompt or restart with a "
            "larger --prefill_buckets set")

    def start_stream(self, prompt: Sequence[int]) -> Tuple[int, int]:
        """Admit one stream: take a slot, prefill its prompt into the slot's
        cache, and return ``(slot, first generated token)``, the TTFT
        boundary.  :class:`SlotsExhausted` when no slot is free,
        :class:`RequestTooLarge` past the largest prompt bucket."""
        prompt = np.asarray(prompt, np.int64)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token list, "
                             f"got shape {prompt.shape}")
        if np.any(prompt < 0) or np.any(prompt >= self.vocab):
            raise ValueError(f"prompt tokens must be in [0, {self.vocab})")
        n = int(prompt.size)
        bucket = self.bucket_for(n)
        if not self.warmed:
            self.warm()
        with self._stats_lock:
            if not self._free:
                raise SlotsExhausted(
                    f"all {self.slots} KV-cache slots are occupied")
            slot = self._free.pop(0)
        with self._lock, self._call(OP_START, (slot, n, bucket), prompt):
            first = self._prefill_into(slot, prompt, bucket)
        with self._stats_lock:
            self._pos[slot] = n
            self.prefills += 1
            self.tokens_out += 1
        self._prefill_children[bucket].inc()
        self._g_active.set(self.active_slots())
        return slot, first

    def _prefill_into(self, slot: int, prompt: np.ndarray,
                      bucket: int) -> Optional[int]:
        """Prefill ``prompt`` into ``slot``'s cache through the bucket's
        programs; the first token on the lead (None on a follower, which
        reads no logits).  Under the engine's lock."""
        n = len(prompt)
        prefill, write = self._prefill[bucket], self._write[bucket]
        staged = self._host[f"tokens{bucket}"]
        arr = staged.numpy()
        arr[:n] = prompt
        arr[n:] = 0
        self._host["slot"].numpy()[0] = slot
        with self._on_device():
            prefill.inputs["tokens"].copy_(staged, non_blocking=self._cuda)
            write.inputs["slot"].copy_(self._host["slot"],
                                       non_blocking=self._cuda)
            logits, _, _ = prefill.run()
            write.run()
            if self.lead:
                self._host["row"].copy_(logits[n - 1],
                                        non_blocking=self._cuda)
            self._wait()
        return int(np.argmax(self._host["row"].numpy())) if self.lead \
            else None

    def release(self, slot: int) -> None:
        """Return a finished or abandoned stream's slot to the free pool.
        No cache scrub: a later prefill overwrites from position 0, and
        nothing past a stream's position is ever read.  Under a model
        group the followers release it too."""
        with self._stats_lock:
            live = slot in self._pos
        if live:
            with self._call(OP_RELEASE, (slot,)):
                self._release_local(slot)

    def _release_local(self, slot: int) -> None:
        with self._stats_lock:
            if slot in self._pos:
                del self._pos[slot]
                self._free.append(slot)
        self._g_active.set(self.active_slots())

    def position(self, slot: int) -> int:
        with self._stats_lock:
            return self._pos[slot]

    # -- decoding ----------------------------------------------------------

    def decode(self, last_tokens: Dict[int, int]) -> Dict[int, int]:
        """One decode step for the ``{slot: last token}`` streams; every
        other slot rides along computing garbage nobody reads.  Returns
        ``{slot: next token}`` and advances each stream's position."""
        if not last_tokens:
            return {}
        out = self.decode_logits(last_tokens)
        return {slot: int(np.argmax(out[slot])) for slot in last_tokens}

    def decode_logits(self, last_tokens: Dict[int, int]) -> np.ndarray:
        """:meth:`decode`'s step, returning the float32 logits of every
        slot (``[slots, VOCAB]``, a host copy) instead of the choices."""
        if not self.warmed:
            self.warm()
        with self._lock:
            arr = np.zeros((2, self.slots), np.int64)
            live = np.full(self.slots, -1, np.int64)
            with self._stats_lock:
                for slot, tok in last_tokens.items():
                    pos = self._pos[slot]
                    if pos >= self.t_max:
                        raise ServeError(
                            f"slot {slot} is at T_MAX={self.t_max}; the "
                            "batcher must finish streams before the cache "
                            "runs out of positions")
                    arr[0, slot] = live[slot] = tok
                    arr[1, slot] = pos
            with self._call(OP_DECODE, (len(last_tokens),),
                            np.concatenate([live, arr[1]])):
                out = self._decode_into(arr)
        with self._stats_lock:
            for slot in last_tokens:
                self._pos[slot] += 1
            self.decode_steps += 1
            self.tokens_out += len(last_tokens)
        self._c_decode_steps.inc()
        return out

    def _decode_into(self, arr: np.ndarray) -> Optional[np.ndarray]:
        """One run of the decode program on ``arr`` (``[2, slots]``: each
        slot's token and position); a host copy of the float32 logits on
        the lead (None on a follower).  Under the engine's lock."""
        step = self._host["step"]
        step.numpy()[:] = arr
        prog = self._decode
        t0 = time.perf_counter()
        with self._on_device():
            prog.inputs["tokens"].copy_(step[0], non_blocking=self._cuda)
            prog.inputs["positions"].copy_(step[1], non_blocking=self._cuda)
            logits = prog.run()
            if self.lead:
                self._host["logits"].copy_(logits, non_blocking=self._cuda)
            self._wait()
        self.decode_seconds += time.perf_counter() - t0
        return self._host["logits"].numpy().copy() if self.lead else None

    # -- introspection -----------------------------------------------------

    def programs(self) -> Dict[str, GraphProgram]:
        """The warm engine's programs by name (``prefill16``, ``write16``,
        ..., ``decode``); empty while cold."""
        if self._decode is None:
            return {}
        out: Dict[str, GraphProgram] = {}
        for b in self.prompt_buckets:
            out[f"prefill{b}"] = self._prefill[b]
            out[f"write{b}"] = self._write[b]
        out["decode"] = self._decode
        return out

    def _group_stats(self) -> Optional[dict]:
        """The model group's side of :meth:`stats`: its size and backend,
        each program's captured segments and the host ms its sums took;
        None without a group."""
        if self.group is None:
            return None
        progs = self.programs()
        return {"size": self.group.size, "rank": self.group.rank,
                "backend": self.group.backend,
                "segments": {name: len(p.segments)
                             for name, p in progs.items()},
                "sum_ms": {name: round(p.sum_seconds * 1e3, 3)
                           for name, p in progs.items() if p.sums},
                "decode_host_ms": round(self.decode_seconds * 1e3, 3)}

    def close(self) -> None:
        """Stop the model group this engine started
        (``from_checkpoint(model_axis=M)``); nothing otherwise."""
        if self._owns_group:
            self.group.close()

    def cache_buffers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The K and V caches (the tensors the programs write in place)."""
        return self._k, self._v

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "slots": self.slots,
                "active_slots": self.slots - len(self._free),
                "prompt_buckets": list(self.prompt_buckets),
                "compiled_executables": self.trace_count,
                "compile_bound": self.compile_bound,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "tokens_out": self.tokens_out,
                "t_max": self.t_max,
                "mesh_devices": self.model_axis,
                "model_group": self._group_stats(),
                "compute_dtype": dtype_name(self.compute_dtype),
                "device": str(self.device),
                "checkpoint": {
                    "file": self.checkpoint_file,
                    "epoch": self.checkpoint_epoch,
                    "step": self.checkpoint_step,
                },
            }
