"""Token-level continuous batching for generative decoding (counterpart of
``ddp_tpu/serve/token_batcher.py``, host-only, the same file but for
imports).

The classifier's :class:`~ddp_tpu_torch.serve.batcher.DynamicBatcher` batches
WHOLE requests: one forward serves each request completely.  A
generative request is a stream of decode steps, so batching at request
granularity would convoy every stream behind the longest one.  This
batcher schedules at TOKEN granularity instead (the Orca-style
continuous batching): one engine thread runs the fixed-shape decode
program over ALL live streams each iteration, admitting new streams
into free KV-cache slots BETWEEN iterations — a stream joins the
decode batch the moment a slot frees, never at epoch boundaries.

Scheduling loop, each iteration:

1. admit: while a slot is free and a request is queued, prefill the
   request's prompt into a slot (its first token — the TTFT boundary —
   is produced here);
2. step: ONE decode advances every live stream by one token (inactive
   slots ride along computing garbage that is never read — the
   fixed-shape contract that keeps the compile count at one);
3. retire: streams that produced ``max_new_tokens`` (or whose caller
   abandoned them) release their slot and wake their caller.

The caller-facing contract mirrors the classifier batcher exactly —
bounded admission queue (:class:`QueueFull` at capacity), admission
refusal while draining (:class:`Draining`), oversize rejection at
admission (:class:`RequestTooLarge` — prompt past the largest bucket,
or prompt+max_new past the cache's T_MAX), blocking ``generate()`` with
timeout-abandonment reclaiming the stream's slot — so the router and
fleet treat both batcher kinds through one protocol (``start`` /
``queue_depth`` / ``draining`` / ``drain`` / ``stats``).

Metrics (shared registry when the fleet passes one): ``ddp_gen_*`` —
generated-token and completed-stream counters, TTFT and end-to-end
latency histograms, slot-occupancy gauge.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs.registry import MetricsRegistry
from ..obs.tracer import get_tracer
from .batcher import Draining, QueueFull, percentiles
from .engine import RequestTooLarge
from .kvcache import KVCacheEngine


class _GenRequest:
    __slots__ = ("prompt", "max_new", "t_submit", "event", "tokens",
                 "ttft_ms", "error", "abandoned", "req_id", "session")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 req_id: Optional[str] = None,
                 session: Optional[str] = None):
        self.prompt = prompt
        self.max_new = max_new
        self.req_id = req_id
        self.session = session
        self.t_submit = time.monotonic()
        self.event = threading.Event()
        self.tokens: Optional[List[int]] = None
        self.ttft_ms: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False


class _Stream:
    __slots__ = ("req", "slot", "tokens", "cur")

    def __init__(self, req: _GenRequest, slot: int, first: int):
        self.req = req
        self.slot = slot
        self.tokens = [first]
        self.cur = first


class TokenBatcher:
    def __init__(self, engine: KVCacheEngine, *,
                 max_new_tokens: int = 32, queue_depth: int = 256,
                 tracer=None, registry=None, metric_labels=None):
        self.engine = engine
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self._q: "queue.Queue[_GenRequest]" = queue.Queue(
            maxsize=max(int(queue_depth), 1))
        self.tracer = tracer if tracer is not None else get_tracer()
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._streams: Dict[int, _Stream] = {}  # slot -> live stream
        self._stats_lock = threading.Lock()
        # The two deques below are read and written under _stats_lock.
        self._ttft_ms: collections.deque = collections.deque(maxlen=4096)
        self._latency_ms: collections.deque = collections.deque(maxlen=4096)
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        labels = dict(metric_labels or {})
        labelnames = tuple(sorted(labels))
        reg = self.registry
        self._c_submitted = reg.counter(
            "ddp_gen_submitted_total",
            "Generative requests accepted for decoding",
            labelnames).labels(**labels)
        self._c_completed = reg.counter(
            "ddp_gen_completed_total",
            "Streams decoded to completion", labelnames).labels(**labels)
        self._c_tokens = reg.counter(
            "ddp_gen_tokens_total",
            "Tokens generated across all streams",
            labelnames).labels(**labels)
        self._c_shed_queue_full = reg.counter(
            "ddp_gen_shed_queue_full_total",
            "Generative requests shed at admission (queue at capacity)",
            labelnames).labels(**labels)
        self._c_rejected_oversize = reg.counter(
            "ddp_gen_rejected_oversize_total",
            "Requests rejected (prompt or prompt+max_new over budget)",
            labelnames).labels(**labels)
        self._c_timed_out = reg.counter(
            "ddp_gen_timed_out_total",
            "Generative requests whose caller gave up before completion",
            labelnames).labels(**labels)
        self._h_ttft = reg.histogram(
            "ddp_gen_ttft_ms",
            "Time to first token, submit to prefill logits (ms)",
            labelnames).labels(**labels)
        self._h_latency = reg.histogram(
            "ddp_gen_request_latency_ms",
            "Completed-stream latency, submit to last token (ms)",
            labelnames).labels(**labels)
        self._g_occupancy = reg.gauge(
            "ddp_gen_occupancy",
            "Live streams / KV-cache slots (the decode-batch fill rate)",
            labelnames).labels(**labels)
        self._g_occupancy.set_function(
            lambda: self.engine.active_slots() / max(self.engine.slots, 1))

    # -- caller side -------------------------------------------------------

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None,
                 req_id: Optional[str] = None,
                 session: Optional[str] = None) -> dict:
        """Block until the stream completes; returns ``{"tokens":
        [generated ids], "prompt_len": n, "ttft_ms": float}``.
        Thread-safe (the one entry point HTTP handler threads call
        concurrently).  ``session`` is the router's sticky-routing key —
        it rides into the stream's spans and stats, the batcher itself
        treats every request as a fresh stream (a migrated session
        simply re-prefills its full history here)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D token list, got shape "
                f"{tuple(prompt.shape)}")
        max_new = (self.max_new_tokens if max_new_tokens is None
                   else min(int(max_new_tokens), self.max_new_tokens))
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        n = int(prompt.size)
        if n > self.engine.max_prompt:
            self._c_rejected_oversize.inc()
            raise RequestTooLarge(
                f"{n} prompt tokens exceed the largest prompt bucket "
                f"{self.engine.max_prompt}; shorten the prompt")
        if n + max_new > self.engine.t_max:
            self._c_rejected_oversize.inc()
            raise RequestTooLarge(
                f"prompt ({n}) + max_new_tokens ({max_new}) exceeds the "
                f"KV-cache length T_MAX={self.engine.t_max}")
        if self._draining.is_set():
            raise Draining("server is draining; no new streams accepted")
        req = _GenRequest(prompt, max_new, req_id=req_id, session=session)
        self._c_submitted.inc()
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._c_shed_queue_full.inc()
            raise QueueFull(
                f"admission queue at capacity ({self._q.maxsize} "
                "requests); retry after backoff") from None
        if self._stopped.is_set():
            self._flush_queue()  # loop already exited: fail stranded work
        if not req.event.wait(timeout):
            req.abandoned = True  # the loop retires it and frees the slot
            self._c_timed_out.inc()
            raise TimeoutError(
                f"stream not completed within {timeout}s (queue depth "
                f"{self._q.qsize()}, "
                f"{self.engine.active_slots()} live streams)")
        if req.error is not None:
            raise req.error
        lat_ms = (time.monotonic() - req.t_submit) * 1e3
        with self._stats_lock:
            self._latency_ms.append(lat_ms)
        self._h_latency.observe(lat_ms)
        return {"tokens": req.tokens, "prompt_len": n,
                "ttft_ms": req.ttft_ms}

    # -- engine thread -----------------------------------------------------

    def start(self) -> "TokenBatcher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serve-token-batcher")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            progressed = self._admit()
            progressed |= self._step()
            if not progressed:
                if self._draining.is_set() and not self._streams \
                        and self._q.empty():
                    self._stopped.set()
                    self._flush_queue()
                    return
                time.sleep(0.002)  # idle: don't spin the GIL

    def _admit(self) -> bool:
        """Prefill queued requests into free slots.  Returns True when
        any stream was admitted (or a request failed at prefill)."""
        progressed = False
        while self.engine.free_slots() > 0:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req.abandoned:
                progressed = True
                continue
            try:
                seq_t0 = time.monotonic()
                slot, first = self.engine.start_stream(req.prompt)
            except BaseException as e:
                req.error = e
                req.event.set()
                progressed = True
                continue
            req.ttft_ms = (time.monotonic() - req.t_submit) * 1e3
            self.tracer.add_span("prefill_admit", seq_t0,
                                 time.monotonic() - seq_t0,
                                 req=req.req_id, overlap=True)
            with self._stats_lock:
                self._ttft_ms.append(req.ttft_ms)
            self._h_ttft.observe(req.ttft_ms)
            self._c_tokens.inc()
            self._streams[slot] = _Stream(req, slot, first)
            progressed = True
        return progressed

    def _step(self) -> bool:
        """One decode iteration over every live stream, then retire the
        finished/abandoned ones.  Returns True when any stream is live."""
        if not self._streams:
            return False
        # Retire abandoned streams BEFORE the step: no token burned on a
        # caller that already gave up.
        for slot in [s for s, st in self._streams.items()
                     if st.req.abandoned]:
            self._retire(slot, completed=False)
        if not self._streams:
            return True
        nxt = self.engine.decode(
            {slot: st.cur for slot, st in self._streams.items()})
        self._c_tokens.inc(len(nxt))
        for slot, tok in nxt.items():
            st = self._streams[slot]
            st.tokens.append(tok)
            st.cur = tok
            if len(st.tokens) >= st.req.max_new:
                self._retire(slot, completed=True)
        return True

    def _retire(self, slot: int, *, completed: bool) -> None:
        st = self._streams.pop(slot)
        self.engine.release(slot)
        if completed:
            st.req.tokens = st.tokens[:st.req.max_new]
            self._c_completed.inc()
            st.req.event.set()

    # -- lifecycle ---------------------------------------------------------

    def _flush_queue(self) -> int:
        leftovers = []
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            r.error = Draining("server drained before this stream ran")
            r.event.set()
        return len(leftovers)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Refuse new streams, decode the live ones to completion, stop
        the engine thread.  Idempotent; same contract as the classifier
        batcher's drain."""
        self._draining.set()
        ok = True
        if self._thread is not None:
            self._thread.join(timeout)
            ok = not self._thread.is_alive()
            if ok:
                self._thread = None
        else:
            self._stopped.set()
        stranded = self._flush_queue()
        return ok and not stranded

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def queue_depth(self) -> int:
        """Streams accepted but not yet admitted to a slot — the router's
        least-loaded key, same semantic as the classifier batcher's."""
        return self._q.qsize()

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            ttft = list(self._ttft_ms)
            lat = list(self._latency_ms)
        out = {
            "submitted": int(self._c_submitted.value),
            "completed_streams": int(self._c_completed.value),
            "tokens_generated": int(self._c_tokens.value),
            "shed_queue_full": int(self._c_shed_queue_full.value),
            "rejected_oversize": int(self._c_rejected_oversize.value),
            "timed_out": int(self._c_timed_out.value),
            "live_streams": self.engine.active_slots(),
            "slots": self.engine.slots,
            "occupancy": round(
                self.engine.active_slots() / max(self.engine.slots, 1), 3),
            "queue_depth": self._q.qsize(),
            "queue_capacity": self._q.maxsize,
            "max_new_tokens": self.max_new_tokens,
            "draining": self._draining.is_set(),
        }
        out["ttft_ms"] = {k: (round(v, 3) if v is not None else None)
                          for k, v in percentiles(ttft).items()}
        out["latency_ms"] = {k: (round(v, 3) if v is not None else None)
                             for k, v in percentiles(lat).items()}
        return out
