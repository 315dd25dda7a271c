"""Dynamic micro-batching with admission control (counterpart of
``ddp_tpu/serve/batcher.py``, host-only, the same file but for imports).

Callers block in :meth:`DynamicBatcher.submit` while one engine thread forms
batches and runs the engine's forwards.

- Requests enqueue into a bounded queue; a full queue sheds the request at
  once with :class:`QueueFull` (503 + Retry-After over HTTP) instead of
  letting latency grow without bound.
- The engine thread forms a batch when ``max_batch`` rows are waiting or
  ``max_wait_ms`` has passed since the oldest queued request, whichever
  comes first.  Once the wait budget is spent it still takes everything
  already queued, up to ``max_batch``, so a saturated queue does not
  collapse to batches of one.
- A request that does not fit the batch being formed is held over whole
  (a request is never split across forwards).
- Requests larger than the engine's largest bucket are rejected at
  admission with :class:`RequestTooLarge`; malformed ones fail alone.
- :meth:`drain` stops admission (:class:`Draining` to new callers), serves
  everything accepted, then stops the engine thread; ``python -m
  ddp_tpu_torch.serve`` wires it to the preemption guard.

Telemetry: each request's ``queue_wait`` (enqueue to batch formation) is an
``overlap=True`` span, and each batch records ``batch_form`` under the batch
sequence number the engine's spans use (claimed here, at formation).
Counters live in the metrics registry (``ddp_batcher_*``, the JAX package's
names; the ``stats()`` names are read-only views), with a
``ddp_batcher_request_latency_ms`` histogram of served requests.
"""
from __future__ import annotations

import collections
import queue
import statistics
import threading
import time
from typing import List, Optional

import numpy as np

from ..obs.registry import MetricsRegistry
from ..obs.tracer import get_tracer
from .engine import RequestTooLarge, ServeError, claim_batch_seq


class QueueFull(ServeError):
    """Admission queue at capacity — shed NOW (explicit backpressure)
    rather than queue into unbounded latency."""


class Draining(ServeError):
    """The server is shutting down: in-flight work completes, new work
    must go elsewhere."""


class _Request:
    __slots__ = ("images", "n", "t_submit", "event", "logits", "error",
                 "abandoned", "req_id")

    def __init__(self, images: np.ndarray,
                 req_id: Optional[str] = None):
        self.images = images
        self.req_id = req_id  # the X-Request-Id (span flow key)
        self.n = images.shape[0]
        self.t_submit = time.monotonic()
        self.event = threading.Event()
        self.logits: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # Caller gave up (submit timeout): batch formation skips it so
        # the engine never burns a forward on logits nobody will read —
        # at overload that wasted capacity would deepen the very
        # saturation that caused the timeout.
        self.abandoned = False


def percentiles(values: List[float], points=(50, 90, 99)) -> dict:
    """Nearest-rank percentiles of ``values`` (ms in, ms out)."""
    if not values:
        return {f"p{p}": None for p in points}
    ordered = sorted(values)
    return {f"p{p}": ordered[min(len(ordered) - 1,
                                 max(0, -(-len(ordered) * p // 100) - 1))]
            for p in points}


class DynamicBatcher:
    def __init__(self, engine, *, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0, queue_depth: int = 256,
                 tracer=None, registry=None, metric_labels=None):
        self.engine = engine
        self.max_batch = engine.max_rows if max_batch is None \
            else min(int(max_batch), engine.max_rows)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(int(queue_depth), 1))
        self.tracer = tracer if tracer is not None else get_tracer()
        # The request that didn't fit the last batch.  Engine-thread-only
        # between start() and the join in drain(); the post-join flush in
        # drain() is ordered by Thread.join, not a lock.
        self._holdover: Optional[_Request] = None
        self._draining = threading.Event()
        self._stopped = threading.Event()  # engine loop has exited
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self._latency_ms: collections.deque = collections.deque(maxlen=4096)
        self._batch_rows: collections.deque = collections.deque(maxlen=4096)
        # Counters live in the metrics registry (internally locked;
        # private by default, the serve entry point passes its one); the
        # deques above stay under _stats_lock for the stats() percentiles.
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        labels = dict(metric_labels or {})
        labelnames = tuple(sorted(labels))
        reg = self.registry
        self._c_submitted = reg.counter(
            "ddp_batcher_submitted_total",
            "Requests accepted for batching", labelnames).labels(**labels)
        self._c_served = reg.counter(
            "ddp_batcher_served_total",
            "Requests served with logits", labelnames).labels(**labels)
        self._c_shed_queue_full = reg.counter(
            "ddp_batcher_shed_queue_full_total",
            "Requests shed at admission (queue at capacity)",
            labelnames).labels(**labels)
        self._c_rejected_oversize = reg.counter(
            "ddp_batcher_rejected_oversize_total",
            "Requests rejected as larger than the largest bucket",
            labelnames).labels(**labels)
        self._c_timed_out = reg.counter(
            "ddp_batcher_timed_out_total",
            "Requests whose caller gave up before service",
            labelnames).labels(**labels)
        self._c_batches = reg.counter(
            "ddp_batcher_batches_total",
            "Batches formed and forwarded", labelnames).labels(**labels)
        self._h_latency = reg.histogram(
            "ddp_batcher_request_latency_ms",
            "Served-request latency, submit to logits (ms)",
            labelnames).labels(**labels)

    # Legacy counter names: read-only views of the registry children.
    @property
    def submitted(self) -> int:
        return int(self._c_submitted.value)

    @property
    def served_requests(self) -> int:
        return int(self._c_served.value)

    @property
    def shed_queue_full(self) -> int:
        return int(self._c_shed_queue_full.value)

    @property
    def rejected_oversize(self) -> int:
        return int(self._c_rejected_oversize.value)

    @property
    def timed_out(self) -> int:
        return int(self._c_timed_out.value)

    @property
    def batches(self) -> int:
        return int(self._c_batches.value)

    # -- caller side -------------------------------------------------------

    def submit(self, images: np.ndarray,
               timeout: Optional[float] = None,
               req_id: Optional[str] = None) -> np.ndarray:
        """Block until ``images``' logits are ready (or raise).  Thread-safe
        — this is the one entry point every HTTP handler thread and load
        generator worker calls concurrently.  ``req_id`` rides into the
        request's spans for flow reconstruction."""
        images = np.asarray(images)
        # Validate at ADMISSION: a malformed request must fail alone, not
        # poison the innocent requests it would have been co-batched with.
        if images.ndim != 4 or images.shape[1:] != self.engine.input_shape:
            raise ValueError(
                f"expected images [n, "
                f"{', '.join(map(str, self.engine.input_shape))}], got "
                f"{images.shape}")
        if images.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 images (the loaders' wire format), got "
                f"{images.dtype}; scale/quantize on the client")
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty request (0 rows)")
        if n > self.engine.max_rows:
            self._c_rejected_oversize.inc()
            raise RequestTooLarge(
                f"{n} rows exceed the largest padded batch bucket "
                f"{self.engine.max_rows}; split the request")
        if self._draining.is_set():
            raise Draining("server is draining; no new requests accepted")
        req = _Request(images, req_id=req_id)
        self._c_submitted.inc()
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._c_shed_queue_full.inc()
            raise QueueFull(
                f"admission queue at capacity ({self._q.maxsize} "
                "requests); retry after backoff") from None
        if self._stopped.is_set():
            # Admission race closed: the engine loop exited between our
            # draining check and the put, so nothing will consume the
            # queue — fail the stranded request(s) NOW (the loop sets
            # _stopped BEFORE its own final flush, so a put that missed
            # that flush always lands in this branch).
            self._flush_queue()
        if not req.event.wait(timeout):
            req.abandoned = True  # reclaim the forward capacity
            self._c_timed_out.inc()
            raise TimeoutError(
                f"request not served within {timeout}s (queue depth "
                f"{self._q.qsize()})")
        if req.error is not None:
            raise req.error
        lat_ms = (time.monotonic() - req.t_submit) * 1e3
        with self._stats_lock:
            self._latency_ms.append(lat_ms)
        self._c_served.inc()
        self._h_latency.observe(lat_ms)
        return req.logits

    # -- engine thread -----------------------------------------------------

    def start(self) -> "DynamicBatcher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serve-batcher")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch:
                self._run_batch(batch)
            elif self._draining.is_set() and self._holdover is None \
                    and self._q.empty():
                # Drained.  Order matters: mark stopped FIRST, then make
                # one final flush — a submit that slips a request in
                # after this flush must observe _stopped (set before it)
                # and flush its own request (see submit()).
                self._stopped.set()
                self._flush_queue()
                return

    def _collect(self) -> List[_Request]:
        """One formed batch: first request (held-over or queued), then
        accumulate until ``max_batch`` rows or the wait budget from the
        FIRST request's arrival runs out.  An empty queue is not an event
        — the engine thread just polls again."""
        first = self._holdover
        self._holdover = None
        if first is None:
            try:
                # Bounded get: the poll interval is what lets drain() make
                # progress when the queue is already empty.
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                return []
        batch, rows = [first], first.n
        deadline = first.t_submit + self.max_wait_s
        while rows < self.max_batch:
            wait = deadline - time.monotonic()
            try:
                if wait <= 0 or self._draining.is_set():
                    # Budget spent (or draining): never WAIT for more work
                    # — but take everything already queued, up to
                    # max_batch.  Without this, a queue whose delay
                    # exceeds the wait budget (i.e. saturation, exactly
                    # when batching pays) would hand every request a
                    # pre-expired deadline and collapse to batch-of-1.
                    nxt = self._q.get_nowait()
                else:
                    nxt = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if rows + nxt.n > self.max_batch:
                self._holdover = nxt  # never split a request
                break
            batch.append(nxt)
            rows += nxt.n
        return batch

    def _run_batch(self, batch: List[_Request]) -> None:
        batch = [r for r in batch if not r.abandoned]
        if not batch:
            return  # every caller gave up: don't burn the forward
        # Claim the process-unique batch sequence HERE so queue_wait/
        # batch_form and the engine's pad/h2d/forward/d2h spans share one
        # key.
        seq = claim_batch_seq()
        t_form = time.monotonic()
        for r in batch:
            # Per-request admission->formation wait; overlap=True — these
            # intervals run concurrently with the engine thread's serial
            # pipeline and would double-count a wall-time identity.
            self.tracer.add_span("queue_wait", r.t_submit,
                                 t_form - r.t_submit, step=seq, overlap=True,
                                 req=r.req_id)
        try:
            with self.tracer.span("batch_form", step=seq):
                images = (batch[0].images if len(batch) == 1
                          else np.concatenate([r.images for r in batch]))
            logits = self.engine.forward(images, seq=seq)
        except BaseException as e:
            for r in batch:
                r.error = e
                r.event.set()
            return
        off = 0
        for r in batch:
            r.logits = logits[off:off + r.n]
            off += r.n
            r.event.set()
        with self._stats_lock:
            self._batch_rows.append(off)
        self._c_batches.inc()

    # -- lifecycle ---------------------------------------------------------

    def _flush_queue(self) -> int:
        """Fail everything still queued (plus any holdover) with
        :class:`Draining`; returns the count.  Only called once nothing
        will consume the queue again (loop exit, post-join, or the
        submit-side race branch)."""
        leftovers = [self._holdover] if self._holdover is not None else []
        self._holdover = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            r.error = Draining("server drained before this request ran")
            r.event.set()
        return len(leftovers)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Graceful shutdown: refuse new work, serve everything accepted,
        stop the engine thread.  Returns True when fully drained within
        ``timeout``.  Idempotent.  Any request that slipped past the
        admission check during the transition is failed with
        :class:`Draining` rather than left blocking forever (the
        loop-exit/_stopped ordering in ``_loop``/``submit`` closes the
        check-then-enqueue race)."""
        self._draining.set()
        ok = True
        if self._thread is not None:
            self._thread.join(timeout)
            ok = not self._thread.is_alive()
            if ok:
                self._thread = None
        else:
            self._stopped.set()  # never started: nothing consumes
        # Post-join flush: the normal path was already flushed by the
        # loop itself (usually 0 here); after a join TIMEOUT (engine
        # wedged mid-forward) it fails the still-queued requests so
        # their callers unblock instead of hanging with the engine.
        stranded = self._flush_queue()
        return ok and not stranded

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def queue_depth(self) -> int:
        """Live admission-queue depth (requests accepted, not yet formed
        into a batch), on /healthz."""
        return self._q.qsize()

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            lat = list(self._latency_ms)
            rows = list(self._batch_rows)
            out = {
                "submitted": self.submitted,
                "served_requests": self.served_requests,
                "shed_queue_full": self.shed_queue_full,
                "rejected_oversize": self.rejected_oversize,
                "timed_out": self.timed_out,
                "batches": self.batches,
                "queue_depth": self._q.qsize(),
                "queue_capacity": self._q.maxsize,
                "max_batch": self.max_batch,
                "max_wait_ms": self.max_wait_s * 1e3,
                "draining": self._draining.is_set(),
            }
        out["latency_ms"] = {k: (round(v, 3) if v is not None else None)
                             for k, v in percentiles(lat).items()}
        out["mean_batch_rows"] = (round(statistics.mean(rows), 2)
                                  if rows else None)
        return out
