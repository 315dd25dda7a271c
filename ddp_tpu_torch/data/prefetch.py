"""Background host->device prefetch: the streaming path's overlap engine
(counterpart of ``ddp_tpu/data/prefetch.py``).

The reference hides its input pipeline behind ``pin_memory=True`` and
DataLoader worker processes (singlegpu.py:177).  Here a thread pool builds
upcoming batches (gather + crop/flip, ``TrainLoader.materialize``) while the
consumer loop enqueues the current step, and each batch is copied to the
card up to ``depth`` steps ahead through
:func:`~ddp_tpu_torch.train.step.to_device`: pinned host memory, the copy
on a side stream, and an event the compute stream waits on.  Loaders with
``materialize(k)`` and a length get a pool of workers (:func:`_pooled`,
the copy on the consumer's thread); any other iterable of batches (the
``--grad_accum`` group stream) gets one producer thread that also copies
(:func:`_threaded`).

Contracts the tests pin (``tests/test_torch_stream.py``):

- **Order and equality**: the stream is the loader's batches in order, bit
  for bit, at every depth and worker count (``depth=0`` is the plain loop).
- **Fast-forward**: ``start=k`` yields exactly batches ``[k, n)``.
- **Shutdown**: abandoning the iterator (an exception in the consumer, an
  early ``break``) stops and joins every thread it started.
- **Errors**: a producer's exception is raised again in the consumer.

:class:`PrefetchStats` attributes the time: the producers' host time
(materialise + augment), the H2D enqueue time (pinning and enqueueing the
copies) and the consumer's wait for a batch that was not ready, the
pipeline's bubble.  The stages also report ``host_augment``, ``h2d`` and
``data_wait`` spans to the tracer (``obs/tracer.py``; ``overlap=True`` on
the producer threads' spans).
"""
from __future__ import annotations

import functools
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ..obs.tracer import get_tracer
from ..train.step import to_device

_DONE = object()


class _Error:
    """A producer's exception, on its way to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchStats:
    """Thread-safe wall-time counters of one streaming run.

    ``host_s``: producer time building batches (summed over the pool's
    workers, so it can exceed wall time); ``h2d_s``: time in
    :func:`~ddp_tpu_torch.train.step.to_device` (pinning the batch and
    enqueueing its copies; the copy itself runs on the card's copy engine);
    ``wait_s``: consumer time blocked on a batch that was not ready, the
    pipeline's bubble; ``batches``: batches yielded."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.host_s = 0.0
        self.h2d_s = 0.0
        self.wait_s = 0.0
        self.batches = 0

    def _add(self, field: str, dt: float) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + dt)

    def count_batch(self) -> None:
        with self._lock:
            self.batches += 1

    def per_step_ms(self) -> Dict[str, float]:
        """Per yielded batch: host, H2D-enqueue and consumer-wait ms, and
        the batch count; one consistent snapshot under the lock."""
        with self._lock:
            n = max(self.batches, 1)
            return {"host_ms_per_step": round(self.host_s / n * 1e3, 3),
                    "h2d_enqueue_ms_per_step":
                        round(self.h2d_s / n * 1e3, 3),
                    "consumer_wait_ms_per_step":
                        round(self.wait_s / n * 1e3, 3),
                    "batches": self.batches}


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]],
                       device: torch.device, depth: int = 2,
                       workers: int = 4,
                       stats: Optional[PrefetchStats] = None,
                       step0: int = 0, start: int = 0) -> Iterator:
    """Yield ``batches`` placed on ``device`` ahead of consumption.

    ``depth`` is how many batches may be in flight beyond the workers' own
    hands (the bounded queue); ``depth=0`` builds and copies each batch
    inline, the unpipelined loop (same stream, bit for bit).  ``workers``
    applies to loaders with ``materialize(k)``.  Each host batch is placed
    by :func:`~ddp_tpu_torch.train.step.to_device`: on the card on a copy
    stream made for this call, whose batches the caller's current stream
    (at the first ``next``) waits for through ``DeviceBatch.wait``; on the
    CPU with ``torch.from_numpy``.  The process tracer gets the spans,
    numbered from ``step0``.  ``start`` skips to batch ``start``: never
    built for ``materialize(k)`` loaders, built and dropped for plain
    iterators."""
    device = torch.device(device)
    place = to_device
    if device.type == "cuda":
        place = functools.partial(
            to_device, stream=torch.cuda.Stream(device),
            compute=torch.cuda.current_stream(device))
    tracer = get_tracer()
    start = max(int(start), 0)
    random_access = hasattr(batches, "materialize") and \
        hasattr(batches, "__len__")
    if depth <= 0:
        if start and random_access:
            loader = batches  # bound now: the generator must not see itself
            batches = (loader.materialize(k)
                       for k in range(start, len(loader)))
            start = 0
        yield from _passthrough(iter(batches), device, stats, place,
                                tracer, step0, start)
    elif random_access:
        yield from _pooled(batches, device, depth, max(workers, 1), stats,
                           place, tracer, step0, start)
    else:
        yield from _threaded(iter(batches), device, depth, stats, place,
                             tracer, step0, start)


def _timed(stats: Optional[PrefetchStats], field: str, fn, *args):
    if stats is None:
        return fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    stats._add(field, time.perf_counter() - t0)
    return out


def _skip(batches: Iterator, start: int) -> None:
    """Advance a plain iterator past its first ``start`` items; an iterator
    that ends first leaves an empty stream."""
    for _ in range(start):
        try:
            next(batches)
        except StopIteration:
            return


def _passthrough(batches: Iterator, device, stats, place, tracer,
                 step0: int, start: int = 0) -> Iterator:
    """The unpipelined shape (singlegpu.py:104-107's loop): build, copy,
    consume, in sequence, all on the consumer's thread (serial spans).  A
    span whose body raises StopIteration is not recorded, so the probe
    that finds the end leaves none."""
    _skip(batches, start)
    k = step0
    while True:
        try:
            with tracer.span("host_augment", step=k):
                batch = _timed(stats, "host_s", lambda: next(batches))
        except StopIteration:
            return
        with tracer.span("h2d", step=k):
            out = _timed(stats, "h2d_s", place, batch, device)
        if stats is not None:
            stats.count_batch()
        k += 1
        yield out


def _materialize_traced(tracer, stats, loader, k: int, step0: int):
    """A pool worker's batch, in an ``overlap=True`` span: the workers run
    beside the consumer loop, so their time is not the loop's."""
    with tracer.span("host_augment", step=step0 + k, overlap=True):
        return _timed(stats, "host_s", loader.materialize, k)


def _pooled(loader, device, depth: int, workers: int, stats, place, tracer,
            step0: int, start: int = 0) -> Iterator:
    n = len(loader)
    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="ddp_prefetch")
    futures: deque = deque()
    try:
        futures.extend(pool.submit(_materialize_traced, tracer, stats,
                                   loader, k, step0)
                       for k in range(start,
                                      min(start + workers + depth, n)))
        next_k = start + len(futures)
        i = 0
        while futures:
            with tracer.span("data_wait", step=step0 + i):
                batch = _timed(stats, "wait_s", futures.popleft().result)
            if next_k < n:
                futures.append(pool.submit(_materialize_traced, tracer,
                                           stats, loader, next_k, step0))
                next_k += 1
            with tracer.span("h2d", step=step0 + i):
                out = _timed(stats, "h2d_s", place, batch, device)
            if stats is not None:
                stats.count_batch()
            i += 1
            yield out
    finally:
        # Abandoned or finished: drop the queued work and join the workers
        # (a batch in a worker's hands finishes; nothing else starts).
        pool.shutdown(wait=True, cancel_futures=True)


def _threaded(batches: Iterator, device, depth: int, stats, place, tracer,
              step0: int, start: int = 0) -> Iterator:
    _skip(batches, start)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        """A bounded put that gives up once the consumer is gone, so the
        producer never blocks for ever on a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        # The producer builds and copies; its spans overlap the consumer's.
        k = step0
        try:
            while not stop.is_set():
                try:
                    with tracer.span("host_augment", step=k, overlap=True):
                        batch = _timed(stats, "host_s",
                                       lambda: next(batches))
                except StopIteration:
                    break
                with tracer.span("h2d", step=k, overlap=True):
                    item = _timed(stats, "h2d_s", place, batch, device)
                if not _put(item):
                    return
                k += 1
        except BaseException as e:  # raised again in the consumer
            _put(_Error(e))
            return
        _put(_DONE)

    t = threading.Thread(target=worker, daemon=True, name="ddp_prefetch")
    t.start()
    i = 0
    try:
        while True:
            # Timed by hand and recorded for real batches only: the get that
            # returns the end or an error is no step's wait.
            t0 = time.monotonic() if tracer.enabled else 0.0
            item = _timed(stats, "wait_s", q.get)
            if item is _DONE:
                return
            if isinstance(item, _Error):
                raise item.exc
            if tracer.enabled:
                tracer.add_span("data_wait", t0, time.monotonic() - t0,
                                step=step0 + i)
            i += 1
            if stats is not None:
                stats.count_batch()
            yield item
    finally:
        stop.set()
        try:  # unblock a producer in the middle of a put
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)
