"""Low-overhead span tracer (counterpart of ``ddp_tpu/obs/tracer.py``: the
recording half).

A :class:`SpanTracer` records one *span* per phase occurrence,

    with tracer.span("h2d", step=seq):
        ...

with ``time.monotonic()`` timestamps, into a bounded in-memory ring
(:meth:`SpanTracer.spans_since` reads a window of it back, as the bench's
``phase_ms`` does) and as append-only JSON lines in a spill file.  A
record is the JAX package's, key for key (``phase``, ``step``,
``start_s``, ``dur_s``, ``overlap``, ``host`` and, on request-scoped spans,
``req``), so ``python -m ddp_tpu.obs`` and its Perfetto export read a spill
of the port as they read their own.  ``overlap=True`` marks spans that run
concurrently with the serial pipeline (a request's queue wait), which
reports must not add to wall time.

Kill switch (``--obs_off``): the module-level default tracer is a
:class:`NullTracer` whose ``span()`` returns one shared no-op context
manager, so an instrumented path costs two trivial calls.  A span is
recorded only when its body exits cleanly.

The spill is written under one lock taken after the body ran, never around
the caller's code.  A failed write degrades to no spill with one warning:
telemetry never stops the run it observes.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import IO, List, Optional


def default_spill_path(snapshot_path: str, filename: str) -> str:
    """The spill next to the checkpoint head (``--snapshot_path``), not in
    the working directory; an explicit ``--trace_spill`` is used as given."""
    head = os.path.dirname(snapshot_path)
    return os.path.join(head, filename) if head else filename


class _NullSpan:
    """Shared no-op context manager: the whole cost of a disabled span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op (``--obs_off``)."""
    enabled = False

    def span(self, phase: str, step: Optional[int] = None,
             overlap: bool = False,
             req: Optional[str] = None) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, phase: str, start_monotonic: float, dur_s: float,
                 step: Optional[int] = None, overlap: bool = False,
                 req: Optional[str] = None) -> None:
        pass

    def flush(self, fsync: bool = False) -> None:
        pass

    def close(self) -> None:
        pass


class _Span:
    """One in-flight span; records itself on a clean ``__exit__`` only."""
    __slots__ = ("_tracer", "phase", "step", "overlap", "req", "_start")

    def __init__(self, tracer: "SpanTracer", phase: str,
                 step: Optional[int], overlap: bool,
                 req: Optional[str] = None):
        self._tracer = tracer
        self.phase = phase
        self.step = step
        self.overlap = overlap
        self.req = req

    def __enter__(self) -> "_Span":
        self._start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:  # an aborted body is not a completed phase
            end = time.monotonic()
            self._tracer._record(self.phase, self.step, self._start,
                                 end - self._start, self.overlap, self.req)
        return False


class SpanTracer:
    """Per-process span recorder: a ring of the newest ``ring`` spans and an
    optional JSONL spill.

    ``host`` tags every record with the process's rank; ``start_s`` is
    relative to the tracer's construction.  The spill is truncated per run,
    as the JAX package's is: two runs' relative timelines must not stack in
    one file."""

    enabled = True

    def __init__(self, spill_path: Optional[str] = None, *,
                 ring: int = 4096, host: int = 0):
        self.host = int(host)
        self.spill_path = spill_path
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._f: Optional[IO[str]] = (open(spill_path, "w")
                                      if spill_path else None)

    def span(self, phase: str, step: Optional[int] = None,
             overlap: bool = False, req: Optional[str] = None) -> _Span:
        return _Span(self, phase, step, overlap, req)

    def add_span(self, phase: str, start_monotonic: float, dur_s: float,
                 step: Optional[int] = None, overlap: bool = False,
                 req: Optional[str] = None) -> None:
        """Record a span the caller timed (``start_monotonic`` on the
        ``time.monotonic`` clock)."""
        self._record(phase, step, start_monotonic, dur_s, overlap, req)

    def _record(self, phase: str, step: Optional[int], start: float,
                dur: float, overlap: bool,
                req: Optional[str] = None) -> None:
        rec = (phase, step, start - self._t0, dur, overlap, req)
        line = None
        if self._f is not None:
            body = {
                "phase": phase, "step": step,
                "start_s": round(rec[2], 6), "dur_s": round(dur, 6),
                "overlap": overlap, "host": self.host,
            }
            if req is not None:  # request-scoped spans only
                body["req"] = req
            # Serialised outside the lock: pure CPU work on local data.
            line = json.dumps(body) + "\n"
        with self._lock:
            self._ring.append(rec)
            if line is None or self._f is None:
                return
            try:
                self._f.write(line)
            except OSError as e:
                print(f"WARNING: span spill write failed ({e}); dropping "
                      f"the spill file", file=sys.stderr)
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    def now(self) -> float:
        """The tracer's own clock (the basis of a span's ``start_s``): the
        window mark :meth:`spans_since` takes."""
        return time.monotonic() - self._t0

    def spans_since(self, t: float) -> List[dict]:
        """The ring's spans that started at or after tracer time ``t``."""
        with self._lock:
            return [{"phase": p, "step": s, "start_s": start, "dur_s": d,
                     "overlap": o, "req": r}
                    for p, s, start, d, o, r in self._ring if start >= t]

    def flush(self, fsync: bool = False) -> None:
        """Flush the spill; ``fsync=True`` also forces it to disk."""
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    if fsync:
                        os.fsync(self._f.fileno())
                except OSError:
                    pass  # never stop the run: same rule as _record

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    def __enter__(self) -> "SpanTracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# The process's tracer for code that takes no tracer argument; the serve
# entry point installs the real one and restores the null one after.
_tracer: object = NullTracer()


def get_tracer():
    return _tracer


def set_tracer(tracer) -> None:
    global _tracer
    _tracer = tracer if tracer is not None else NullTracer()
