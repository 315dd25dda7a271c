"""Flight recorder: the postmortem a dead run leaves behind (counterpart of
``ddp_tpu/obs/blackbox.py``, a copy: the JAX module needs only the standard
library, but the port imports nothing of ``ddp_tpu``).

A :class:`FlightRecorder` keeps a bounded in-memory ring of the run's
recent telemetry (every ``MetricsLogger`` record taps in through
``attach_recorder``), reads the tracer's span ring and a JSON-safe snapshot
of the CLI's arguments, and on an abnormal exit dumps one schema-checked
``postmortem.json`` next to the metrics JSONL.  The schema
(``postmortem/1``) and the reasons are the JAX package's byte for byte, so
either package's :func:`validate_postmortem` accepts the other's bundle.
The supervisor's failure ledger and its exit-87 ``diagnosis.json`` link
the bundle (``resilience/supervisor.py``), and the chaos campaign scores
every drill on it.

Dump sites (``cli.py``): the watchdog's expiry, on a side thread with a
join timeout (the expiry exists to escape a wedged run, so the span read
takes a lock timeout too); and around ``Trainer.train``, a preemption
(``preemption``), a guard abort (``guard_abort``), a drift abort
(``drift_abort``) and any other exception (``crash``), each before the
error reaches the CLI's teardown.

The write is crash-atomic (a temporary sibling, fsync, ``os.replace``,
the directory's fsync): a reader racing the child's death sees the old
bundle or the new one, never a torn one.  A failed dump warns and
returns; it never kills the run it observes.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

POSTMORTEM_SCHEMA = "postmortem/1"
POSTMORTEM_BASENAME = "postmortem.json"

# Dump reasons — the closed vocabulary validate_postmortem accepts.
REASONS = ("crash", "preemption", "watchdog_stall", "guard_abort",
           "drift_abort", "exit")


def _fsync_dir(d: str) -> None:
    """fsync a directory, where the platform and filesystem allow it."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Crash-atomic text write: temp sibling + flush + fsync +
    ``os.replace`` + directory fsync.  A concurrent reader sees either
    the old complete file or the new complete file."""
    d = os.path.dirname(os.path.abspath(path)) or os.getcwd()
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise


def _json_safe(v: Any) -> Any:
    """Best-effort JSON projection of config values."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return repr(v)


class FlightRecorder:
    """Bounded telemetry ring + one-shot postmortem bundle writer.

    ``path`` is the bundle destination (``postmortem.json`` next to the
    metrics JSONL); ``config`` a dict snapshot of the CLI args;
    ``tracer`` the live span tracer (read at dump time, bounded);
    ``context`` an optional callable returning a dict of live run state
    (cli.py passes the trainer's step, epoch, guard and mirror state).
    """

    def __init__(self, path: str, *, config: Optional[dict] = None,
                 tracer=None, context: Optional[Callable[[], dict]] = None,
                 ring: int = 256):
        self.path = path
        self._config = _json_safe(dict(config or {}))
        self._tracer = tracer
        self._context = context
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=ring)
        self._ring = int(ring)
        self._t0 = time.monotonic()
        self.dumped: Optional[str] = None  # reason of the landed dump

    # -- recording ---------------------------------------------------------

    def record(self, rec: dict) -> None:
        """Tap for every MetricsLogger record (utils/metrics.py): per-step
        scalars, guard/drift/preemption events, live telemetry.  One dict
        append under a lock — cheap enough for the per-step stream."""
        with self._lock:
            self._events.append(rec)

    # -- dumping -----------------------------------------------------------

    def _spans(self, bounded: bool) -> List[dict]:
        tracer = self._tracer
        if tracer is None or not getattr(tracer, "enabled", False):
            return []
        # The expire path must never block behind a wedged spill writer
        # holding the tracer lock: its read takes a lock timeout.
        spans = tracer.spans_since(0.0,
                                   lock_timeout=2.0 if bounded else None)
        return spans[-self._ring:]

    def _build(self, reason: str, *, exit_status: Optional[int],
               error: Optional[str], bounded: bool) -> dict:
        with self._lock:
            events = list(self._events)
        ctx: Optional[dict] = None
        if self._context is not None:
            try:
                ctx = _json_safe(self._context())
            except Exception as e:  # context must not block the dump
                ctx = {"context_error": repr(e)}
        return {
            "schema": POSTMORTEM_SCHEMA,
            "reason": reason,
            "exit_status": exit_status,
            "error": error,
            "time_unix": time.time(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "config": self._config,
            "health": ctx,
            "spans": self._spans(bounded),
            "events": events,
        }

    def dump(self, reason: str, *, exit_status: Optional[int] = None,
             error: Optional[str] = None, bounded: bool = False) -> bool:
        """Write the bundle; returns True when it landed.  ``bounded``
        (the watchdog expire path) runs the whole dump on a side thread
        with a join timeout, so a hung filesystem cannot keep the expire
        path from reaching exit 124."""
        if reason not in REASONS:
            reason = "crash"
        if bounded:
            done: List[bool] = []

            def _run() -> None:
                done.append(self._dump_now(reason, exit_status, error,
                                           bounded=True))

            t = threading.Thread(target=_run, daemon=True,
                                 name="obs-postmortem")
            t.start()
            t.join(timeout=3.0)
            return bool(done and done[0])
        return self._dump_now(reason, exit_status, error, bounded=False)

    def _dump_now(self, reason: str, exit_status: Optional[int],
                  error: Optional[str], *, bounded: bool) -> bool:
        try:
            doc = self._build(reason, exit_status=exit_status, error=error,
                              bounded=bounded)
            validate_postmortem(doc)  # never ship a bundle we'd reject
            atomic_write_text(self.path, json.dumps(doc, indent=1,
                                                    sort_keys=True) + "\n")
            self.dumped = reason
            return True
        except Exception as e:
            print(f"WARNING: postmortem dump failed ({e}); the run's "
                  "exit status is still authoritative", file=sys.stderr)
            return False


# ---------------------------------------------------------------------------
# Schema validation and rendering.
# ---------------------------------------------------------------------------

_REQUIRED: Dict[str, tuple] = {
    "schema": (str,),
    "reason": (str,),
    "exit_status": (int, type(None)),
    "error": (str, type(None)),
    "time_unix": (int, float),
    "uptime_s": (int, float),
    "config": (dict,),
    "health": (dict, type(None)),
    "spans": (list,),
    "events": (list,),
}


def validate_postmortem(doc: Any) -> dict:
    """Strictly validate a postmortem bundle; returns the doc or raises
    :class:`ValueError` with a one-line diagnosis.  The executable
    contract the chaos campaign, the supervisor link, and the renderer
    all share — a bundle that parses but fails here is treated exactly
    like a torn one."""
    if not isinstance(doc, dict):
        raise ValueError(f"postmortem bundle is {type(doc).__name__}, "
                         "expected a JSON object")
    if doc.get("schema") != POSTMORTEM_SCHEMA:
        raise ValueError(f"schema {doc.get('schema')!r} != "
                         f"{POSTMORTEM_SCHEMA!r}")
    for key, kinds in _REQUIRED.items():
        if key not in doc:
            raise ValueError(f"missing required key {key!r}")
        if not isinstance(doc[key], kinds):
            raise ValueError(
                f"key {key!r} is {type(doc[key]).__name__}, expected "
                f"{'/'.join(k.__name__ for k in kinds)}")
    if doc["reason"] not in REASONS:
        raise ValueError(f"reason {doc['reason']!r} not in {REASONS}")
    for i, s in enumerate(doc["spans"]):
        if not isinstance(s, dict) or "phase" not in s or "dur_s" not in s:
            raise ValueError(f"spans[{i}] is not a span record")
    for i, e in enumerate(doc["events"]):
        if not isinstance(e, dict):
            raise ValueError(f"events[{i}] is not a record object")
    return doc


# Event kinds that form the guard/drift/resilience timeline in the
# rendered report (everything else in the ring is scalar curve noise).
_TIMELINE_EVENTS = ("guard_decision", "drift_detected", "drift_audit",
                    "restore_from_checkpoint", "preemption_checkpoint",
                    "batch_skipped", "watchdog")


def format_postmortem(doc: dict) -> str:
    """Human-rendered bundle: header, config, guard/drift timeline, last
    spans — newest last, the way you read a black box."""
    out: List[str] = []
    status = ("" if doc["exit_status"] is None
              else f" (exit {doc['exit_status']})")
    out.append(f"postmortem: reason={doc['reason']}{status} after "
               f"{doc['uptime_s']:.1f}s")
    if doc.get("error"):
        out.append(f"error: {doc['error']}")
    health = doc.get("health") or {}
    if health:
        out.append("health at dump: " + ", ".join(
            f"{k}={v}" for k, v in sorted(health.items())))
    cfg = doc.get("config") or {}
    if cfg:
        keys = [k for k in ("model", "total_epochs", "batch_size",
                            "mesh_shape", "num_devices", "watchdog_secs",
                            "drift_audit_every", "drift_action", "on_nan",
                            "guard_action", "metrics_path") if k in cfg]
        out.append("config: " + ", ".join(f"{k}={cfg[k]}" for k in keys))
    timeline = [e for e in doc["events"]
                if e.get("event") in _TIMELINE_EVENTS]
    out.append(f"timeline ({len(timeline)} resilience event(s) of "
               f"{len(doc['events'])} recorded):")
    for e in timeline[-20:]:
        t = e.get("wall_s")
        stamp = f"{t:10.3f}s" if isinstance(t, (int, float)) else " " * 11
        rest = {k: v for k, v in e.items() if k not in ("event", "wall_s")}
        out.append(f"  {stamp}  {e['event']}  "
                   + " ".join(f"{k}={v}" for k, v in rest.items()))
    if not timeline:
        out.append("  (none)")
    spans = doc["spans"]
    out.append(f"last spans ({len(spans)}):")
    for s in spans[-20:]:
        step = f" step {s['step']}" if s.get("step") is not None else ""
        out.append(f"  {s.get('start_s', 0.0):10.3f}s  "
                   f"{s['phase']:<14}{step}  "
                   f"{s['dur_s'] * 1e3:9.2f} ms")
    if not spans:
        out.append("  (none)")
    return "\n".join(out)
