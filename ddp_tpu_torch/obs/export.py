"""Offline analysis of a tracer spill (counterpart of
``ddp_tpu/obs/export.py``): the Chrome/Perfetto ``trace_event`` export and
the terminal reports behind ``python -m ddp_tpu_torch.obs``.

A spill file (``--trace_spill``; ``obs/tracer.py``) is append-only JSON
lines ``{"phase", "step", "start_s", "dur_s", "overlap", "host"}`` (and
``req`` on request-scoped serving spans), key for key the JAX package's,
so either package's tools read the other's spills.  A data-parallel run
writes one spill per rank (``.hostN`` after the first); :func:`read_spill`
merges any number of them into one timeline.

:func:`to_trace_events` renders the run in the ``trace_event`` JSON format
that ``chrome://tracing`` and ``ui.perfetto.dev`` load: one process per
host, one track per phase, complete ``"X"`` events with the step in
``args``, and one flow chain per serving request.
:func:`validate_trace_events` checks the subset emitted.

``overlap=True`` spans ran on producer threads (prefetch workers, the
checkpoint writer) beside the consumer loop, so the wall-time identity
holds over the serial spans only: :func:`phase_summary` keeps the two
apart and reports the serial sum as a share of wall.
"""
from __future__ import annotations

import json
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

# Canonical phase order: consumer-loop phases first in pipeline order,
# then the boundary/background phases, then the serving engine's batch
# pipeline (serve/ — queue_wait is per-request and overlap=True;
# batch_form..d2h are the engine thread's serial stages, sharing "h2d"
# with the training pipeline).  Unknown phases sort after these (the
# tracer accepts free-form names).
PHASE_ORDER = ("data_wait", "host_augment", "h2d", "dispatch",
               "loss_flush", "drift_audit", "ckpt_write", "ckpt_upload",
               "eval",
               "queue_wait", "batch_form", "pad", "forward", "d2h",
               # Fleet/router phases (serve/router.py, serve/fleet.py):
               # route/retry are per-request handler-thread spans
               # (overlap=True); eject/readmit mark rotation changes and
               # swap_warm/swap_commit bracket a checkpoint hot-swap —
               # none is per-step (a request is not a batch sequence).
               "route", "retry", "eject", "readmit",
               "swap_warm", "swap_commit")

# Phases attributable to ONE step each — the per-step wall decomposition
# the histogram and slowest-K tables are built from.  Boundary phases
# (loss_flush covers a whole epoch's steps, ckpt_write/eval a whole
# epoch) stay in the phase table but not in per-step grouping.  On serve
# spills a "step" is one formed batch (the engine's sequence number), so
# the serving stages join the set — the two workloads never mix phases
# in one spill, so neither pollutes the other's decomposition.
PER_STEP_PHASES = frozenset(("data_wait", "host_augment", "h2d",
                             "dispatch",
                             "batch_form", "pad", "forward", "d2h"))


def _phase_rank(phase: str) -> tuple:
    try:
        return (PHASE_ORDER.index(phase), phase)
    except ValueError:
        return (len(PHASE_ORDER), phase)


def read_spill(paths: Iterable[str]) -> List[dict]:
    """Merge one or more spill files into one start-sorted span list.
    Torn tails (a final partial line from a SIGKILL mid-write) are
    skipped, not fatal — a telemetry reader must not die on the exact
    runs it exists to explain."""
    spans: List[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail
                if isinstance(rec, dict) and "phase" in rec \
                        and "start_s" in rec and "dur_s" in rec:
                    rec.setdefault("host", 0)
                    rec.setdefault("overlap", False)
                    rec.setdefault("step", None)
                    rec.setdefault("req", None)
                    spans.append(rec)
    spans.sort(key=lambda r: r["start_s"])
    return spans


# -- Perfetto / chrome://tracing export -----------------------------------

def to_trace_events(spans: List[dict]) -> dict:
    """``trace_event`` JSON: one process per host, one track per phase.

    Timestamps are microseconds on the tracer's monotonic clock (hosts'
    clocks are independent; cross-host alignment is by step number in
    ``args``, not by wall time — same caveat as any multi-machine trace).

    Request-scoped spans (a ``req`` id minted by the router at admission
    and threaded through route/retry → queue_wait → the joined batch's
    engine stages) additionally emit Perfetto *flow* events — one
    ``s``/``t``.../``f`` chain per request id, each bound to its slice —
    so one request renders as a single connected arrow path across
    replica tracks, including a crash→retry hand-off between replicas.
    """
    hosts = sorted({int(s["host"]) for s in spans})
    phases = sorted({s["phase"] for s in spans}, key=_phase_rank)
    tid_of = {p: i + 1 for i, p in enumerate(phases)}
    events: List[dict] = []
    for h in hosts:
        events.append({"name": "process_name", "ph": "M", "pid": h,
                       "tid": 0, "args": {"name": f"host {h}"}})
        for p in phases:
            events.append({"name": "thread_name", "ph": "M", "pid": h,
                           "tid": tid_of[p], "args": {"name": p}})
    slice_of: Dict[int, dict] = {}
    for s in spans:
        args = {"overlap": bool(s["overlap"])}
        if s.get("step") is not None:
            args["step"] = int(s["step"])
        if s.get("req") is not None:
            args["req"] = str(s["req"])
        ev = {
            "name": s["phase"], "cat": "train", "ph": "X",
            "ts": round(float(s["start_s"]) * 1e6, 3),
            "dur": round(max(float(s["dur_s"]), 0.0) * 1e6, 3),
            "pid": int(s["host"]), "tid": tid_of[s["phase"]],
            "args": args,
        }
        slice_of[id(s)] = ev
        events.append(ev)
    # One flow chain per request: parent/child links between the slices
    # the request passed through, in time order.  The flow event binds
    # to its slice via matching pid/tid and a ts inside the slice.
    for fid, (req, chain) in enumerate(
            sorted(request_chains(spans).items()), start=1):
        if len(chain) < 2:
            continue  # a single-span request has nothing to connect
        for j, s in enumerate(chain):
            ev = slice_of[id(s)]
            ph = "s" if j == 0 else ("f" if j == len(chain) - 1 else "t")
            fev = {"name": f"req {req}", "cat": "request", "ph": ph,
                   "id": fid, "pid": ev["pid"], "tid": ev["tid"],
                   "ts": round(ev["ts"] + ev["dur"] / 2.0, 3)}
            if ph == "f":
                fev["bp"] = "e"  # bind the finish to the enclosing slice
            events.append(fev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_trace_events(trace: dict) -> int:
    """Schema check of the ``trace_event`` subset :func:`to_trace_events`
    emits — the CI gate that an exported file will load in
    ``ui.perfetto.dev``.  Returns the number of events; raises
    ``ValueError`` naming the first offending event otherwise."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace_event JSON must be an object with a "
                         "'traceEvents' array")
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty array")
    for i, ev in enumerate(events):
        def bad(why: str):
            return ValueError(f"traceEvents[{i}] {why}: {ev!r}")
        if not isinstance(ev, dict):
            raise bad("is not an object")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise bad("needs a non-empty string 'name'")
        ph = ev.get("ph")
        if ph not in ("X", "M", "s", "t", "f"):
            raise bad("has unsupported 'ph' (this exporter emits X/M "
                      "slices and s/t/f flow events only)")
        if not isinstance(ev.get("pid"), int) or ev["pid"] < 0:
            raise bad("needs a non-negative integer 'pid'")
        if not isinstance(ev.get("tid"), int) or ev["tid"] < 0:
            raise bad("needs a non-negative integer 'tid'")
        if ph == "X":
            for key in ("ts", "dur"):
                v = ev.get(key)
                if not isinstance(v, (int, float)) or v < 0:
                    raise bad(f"needs a non-negative numeric {key!r}")
        if ph in ("s", "t", "f"):
            if not isinstance(ev.get("id"), (int, str)):
                raise bad("flow events need an 'id' linking the chain")
            v = ev.get("ts")
            if not isinstance(v, (int, float)) or v < 0:
                raise bad("needs a non-negative numeric 'ts'")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise bad("'args' must be an object")
    return len(events)


def write_perfetto(spans: List[dict], out_path: str) -> int:
    """Export + self-validate + write; returns the event count."""
    trace = to_trace_events(spans)
    n = validate_trace_events(trace)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return n


# -- request-scoped reconstruction ----------------------------------------

# Spans a request passes through directly (they carry its ``req`` id)
# versus the engine-thread stages it joins via the formed batch's
# sequence number (``step`` on a serve spill).
BATCH_PHASES = ("batch_form", "pad", "h2d", "forward", "d2h")


def request_chains(spans: List[dict]) -> Dict[str, List[dict]]:
    """``{req: [span, ...]}`` — every span a request passed through, in
    time order: its own route/retry/queue_wait spans plus the engine
    stages of each batch its ``queue_wait`` joined (matched on the
    global batch sequence number, which is unique across replicas and
    across checkpoint hot-swaps — serve/engine.py mints it from one
    process-wide counter exactly so this join is unambiguous)."""
    by_req: Dict[str, List[dict]] = {}
    for s in spans:
        if s.get("req") is not None:
            by_req.setdefault(str(s["req"]), []).append(s)
    if not by_req:
        return {}
    by_step: Dict[int, List[dict]] = {}
    for s in spans:
        if (s.get("req") is None and s.get("step") is not None
                and s["phase"] in BATCH_PHASES):
            by_step.setdefault(int(s["step"]), []).append(s)
    chains: Dict[str, List[dict]] = {}
    for req, own in by_req.items():
        steps = sorted({int(s["step"]) for s in own
                        if s.get("step") is not None
                        and s["phase"] == "queue_wait"})
        joined = list(own)
        for st in steps:
            joined.extend(by_step.get(st, []))
        joined.sort(key=lambda r: (r["start_s"], _phase_rank(r["phase"])))
        chains[req] = joined
    return chains


def request_flows(spans: List[dict]) -> Dict[str, dict]:
    """Per-request hop breakdown: total latency, retry count, and the
    batch step(s) it rode — the offline answer to "where did this p99
    request go"."""
    out: Dict[str, dict] = {}
    for req, chain in request_chains(spans).items():
        start = min(s["start_s"] for s in chain)
        end = max(s["start_s"] + s["dur_s"] for s in chain)
        out[req] = {
            "hops": [{"phase": s["phase"],
                      "start_s": round(float(s["start_s"]), 6),
                      "dur_ms": float(s["dur_s"]) * 1e3,
                      "step": s.get("step"),
                      "host": int(s.get("host", 0))} for s in chain],
            "total_ms": (end - start) * 1e3,
            "retries": sum(1 for s in chain if s["phase"] == "retry"),
            "batch_steps": sorted({
                int(s["step"]) for s in chain
                if s.get("step") is not None
                and s["phase"] in BATCH_PHASES + ("queue_wait",)}),
        }
    return out


def slowest_requests(spans: List[dict], k: int = 10
                     ) -> List[Tuple[str, dict]]:
    flows = request_flows(spans)
    return sorted(flows.items(), key=lambda kv: kv[1]["total_ms"],
                  reverse=True)[:max(k, 0)]


def format_requests_report(spans: List[dict], top: int = 10) -> str:
    """The ``python -m ddp_tpu_torch.obs --requests`` table: slowest-K requests
    with their per-hop breakdown."""
    flows = request_flows(spans)
    if not flows:
        return ("no request-scoped spans in the spill (req ids are "
                "minted by the serve router; train spills have none)")
    lines = [f"{len(flows)} request(s); slowest {min(top, len(flows))}:"]
    for req, f in slowest_requests(spans, top):
        lines.append(
            f"  {req}: {f['total_ms']:9.3f} ms total, "
            f"{f['retries']} retries, batch step(s) "
            f"{','.join(map(str, f['batch_steps'])) or '-'}")
        lines.append("    " + " -> ".join(
            f"{h['phase']}"
            + (f"@{h['step']}" if h["step"] is not None else "")
            + f" {h['dur_ms']:.3f}ms" for h in f["hops"]))
    return "\n".join(lines)


# -- terminal reports ------------------------------------------------------

def phase_summary(spans: List[dict]) -> Tuple[List[dict], float, float]:
    """Per-phase ledger + the wall identity.

    Returns ``(rows, wall_s, critical_s)``: one row per phase (count,
    total/median/mean ms, overlap flag), the run's wall time (span of
    the whole timeline), and the *critical* sum — total time of
    non-overlap spans only, the quantity comparable to wall (producer
    threads run concurrently and would double-count)."""
    if not spans:
        return [], 0.0, 0.0
    by_phase: Dict[Tuple[str, bool], List[float]] = {}
    for s in spans:
        by_phase.setdefault((s["phase"], bool(s["overlap"])), []).append(
            float(s["dur_s"]))
    rows = []
    for (phase, overlap), durs in sorted(
            by_phase.items(), key=lambda kv: _phase_rank(kv[0][0])):
        rows.append({
            "phase": phase, "overlap": overlap, "count": len(durs),
            "total_ms": sum(durs) * 1e3,
            "median_ms": statistics.median(durs) * 1e3,
            "mean_ms": sum(durs) / len(durs) * 1e3,
        })
    wall_s = (max(s["start_s"] + s["dur_s"] for s in spans)
              - min(s["start_s"] for s in spans))
    critical_s = sum(s["dur_s"] for s in spans if not s["overlap"])
    return rows, wall_s, critical_s


def step_walls(spans: List[dict]) -> Dict[int, Dict[str, float]]:
    """Per-step phase decomposition: ``{step: {phase: ms, "total": ms}}``
    over non-overlap :data:`PER_STEP_PHASES` spans (the consumer loop's
    view of each step).

    Replay-aware: an ``--on_nan restore`` rewinds the step counter and
    the replayed trajectory re-emits spans under the SAME global step
    numbers — seeing a per-step phase repeat for a step starts a fresh
    row, so the report describes the latest trajectory (the same
    last-record-wins rule the metrics JSONL documents for the replay)
    instead of summing both into a fake 2x straggler."""
    out: Dict[int, Dict[str, float]] = {}
    seen: Dict[int, set] = {}
    for s in sorted(spans, key=lambda r: r["start_s"]):
        if (s.get("step") is None or s["overlap"]
                or s["phase"] not in PER_STEP_PHASES):
            continue
        step = int(s["step"])
        phases = seen.setdefault(step, set())
        if s["phase"] in phases:  # replayed trajectory: latest wins
            out[step] = {"total": 0.0}
            phases.clear()
        phases.add(s["phase"])
        row = out.setdefault(step, {"total": 0.0})
        row[s["phase"]] = row.get(s["phase"], 0.0) + s["dur_s"] * 1e3
        row["total"] += s["dur_s"] * 1e3
    return out


def slowest_steps(spans: List[dict], k: int = 10,
                  walls: Optional[Dict[int, Dict[str, float]]] = None
                  ) -> List[Tuple[int, Dict[str, float]]]:
    """Top-``k`` steps by per-step serial wall; pass a precomputed
    ``walls`` (from :func:`step_walls`) to avoid regrouping the spans."""
    if walls is None:
        walls = step_walls(spans)
    return sorted(walls.items(), key=lambda kv: kv[1]["total"],
                  reverse=True)[:max(k, 0)]


def histogram_lines(values: List[float], bins: int = 12,
                    width: int = 40) -> List[str]:
    """ASCII histogram of per-step ms — the one-look distribution check
    (a long tail here IS the straggler signature)."""
    if not values:
        return []
    lo, hi = min(values), max(values)
    if hi <= lo:
        return [f"  {lo:9.3f} ms  all {len(values)} steps identical"]
    bins = max(bins, 1)
    edges = [lo + (hi - lo) * i / bins for i in range(bins + 1)]
    counts = [0] * bins
    for v in values:
        i = min(int((v - lo) / (hi - lo) * bins), bins - 1)
        counts[i] += 1
    peak = max(counts)
    return [
        f"  {edges[i]:9.3f}..{edges[i + 1]:9.3f} ms "
        f"{'#' * max(int(c / peak * width), 1 if c else 0):<{width}} {c}"
        for i, c in enumerate(counts)]


def format_report(spans: List[dict], top: int = 10, bins: int = 12,
                  perfetto_out: Optional[str] = None) -> str:
    """The full terminal report ``python -m ddp_tpu_torch.obs`` prints.

    Multi-host spills are reported PER HOST: each host's spans share one
    clock (its own tracer t0) and its serial lanes tile its own wall —
    pooling hosts would double-count every identity (two hosts' serial
    dispatch sums against one wall reads as ~200%) and merge unrelated
    per-step totals under colliding step numbers.  The Perfetto export
    is the one place the hosts land side by side (one process per host).
    """
    if not spans:
        return "no spans found in the spill file(s)"
    hosts = sorted({int(s["host"]) for s in spans})
    lines: List[str] = [f"{len(spans)} spans, {len(hosts)} host(s)"]
    for host in hosts:
        lines.extend(_format_host_report(
            [s for s in spans if int(s["host"]) == host],
            host=host, top=top, bins=bins, multi=len(hosts) > 1))
    if perfetto_out:
        n = write_perfetto(spans, perfetto_out)
        lines.append("")
        lines.append(f"wrote Perfetto trace_event JSON: {perfetto_out} "
                     f"({n} events) — open in ui.perfetto.dev")
    return "\n".join(lines)


def _format_host_report(spans: List[dict], *, host: int, top: int,
                        bins: int, multi: bool) -> List[str]:
    rows, wall_s, critical_s = phase_summary(spans)
    if not rows:
        return []
    lines: List[str] = [""]
    if multi:
        lines.append(f"=== host {host}: {len(spans)} spans, "
                     f"wall {wall_s:.3f} s ===")
    else:
        lines.append(f"wall {wall_s:.3f} s")
    lines.append(f"{'phase':<16} {'lane':<8} {'count':>7} {'total ms':>12} "
                 f"{'median ms':>11} {'mean ms':>11} {'% wall':>7}")
    for r in rows:
        share = r["total_ms"] / (wall_s * 1e3) * 100.0 if wall_s else 0.0
        lines.append(
            f"{r['phase']:<16} {'overlap' if r['overlap'] else 'serial':<8} "
            f"{r['count']:>7} {r['total_ms']:>12.2f} "
            f"{r['median_ms']:>11.3f} {r['mean_ms']:>11.3f} {share:>6.1f}%")
    pct = critical_s / wall_s * 100.0 if wall_s else 0.0
    lines.append("")
    lines.append(f"phase sum (serial lanes): {critical_s * 1e3:.1f} ms = "
                 f"{pct:.1f}% of wall {wall_s * 1e3:.1f} ms")
    walls = step_walls(spans)
    if walls:
        lines.append("")
        lines.append(f"step-time histogram ({len(walls)} steps, per-step "
                     f"serial phases {sorted(PER_STEP_PHASES)}):")
        lines.extend(histogram_lines([w["total"] for w in walls.values()],
                                     bins=bins))
        lines.append("")
        lines.append(f"slowest {min(top, len(walls))} steps:")
        for step, row in slowest_steps(spans, top, walls=walls):
            detail = " ".join(
                f"{p}={row[p]:.3f}" for p in sorted(
                    row, key=_phase_rank) if p != "total")
            lines.append(f"  step {step:>8}: {row['total']:9.3f} ms "
                         f"({detail})")
    return lines
