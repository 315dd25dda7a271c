"""The efficiency ledger (counterpart of ``ddp_tpu/obs/ledger.py``):
measured spans joined against a cost model's predictions, phase by phase.

A calibration record (the JSON ``bench.py --calibrate_cost`` writes; its
producer in this package is ROADMAP A13c) predicts ms a step for each
audited program; the spill measures what ran.  Each traced phase with a
program (``dispatch`` → the train step, ``eval`` → the eval step,
``drift_audit`` → the audit, ``forward`` → the serve forward) gets a
predicted-against-measured row with its gap; the phases no program prices
(``data_wait``, ``host_augment``, ``h2d``, ...) are listed measured only.
The ledger also carries the spill's serial coverage (the serial span sum
over wall, ``obs/export.py::phase_summary``): a gap read from a spill whose
serial lanes tile 40% of wall answers another question than one at 95%.

``pred_scale`` (``--ledger_scale``) multiplies every prediction: a record
fitted for one shard on a mesh whose shards run one after another predicts
1/n of what runs.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from .export import phase_summary

# Traced phase -> the prefix of its program's name in a calibration record
# (names are "<prefix>@<mesh>").  The preferred variant is the plain
# data-parallel one.
PHASE_PROGRAM_PREFIX = {
    "dispatch": "train_step",
    "eval": "eval_step",
    "drift_audit": "drift_audit",
    "forward": "serve_forward",
}


def _pick_program(prefix: str, predicted: Dict[str, float]
                  ) -> Optional[str]:
    """The calibration record's program for a phase: the plain ``@dp``
    variant when present (accum/zero/tp variants answer narrower
    questions), else the first match in sorted order."""
    candidates = sorted(n for n in predicted
                        if n == prefix or n.startswith(prefix + "@"))
    for name in candidates:
        tail = name.split("@", 1)[-1]
        if tail.startswith("dp"):
            return name
    return candidates[0] if candidates else None


def build_ledger(spans: List[dict], calib: dict, *,
                 pred_scale: float = 1.0) -> dict:
    """Join measured phase timings with calibrated predictions.

    ``calib`` is a ``bench.py --calibrate_cost`` JSON record (needs
    ``predicted_ms_per_step``; ``coefficients`` ride along for
    provenance).  Returns ``{"rows": [...], "unpriced": [...],
    "serial_coverage": f, "pred_scale": k, "coefficients": {...}}``
    where each row carries ``phase, program, count, measured_ms
    (median over steady-state occurrences), predicted_ms, gap_pct,
    first_call_ms`` — ``gap_pct`` positive when the run was slower than
    the model's floor, and the first (compile-paying) occurrence per
    host excluded from the steady stats and reported on its own.
    """
    predicted = calib.get("predicted_ms_per_step") or {}
    if not predicted:
        raise ValueError(
            "calibration record has no 'predicted_ms_per_step' — pass "
            "the JSON emitted by bench.py --calibrate_cost")
    # Each host's FIRST span of a phase paid the one-time costs (a
    # compile, a kernel build, cuDNN's algorithm search), so folding it
    # into the phase's median poisons low-count phases.  The first
    # occurrence per (phase, host) is split out as
    # ``first_call_ms`` and the steady stats are computed from the rest;
    # a phase that only ever ran once per host keeps its measurement but
    # says so (``first_call_only``) instead of presenting compile time
    # as steady state.
    by_phase: Dict[str, Dict[int, List[dict]]] = {}
    for s in spans:
        if not s.get("overlap"):
            by_phase.setdefault(s["phase"], {}).setdefault(
                int(s.get("host", 0)), []).append(s)
    rows: List[dict] = []
    unpriced: List[dict] = []
    for phase in sorted(by_phase):
        firsts: List[float] = []
        steady: List[float] = []
        for host_spans in by_phase[phase].values():
            host_spans.sort(key=lambda s: float(s.get("start_s", 0.0)))
            firsts.append(float(host_spans[0]["dur_s"]) * 1e3)
            steady.extend(float(s["dur_s"]) * 1e3
                          for s in host_spans[1:])
        first_call = statistics.median(firsts)
        first_only = not steady
        durs = steady or firsts
        measured = statistics.median(durs)
        prefix = PHASE_PROGRAM_PREFIX.get(phase)
        prog = _pick_program(prefix, predicted) if prefix else None
        if prog is None:
            unpriced.append({"phase": phase, "count": len(durs),
                             "measured_ms": round(measured, 3),
                             "first_call_ms": round(first_call, 3)})
            continue
        pred = float(predicted[prog]) * float(pred_scale)
        gap = ((measured - pred) / pred * 100.0) if pred > 0 else None
        row = {
            "phase": phase, "program": prog, "count": len(durs),
            "measured_ms": round(measured, 3),
            "predicted_ms": round(pred, 3),
            "gap_pct": round(gap, 1) if gap is not None else None,
            "first_call_ms": round(first_call, 3),
        }
        if first_only:
            row["first_call_only"] = True
        rows.append(row)
    _, wall_s, critical_s = phase_summary(spans)
    return {
        "rows": rows,
        "unpriced": unpriced,
        "serial_coverage": round(critical_s / wall_s, 4) if wall_s else 0.0,
        "pred_scale": float(pred_scale),
        "coefficients": calib.get("coefficients", {}),
    }


def format_ledger(ledger: dict) -> str:
    """The ``python -m ddp_tpu_torch.obs --ledger`` terminal table."""
    lines = [f"{'phase':<14} {'program':<22} {'count':>6} "
             f"{'measured ms':>12} {'predicted ms':>13} {'gap':>8} "
             f"{'first ms':>10}"]
    for r in ledger["rows"]:
        gap = f"{r['gap_pct']:+.1f}%" if r["gap_pct"] is not None else "-"
        first = f"{r['first_call_ms']:.3f}" + \
            ("*" if r.get("first_call_only") else "")
        lines.append(f"{r['phase']:<14} {r['program']:<22} "
                     f"{r['count']:>6} {r['measured_ms']:>12.3f} "
                     f"{r['predicted_ms']:>13.3f} {gap:>8} "
                     f"{first:>10}")
    if not ledger["rows"]:
        lines.append("  (no priceable phases in this spill)")
    for r in ledger["unpriced"]:
        lines.append(f"{r['phase']:<14} {'(unpriced)':<22} "
                     f"{r['count']:>6} {r['measured_ms']:>12.3f} "
                     f"{'-':>13} {'-':>8} "
                     f"{r['first_call_ms']:>10.3f}")
    if any(r.get("first_call_only") for r in ledger["rows"]):
        lines.append("  * phase ran once per host: its only measurement "
                     "IS the first (compile-tainted) call")
    lines.append(
        f"serial coverage {ledger['serial_coverage'] * 100:.1f}% of wall; "
        f"predictions scaled x{ledger['pred_scale']:g} "
        "(virtual-mesh shard serialization)")
    return "\n".join(lines)
