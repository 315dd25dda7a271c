"""Cross-rank straggler attribution (counterpart of
``ddp_tpu/obs/aggregate.py``): each rank's per-phase medians over an
epoch's spans, gathered over the ranks, and for each phase the slowest
rank named with its skew against the median.

Each rank summarises its own tracer ring into one float32 row of median
ms, one column per phase of :data:`~ddp_tpu_torch.obs.export.PHASE_ORDER`;
the rows are gathered with one ``all_gather`` of CPU tensors over the gloo
side group the stop vote uses (``parallel/dist.py::all_gather_rows``,
counted as ``straggler_gather``), so the record never waits on the card's
queue, and every rank derives the same verdict.  Rank 0 logs it
(``phase_stragglers``) into the metrics stream once an epoch.  At world 1
the gather is the identity and the record has the same shape, as the JAX
package's single-host path has.

The stall-time counterpart (an epoch that never ends gathers nothing) is
the watchdog's line naming each rank's last completed spans
(``obs/tracer.py::SpanTracer.describe_last``).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np

from ..parallel import dist
from .export import PHASE_ORDER

# Phases left out of the cross-rank verdict because only rank 0 pays them
# (the checkpoint's snapshot, write and upload, as the reference writes on
# rank 0 alone, multigpu.py:118): rank 0 would be named their straggler at
# every save.  They stay in each rank's report and in the bench's
# ``phase_ms``.
STRAGGLER_EXCLUDED_PHASES = frozenset(("ckpt_write", "ckpt_upload"))


def phase_medians(spans: List[dict],
                  include_overlap: bool = True) -> Dict[str, float]:
    """Median duration (ms) per phase over ``spans``.
    ``include_overlap=False`` keeps the serial (consumer-loop) spans only,
    which the straggler gather compares: the producer threads' spans are
    rank-asymmetric (only rank 0 runs the checkpoint writer), and a slow
    producer shows in the serial ``data_wait`` anyway.  The bench's
    ``phase_ms`` keeps the overlapped spans."""
    durs: Dict[str, List[float]] = {}
    for s in spans:
        if not include_overlap and s.get("overlap"):
            continue
        durs.setdefault(s["phase"], []).append(float(s["dur_s"]))
    return {p: statistics.median(d) * 1e3 for p, d in durs.items()}


def _median_vector(medians: Dict[str, float]) -> np.ndarray:
    """One row over the canonical phases (an absent phase is 0): every
    rank contributes the same shape to the gather."""
    return np.asarray([medians.get(p, 0.0) for p in PHASE_ORDER],
                      np.float32)


def straggler_report(medians: Dict[str, float], gather: bool = False
                     ) -> Dict[str, dict]:
    """Per-phase verdict ``{phase: {slowest_host, slowest_ms, median_ms,
    skew_pct}}``.  With ``gather`` and a world > 1 it is a collective that
    every rank must call at the same point; otherwise it is the single-rank
    identity record.  Phases no rank timed are left out."""
    row = _median_vector(medians)
    # analysis: divergence-ok(gather passed uniformly by call contract)
    if gather and dist.world_size() > 1:
        rows = list(enumerate(dist.all_gather_rows(row)))
    else:
        rows = [(0, row)]
    report: Dict[str, dict] = {}
    for j, phase in enumerate(PHASE_ORDER):
        if phase in STRAGGLER_EXCLUDED_PHASES:
            continue  # rank-asymmetric by design: the skew is structural
        vals = [(h, float(r[j])) for h, r in rows]
        if all(v == 0.0 for _, v in vals):
            continue  # nobody recorded this phase this epoch
        med = float(np.median([v for _, v in vals]))
        slowest_host, slowest = max(vals, key=lambda hv: hv[1])
        report[phase] = {
            "slowest_host": slowest_host,
            "slowest_ms": round(slowest, 3),
            "median_ms": round(med, 3),
            "skew_pct": round((slowest - med) / med * 100.0, 1)
            if med > 0 else 0.0,
        }
    return report


def epoch_straggler_record(tracer, gather: bool, since: float,
                           metrics=None, epoch: Optional[int] = None
                           ) -> Optional[Dict[str, dict]]:
    """One epoch's cross-rank attribution: the serial spans of the tracer
    window from ``since``, gathered (:func:`straggler_report`), and logged
    as ``phase_stragglers`` where ``metrics`` is given (rank 0).  Returns
    the report on every rank, or None when the tracer is off (a setting
    every rank shares, so every rank skips the gather alike)."""
    if not getattr(tracer, "enabled", False):
        # analysis: divergence-ok(enabled is shared CLI config)
        return None
    report = straggler_report(
        phase_medians(tracer.spans_since(since), include_overlap=False),
        gather=gather)
    if metrics is not None and report:
        metrics.log_event("phase_stragglers", epoch=epoch, phases=report)
    return report
