"""Per-phase medians over a window of spans (counterpart of
``phase_medians`` in ``ddp_tpu/obs/aggregate.py``), over the records of
the port's :class:`~ddp_tpu_torch.obs.tracer.SpanTracer`.  The cross-rank
straggler record built on it, and the serial-spans-only form it needs,
belong to the observability slice (ROADMAP A8) and are not here."""
from __future__ import annotations

import statistics
from typing import Dict, List


def phase_medians(spans: List[dict]) -> Dict[str, float]:
    """Median duration (ms) per phase over ``spans``, overlapped spans
    included (the bench's ``phase_ms``)."""
    durs: Dict[str, List[float]] = {}
    for s in spans:
        durs.setdefault(s["phase"], []).append(float(s["dur_s"]))
    return {p: statistics.median(d) * 1e3 for p, d in durs.items()}
