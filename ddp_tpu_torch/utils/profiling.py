"""Streaming-gap attribution (counterpart of
``ddp_tpu/utils/profiling.py::attribute_streaming``): the pipeline-model
decomposition that ``python -m ddp_tpu_torch.bench --stream_attr`` reports.
The JAX module's trace readers parse ``jax.profiler`` directories; the
port's traces are ``torch.profiler`` Chrome traces, read by
``obs/inspect.py`` and ``profile_resident.py``."""
from __future__ import annotations

from typing import Dict


def attribute_streaming(host_ms: float, h2d_ms: float, step_ms: float,
                        wall_ms: float) -> Dict[str, float]:
    """Pipeline-model decomposition of a streaming run's per-step wall
    time.

    Inputs are the three stages measured in isolation at the same shape
    (sequential host materialise+augment, blocking H2D upload, steady-state
    device step: the pipeline-floor model needs each stage's uncontended
    cost; the same run's tracer spans ship alongside as the record's
    ``phase_ms`` block) plus the measured end-to-end streaming wall time a
    step.  In a perfectly overlapped pipeline the wall time equals the
    slowest stage (the others hide behind it); everything above that floor
    is serialization the overlap engine failed to hide, the dispatch gap.
    Returns the stage costs, the bottleneck stage's name, the pipeline
    floor, ``dispatch_gap_ms`` and ``overlap_efficiency`` (floor / wall;
    1.0 = every non-bottleneck stage fully hidden).

    Measurement noise can put the wall below the floor (a floor stage timed
    on a colder cache than the real run): the gap is clamped at 0 and the
    efficiency capped at 1.0, so a noisy sample reads as fully overlapped,
    never as a negative gap; ``wall_ms <= 0`` (no steps ran) reports zero
    efficiency and zero gap rather than dividing by it.
    """
    stages = {"host_augment_ms": host_ms, "h2d_ms": h2d_ms,
              "device_step_ms": step_ms}
    bottleneck = max(stages, key=lambda k: stages[k])
    floor = stages[bottleneck]
    return {
        **{k: round(v, 3) for k, v in stages.items()},
        "streaming_wall_ms": round(wall_ms, 3),
        "bottleneck": bottleneck,
        "pipeline_floor_ms": round(floor, 3),
        "dispatch_gap_ms": round(max(wall_ms - floor, 0.0), 3)
        if wall_ms > 0 else 0.0,
        "overlap_efficiency": round(min(floor / wall_ms, 1.0), 4)
        if wall_ms > 0 else 0.0,
    }
