"""Pipeline parallelism over the third ``stage`` axis of the rank grid
(counterpart of ``ddp_tpu/parallel/pp/``).

``partition.py`` cuts the model's declared PP_BLOCKS into balanced
contiguous stages with the per-layer forward-flop table; ``schedule.py``
runs the GPipe / 1F1B micro-batch schedules, one process a stage, handing
activations and cotangents between neighbouring stages point to point.
``python -m ddp_tpu_torch.parallel.pp`` prints the offline stage table.
"""
from .partition import (StagePlan, format_stage_table, plan_stages,
                        predicted_bubble, stage_model_psums,
                        stage_param_paths, stage_subtree)
from .schedule import PPStep, pp_feed, schedule_ops, stage_module_

__all__ = [
    "StagePlan", "format_stage_table", "plan_stages", "predicted_bubble",
    "stage_model_psums", "stage_param_paths", "stage_subtree", "PPStep",
    "pp_feed", "schedule_ops", "stage_module_",
]
