"""Evaluation over the device-resident test set (counterpart of
``ddp_tpu/train/evaluate.py::evaluate_resident``): eval-mode forward in the
training's compute dtype, argmax accuracy in percent.  In a data-parallel
run each rank scores its columns of the test set and the counters are
summed over the ranks, so every rank returns the same accuracy."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.loader import EvalLoader
from ..data.resident import ResidentData
from ..parallel import dist
from .epoch import make_eval_epoch


def evaluate_resident(model: nn.Module, resident: ResidentData,
                      loader: EvalLoader,
                      compute_dtype: Optional[torch.dtype] = None) -> float:
    """Accuracy (%) of ``model`` on ``loader.dataset``, held on the device
    as ``resident``, with this rank scoring its columns of ``loader``'s
    matrices (``loader.num_replicas`` must be the world size).  Reads the
    two counters once, at the end."""
    device = resident.images.device
    if loader.num_replicas != dist.world_size():
        raise ValueError(f"the eval loader has {loader.num_replicas} "
                         f"replicas; the world is {dist.world_size()}")
    idx, mask = loader.rank_index_matrix(dist.rank())
    correct, total = make_eval_epoch(model, compute_dtype)(
        resident.images, resident.labels, torch.from_numpy(idx).to(device),
        torch.from_numpy(mask).to(device))
    return float(correct) / max(float(total), 1.0) * 100.0
