"""Evaluation over the device-resident test set (counterpart of
``ddp_tpu/train/evaluate.py::evaluate_resident``): eval-mode forward, argmax
accuracy in percent."""
from __future__ import annotations

import torch
from torch import nn

from ..data.loader import EvalLoader
from ..data.resident import ResidentData
from .epoch import make_eval_epoch


def evaluate_resident(model: nn.Module, resident: ResidentData,
                      loader: EvalLoader) -> float:
    """Accuracy (%) of ``model`` on ``loader.dataset``, held on the device
    as ``resident``.  Reads the two counters once, at the end."""
    device = resident.images.device
    idx, mask = loader.epoch_index_matrix()
    correct, total = make_eval_epoch(model)(
        resident.images, resident.labels, torch.from_numpy(idx).to(device),
        torch.from_numpy(mask).to(device))
    return float(correct) / max(float(total), 1.0) * 100.0
