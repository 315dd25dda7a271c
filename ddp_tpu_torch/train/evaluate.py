"""Evaluation (counterpart of ``ddp_tpu/train/evaluate.py``): eval-mode
forward in the training's compute dtype, argmax accuracy in percent, over
streamed host batches (:func:`evaluate`) or the device-resident test set
(:func:`evaluate_resident`).  In a data-parallel run each rank scores its
share of the test set and the counters are summed over the ranks, so every
rank returns the same accuracy."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..data.loader import EvalLoader
from ..data.resident import ResidentData
from ..parallel import dist
from .epoch import make_eval_epoch
from .step import make_eval_apply, micro_from_batch, to_device


@torch.no_grad()
def eval_counts(model: nn.Module, loader: EvalLoader,
                compute_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(correct, total)`` over ``loader``'s host batches (its local
    replicas' rows, ``EvalLoader.__iter__``), summed over the ranks: each
    batch copied to the model's device (:func:`~ddp_tpu_torch.train.step
    .to_device`, on a copy stream on the card), through ``gather_batch``'s
    eval form into ``compute_dtype`` and the eval forward; the masked
    counters stay on the device until one all-reduce at the end
    (``ddp_tpu/train/evaluate.py:34-84``)."""
    device = next(model.parameters()).device
    if loader.num_replicas != dist.world_size() or \
            loader.local_replicas != [dist.rank()]:
        raise ValueError(f"the eval loader builds replicas "
                         f"{loader.local_replicas} of {loader.num_replicas}; "
                         f"this is rank {dist.rank()} of "
                         f"{dist.world_size()}")
    apply_fn = make_eval_apply(model, compute_dtype)
    get_micro = micro_from_batch(False, compute_dtype or torch.float32)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    correct = torch.zeros((), device=device)
    total = torch.zeros((), device=device)
    for batch in loader:
        batch = to_device(batch, device, stream=stream).wait()
        x, y = get_micro(None, batch)
        hit = (apply_fn(x).argmax(dim=-1) == y).float()
        correct += (hit * batch["mask"]).sum()
        total += batch["mask"].sum()
    counts = dist.all_reduce_sum_(torch.stack([correct, total]))
    return counts[0], counts[1]


def evaluate(model: nn.Module, loader: EvalLoader,
             compute_dtype: Optional[torch.dtype] = None) -> float:
    """Accuracy (%) of ``model`` over ``loader``'s streamed batches
    (:func:`eval_counts`); ``loader.num_replicas`` must be the world size
    and its local replica this rank.  Reads the two counters once, at the
    end."""
    correct, total = eval_counts(model, loader, compute_dtype)
    return float(correct) / max(float(total), 1.0) * 100.0


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
