"""Device-resident epochs (counterpart of ``ddp_tpu/train/epoch.py`` and of
the resident epochs of ``ddp_tpu/train/zero.py``), and the streaming path's
optimizer step (:func:`make_train_step`, the counterpart of the JAX
package's per-step programs).

The dataset stays on the card (``data/resident.py``); an epoch uploads its
int32 index matrix once and runs one optimizer step per group of its
micro-batch rows.  The JAX package runs the epoch as one ``lax.scan``
program; here it is a Python loop that enqueues each step's kernels without
waiting for the device: losses and eval counters stay on the device until
the epoch ends.  In a data-parallel run each rank runs its own columns of
the matrices (``data/loader.py::replica_columns``), and the counters are
summed over the ranks once, at the end.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn

from ..data.device_augment import Draws
from ..ops.gather import gather_batch
from ..optim import sgd as sgd_lib
from ..parallel import dist
from .step import (TrainState, make_accum_grads, make_eval_apply,
                   make_group_update, make_local_grads, micro_from_batch,
                   micro_from_table)
from .zero import make_zero_update

# (optimizer step, batch size, micro-batch) -> draws
DrawFn = Callable[..., Draws]
# (optimizer step, micro-batch) -> the generator of its dropout mask
DropoutFn = Callable[..., torch.Generator]


def _optimizer_step(model: nn.Module, sgd_config: sgd_lib.SGDConfig,
                    lr_schedule: Callable[[int], float], *, sync_bn: bool,
                    shard_update: bool,
                    compute_dtype: Optional[torch.dtype]):
    """``step(state, get_micro, micros, draws, dropout=None) -> loss``: one
    optimizer step, :func:`~ddp_tpu_torch.train.step.make_accum_grads` over
    ``micros`` then the update stage (the replicated one, or the sharded
    one of ``train/zero.py``); micro-batch k's draws are ``draws(state.step,
    B, micro=k)`` and its dropout generator ``dropout(state.step,
    micro=k)``."""
    local_grads = make_local_grads(model, sync_bn, compute_dtype)
    update = (make_zero_update if shard_update else make_group_update)(
        sgd_config, lr_schedule)

    def step(state: TrainState, get_micro, micros,
             draws: Optional[DrawFn],
             dropout: Optional[DropoutFn] = None) -> torch.Tensor:
        loss, grads = make_accum_grads(local_grads, get_micro)(
            micros, lambda k, n: draws(state.step, n, micro=k),
            None if dropout is None else
            lambda k: dropout(state.step, micro=k))
        update(state, grads)
        return loss

    return step


def make_train_step(model: nn.Module, sgd_config: sgd_lib.SGDConfig,
                    lr_schedule: Callable[[int], float],
                    device_augment: bool = False, *, sync_bn: bool = False,
                    shard_update: bool = False,
                    compute_dtype: Optional[torch.dtype] = None):
    """``step_fn(state, micros, draws=None, dropout=None) -> loss``: one
    optimizer step of
    the streaming path over ``micros``, its A micro-batches as device
    batches ``{"image": uint8 [B,32,32,3], "label": int64 [B]}`` whose
    copies the compute stream already waits for (the counterpart of
    ``make_train_step``, ``make_train_step_accum`` and their ZeRO forms).
    Each micro-batch goes through
    :func:`~ddp_tpu_torch.train.step.micro_from_batch` (one ``gather_batch``
    launch, cropped and flipped with ``draws(step, B, micro=k)`` under
    ``device_augment``), then the step is :func:`make_train_epoch`'s, with
    ``dropout(step, micro=k)`` its dropout generator.
    ``loss`` is this rank's share of the step's global-mean loss, on the
    device."""
    step = _optimizer_step(model, sgd_config, lr_schedule, sync_bn=sync_bn,
                           shard_update=shard_update,
                           compute_dtype=compute_dtype)
    get_micro = micro_from_batch(device_augment,
                                 compute_dtype or torch.float32)

    def step_fn(state: TrainState, micros, draws: Optional[DrawFn] = None,
                dropout: Optional[DropoutFn] = None) -> torch.Tensor:
        return step(state, get_micro, micros, draws, dropout)

    return step_fn


def make_train_epoch(model: nn.Module, sgd_config: sgd_lib.SGDConfig,
                     lr_schedule: Callable[[int], float],
                     device_augment: bool = False, *, sync_bn: bool = False,
                     shard_update: bool = False,
                     compute_dtype: Optional[torch.dtype] = None):
    """``epoch_fn(state, images, labels, idx, draws=None, events=None,
    dropout=None) -> losses``: one optimizer step per group of the device
    index tensor
    ``idx``, over the resident ``images``/``labels``.  ``idx`` is
    ``[G, A, B]``, G groups of A micro-batch rows
    (``data/loader.py::optimizer_groups``; the counterpart of
    ``make_train_epoch_accum``, ``ddp_tpu/train/epoch.py:87-140``), or
    ``[steps, B]``, one row a step.

    Each step runs :func:`~ddp_tpu_torch.train.step.make_accum_grads` over
    its rows, then the update stage: the replicated one, or with
    ``shard_update`` the sharded one (``train/zero.py``, the counterparts of
    ``make_train_epoch_zero`` and ``make_train_epoch_zero_accum``).
    ``sync_bn`` synchronises BatchNorm's statistics over the ranks.
    ``compute_dtype`` (``torch.bfloat16`` under ``--bf16``) is the dtype of
    each micro-batch's images, as the kernel writes them, and of the
    model's activations; the gradients and the update stay float32.
    ``draws(step, B, micro=k)`` gives micro-batch k's crop/flip draws under
    ``device_augment``, and ``dropout(step, micro=k)`` its dropout
    generator (DeepNN's; the other models draw none).  ``losses`` is the
    ``[G]`` tensor of this rank's
    shares of the per-step global-mean losses (each the mean over the
    step's micro-batches), on the device (at world 1, the losses
    themselves): the caller sums it over the ranks once an epoch
    (:func:`~ddp_tpu_torch.parallel.dist.all_reduce_sum_`), as the JAX
    epoch returns the global means.  When ``events`` is a list, a CUDA
    event recorded after each step is appended to it (step timing without a
    host sync).  The trainer calls this once per shape of group, as the JAX
    trainer does."""
    step = _optimizer_step(model, sgd_config, lr_schedule, sync_bn=sync_bn,
                           shard_update=shard_update,
                           compute_dtype=compute_dtype)

    def epoch_fn(state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor, idx: torch.Tensor,
                 draws: Optional[DrawFn] = None,
                 events: Optional[List[torch.cuda.Event]] = None,
                 dropout: Optional[DropoutFn] = None) -> torch.Tensor:
        get_micro = micro_from_table(images, labels, device_augment,
                                     compute_dtype or torch.float32)
        losses = []
        for group in (idx[:, None] if idx.dim() == 2 else idx):
            losses.append(step(state, get_micro, group, draws, dropout))
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        return torch.stack(losses)

    return epoch_fn


def make_eval_epoch(model: nn.Module,
                    compute_dtype: Optional[torch.dtype] = None):
    """``eval_fn(images, labels, idx, mask) -> (correct, total)``: this
    rank's columns of the test set through the eval forward in
    ``compute_dtype`` (the batch from the kernel in it), row by row of
    its padded index matrix ``idx`` ``[steps, B]``; ``mask`` zeroes the
    padding out of both counters, which stay on the device and are summed
    over the ranks by one all-reduce at the end (the JAX eval's ``psum``,
    ``ddp_tpu/train/step.py:516``), so every rank returns the global
    counts."""
    apply_fn = make_eval_apply(model, compute_dtype)
    dtype = compute_dtype or torch.float32

    @torch.no_grad()
    def eval_fn(images: torch.Tensor, labels: torch.Tensor,
                idx: torch.Tensor, mask: torch.Tensor):
        correct = torch.zeros((), device=images.device)
        total = torch.zeros((), device=images.device)
        for idx_row, mask_row in zip(idx, mask):
            x, y = gather_batch(images, labels, idx_row, dtype=dtype)
            hit = (apply_fn(x).argmax(dim=-1) == y).float()
            correct += (hit * mask_row).sum()
            total += mask_row.sum()
        counts = dist.all_reduce_sum_(torch.stack([correct, total]))
        return counts[0], counts[1]

    return eval_fn
