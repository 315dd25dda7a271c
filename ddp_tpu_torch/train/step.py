"""The single-device train and eval steps (counterpart of
``ddp_tpu/train/step.py`` at one device).

One step: the batch from the resident table, cropped, flipped and scaled
u8/255 by one kernel (``ops/gather.py::gather_batch``), forward in training
mode, the global-mean loss ``sum/count``, backward, and the SGD update at
``lr_schedule(step)``.  PyTorch runs it eagerly; the JAX package's
``shard_map``/``jit`` wiring has no counterpart at one device.  BatchNorm's
running buffers are updated in place by the forward (the JAX package
returns them as new state).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from ..data.device_augment import Draws
from ..ops.gather import gather_batch
from ..ops.losses import cross_entropy_sum_count
from ..optim import sgd as sgd_lib


def _as_input(x: torch.Tensor) -> torch.Tensor:
    """NHWC batch -> float32 NCHW, uint8 scaled u8/255 (ToTensor), on the
    tensor's device.  A float batch from :func:`gather_batch` is already
    scaled and stored channels-first, so this returns its buffer as is."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return x.permute(0, 3, 1, 2).contiguous()


@dataclass
class TrainState:
    """What evolves across steps.  ``model`` holds the weights and
    BatchNorm buffers; ``momentum`` is parallel to
    ``list(model.parameters())``; ``step`` is the host's count of optimizer
    steps (it drives the LR schedule without a device read)."""
    model: nn.Module
    momentum: List[torch.Tensor]
    step: int = 0


def init_train_state(model: nn.Module) -> TrainState:
    return TrainState(model, sgd_lib.init(model.parameters()), 0)


def make_loss_and_grads(model: nn.Module):
    """``fn(images [B,32,32,3], labels [B]) -> (loss, grads)``: the
    forward in training mode and the backward of the global-mean loss.
    ``loss`` stays on the device, detached."""
    params = list(model.parameters())

    def loss_and_grads(images: torch.Tensor, labels: torch.Tensor):
        model.train()
        logits = model(_as_input(images))
        ce_sum, count = cross_entropy_sum_count(logits, labels)
        loss = ce_sum / count
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    return loss_and_grads


def make_group_update(sgd_config: sgd_lib.SGDConfig,
                      lr_schedule: Callable[[int], float]):
    """``update(state, grads)``: SGD at ``lr_schedule(state.step)``, in
    place, then ``state.step += 1``."""

    def update(state: TrainState, grads) -> None:
        sgd_lib.apply_updates(list(state.model.parameters()), list(grads),
                              state.momentum, lr_schedule(state.step),
                              sgd_config)
        state.step += 1

    return update


def micro_from_table(images: torch.Tensor, labels: torch.Tensor,
                     device_augment: bool):
    """``get_micro(draws, idx_row) -> (images, labels)`` for the resident
    path: the batch of float32 images, cropped and flipped with ``draws``
    under ``device_augment``, and its labels, from one
    :func:`~ddp_tpu_torch.ops.gather.gather_batch` launch."""

    def get_micro(draws: Optional[Draws], idx_row: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        return gather_batch(images, labels, idx_row,
                            draws if device_augment else None)

    return get_micro


def make_eval_apply(model: nn.Module):
    """``fn(images [B,32,32,3]) -> logits [B,10]``: the eval-mode
    forward (BatchNorm on running statistics), without autograd.  The one
    eval forward of the port; the serving slice will reuse it."""

    @torch.no_grad()
    def apply_fn(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(_as_input(images))

    return apply_fn
