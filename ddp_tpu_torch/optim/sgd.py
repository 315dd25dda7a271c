"""SGD with PyTorch's update convention (counterpart of
``ddp_tpu/optim/sgd.py``): lr 0.4, momentum 0.9, weight decay 5e-4 on every
parameter, BatchNorm's included.

    buf <- momentum * buf + grad + weight_decay * param   (buf starts at 0)
    p   <- p - lr * buf

Decay is folded into the gradient before the momentum trace, not decoupled;
``torch.optim.SGD`` with ``dampening=0`` computes the same.  Written as a
loop in place so the sums run in the JAX package's order and the learning
rate of each step comes from the schedule.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple

import torch


class SGDConfig(NamedTuple):
    """``lr`` is the base rate the schedule scales; each step's rate
    ``lr_t`` is passed to :func:`apply_updates`."""
    lr: float = 0.4
    momentum: float = 0.9
    weight_decay: float = 5e-4


def init(params: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Momentum buffers, zeros like each parameter."""
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def apply_updates(params: List[torch.Tensor], grads: List[torch.Tensor],
                  momentum_buf: List[torch.Tensor], lr_t: float,
                  config: SGDConfig) -> None:
    """One SGD step at rate ``lr_t``, updating ``params`` and
    ``momentum_buf`` in place (the port's saving over the JAX package's
    fresh copies: no second set of weights is allocated per step)."""
    mu, wd = config.momentum, config.weight_decay
    for p, g, b in zip(params, grads, momentum_buf):
        b.mul_(mu).add_(g).add_(p, alpha=wd)
        p.sub_(lr_t * b)
