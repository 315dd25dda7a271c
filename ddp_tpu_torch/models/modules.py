"""The layers the port's models are built from, over NCHW activations.

Each module casts its weights to the input's dtype (``--bf16``'s compute
dtype) where the JAX models cast theirs; BatchNorm keeps float32 γ/β and
statistics whatever the input's dtype.  In training BatchNorm updates its
running buffers in place; ``sync_bn`` takes the batch statistics over every
rank's batch (``--sync_bn``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import initializers as init_lib
from ..ops.layers import BatchNormState, batch_norm, bn_relu, conv2d, linear


class Conv(nn.Module):
    """A convolution with an optional bias, added after the convolution and
    not fused into it, as JAX adds it after ``lax.conv`` (under ``--bf16``
    the sum rounds twice in both)."""

    def __init__(self, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                   padding=self.padding)
        return y if self.bias is None else \
            y + self.bias.to(x.dtype).view(1, -1, 1, 1)


class _BatchNorm(nn.Module):
    """BatchNorm2d's parameters and running buffers (torch defaults)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        scale, bias = init_lib.batch_norm_params(num_features, device)
        mean, var = init_lib.batch_norm_stats(num_features, device)
        self.weight = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)
        self.register_buffer("running_mean", mean)
        self.register_buffer("running_var", var)

    def _apply_op(self, op, x: torch.Tensor, sync_bn: bool) -> torch.Tensor:
        y, new = op(x, self.weight, self.bias,
                    BatchNormState(self.running_mean, self.running_var),
                    train=self.training, sync=sync_bn)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(new.mean)
                self.running_var.copy_(new.var)
        return y


class BNReLU(_BatchNorm):
    """BatchNorm2d followed by ReLU, through the fused
    :func:`~ddp_tpu_torch.ops.layers.bn_relu`."""

    def forward(self, x: torch.Tensor, sync_bn: bool = False
                ) -> torch.Tensor:
        return self._apply_op(bn_relu, x, sync_bn)


class BatchNorm(_BatchNorm):
    """BatchNorm2d alone (:func:`~ddp_tpu_torch.ops.layers.batch_norm`),
    where no ReLU follows at once: ResNet's bn2 and shortcut BN, whose
    outputs meet at the residual add first."""

    def forward(self, x: torch.Tensor, sync_bn: bool = False
                ) -> torch.Tensor:
        return self._apply_op(batch_norm, x, sync_bn)


class Linear(nn.Module):
    """``x @ weight.T + bias`` with the weight and bias cast to ``x``'s
    dtype."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
