"""Parameter initialisers with PyTorch's layer defaults, drawn from an
explicit generator (counterpart of ``ddp_tpu/ops/initializers.py``).

- Conv2d / Linear weight and bias: ``kaiming_uniform_(a=sqrt(5))`` reduces to
  U(-1/sqrt(fan_in), +1/sqrt(fan_in)).
- BatchNorm2d: weight 1, bias 0, running_mean 0, running_var 1.
- torchvision's ResNet conv init, ``kaiming_normal_(mode='fan_out',
  nonlinearity='relu')``: N(0, sqrt(2 / (out_ch * kh * kw))).

Values are drawn on the CPU from a CPU :class:`torch.Generator` and then moved
to ``device``, so one seed gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def torch_default_uniform(generator: torch.Generator, shape: Sequence[int],
                          fan_in: int, device=None) -> torch.Tensor:
    """float32 U(-1/sqrt(fan_in), +1/sqrt(fan_in)) — PyTorch conv/linear
    default."""
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(device)


def conv_kernel(generator: torch.Generator, kh: int, kw: int, in_ch: int,
                out_ch: int, device=None) -> torch.Tensor:
    """OIHW conv kernel (PyTorch's layout; ``ddp_tpu`` stores HWIO)."""
    return torch_default_uniform(generator, (out_ch, in_ch, kh, kw),
                                 in_ch * kh * kw, device)


def linear_weight(generator: torch.Generator, in_features: int,
                  out_features: int, device=None) -> torch.Tensor:
    """``[out, in]`` linear weight (``ddp_tpu`` stores ``[in, out]``)."""
    return torch_default_uniform(generator, (out_features, in_features),
                                 in_features, device)


def linear_bias(generator: torch.Generator, in_features: int,
                out_features: int, device=None) -> torch.Tensor:
    return torch_default_uniform(generator, (out_features,), in_features,
                                 device)


def conv_bias(generator: torch.Generator, kh: int, kw: int, in_ch: int,
              out_ch: int, device=None) -> torch.Tensor:
    """``[out_ch]`` conv bias, U(-1/sqrt(fan_in), +1/sqrt(fan_in)) with
    fan_in = in_ch * kh * kw (``ddp_tpu/ops/initializers.py:55``)."""
    return torch_default_uniform(generator, (out_ch,), in_ch * kh * kw,
                                 device)


def kaiming_normal_fan_out(generator: torch.Generator, kh: int, kw: int,
                           in_ch: int, out_ch: int,
                           device=None) -> torch.Tensor:
    """OIHW conv kernel from N(0, sqrt(2 / fan_out)), fan_out = out_ch * kh
    * kw: torchvision's ResNet init (``ddp_tpu/models/resnet.py:29-33``)."""
    std = math.sqrt(2.0 / (out_ch * kh * kw))
    t = torch.empty((out_ch, in_ch, kh, kw), dtype=torch.float32)
    t.normal_(0.0, std, generator=generator)
    return t.to(device)


def batch_norm_params(num_features: int, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) = (1, 0) — BatchNorm2d affine defaults."""
    return (torch.ones(num_features, device=device),
            torch.zeros(num_features, device=device))


def batch_norm_stats(num_features: int, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(running_mean, running_var) = (0, 1)."""
    return (torch.zeros(num_features, device=device),
            torch.ones(num_features, device=device))
