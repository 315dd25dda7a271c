"""ResNet-18 as torchvision builds it (counterpart of
``ddp_tpu/models/resnet.py``): 11,181,642 parameters.

A 7x7/2 stem convolution, BN+ReLU and a 3x3/2 max pool with padding 1; four
stages of two BasicBlocks of widths 64, 128, 256 and 512 (the first block
of stages 2-4 strides by 2 and takes a 1x1/2 convolution + BN shortcut);
a global average pool and a linear 512->10.  Convolutions have no bias and
are drawn from N(0, sqrt(2 / fan_out)) (torchvision's
``kaiming_normal_(mode='fan_out')``); BatchNorm and the linear layer take
torch's defaults.  On 32x32 images the stem leaves 8x8 after its pool, and
layer4 runs at 1x1.

The parameter and buffer names are torchvision's (``conv1``, ``bn1``,
``layer{s}.{b}.conv1/bn1/conv2/bn2``, ``layer{s}.{b}.downsample.0/1``,
``fc``), so the ``state_dict`` is torchvision's but for BatchNorm's
``num_batches_tracked``.

Each block's bn1, and the stem's, is the fused
:func:`~ddp_tpu_torch.ops.layers.bn_relu`; bn2 and the shortcut's BN are
:func:`~ddp_tpu_torch.ops.layers.batch_norm`, then ``relu(y + identity)``.
``--sync_bn`` reaches all 20 BatchNorm layers.  Under ``--bf16`` the
input, every conv kernel and the linear's weight and bias are cast to the
compute dtype, as the JAX model casts them; the residual add runs in that
dtype and the logits are float32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import initializers as init_lib
from ..ops.layers import global_avg_pool, max_pool
from .modules import BatchNorm, BNReLU, Conv, Linear

NAME = "resnet18"
NUM_CLASSES = 10
STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]  # (width, first stride)
BLOCKS_PER_STAGE = 2


def _conv(generator, k: int, cin: int, cout: int, stride: int, device
          ) -> Conv:
    return Conv(init_lib.kaiming_normal_fan_out(generator, k, k, cin, cout,
                                                device),
                stride=stride, padding=k // 2)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with BN, and the shortcut: the input, or a 1x1
    convolution + BN where the block strides or widens."""

    def __init__(self, cin: int, width: int, stride: int, generator,
                 device=None):
        super().__init__()
        self.conv1 = _conv(generator, 3, cin, width, stride, device)
        self.bn1 = BNReLU(width, device)
        self.conv2 = _conv(generator, 3, width, width, 1, device)
        self.bn2 = BatchNorm(width, device)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(
                _conv(generator, 1, cin, width, stride, device),
                BatchNorm(width, device))

    def forward(self, x: torch.Tensor, sync_bn: bool) -> torch.Tensor:
        y = self.bn2(self.conv2(self.bn1(self.conv1(x), sync_bn)), sync_bn)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x), sync_bn)
        return torch.relu(y + identity)


class ResNet18(nn.Module):
    """``[N,3,32,32]`` float -> ``[N,10]`` float32 logits.  Weights are
    drawn from ``generator`` (a CPU generator; seed 0 when omitted) and
    moved to ``device``.  ``forward(x, sync_bn, compute_dtype, generator)``
    is every port model's signature; ResNet has no dropout, so
    ``generator`` is ignored."""

    name = NAME

    def __init__(self, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.conv1 = _conv(generator, 7, 3, 64, 2, device)
        self.bn1 = BNReLU(64, device)
        cin = 64
        for s, (width, stride) in enumerate(STAGES, start=1):
            blocks = []
            for b in range(BLOCKS_PER_STAGE):
                blocks.append(BasicBlock(cin, width, stride if b == 0 else 1,
                                         generator, device))
                cin = width
            setattr(self, f"layer{s}", nn.Sequential(*blocks))
        self.fc = Linear(
            init_lib.linear_weight(generator, 512, NUM_CLASSES, device),
            init_lib.linear_bias(generator, 512, NUM_CLASSES, device))

    def forward(self, x: torch.Tensor, sync_bn: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.bn1(self.conv1(x.to(compute_dtype or x.dtype)), sync_bn)
        x = max_pool(x, 3, 2, 1)
        for s in range(1, len(STAGES) + 1):
            for block in getattr(self, f"layer{s}"):
                x = block(x, sync_bn)
        return self.fc(global_avg_pool(x)).float()
