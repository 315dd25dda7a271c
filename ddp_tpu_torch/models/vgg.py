"""VGG-11-style CIFAR classifier (counterpart of ``ddp_tpu/models/vgg.py``).

The same architecture string, ``conv{i}``/``bn{i}`` naming and parameter
count (9,228,362), as an :class:`torch.nn.Module` over NCHW activations.  Its
``state_dict`` keys are the reference checkpoint's
(``backbone.conv0.weight``, ``backbone.bn0.running_mean``, ...,
``classifier.weight``), and :mod:`ddp_tpu_torch.interop` maps them to and
from ``ddp_tpu``'s nested parameters.

Mixed precision (``--bf16``) casts by hand where ``ddp_tpu/models/vgg.py``
casts: the input and every conv kernel to the compute dtype, BatchNorm+ReLU
on that input with float32 γ/β and float32 statistics (its output in the
compute dtype), the classifier's weight and bias cast, the logits float32.
Parameters, their gradients and the BatchNorm buffers stay float32.
``torch.autocast`` would cast elsewhere (BatchNorm in float32 on float32
outputs, its own choice of ops), so it is not used.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops import initializers as init_lib
from ..ops.layers import global_avg_pool, max_pool
from .modules import BNReLU, Conv, Linear

NAME = "vgg"
NUM_CLASSES = 10
ARCH = [64, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
# The classifier reads 512 features, whatever the last conv's position.
CLASSIFIER_IN = 512


class VGG(nn.Module):
    """``[N,3,32,32]`` float -> ``[N,10]`` float32 logits.

    ``arch`` defaults to the reference :data:`ARCH`; the tests pass narrow
    ones.  Weights are drawn from ``generator`` (a CPU generator; seed 0 when
    omitted) with PyTorch's default distributions and moved to ``device``.
    ``forward(x, sync_bn=True)`` synchronises every BatchNorm layer's
    training statistics over the process group; ``compute_dtype``
    (``torch.bfloat16`` under ``--bf16``; None keeps ``x``'s dtype) is the
    activations' dtype; ``generator`` is ignored (VGG has no dropout; the
    argument keeps one forward signature for every model)."""

    name = NAME

    def __init__(self, arch: Optional[Sequence[Union[int, str]]] = None,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch = list(ARCH if arch is None else arch)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.backbone = nn.ModuleDict()
        in_ch, i = 3, 0
        for a in self.arch:
            if a == "M":
                continue
            self.backbone[f"conv{i}"] = Conv(
                init_lib.conv_kernel(generator, 3, 3, in_ch, a, device))
            self.backbone[f"bn{i}"] = BNReLU(a, device)
            in_ch, i = a, i + 1
        self.classifier = Linear(
            init_lib.linear_weight(generator, CLASSIFIER_IN, NUM_CLASSES,
                                   device),
            init_lib.linear_bias(generator, CLASSIFIER_IN, NUM_CLASSES,
                                 device))

    def forward(self, x: torch.Tensor, sync_bn: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.to(compute_dtype or x.dtype)
        i = 0
        for a in self.arch:
            if a == "M":
                x = max_pool(x, 2, 2)
                continue
            x = self.backbone[f"bn{i}"](self.backbone[f"conv{i}"](x),
                                        sync_bn)
            i += 1
        return self.classifier(global_avg_pool(x)).float()
