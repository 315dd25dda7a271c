"""DeepNN, the reference's plain CNN (counterpart of
``ddp_tpu/models/deepnn.py``): 1,186,986 parameters.

Four 3x3 convolutions with biases, padding 1, each followed by ReLU, and a
2x2 max pool after the second and the fourth (3->128->64, pool, 64->64->32,
pool); the ``[N,32,8,8]`` activation flattened channel-major to 2048; a
linear 2048->512, ReLU, dropout 0.1 in training, and a linear 512->10.  The
logits are float32.

The module's layout is the reference's: a ``features`` Sequential with its
convolutions at slots 0/2/5/7 and a ``classifier`` with its linears at 0/3,
so its ``state_dict`` is the reference's key for key.  The port works
channels-first, so its flatten is torch's; the JAX package flattens NHWC
and keeps ``linear0``'s input axis in that order, which
:mod:`ddp_tpu_torch.interop` permutes.

Dropout draws its mask from the ``generator`` the forward is given
(:func:`~ddp_tpu_torch.ops.layers.dropout`): the trainer keys one per
micro-batch.  Eval never draws.  Under ``--bf16`` the input, every conv
kernel and bias and both linears' weights and biases are cast to the
compute dtype, where the JAX model casts them.

The JAX model's tensor- and pipeline-parallel hooks (``TP_RECIPE``,
``TP_BARRIERS``, ``TP_STEM``, ``PP_BLOCKS``, ``apply_blocks``) belong to
the port's tensor- and pipeline-parallel slices and are not here.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import initializers as init_lib
from ..ops.layers import dropout
from .modules import Conv, Linear

NAME = "deepnn"
NUM_CLASSES = 10
DROPOUT_RATE = 0.1
# (in_ch, out_ch) of the four 3x3 convs; "M" = 2x2 max pool.
FEATURES = [(3, 128), (128, 64), "M", (64, 64), (64, 32), "M"]
FLAT = 32 * 8 * 8
HIDDEN = 512


class Dropout(nn.Module):
    """Inverted dropout at ``rate`` in training, from the generator
    :meth:`forward` is given."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return dropout(x, self.rate, train=self.training,
                       generator=generator)


class DeepNN(nn.Module):
    """``[N,3,32,32]`` float -> ``[N,10]`` float32 logits.  Weights are
    drawn from ``generator`` (a CPU generator; seed 0 when omitted) with
    PyTorch's default distributions and moved to ``device``.
    ``forward(x, sync_bn, compute_dtype, generator)`` is every port model's
    signature: DeepNN has no BatchNorm, so ``sync_bn`` changes nothing;
    ``generator`` feeds the dropout in training."""

    name = NAME

    def __init__(self, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        layers = []
        for spec in FEATURES:
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            cin, cout = spec
            layers += [Conv(init_lib.conv_kernel(generator, 3, 3, cin, cout,
                                                 device),
                            init_lib.conv_bias(generator, 3, 3, cin, cout,
                                               device)),
                       nn.ReLU()]
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(init_lib.linear_weight(generator, FLAT, HIDDEN, device),
                   init_lib.linear_bias(generator, FLAT, HIDDEN, device)),
            nn.ReLU(), Dropout(DROPOUT_RATE),
            Linear(init_lib.linear_weight(generator, HIDDEN, NUM_CLASSES,
                                          device),
                   init_lib.linear_bias(generator, HIDDEN, NUM_CLASSES,
                                        device)))

    def forward(self, x: torch.Tensor, sync_bn: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.features(x.to(compute_dtype or x.dtype))
        x = x.reshape(x.shape[0], -1)
        for layer in self.classifier:
            x = layer(x, generator) if isinstance(layer, Dropout) \
                else layer(x)
        return x.float()
