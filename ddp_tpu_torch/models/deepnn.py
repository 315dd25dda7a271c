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

Tensor parallelism (``parallel/tp/``): ``TP_RECIPE``, ``TP_BARRIERS``
and ``TP_STEM`` are the JAX model's, under its tree paths.  Under a model
group (``forward(..., tp_group=...)``; the parameters are then this rank's
slices, ``parallel/tp/plan.py::shard_module_``) the recipe's members run
through the column/row wrappers of ``parallel/tp/layers.py`` and the
dropout after a column-parallel ``linear0`` draws the full-width mask and
takes this rank's block.  The pipeline hooks (``PP_BLOCKS``,
``apply_blocks``) belong to the pipeline-parallel slice (ROADMAP A11).
"""
from __future__ import annotations

from typing import Dict, Optional

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

# Tensor-parallel recipe (parallel/tp/plan.py): back-to-back blocks pair
# column-then-row so the column-sharded activation feeds the row layer
# directly and only the row output is summed over the model group.  The
# planner derives the per-leaf specs from this mapping and forward() below
# consults it for which convs/linears run row- or column-parallel under a
# group: they cannot drift.
TP_RECIPE = {
    "features/conv0": "column",
    "features/conv1": "row",
    "features/conv2": "column",
    "features/conv3": "row",
    "classifier/linear0": "column",
    "classifier/linear1": "row",
}

# Activation-width barriers for a searched recipe: the activation LEAVING
# each named layer must be full-width.  conv3 feeds the flatten
# ([N,32,8,8] -> [N,2048]); a channel-sharded input would flatten to a
# subset of the 2048 vector that no contiguous row-parallel weight slice
# matches.
TP_BARRIERS = ("features/conv3",)

# The layer consuming the NETWORK INPUT.  Declared (not inferred) because
# the plan's expected-collectives accounting needs it: a train step takes
# gradients w.r.t. the parameters only, so the stem's column-style
# input-gradient sum never runs (parallel/tp/plan.py).
TP_STEM = "features/conv0"


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
                generator: Optional[torch.Generator] = None,
                tp_group=None, tp_recipe: Optional[Dict[str, str]] = None
                ) -> torch.Tensor:
        """The logits.  With ``tp_group`` (a model group; the parameters
        are this rank's slices under the plan) the recipe's members run
        through the tensor-parallel wrappers; ``tp_recipe`` overrides
        ``TP_RECIPE``, and a layer it omits or maps to ``"replicated"``
        runs the plain op."""
        x = x.to(compute_dtype or x.dtype)
        if tp_group is not None:
            return self._forward_tp(x, generator, tp_group,
                                    TP_RECIPE if tp_recipe is None
                                    else tp_recipe)
        x = self.features(x)
        x = x.reshape(x.shape[0], -1)
        for layer in self.classifier:
            x = layer(x, generator) if isinstance(layer, Dropout) \
                else layer(x)
        return x.float()

    def _forward_tp(self, x: torch.Tensor,
                    generator: Optional[torch.Generator], group,
                    recipe: Dict[str, str]) -> torch.Tensor:
        from ..parallel.tp import layers as tp

        def layer(module, path, x):
            style = recipe.get(path, "replicated")
            if style == "replicated":
                return module(x)
            w, b = module.weight.to(x.dtype), module.bias.to(x.dtype)
            if isinstance(module, Conv):
                fn = tp.column_conv2d if style == "column" else \
                    tp.row_conv2d
                return fn(x, w, b, group, stride=module.stride,
                          padding=module.padding)
            fn = tp.column_linear if style == "column" else tp.row_linear
            return fn(x, w, b, group)

        conv = 0
        for module in self.features:
            if isinstance(module, Conv):
                x = layer(module, f"features/conv{conv}", x)
                conv += 1
            else:
                x = module(x)
        x = x.reshape(x.shape[0], -1)
        linear0, relu, drop, linear1 = self.classifier
        x = relu(layer(linear0, "classifier/linear0", x))
        if recipe.get("classifier/linear0") == "column":
            x = tp.sharded_dropout(x, drop.rate, train=drop.training,
                                   group=group, generator=generator)
        else:
            x = drop(x, generator)
        return layer(linear1, "classifier/linear1", x).float()
