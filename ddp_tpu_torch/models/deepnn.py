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
takes this rank's block.

Pipeline parallelism (``parallel/pp/``): ``PP_BLOCKS`` is the JAX model's
block list and ``PP_SHARDED_OUT`` its column-parallel blocks;
:meth:`DeepNN.forward_blocks` runs a contiguous range of blocks, and
:meth:`DeepNN.forward` is that range over every block, so a stage axis of
1 cannot drift from the plain path.  A stage's model holds only its
blocks' layers (``parallel/pp/schedule.py::stage_module_``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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

# Pipeline-parallel block list (parallel/pp/partition.py): the model as an
# ordered sequence of cut-able units, one per TP_RECIPE layer, each owning
# the layer and its trailing ReLU/pool/flatten/dropout, so a cut between
# any two blocks is a clean activation handoff.  Block names ARE the
# recipe paths, and block "a/b" owns the parameters under tree path "a/b".
PP_BLOCKS = (
    "features/conv0",      # conv + relu
    "features/conv1",      # conv + relu + maxpool
    "features/conv2",      # conv + relu
    "features/conv3",      # conv + relu + maxpool + flatten
    "classifier/linear0",  # linear + relu + dropout (train)
    "classifier/linear1",  # linear + float32 logits
)

# Blocks whose OUTPUT is model-sharded under the TP recipe (column
# layers): a pipeline cut after one would hand a sharded activation across
# stages, so the planner rejects those cuts when m > 1.
PP_SHARDED_OUT = tuple(p for p, s in TP_RECIPE.items() if s == "column")

# Each block's modules: (Sequential, first index, end index).
_BLOCK_MODULES = {
    "features/conv0": ("features", 0, 2),
    "features/conv1": ("features", 2, 5),
    "features/conv2": ("features", 5, 7),
    "features/conv3": ("features", 7, 10),
    "classifier/linear0": ("classifier", 0, 3),
    "classifier/linear1": ("classifier", 3, 4),
}


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
        """The logits: :meth:`forward_blocks` over every block.  With
        ``tp_group`` (a model group; the parameters are this rank's slices
        under the plan) the recipe's members run through the
        tensor-parallel wrappers; ``tp_recipe`` overrides ``TP_RECIPE``,
        and a layer it omits or maps to ``"replicated"`` runs the plain
        op."""
        return self.forward_blocks(x, (0, len(PP_BLOCKS)),
                                   compute_dtype=compute_dtype,
                                   generator=generator, tp_group=tp_group,
                                   tp_recipe=tp_recipe)

    def forward_blocks(self, x: torch.Tensor, blocks: Tuple[int, int], *,
                       compute_dtype: Optional[torch.dtype] = None,
                       generator: Optional[torch.Generator] = None,
                       tp_group=None,
                       tp_recipe: Optional[Dict[str, str]] = None
                       ) -> torch.Tensor:
        """The ``PP_BLOCKS`` half-open range ``blocks=(lo, hi)`` (the
        counterpart of the JAX model's ``apply_blocks``): ``x`` is the
        network input for ``lo == 0``, otherwise the activation handed over
        by the previous stage; the result is the activation after block
        ``hi - 1`` (the float32 logits after the last).  Only the range's
        layers are touched, so a stage's model needs no others."""
        lo, hi = blocks
        if not 0 <= lo < hi <= len(PP_BLOCKS):
            raise ValueError(
                f"blocks must be a non-empty range within "
                f"(0, {len(PP_BLOCKS)}), got {blocks!r}")
        x = x.to(compute_dtype or x.dtype)
        recipe = TP_RECIPE if tp_recipe is None else tp_recipe
        if tp_group is not None:
            from ..parallel.tp import layers as tp

        def layer(module, path, x):
            style = ("replicated" if tp_group is None
                     else recipe.get(path, "replicated"))
            if style == "replicated":
                return module(x)
            w, b = module.weight.to(x.dtype), module.bias.to(x.dtype)
            if isinstance(module, Conv):
                fn = tp.column_conv2d if style == "column" else \
                    tp.row_conv2d
                return fn(x, w, b, tp_group, stride=module.stride,
                          padding=module.padding)
            fn = tp.column_linear if style == "column" else tp.row_linear
            return fn(x, w, b, tp_group)

        for name in PP_BLOCKS[lo:hi]:
            seq, first, end = _BLOCK_MODULES[name]
            modules = list(getattr(self, seq))[first:end]
            x = layer(modules[0], name, x)
            for module in modules[1:]:
                if not isinstance(module, Dropout):
                    x = module(x)
                elif tp_group is not None and recipe.get(name) == "column":
                    x = tp.sharded_dropout(x, module.rate,
                                           train=module.training,
                                           group=tp_group,
                                           generator=generator)
                else:
                    x = module(x, generator)
            if name == "features/conv3":
                x = x.reshape(x.shape[0], -1)
            elif name == "classifier/linear1":
                x = x.float()
        return x
