"""Sharded compute for tensor-model parallelism: column/row-parallel linear
and conv over the ``ops/layers.py`` primitives (counterpart of
``ddp_tpu/parallel/tp/layers.py``).

The Megatron/Mesh-TensorFlow pairing on the model group of a ``(data,
model)`` grid (``parallel/mesh.py``):

- **column-parallel**: the weight's OUTPUT dimension is sharded, so each
  model rank computes a feature *slice* of the layer's output from the
  full (replicated) input.  The local FORWARD is the unsharded op on the
  weight slice; the wrapper's real job is the backward — :func:`column_input`
  (Megatron's "f") sums the input gradient over the model group, because
  each rank's backward contributes only its weight slice's share of dx.
- **row-parallel**: the weight's INPUT dimension is sharded, consuming the
  column-sharded activation directly (no gather between the pair); each
  rank produces a PARTIAL sum over its input slice and the full output is
  their sum over the model group (:func:`psum_keepgrad`, Megatron's "g").
  The bias is replicated and added AFTER the sum (a per-rank bias would
  count it model-axis-size times).

Every collective here reduces over the model group ONLY (one
``all_reduce``, counted as ``psum_model_fwd`` or ``psum_model_bwd`` in
``parallel/dist.py::collective_calls``); the gradient all-reduce of the
train step stays on the data group (``train/step.py``).  The row-parallel
sum's backward is the IDENTITY: its output is replicated over the model
group downstream, so the adjoint of the shard-sum hands each rank the
cotangent as is.  ``torch.distributed.nn.functional.all_reduce`` is not
used: its backward is another all-reduce, a silent model-axis-size
overcount of every gradient upstream of a row layer, compounding at each
one.  A train step never runs the stem's input-gradient sum: the batch
needs no gradient, so autograd never calls that backward
(``plan.py::expected_collectives``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist

from ...ops import layers as _layers
from .. import dist


class _PsumKeepgrad(torch.autograd.Function):
    """All-reduce (sum) over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return dist.all_reduce_model_(x.clone(), group, "psum_model_fwd")

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _ColumnInput(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient over the model
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return (dist.all_reduce_model_(ct.clone(), ctx.group,
                                       "psum_model_bwd"), None)


def psum_keepgrad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the model ``group``, whose backward is the
    identity — the correct adjoint when the summed output is consumed
    replicated over that group (every row-parallel layer's situation)."""
    return _PsumKeepgrad.apply(x, group)


def column_input(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f" operator — the column-parallel layers' dual of
    :func:`psum_keepgrad`: identity forward, the gradient summed over the
    model ``group`` backward.  A column layer's input is replicated over
    the group while its weight slice differs per rank, so each rank's
    backward produces only its slice's contribution to the input gradient;
    the sum over ranks is the real dx.  At m=1 the sum is over one rank."""
    return _ColumnInput.apply(x, group)


def column_linear(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], group) -> torch.Tensor:
    """Column-parallel linear: ``weight`` is the ``[out/m, in]`` slice, the
    output the matching feature slice (``ops.layers.linear`` on the slice);
    :func:`column_input` carries the backward's model-group sum."""
    return _layers.linear(column_input(x, group), weight, bias)


def row_linear(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], group) -> torch.Tensor:
    """Row-parallel linear: ``x`` is the column-sharded ``[..., in/m]``
    activation, ``weight`` the ``[out, in/m]`` slice; the partial products
    are summed over the model ``group`` and the replicated ``bias`` is added
    once, after the sum."""
    y = psum_keepgrad(_layers.linear(x, weight, None), group)
    return y if bias is None else y + bias


def _conv_bias(y: torch.Tensor, bias: Optional[torch.Tensor]):
    # After the convolution, as models/modules.py::Conv adds it.
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def column_conv2d(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], group, *, stride: int = 1,
                  padding: int = 1) -> torch.Tensor:
    """Column-parallel conv: ``weight`` is the ``[out/m, in, kh, kw]``
    slice, the output channels the matching slice; :func:`column_input`
    carries the backward's model-group sum."""
    return _conv_bias(_layers.conv2d(column_input(x, group), weight,
                                     stride=stride, padding=padding), bias)


def row_conv2d(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], group, *, stride: int = 1,
               padding: int = 1) -> torch.Tensor:
    """Row-parallel conv: ``x`` carries the column-sharded ``in/m``
    channels, ``weight`` is the ``[out, in/m, kh, kw]`` slice; the partial
    channel sums are summed over the model ``group``, the replicated
    ``bias`` added after."""
    return _conv_bias(psum_keepgrad(_layers.conv2d(
        x, weight, stride=stride, padding=padding), group), bias)


def sharded_dropout(x: torch.Tensor, rate: float, *, train: bool, group,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Dropout on a feature-sharded activation that draws the SAME mask the
    unsharded layer would: the full-width ``[..., local * m]`` mask is drawn
    on every model rank (``ops.layers.keep_mask`` from ``generator``, which
    the ranks of a data row seed alike) and each rank takes its own column
    block.  A per-rank-shaped mask would give every rank the same mask for
    *different* feature slices.  At m=1 the block is the whole mask and
    this is ``ops.layers.dropout``."""
    if not train or rate == 0.0:
        return x
    m, k = tdist.get_world_size(group), tdist.get_rank(group)
    local = x.shape[-1]
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    mask = _layers.keep_mask(tuple(x.shape[:-1]) + (local * m,),
                             1.0 - rate, generator, x.device)
    return _layers.dropout(x, rate, train=True,
                           mask=mask[..., k * local:(k + 1) * local])
