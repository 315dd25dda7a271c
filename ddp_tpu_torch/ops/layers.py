"""Low-level NN ops over NCHW activations and OIHW kernels (counterpart of
``ddp_tpu/ops/layers.py``, which works in NHWC / HWIO).

The convolutions and matrix products go to PyTorch (cuDNN and cuBLAS on the
card), in the dtype of their inputs (bfloat16 under ``--bf16``); BatchNorm's
statistics and parameters stay float32 whatever ``x``'s dtype, as in
``ddp_tpu``.  :func:`bn_relu` keeps the JAX package's hand-written backward as a
:class:`torch.autograd.Function`: it recomputes the ReLU mask and x̂ from
``x`` and reads only ``(x, dz)``.  Batch statistics are per rank, or with
``sync=True`` (``--sync_bn``, the JAX package's ``bn_sync_axis``) over the
global batch of every rank of the process group: the centred two-pass
statistics, each pass one all-reduce (``parallel/dist.py``), and in
:func:`bn_relu`'s backward one all-reduce of the packed ``[dβ, dγ]`` sums.
The returned parameter gradients stay the rank's own (local) sums: the
step's gradient collective sums them over the ranks, as it does every other
gradient.  Without a process group the all-reduces are the identity.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import dist

_REDUCE = (0, 2, 3)  # batch and spatial dims of an NCHW activation


def _ch(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over NCHW."""
    return v.view(1, -1, 1, 1)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """2-D convolution. x: [N,C_in,H,W], weight: [C_out,C_in,kh,kw]."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: int = 0) -> torch.Tensor:
    """MaxPool2d(window, stride, padding)."""
    return F.max_pool2d(x, window, stride, padding)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias). weight: [out, in].  The product and then the
    sum, each rounded to ``x``'s dtype, as the JAX package's ``x @ w + b``
    rounds twice in bfloat16; ``F.linear``'s fused bias would round once."""
    y = F.linear(x, weight)
    return y if bias is None else y + bias


def keep_mask(shape, keep: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """A boolean mask of ``shape``, each element True with probability
    ``keep`` (``uniform < keep``, as ``jax.random.bernoulli``), drawn from
    ``generator`` on the generator's device and moved to ``device``: a CPU
    generator gives the same mask on the card as on the CPU (the parity
    drills' choice); a CUDA generator draws on the card without a host
    round trip (the trainer's).  The streams are torch's, not JAX's."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device)
    return (u < keep).to(device)


def dropout(x: torch.Tensor, rate: float, *, train: bool,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout in the torch convention (``ddp_tpu/ops/layers.py:
    313-322``): in training each element is kept with probability ``keep =
    1 - rate`` and divided by ``keep``; otherwise ``x`` unchanged.  The
    arithmetic is JAX's ``where(mask, x / keep, 0)``, where ``keep`` takes
    ``x``'s dtype (0.8984375 in bfloat16) and the quotient is rounded once:
    the divisor is a tensor of ``x``'s dtype on its device, as
    ``train/step.py::_as_input`` divides, where a Python float would divide
    by the float32 0.9 (and on the card multiply by its reciprocal).  The
    mask is ``mask`` when given (a test passes the one JAX drew), else
    :func:`keep_mask` from ``generator``, which training needs."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        if generator is None:
            raise ValueError("dropout in training needs a generator or a "
                             "mask")
        mask = keep_mask(x.shape, keep, generator, x.device)
    divisor = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / divisor, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N,C,H,W] -> [N,C], the mean over the spatial dims."""
    return x.mean(dim=(2, 3))


class BatchNormState(NamedTuple):
    """Running statistics (BatchNorm2d's buffers)."""
    mean: torch.Tensor
    var: torch.Tensor


def _bn_stats(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Per-channel batch statistics of a float32 NCHW ``xf``, in one pass:
    ``(mean, biased var, count)`` with var = max(E[x²] - E[x]², 0), the form
    ``ddp_tpu``'s per-device ``_bn_stats`` uses."""
    count = float(xf.shape[0] * xf.shape[2] * xf.shape[3])
    mean = xf.mean(dim=_REDUCE)
    var = torch.clamp((xf * xf).mean(dim=_REDUCE) - mean * mean, min=0.0)
    return mean, var, count


def _sync_bn_stats(xf: torch.Tensor, mean_over_ranks
                   ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The synchronised form of :func:`_bn_stats` (``ddp_tpu``'s
    ``_bn_stats`` under a sync axis, ``ddp_tpu/ops/layers.py:177-199``):
    centred two-pass, ``mean = Σ_r mean_r / world`` then ``var = Σ_r
    mean_r((x - mean)²) / world``, over ``count = n * world`` elements.
    ``mean_over_ranks(t)`` is ``Σ_r t_r / world``; the second pass waits on
    the first's result."""
    world = dist.data_size()
    n = float(xf.shape[0] * xf.shape[2] * xf.shape[3])
    mean = mean_over_ranks(xf.mean(dim=_REDUCE))
    d = xf - _ch(mean)
    var = mean_over_ranks((d * d).mean(dim=_REDUCE))
    return mean, var, n * world


def _mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    return dist.all_reduce_sum_(t) / dist.data_size()


class _MeanOverRanks(torch.autograd.Function):
    """``Σ_r t_r / world`` with its transpose as backward (the cotangent
    summed over the ranks, divided by the world): the differentiable
    all-reduce :func:`batch_norm`'s synchronised statistics go through, so
    each rank's ``dx`` carries the cross-rank terms of the summed
    objective."""

    @staticmethod
    def forward(ctx, t):
        return _mean_over_ranks(t.clone())

    @staticmethod
    def backward(ctx, ct):
        return _mean_over_ranks(ct.clone())


def _unbiased(var: torch.Tensor, count: float) -> torch.Tensor:
    return var * (count / max(count - 1.0, 1.0))


def _blend_running_stats(state: BatchNormState, batch_mean: torch.Tensor,
                         unbiased_var: torch.Tensor,
                         momentum: float) -> BatchNormState:
    """torch's running-buffer EMA, shared by :func:`batch_norm` and
    :func:`bn_relu`."""
    return BatchNormState(
        mean=(1.0 - momentum) * state.mean + momentum * batch_mean,
        var=(1.0 - momentum) * state.var + momentum * unbiased_var)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               state: BatchNormState, *, train: bool, momentum: float = 0.1,
               eps: float = 1e-5, sync: bool = False
               ) -> Tuple[torch.Tensor, BatchNormState]:
    """BatchNorm2d with torch semantics: training normalises with the biased
    batch variance and blends the unbiased one into the running variance;
    eval normalises with the running statistics.  With ``sync`` the
    training statistics are those of every rank's batch together (autograd
    runs through their all-reduces).  Returns ``(y, new state)``; the caller
    stores the state."""
    if train:
        mean, var, count = (_sync_bn_stats(x.float(), _MeanOverRanks.apply)
                            if sync else _bn_stats(x.float()))
        new_state = _blend_running_stats(state, mean.detach(),
                                         _unbiased(var, count).detach(),
                                         momentum)
    else:
        new_state = state
        mean, var = state.mean, state.var
    inv = torch.rsqrt(var + eps) * scale
    y = (x - _ch(mean).to(x.dtype)) * _ch(inv).to(x.dtype) + \
        _ch(bias).to(x.dtype)
    return y, new_state


class _BNReLUTrain(torch.autograd.Function):
    """Training-mode BatchNorm+ReLU with the hand-written backward of
    ``ddp_tpu/ops/layers.py::_bn_relu_train``.

    Forward returns ``(z, batch mean, unbiased batch var)``; the two
    statistics are not differentiable (they only feed the running buffers).
    Backward recomputes x̂ and the ReLU mask (x̂·γ+β > 0, the forward's own
    expression) from the saved ``x``, so it reads only ``(x, dz)``: one
    reduction pass for dβ and dγ and one elementwise pass for dx.

    With ``sync`` (``_bn_relu_bwd`` under a sync axis,
    ``ddp_tpu/ops/layers.py:241-283``) the statistics are the global
    batch's, and ``dx``'s mean-subtraction terms need the dβ/dγ sums over
    that batch: one all-reduce of the packed local sums.  The returned dγ
    and dβ stay the local sums, the gradient of the rank's own share of the
    loss: the step's gradient collective sums them over the ranks like any
    other gradient, where returning the summed ones would count them
    ``world`` times."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, sync: bool):
        xf = x.float()
        mean, var, count = (_sync_bn_stats(xf, _mean_over_ranks) if sync
                            else _bn_stats(xf))
        inv = torch.rsqrt(var + eps)
        xhat = (xf - _ch(mean)) * _ch(inv)
        z = torch.clamp(xhat * _ch(scale) + _ch(bias), min=0.0).to(x.dtype)
        unbiased = _unbiased(var, count)
        ctx.save_for_backward(x, mean, inv, scale, bias)
        ctx.sync, ctx.count = sync, count
        ctx.mark_non_differentiable(mean, unbiased)
        return z, mean, unbiased

    @staticmethod
    def backward(ctx, ct_z, _ct_mean, _ct_unbiased):
        x, mean, inv, scale, bias = ctx.saved_tensors
        xf = x.float()
        count = ctx.count
        xhat = (xf - _ch(mean)) * _ch(inv)
        dy = torch.where(xhat * _ch(scale) + _ch(bias) > 0.0, ct_z.float(),
                         torch.zeros((), dtype=torch.float32,
                                     device=x.device))
        dbeta = dy.sum(dim=_REDUCE)
        dgamma = (dy * xhat).sum(dim=_REDUCE)
        sbeta, sgamma = dbeta, dgamma
        if ctx.sync:
            sbeta, sgamma = dist.all_reduce_sum_(torch.stack([dbeta, dgamma]))
        dx = _ch(inv) * (dy * _ch(scale) - _ch(sbeta * scale) / count
                         - xhat * _ch(sgamma * scale) / count)
        return dx.to(x.dtype), dgamma, dbeta, None, None


def bn_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            state: BatchNormState, *, train: bool, momentum: float = 0.1,
            eps: float = 1e-5, sync: bool = False
            ) -> Tuple[torch.Tensor, BatchNormState]:
    """``relu(batch_norm(x))`` as one op, with :class:`_BNReLUTrain`'s
    backward in training (``sync``: statistics over every rank's batch).
    Eval delegates to :func:`batch_norm` so its numbers are those of the
    unfused composition."""
    if not train:
        y, _ = batch_norm(x, scale, bias, state, train=False,
                          momentum=momentum, eps=eps)
        return torch.relu(y), state
    z, batch_mean, unbiased = _BNReLUTrain.apply(x, scale, bias, eps, sync)
    return z, _blend_running_stats(state, batch_mean, unbiased, momentum)
