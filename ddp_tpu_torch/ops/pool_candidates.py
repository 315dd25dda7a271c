"""Alternative 2x2/2 max pool (counterpart of
``ddp_tpu/ops/pool_candidates.py``), NHWC as in the JAX package.

For the VGG case (window == stride == 2, no padding, even spatial dims) the
pool is a reshape + axis max, whose backward is elementwise work (an
equality mask and a broadcast) if its tie-breaking is pinned: plain
autograd of ``amax`` splits the cotangent evenly among tied elements, while
``F.max_pool2d`` (and the JAX package's ``select_and_scatter``) route it to
the FIRST maximal element in row-major window order, and ties are common on
post-ReLU activations.  :func:`max_pool_reshape` pins first-tie semantics
with a hand-written backward (the cumulative count of ties == 1).  No
kernel: the baseline is ``F.max_pool2d`` through a channels-last view.

Measure with ``python -m ddp_tpu_torch.ops.pool_candidates [--device cuda]``
(the conv probe's marginal-cost chains); one JSON line per (impl, shape).
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
# The timing methodology (chain lengths, noise threshold, best-of core)
# comes from the conv probe so the two cannot drift.
from .conv_probe import N_LONG, N_SHORT, NOISE_S_PER_CALL, best_of

# (H=W, C) at batch 512: every "M" site in the VGG architecture.
VGG_POOL_SHAPES = [(32, 128), (16, 256), (8, 512), (4, 512)]


def _window_view(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,H/2,W/2,4,C] with the window index in row-major order
    ((dy,dx) = (0,0),(0,1),(1,0),(1,1)), the order ties are broken in."""
    n, h, w, c = x.shape
    return (x.reshape(n, h // 2, 2, w // 2, 2, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4, c))


class _MaxPoolReshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n, h, w, c = x.shape
        y = x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        n, h, w, c = x.shape
        eq = _window_view(x) == y[:, :, :, None, :]
        # First maximal element per window: where the running count of
        # ties is exactly 1.
        first = eq & (torch.cumsum(eq, dim=3) == 1)
        dxw = torch.where(first, dy[:, :, :, None, :],
                          torch.zeros((), dtype=dy.dtype, device=dy.device))
        return (dxw.to(x.dtype).reshape(n, h // 2, w // 2, 2, 2, c)
                .permute(0, 1, 3, 2, 4, 5)
                .reshape(n, h, w, c))


def max_pool_reshape(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of NHWC ``x`` (even H and W) as reshape+max
    with an elementwise first-tie backward: the candidate."""
    return _MaxPoolReshape.apply(x)


def max_pool2d_nhwc(x: torch.Tensor) -> torch.Tensor:
    """The baseline: ``F.max_pool2d`` on the channels-last view of NHWC
    ``x``, returned as NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


IMPLS = {
    "baseline_max_pool2d": max_pool2d_nhwc,
    "reshape_max_first_tie": max_pool_reshape,
}


def _train_chain(n, pool):
    def win(x):
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(n):
            with torch.enable_grad():
                xi = (x + acc * 1e-30).requires_grad_()
                y = pool(xi)
                (dx,) = torch.autograd.grad(y, (xi,), y.detach())
            acc = torch.mean(dx) + torch.mean(y.detach())
        return acc

    return win


def probe(batch: int = 512, repeats: int = 6, dtype=torch.float32,
          device="cuda") -> List[dict]:
    device = resolve_device(device)
    records = []
    for name, pool in IMPLS.items():
        for h, c in VGG_POOL_SHAPES:
            # ReLU-like data: exact zeros make ties common, as in the real
            # activations this op pools.
            g = torch.Generator(device=device).manual_seed(0)
            x = torch.relu(torch.randn((batch, h, h, c), generator=g,
                                       device=device) - 0.3).to(dtype)
            t_s = best_of(_train_chain(N_SHORT, pool), (x,), repeats)
            t_l = best_of(_train_chain(N_LONG, pool), (x,), repeats)
            per = max((t_l - t_s) / (N_LONG - N_SHORT), 1e-9)
            rec = {"impl": name, "shape": f"{h}x{h}x{c}",
                   "marginal_ms_per_call": round(per * 1e3, 3),
                   "noise_limited": (t_l - t_s) < NOISE_S_PER_CALL
                   * (N_LONG - N_SHORT)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    for name in IMPLS:
        total = sum(r["marginal_ms_per_call"] for r in records
                    if r["impl"] == name)
        print(json.dumps({"impl": name,
                          "sum_marginal_ms_per_step": round(total, 3)}),
              flush=True)
    return records


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    args = p.parse_args(argv)
    return probe(args.batch, args.repeats,
                 torch.bfloat16 if args.bf16 else torch.float32,
                 device=args.device)


if __name__ == "__main__":
    main()
