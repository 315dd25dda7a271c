"""Per-layer convolution probe (counterpart of ``ddp_tpu/ops/conv_probe.py``).

Times every distinct VGG conv layer in isolation on the card, forward and
the full trained cost (``train(fwd+dgrad+wgrad)``: the chain runs the
primal, so that row's FLOP multiplier is 3), and reports achieved TFLOP/s.
Activations are NHWC and weights HWIO, as in the JAX package, so a
candidate from :mod:`~ddp_tpu_torch.ops.conv_candidates` plugs into
:func:`probe` with the same contract ``conv(x, w) -> y``.

Method, as in the JAX package: each measurement runs a chain of N
dependency-linked convs (dependency through the weight, ``w + acc*1e-30``)
and takes the best-of-repeats wall time at two chain lengths; the reported
per-call time is the marginal ``(t_long - t_short)/(N_LONG - N_SHORT)``,
which cancels the fixed cost of a dispatch and a host read.  The JAX chain
is one jitted program; here it runs eagerly, so each link also launches its
own ``w + acc*1e-30`` and mean kernels (a few microseconds a link, which
XLA fused), and the train chain keeps no autograd graph from one link to
the next.  The baseline :func:`conv2d_nhwc` is cuDNN through zero-copy
views; TF32 is off throughout (:func:`~ddp_tpu_torch.device.set_tf32`).

Usage: ``python -m ddp_tpu_torch.ops.conv_probe [--batch 512] [--bf16]
[--device cuda]`` prints one JSON line per (shape, direction) and a summary.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device, set_tf32

# (H=W, C_in, C_out, reps) for each conv in VGG.ARCH at the spatial size it
# sees; 'reps' folds the two identical 4x4 512->512 layers into one row.
VGG_CONV_SHAPES = [
    (32, 3, 64, 1),
    (32, 64, 128, 1),
    (16, 128, 256, 1),
    (16, 256, 256, 1),
    (8, 256, 512, 1),
    (8, 512, 512, 1),
    (4, 512, 512, 2),
]

N_SHORT, N_LONG = 10, 50

# A marginal below 0.1 ms/call is flagged as noise-limited (the JAX
# package's threshold, shared with the pool probe so the two cannot drift).
NOISE_S_PER_CALL = 1e-4

Conv = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def conv_flops(n: int, h: int, cin: int, cout: int) -> float:
    """MAC-pair FLOPs of a SAME-padded 3x3 stride-1 conv (interior
    approximation, as the JAX package counts them)."""
    return 2.0 * n * h * h * cout * 9 * cin


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv of NHWC ``x`` with HWIO ``w`` through
    ``F.conv2d`` (cuDNN on the card).  A contiguous NHWC tensor is a
    channels-last NCHW view, so no activation is copied, and the result
    comes back as a contiguous NHWC view."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _fwd_chain(n: int, conv: Conv):
    @torch.no_grad()
    def win(x, w):
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(n):
            acc = torch.mean(conv(x, w + acc * 1e-30))
        return acc

    return win


def _train_chain(n: int, conv: Conv):
    # Each link runs the primal and both gradients (the cotangent is y
    # itself, as in the JAX chain), so the window times fwd+dgrad+wgrad.
    def win(x, w):
        xg = x.detach().requires_grad_()
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(n):
            with torch.enable_grad():
                wl = (w + acc * 1e-30).requires_grad_()
                y = conv(xg, wl)
                dx, dw = torch.autograd.grad(y, (xg, wl), y.detach())
            acc = torch.mean(dx) + torch.mean(dw)
        return acc

    return win


def best_of(fn, args, repeats: int) -> float:
    """Best-of-``repeats`` wall time of ``fn(*args)``, each run ended by
    reading its scalar result on the host (``.item()`` waits for the
    device).  The timing core of every probe in this package."""
    fn(*args).item()  # warm-up (cuDNN algorithm choice, kernel builds)
    dt = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args).item()
        dt = min(dt, time.perf_counter() - t0)
    return dt


def probe(batch: int = 512, repeats: int = 6, dtype=torch.float32,
          conv: Conv = conv2d_nhwc, shapes=None, device="cuda") -> List[dict]:
    """Marginal per-call ms and achieved TFLOP/s for each conv shape.

    ``conv`` is pluggable (``conv(x, w) -> y``, NHWC/HWIO) so alternative
    implementations are measured under the identical harness; ``shapes``
    restricts the sweep (default: every VGG conv shape).  Inputs are drawn
    from :class:`torch.Generator` s seeded 0 (x) and 1 (w) on ``device``,
    which defaults to the card."""
    device = resolve_device(device)
    set_tf32(False)
    records = []
    for h, cin, cout, reps in (VGG_CONV_SHAPES if shapes is None
                               else shapes):
        gx = torch.Generator(device=device).manual_seed(0)
        gw = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((batch, h, h, cin), generator=gx,
                        device=device).to(dtype)
        w = (torch.randn((3, 3, cin, cout), generator=gw, device=device)
             * (2.0 / (9 * cin)) ** 0.5).to(dtype)
        for name, chain, fmult in (("fwd", _fwd_chain, 1.0),
                                   ("train(fwd+dgrad+wgrad)", _train_chain,
                                    3.0)):
            t_s = best_of(chain(N_SHORT, conv), (x, w), repeats)
            t_l = best_of(chain(N_LONG, conv), (x, w), repeats)
            per_call = max((t_l - t_s) / (N_LONG - N_SHORT), 1e-9)
            fl = conv_flops(batch, h, cin, cout) * fmult
            noise_limited = (t_l - t_s) < NOISE_S_PER_CALL * (N_LONG
                                                             - N_SHORT)
            rec = {
                "shape": f"{h}x{h} {cin}->{cout}" + (f" x{reps}" if reps > 1
                                                     else ""),
                "dir": name,
                "marginal_ms_per_call": round(per_call * 1e3, 3),
                "tflops": (None if noise_limited
                           else round(fl / per_call / 1e12, 1)),
                "noise_limited": noise_limited,
                "reps_in_vgg": reps,
            }
            records.append(rec)
            print(json.dumps(rec), flush=True)
    return records


def summary(records: List[dict]) -> dict:
    """The per-step trained total: the train rows already contain the
    forward, so their sum (times each shape's reps) is the step's conv
    cost.  Noise-limited rows contribute ~0 (the sum is then a lower
    bound), and conv1's dgrad, which the real step never computes, is
    included."""
    train_rows = [r for r in records if r["dir"].startswith("train")]
    total = sum(r["marginal_ms_per_call"] * r["reps_in_vgg"]
                for r in train_rows)
    return {"sum_marginal_train_ms_per_step": round(total, 2),
            "noise_limited_train_rows": sum(r["noise_limited"]
                                            for r in train_rows)}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    args = p.parse_args(argv)
    recs = probe(args.batch, args.repeats,
                 torch.bfloat16 if args.bf16 else torch.float32,
                 device=args.device)
    print(json.dumps(summary(recs)), flush=True)
    return recs


if __name__ == "__main__":
    main()
