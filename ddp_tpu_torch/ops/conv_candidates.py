"""Alternative 3x3 SAME-conv implementations for the conv-probe seam
(counterpart of ``ddp_tpu/ops/conv_candidates.py``), NHWC activations and
HWIO weights as in the JAX package.

- ``conv2d_shift9``: nine accumulated ``[N*H*W, Cin] @ [Cin, Cout]``
  ``torch.matmul`` s over 1-pixel-shifted views of the zero-padded input.
- ``conv2d_im2col``: the ``[N,H,W,9*Cin]`` patch tensor, then one matmul
  with K = 9*Cin.
- ``conv2d_fused``: the hand-written CUDA kernels ``csrc/conv3x3.cu`` behind
  :func:`conv3x3_fused` (they replace the TPU kernel
  ``ddp_tpu/ops/conv_candidates.py::_pallas_fwd``; the source says how each
  is laid out).  :func:`conv3x3_route` picks one of three routes from the
  shape and dtype before the launch: ``wgmma_bf16`` (tensor cores, TMA
  ring), ``ffma_f32`` (register-tiled CUDA cores, cp.async double
  buffering) or ``general`` (any shape, e.g. Cin = 3).  The TPU wrapper
  sizes a VMEM batch tile with ``_pick_block_n``; the CUDA kernels tile the
  output themselves, so that helper has no counterpart here.
- ``conv2d_fused_fwd_cudnn_bwd``: the kernel's forward with the baseline
  conv's own backward (cuDNN's dgrad and wgrad).

All follow the conv contract (SAME padding, stride 1, fp32 accumulation,
output in the input dtype) and carry a :class:`torch.autograd.Function`
whose default backward routes dgrad through the same forward (dgrad of a
SAME 3x3 conv is a SAME 3x3 conv of ``dy`` with the flipped, transposed
kernel) and wgrad through nine shifted matmuls.  Measure with::

    python -m ddp_tpu_torch.ops.conv_candidates [--bf16] [--all_shapes] \\
        [--candidates a,b] [--repeats 6] [--device cuda]

One JSON line per (candidate, shape, direction), as the JAX CLI prints.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from . import conv_probe

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pad_hw(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 accumulation (fp64 for a float64 reference)."""
    return torch.promote_types(dtype, torch.float32)


def _shift9_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Nine accumulated shifted matmuls; also the plain version of
    :func:`conv3x3_fused` (its CPU path and its reference on the card)."""
    n, h, wd, _ = x.shape
    acc_t = _acc_dtype(x.dtype)
    xp = _pad_hw(x).to(acc_t)
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=acc_t, device=x.device)
    for ky in range(3):
        for kx in range(3):
            acc = acc + torch.matmul(xp[:, ky:ky + h, kx:kx + wd, :],
                                     w[ky, kx].to(acc_t))
    return acc.to(x.dtype)


def _im2col_patches(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,Cin] -> [N,H,W,9*Cin] patch tensor (ky-major, kx, cin-minor,
    matching ``w.reshape(9*cin, cout)``)."""
    _, h, wd, _ = x.shape
    xp = _pad_hw(x)
    return torch.cat([xp[:, ky:ky + h, kx:kx + wd, :]
                      for ky in range(3) for kx in range(3)], dim=-1)


def _im2col_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    acc_t = _acc_dtype(x.dtype)
    p = _im2col_patches(x).reshape(n * h * wd, 9 * cin).to(acc_t)
    y = torch.matmul(p, w.reshape(9 * cin, cout).to(acc_t))
    return y.reshape(n, h, wd, cout).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    if not getattr(lib, "_typed", False):
        ptrs = [ctypes.c_void_p] * 3
        ints = [ctypes.c_int] * 5  # n, h, wd, cin, cout
        for fn, extra in ((lib.ddp_conv3x3, [ctypes.c_int]),  # dtype
                          (lib.ddp_conv3x3_f32_tiled, []),
                          (lib.ddp_conv3x3_bf16_wgmma,
                           [ctypes.c_int, ctypes.c_int])):  # box_h, box_n
            fn.argtypes = ptrs + ints + extra + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


ROUTES = ("wgmma_bf16", "ffma_f32", "general")
# The wgmma route's tile: 128 output pixels (two warpgroups of 64 rows).
_TC_PIXELS = 128


def tc_box(h: int, wd: int) -> Optional[Tuple[int, int]]:
    """``(box_h, box_n)`` of the wgmma route's input box for an H x W
    image: 128 pixels as ``box_h`` whole rows of one image, or as ``box_n``
    whole images; ``None`` when neither tiles 128 pixels exactly."""
    hw = h * wd
    if hw >= _TC_PIXELS:
        if _TC_PIXELS % wd == 0 and h % (_TC_PIXELS // wd) == 0:
            return _TC_PIXELS // wd, 1
    elif _TC_PIXELS % hw == 0:
        return h, _TC_PIXELS // hw
    return None


def conv3x3_route(n: int, h: int, wd: int, cin: int, cout: int,
                  dtype: torch.dtype, aligned: bool = True) -> str:
    """Which kernel of ``csrc/conv3x3.cu`` runs a conv of x ``[n, h, wd,
    cin]`` and w ``[3, 3, cin, cout]`` in ``dtype``; ``aligned``: x and w
    start on 16 bytes.  Decided from these alone, before the launch.

    - ``wgmma_bf16``: bfloat16 with Cin and Cout multiples of 8 (TMA's 16 B
      strides) and rows or images that tile 128 pixels (:func:`tc_box`);
    - ``ffma_f32``: float32 with Cin and Cout multiples of 4 (16 B copies);
    - ``general``: everything else, e.g. VGG's conv0 (Cin = 3) and its
      dgrad (Cout = 3)."""
    if aligned and dtype == torch.bfloat16 and cin % 8 == 0 and \
            cout % 8 == 0 and tc_box(h, wd) is not None:
        return "wgmma_bf16"
    if aligned and dtype == torch.float32 and cin % 4 == 0 and \
            cout % 4 == 0:
        return "ffma_f32"
    return "general"


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` -> ``[9, Cout, Cin]``, contiguous: the
    wgmma route's B operand, K (input channels) innermost."""
    return w.reshape(9, w.shape[2], w.shape[3]).transpose(1, 2).contiguous()


def conv3x3_fused(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv: NHWC ``x`` ``[N,H,W,Cin]``, HWIO ``w``
    ``[3,3,Cin,Cout]`` -> ``[N,H,W,Cout]`` in ``x``'s dtype.

    CUDA tensors (float32 or bfloat16, both contiguous, one dtype) go
    through the kernel of the route :func:`conv3x3_route` picks, launched on
    the current stream without a synchronise; each launch adds one to
    ``conv3x3_fused.launches`` and to the route's count in
    ``conv3x3_fused.route_launches``.  CPU tensors take the plain version
    :func:`_shift9_fwd`.  Anything else raises, and so does a launch the
    kernel refuses: no route falls back to another."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _shift9_fwd(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv3x3_fused: x on {x.device} and w on "
                         f"{w.device}; both must be on one CUDA device (or "
                         f"both on the CPU)")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (
            3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_fused: x {tuple(x.shape)} must be NHWC "
                         f"and w {tuple(w.shape)} HWIO [3, 3, Cin, Cout]")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv3x3_fused: x {x.dtype} and w {w.dtype}; the "
                         f"kernel takes float32 or bfloat16, one dtype")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_fused: x and w must be contiguous")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if max(n, h, wd, cin, cout) >= 2**31:
        raise ValueError(f"conv3x3_fused: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: every size must be < 2^31")
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    route = conv3x3_route(n, h, wd, cin, cout, x.dtype, aligned=(
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _lib()
        if route == "wgmma_bf16":
            box_h, box_n = tc_box(h, wd)
            wk = kmajor_weights(w)
            err = lib.ddp_conv3x3_bf16_wgmma(
                x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, wd, cin,
                cout, box_h, box_n, stream)
        elif route == "ffma_f32":
            err = lib.ddp_conv3x3_f32_tiled(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, cin,
                cout, stream)
        else:
            err = lib.ddp_conv3x3(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  n, h, wd, cin, cout,
                                  _KERNEL_DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_fused: {route} kernel launch failed "
                           f"with error {err} (a CUDA error; 1000: no "
                           f"cuTensorMapEncodeTiled; 2000 + a CUresult: "
                           f"tensor map refused)")
    conv3x3_fused.launches += 1
    conv3x3_fused.route_launches[route] += 1
    return y


conv3x3_fused.launches = 0
conv3x3_fused.route_launches = dict.fromkeys(ROUTES, 0)


def _flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """dgrad kernel: spatial flip + in/out channel transpose, so dgrad is
    the same forward conv applied to dy.  A non-contiguous view."""
    return torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2)


def _wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw[ky,kx,cin,cout] = sum_nhw xpad[n, h+ky, w+kx, cin] * dy[n,h,w,cout]
    — nine [Cin, N*H*W] @ [N*H*W, Cout] matmuls."""
    n, h, wd, cin = x.shape
    cout = dy.shape[-1]
    acc_t = _acc_dtype(x.dtype)
    xp = _pad_hw(x)
    dyf = dy.reshape(n * h * wd, cout).to(acc_t)
    rows = [torch.matmul(
        xp[:, ky:ky + h, kx:kx + wd, :].reshape(n * h * wd, cin).to(acc_t).t(),
        dyf) for ky in range(3) for kx in range(3)]
    return torch.stack(rows).reshape(3, 3, cin, cout).to(x.dtype)


def _cudnn_bwd(res, dy):
    """The baseline conv's own backward: the dgrad and wgrad that autograd
    of :func:`~ddp_tpu_torch.ops.conv_probe.conv2d_nhwc` runs (cuDNN on the
    card), called without re-running its forward, as XLA drops the unused
    primal in the JAX package's ``_xla_bwd``."""
    x, w = res
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


def _default_bwd(fwd):
    def bwd(res, dy):
        x, w = res
        return (fwd(dy.contiguous(), _flip_transpose(w).contiguous()),
                _wgrad(x, dy))

    return bwd


def _with_vjp(fwd, bwd=None) -> Callable:
    """Wrap a forward into the probe's conv contract as a
    :class:`torch.autograd.Function`.  Default backward: dgrad through the
    same forward (flipped, transposed kernel, made contiguous for it),
    wgrad through shifted matmuls."""
    backward = bwd or _default_bwd(fwd)

    class _Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return fwd(x, w)

        @staticmethod
        def backward(ctx, dy):
            return backward(ctx.saved_tensors, dy)

    def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _Conv.apply(x, w)

    return conv


conv2d_shift9 = _with_vjp(_shift9_fwd)
conv2d_im2col = _with_vjp(_im2col_fwd)
conv2d_fused = _with_vjp(conv3x3_fused)
conv2d_fused_fwd_cudnn_bwd = _with_vjp(conv3x3_fused, bwd=_cudnn_bwd)

CANDIDATES: Dict[str, Optional[Callable]] = {
    "baseline_cudnn_conv": None,  # conv_probe's default conv2d_nhwc
    "shift9_torch": conv2d_shift9,
    "im2col_torch": conv2d_im2col,
    "shift9_fused_cuda": conv2d_fused,
    "cuda_fwd_cudnn_bwd": conv2d_fused_fwd_cudnn_bwd,
}

# The two sub-peak shapes of the JAX package's roofline (plus reps=1).
TARGET_SHAPES = [(32, 64, 128, 1), (8, 256, 512, 1)]


def main(argv: Optional[List[str]] = None) -> Dict[str, List[dict]]:
    """The CLI; returns each candidate's probe records."""
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--all_shapes", action="store_true",
                   help="Probe every VGG conv shape, not just the two "
                        "sub-peak targets")
    p.add_argument("--candidates", default=None,
                   help="Comma list (default: all)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    args = p.parse_args(argv)
    shapes = (conv_probe.VGG_CONV_SHAPES if args.all_shapes
              else TARGET_SHAPES)
    names = (args.candidates.split(",") if args.candidates
             else list(CANDIDATES))
    unknown = [n for n in names if n not in CANDIDATES]
    if unknown:
        p.error(f"unknown candidate(s) {unknown}; "
                f"valid: {', '.join(CANDIDATES)}")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    records = {}
    for name in names:
        cand = CANDIDATES[name]
        kw = {} if cand is None else {"conv": cand}
        print(json.dumps({"candidate": name}), flush=True)
        records[name] = conv_probe.probe(args.batch, args.repeats, dtype,
                                         shapes=shapes, device=args.device,
                                         **kw)
    return records


if __name__ == "__main__":
    main()
