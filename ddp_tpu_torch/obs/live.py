"""Live run statistics (counterpart of ``ddp_tpu/obs/live.py``): a rolling
window of step times, samples/s, MFU and the prefetch engine's occupancy,
written through :class:`~ddp_tpu_torch.utils.metrics.MetricsLogger` every
``--log_every`` steps.

The FLOP count and the peak table live here, and ``bench.py`` imports them
for its records, so the live and the bench MFU share one numerator and one
denominator.

- **Numerator:** :func:`train_gflop_per_sample` counts the convolution and
  matrix-product FLOPs of one training step of the port's own model: the
  forward, and the backward for the parameters only (the input needs no
  gradient, as in JAX's ``grad`` with respect to the parameters).  It
  equals the conv + dot classes of JAX's ``cost_of_jaxpr`` count of
  ``grad(loss)`` to the FLOP.  JAX's total also counts elementwise and
  reduce operations (0.2-0.6% more); their torch decomposition differs
  from XLA's, so they are left out here, as the usual MFU numerator leaves
  them out.  The input gradient of a strided convolution is counted as the
  dilated convolution XLA runs for it (every output element of the input
  gradient times the kernel volume and output channels), as JAX's count
  does; torch's own formula counts only the non-zero products, 10.9% less
  on ResNet-18.
- **Denominator:** :data:`PEAK_TFLOPS`, published dense peaks by device
  name and compute dtype.  The port computes float32 with TF32 off
  (``device.set_tf32(False)``), on the CUDA cores, so float32 has its own
  peak; the JAX package's one bf16-pass peak cannot serve it.  A device
  kind missing from the table (the CPU included) gets a probed peak, the
  best of five square matrix products there (:func:`probed_peak_tflops`).
"""
from __future__ import annotations

import time
from collections import deque
from math import prod
from typing import Dict, Optional, Tuple, Union

import torch

from .. import device as _device
from ..device import dtype_name

DtypeLike = Union[None, str, torch.dtype]

# Dense peaks from NVIDIA's data sheet (SXM part, without sparsity, at the
# 700 W limit), TFLOP/s, by torch.cuda.get_device_name and compute dtype:
# float32 on the CUDA cores (TF32 is off on the port's path), bfloat16 on
# the tensor cores.  PERF.md's bounds use the same two numbers.
PEAK_TFLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"float32": 66.9, "bfloat16": 989.0},
}

_GFLOP_CACHE: Dict[str, float] = {}
_PROBED_PEAK: Dict[Tuple[str, str], Optional[float]] = {}


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         groups, output_mask, out_shape=None, **kwargs
                         ) -> int:
    """``aten.convolution_backward``'s FLOPs as XLA's cost model counts the
    two convolutions JAX's transpose rules emit: the input gradient as a
    dense convolution over the (dilated) output gradient, 2 x its elements
    x output channels per group x kernel volume; the weight gradient as the
    forward's count."""
    if transposed:
        raise ValueError("transposed convolutions are not counted")
    flops = 0
    if output_mask[0]:
        flops += 2 * prod(x_shape) * (w_shape[0] // groups) * \
            prod(w_shape[2:])
    if output_mask[1]:
        flops += 2 * prod(grad_out_shape) * prod(w_shape[1:])
    return flops


def train_gflop_per_sample(model_name: str) -> float:
    """GFLOP a sample of one training step of the port's ``model_name``:
    convolutions and matrix products of the forward and of the backward
    with respect to the parameters, counted by ``FlopCounterMode`` (at the
    dispatcher, so a custom ``autograd.Function``'s backward counts too)
    over a batch of 2 on the meta device (BatchNorm refuses one sample in
    training mode) and halved.  Cached per model."""
    if model_name in _GFLOP_CACHE:
        return _GFLOP_CACHE[model_name]
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import get_model
    from ..ops.losses import cross_entropy_sum_count
    model = get_model(model_name, device="meta")
    model.train()
    x = torch.zeros((2, 3, 32, 32), device="meta")
    y = torch.zeros((2,), dtype=torch.long, device="meta")
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter:
        logits = model(x, generator=torch.Generator())
        ce_sum, count = cross_entropy_sum_count(logits, y)
        torch.autograd.grad(ce_sum / count, list(model.parameters()))
    gflop = counter.get_total_flops() / 2 / 1e9
    _GFLOP_CACHE[model_name] = gflop
    return gflop


def _probe_device(device_kind: Optional[str]) -> Optional[torch.device]:
    if device_kind in (None, "") and torch.cuda.is_available():
        return torch.device("cuda", 0)
    if device_kind in (None, "", "cpu"):
        return torch.device("cpu")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            if torch.cuda.get_device_name(i) == device_kind:
                return torch.device("cuda", i)
    return None


def probed_peak_tflops(device_kind: Optional[str] = None,
                       dtype: DtypeLike = None) -> Optional[float]:
    """The best of five square matrix products (n = 1024 on the CPU, 4096
    on a card) on one device of ``device_kind`` (``"cpu"``, or a
    ``torch.cuda.get_device_name``; default the first card, else the
    CPU), in TFLOP/s: the MFU denominator of a kind missing from
    :data:`PEAK_TFLOPS`.  On a card in ``dtype`` (float32 with TF32 off),
    on the CPU in float32.  None when no such device is visible.  Cached
    per kind and dtype."""
    device = _probe_device(device_kind)
    if device is None:
        return None
    kind = _device.device_kind(device)
    name = dtype_name(dtype) if device.type == "cuda" else "float32"
    if (kind, name) in _PROBED_PEAK:
        return _PROBED_PEAK[(kind, name)]
    n = 4096 if device.type == "cuda" else 1024
    a = torch.ones((n, n), dtype=getattr(torch, name), device=device)

    def timed() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        a @ a
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        timed()  # warm-up: the library's set-up
        best = min(timed() for _ in range(5))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    peak = 2.0 * n ** 3 / best / 1e12
    _PROBED_PEAK[(kind, name)] = peak
    return peak


def mfu_peak(device_kind: Optional[str], dtype: DtypeLike = None
             ) -> Optional[Tuple[float, str]]:
    """The MFU denominator, ``(tflops, source)``: the data sheet's peak
    (``"datasheet"``) for a kind and dtype in :data:`PEAK_TFLOPS`, else the
    probed one (``"probed"``); None when neither exists."""
    peak = PEAK_TFLOPS.get(device_kind or "", {}).get(dtype_name(dtype))
    if peak is not None:
        return peak, "datasheet"
    peak = probed_peak_tflops(device_kind, dtype)
    if peak is not None:
        return peak, "probed"
    return None


def model_mfu(samples_per_sec_per_chip: float, model: Optional[str],
              device_kind: Optional[str], dtype: DtypeLike = None
              ) -> Optional[float]:
    """MFU of a measured rate a chip: :func:`train_gflop_per_sample`'s
    FLOPs a second over :func:`mfu_peak` for ``dtype``.  None without a
    model or a peak."""
    if not model:
        return None
    peak = mfu_peak(device_kind, dtype)
    if peak is None:
        return None
    return samples_per_sec_per_chip * train_gflop_per_sample(model) * 1e9 \
        / (peak[0] * 1e12)


class LiveStats:
    """Rolling-window live statistics, fed each optimizer step's duration
    by the trainer's streaming loop (on a card the step's device time
    between CUDA events, on the CPU the consumer loop's); every
    ``log_every`` steps one ``live`` record goes to the metrics stream
    (rank 0: the caller gates).  The record is the JAX package's, plus
    ``compute_dtype`` (the dtype its MFU is against).

    ``prefetch_stats`` (the port's
    :class:`~ddp_tpu_torch.data.prefetch.PrefetchStats`) is read
    differentially at each record, so the prefetch fields describe the
    window just measured (on a card, the batches the host took since the
    last record, a few steps ahead of the timed ones)."""

    def __init__(self, metrics, *, global_batch: int, n_chips: int,
                 log_every: int = 50, window: int = 100,
                 model: Optional[str] = None,
                 device_kind: Optional[str] = None,
                 compute_dtype: DtypeLike = None, prefetch_stats=None):
        self._metrics = metrics
        self.global_batch = int(global_batch)
        self.n_chips = max(int(n_chips), 1)
        self.log_every = max(int(log_every), 1)
        self._durs: deque = deque(maxlen=max(int(window), 2))
        self._count = 0
        self.model = model
        self.device_kind = device_kind
        self.compute_dtype = dtype_name(compute_dtype)
        self._pf = prefetch_stats
        self._pf_prev = self._pf_snapshot()
        # Step seconds fed since the last record: the occupancy's
        # denominator (wall time since the last record would count epoch
        # boundaries, checkpoints and evals as time fed by the pipeline).
        self._win_s = 0.0

    def _pf_snapshot(self) -> Dict[str, float]:
        if self._pf is None:
            return {}
        return {"wait_s": self._pf.wait_s, "host_s": self._pf.host_s,
                "h2d_s": self._pf.h2d_s, "batches": self._pf.batches}

    def step(self, dur_s: float, step: int) -> None:
        """Record one step's duration; writes a record on the cadence."""
        self._durs.append(float(dur_s))
        self._win_s += float(dur_s)
        self._count += 1
        if self._count % self.log_every == 0:
            self._emit(step)

    def _emit(self, step: int) -> None:
        durs = sorted(self._durs)
        n = len(durs)
        median = durs[n // 2] if n % 2 else (durs[n // 2 - 1]
                                             + durs[n // 2]) / 2.0
        # Nearest rank: the ceil(0.9 n)-th order statistic, so a small
        # window still shows a single straggler step.
        p90 = durs[min(-(-9 * n // 10) - 1, n - 1)]
        fields: Dict[str, object] = {
            "step_ms_median": round(median * 1e3, 3),
            "step_ms_p90": round(p90 * 1e3, 3),
            "window_steps": n,
        }
        if median > 0:
            sps = self.global_batch / median
            fields["samples_per_sec"] = round(sps, 2)
            fields["samples_per_sec_per_chip"] = round(sps / self.n_chips, 2)
            mfu = model_mfu(sps / self.n_chips, self.model, self.device_kind,
                            self.compute_dtype)
            if mfu is not None:
                fields["mfu"] = round(mfu, 4)
        if self._pf is not None:
            cur = self._pf_snapshot()
            db = cur["batches"] - self._pf_prev["batches"]
            elapsed = max(self._win_s, 1e-9)
            dwait = max(cur["wait_s"] - self._pf_prev["wait_s"], 0.0)
            if db > 0:
                fields["prefetch_wait_ms_per_step"] = round(
                    dwait / db * 1e3, 3)
                fields["prefetch_host_ms_per_step"] = round(
                    max(cur["host_s"] - self._pf_prev["host_s"], 0.0)
                    / db * 1e3, 3)
                fields["prefetch_h2d_ms_per_step"] = round(
                    max(cur["h2d_s"] - self._pf_prev["h2d_s"], 0.0)
                    / db * 1e3, 3)
            # The share of the window the consumer was not waiting for a
            # batch: 1.0 when the input pipeline hides behind compute.
            fields["prefetch_occupancy"] = round(
                min(max(1.0 - dwait / elapsed, 0.0), 1.0), 4)
            self._pf_prev = cur
        fields["compute_dtype"] = self.compute_dtype
        self._win_s = 0.0
        self._metrics.log_live(step=step, **fields)
