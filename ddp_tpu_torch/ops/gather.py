"""Batch gathers from the device-resident dataset, as CUDA kernels.

Every resident train and eval step takes its batch by index from the uint8
``[M,32,32,3]`` table kept on the card (``data/resident.py``).  Two kernels
of ``csrc/gather.cu`` (the source says how each is laid out) replace the TPU
kernel ``ddp_tpu/ops/gather.py::_pallas_row_gather``:

- :func:`gather_rows`, ``table[idx]`` along axis 0 for a table of any
  dtype, the direct counterpart of the TPU kernel;
- :func:`gather_batch`, the whole input of a resident step in one launch:
  the rows, the crop/flip, u8/255 in float32 or bfloat16, channels-first
  storage and the labels.  The train and eval steps call this one.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain version (:func:`gather_rows_plain`,
:func:`gather_batch_plain`).  All clamp indices to ``[0, M-1]``, as the TPU
wrapper does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

_IDX_TYPES = (torch.int32, torch.int64)
# gather_batch's output types: the step's compute dtype (``--bf16``).
_OUT_TYPES = (torch.float32, torch.bfloat16)
IMAGE_SHAPE = (32, 32, 3)  # the resident table's rows, NHWC uint8


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, M-1)]`` in plain PyTorch: the kernel's reference
    and the CPU path."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    if not getattr(lib, "_typed", False):
        lib.ddp_row_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.ddp_row_gather.restype = ctypes.c_int
        lib.ddp_gather_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, *[ctypes.c_void_p] * 5,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.ddp_gather_batch.restype = ctypes.c_int
        lib._typed = True
    return lib


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, M-1)]`` along axis 0: ``[M, ...]`` table (any
    dtype), 1-D int32/int64 ``idx`` of length N -> ``[N, ...]``.

    CUDA tensors go through the kernel, launched on the current stream
    without a synchronise; each launch adds one to ``gather_rows.launches``.
    CPU tensors take :func:`gather_rows_plain`.  Anything the kernel does not
    take raises."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device} and idx on "
                         f"{idx.device}; both must be on one CUDA device "
                         f"(or both on the CPU)")
    if table.dim() < 1 or table.shape[0] < 1:
        raise ValueError(f"gather_rows: table of shape {tuple(table.shape)} "
                         f"has no rows to gather from")
    if idx.dim() != 1 or idx.dtype not in _IDX_TYPES:
        raise ValueError(f"gather_rows: idx must be 1-D int32 or int64, got "
                         f"{idx.dtype} of shape {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")
    n = idx.shape[0]
    if n >= 2**31:
        raise ValueError(f"gather_rows: {n} indices; the kernel takes < 2^31")
    out = torch.empty((n,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    row_bytes = out[0].numel() * out.element_size() if n else 0
    if n == 0 or row_bytes == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ddp_row_gather(
            table.data_ptr(), table.shape[0], row_bytes, idx.data_ptr(),
            idx.element_size(), n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows: kernel launch failed with CUDA "
                           f"error {err}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_batch_plain(table: torch.Tensor, labels: torch.Tensor,
                       idx: torch.Tensor, draws=None, *,
                       dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gather_batch` in plain PyTorch: the kernel's reference and the
    CPU path.  The clamped rows, then
    :func:`~ddp_tpu_torch.data.device_augment.crop_flip` with ``draws``,
    then u8/255 into a channels-first buffer: the float32 quotient, rounded
    to nearest even for bfloat16 (JAX's ``u8.astype(bf16) / 255``)."""
    # device_augment imports this module for gather_rows.
    from ..data.device_augment import crop_flip
    rows = idx.clamp(0, table.shape[0] - 1).long()
    x = table[rows]
    if draws is not None:
        x = crop_flip(x, *draws)
    # A true division, as the kernel's: on a CUDA tensor, ``x / 255.0``
    # multiplies by the reciprocal, which differs in the last bit.
    x = x.permute(0, 3, 1, 2).float() / torch.full((), 255.0,
                                                   device=x.device)
    return x.to(dtype).contiguous().permute(0, 2, 3, 1), labels[rows]


def _check_batch_args(table, labels, idx, draws, dtype) -> None:
    """Raises ValueError for what the kernel does not take (every device)."""
    if dtype not in _OUT_TYPES:
        raise ValueError(f"gather_batch: dtype must be torch.float32 or "
                         f"torch.bfloat16, got {dtype}")
    if table.dim() != 4 or tuple(table.shape[1:]) != IMAGE_SHAPE or \
            table.shape[0] < 1 or table.dtype != torch.uint8 or \
            not table.is_contiguous():
        raise ValueError(f"gather_batch: table must be a contiguous uint8 "
                         f"[M>=1,32,32,3], got {table.dtype} of shape "
                         f"{tuple(table.shape)}")
    if labels.dtype != torch.int64 or tuple(labels.shape) != \
            (table.shape[0],) or not labels.is_contiguous():
        raise ValueError(f"gather_batch: labels must be contiguous int64 "
                         f"[{table.shape[0]}], got {labels.dtype} of shape "
                         f"{tuple(labels.shape)}")
    if idx.dim() != 1 or idx.dtype not in _IDX_TYPES or \
            not idx.is_contiguous() or idx.shape[0] >= 2**31:
        raise ValueError(f"gather_batch: idx must be contiguous 1-D int32 or "
                         f"int64 with < 2^31 entries, got {idx.dtype} of "
                         f"shape {tuple(idx.shape)}")
    if draws is None:
        return
    if len(draws) != 3:
        raise ValueError(f"gather_batch: draws must be (ys, xs, flip), got "
                         f"{len(draws)} tensors")
    n = idx.shape[0]
    for name, d, dtype in zip(("ys", "xs", "flip"), draws,
                              (torch.int64, torch.int64, torch.bool)):
        if d.dtype != dtype or tuple(d.shape) != (n,) or \
                not d.is_contiguous():
            raise ValueError(f"gather_batch: {name} must be contiguous "
                             f"{dtype} [{n}], got {d.dtype} of shape "
                             f"{tuple(d.shape)}")


def gather_batch(table: torch.Tensor, labels: torch.Tensor,
                 idx: torch.Tensor, draws: Optional[tuple] = None, *,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One resident step's input: ``(images, labels_out)`` for the rows
    ``r = clamp(idx, 0, M-1)`` of the uint8 ``[M,32,32,3]`` ``table`` and
    the int64 ``[M]`` ``labels``.

    ``images`` is ``dtype`` (float32, or bfloat16 under ``--bf16``) of
    logical shape ``[N,32,32,3]`` (the JAX package's layout), ``table[r]``
    cropped and flipped with ``draws`` (``(ys, xs, flip)`` from
    :func:`~ddp_tpu_torch.data.device_augment.make_draws`; ``None`` for the
    eval form, which leaves the image as it is), scaled u8/255 (bfloat16:
    the float32 quotient rounded to nearest even, as JAX's ``_as_input``
    computes it).  Any other ``dtype`` raises ValueError.  It is the NHWC view of a contiguous ``[N,3,32,32]``
    buffer, so the step's NCHW input costs no copy.  ``labels_out`` is
    ``labels[r]``: the label of the same clamped row as the image.

    CUDA tensors go through the kernel, launched on the current stream
    without a synchronise; each launch, of either form, adds one to
    ``gather_batch.launches``, and a bfloat16 one also to
    ``gather_batch.launches_bf16``.  CPU tensors take :func:`gather_batch_plain`.
    Anything the kernel does not take raises ValueError."""
    _check_batch_args(table, labels, idx, draws, dtype)
    tensors = [table, labels, idx, *(draws or ())]
    if all(t.device.type == "cpu" for t in tensors):
        return gather_batch_plain(table, labels, idx, draws, dtype=dtype)
    if table.device.type != "cuda" or \
            any(t.device != table.device for t in tensors):
        raise ValueError(f"gather_batch: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}; all "
                         f"must be on one CUDA device (or all on the CPU)")
    if table.data_ptr() % 16:
        raise ValueError("gather_batch: the table must start 16-byte aligned "
                         "(the kernel's bulk copy reads whole 16 B words)")
    n = idx.shape[0]
    images = torch.empty((n, 3, 32, 32), dtype=dtype, device=table.device)
    labels_out = torch.empty((n,), dtype=torch.int64, device=table.device)
    if n:
        ys, xs, flip = (d.data_ptr() for d in draws) if draws is not None \
            else (None, None, None)
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib().ddp_gather_batch(
                table.data_ptr(), table.shape[0], idx.data_ptr(),
                idx.element_size(), n, labels.data_ptr(), ys, xs, flip,
                images.data_ptr(), images.element_size(),
                labels_out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"gather_batch: kernel launch failed with CUDA "
                               f"error {err}")
        gather_batch.launches += 1
        gather_batch.launches_bf16 += dtype == torch.bfloat16
    return images.permute(0, 2, 3, 1), labels_out


gather_batch.launches = gather_batch.launches_bf16 = 0
