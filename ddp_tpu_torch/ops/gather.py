"""Batched row gather — the resident data path's hot op, as a CUDA kernel.

``table[idx]`` along axis 0 for the device-resident dataset
(``data/resident.py``): every resident train and eval step gathers its batch
by index from the uint8 table kept on the card.  On a CUDA tensor
:func:`gather_rows` launches the hand-written kernel ``csrc/gather.cu``
(which replaces the TPU kernel ``ddp_tpu/ops/gather.py::_pallas_row_gather``;
the source says how it is laid out); on a CPU tensor it runs the plain
version :func:`gather_rows_plain`.  Both clamp indices to ``[0, M-1]``, as
the TPU wrapper does.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_IDX_TYPES = (torch.int32, torch.int64)


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
