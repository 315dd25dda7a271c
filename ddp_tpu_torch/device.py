"""Device resolution and numeric precision for the port's entry points
(counterpart of ``ddp_tpu/utils/platform.py``, which pins JAX's platform).

Entry points run on ``cuda`` unless the caller asks for the CPU; a missing
card is an error, never a silent fall back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


class NoCardError(RuntimeError):
    """A CUDA device was asked for and this process sees none."""


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises :class:`NoCardError`
    when it names CUDA and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCardError(
            f"device {str(dev)!r} was asked for but torch sees no CUDA card "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}).  Pass --device cpu (or device='cpu') "
            f"to run on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def set_tf32(enabled: bool = False) -> None:
    """Set both TF32 switches, and keep bfloat16 matrix products' reductions
    in float32.  The main path runs with TF32 off: float32 convolutions and
    matrix products in full float32, like the JAX reference (cuDNN would
    otherwise take TF32 for convolutions).  Under ``--bf16`` cuBLAS may
    otherwise add split-K partial sums in bfloat16; XLA accumulates bfloat16
    dots in float32, so that switch stays off whatever ``enabled`` says."""
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def dtype_name(compute_dtype) -> str:
    """``"float32"`` for None, else the dtype's name (``"bfloat16"``; a
    name is returned as it is): the compute dtype as the result JSON, the
    serving stats and the MFU peak table key it."""
    return str(compute_dtype or torch.float32).replace("torch.", "")


def device_kind(device: DeviceLike) -> str:
    """The device's kind for MFU's peak table: the card's
    ``torch.cuda.get_device_name``, or ``"cpu"``."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
