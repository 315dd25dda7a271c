"""The host library of the streaming path: RandomCrop + HFlip in C++
(counterpart of ``ddp_tpu/data/native.py``).

``_native/crop_flip.cpp`` is built with ``g++ -O3 -shared -fPIC
-fopenmp`` (without ``-fopenmp`` where the compiler lacks it) at first
use, into ``ddp_tpu_torch/_build/`` beside the CUDA libraries, under a name
keyed on the hash of the source and the flags, and loaded with ``ctypes``
(no ``Python.h``).  The build writes a temporary file and renames it into
place, so several processes that build at once (``multigpu --spawn N``)
each load a whole library.

Python draws every random number (``data/augment.py``) and passes the
offsets in, so this library and the numpy version give the same bytes and
either may run.  Where the build fails, the numpy version runs and one
warning says why; ``DDP_TPU_NATIVE=0`` asks for numpy.  :func:`path` says
which one runs (the CLI's ``--result_json`` reports it as
``host_augment``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                   "crop_flip.cpp")
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(openmp: bool) -> str:
    """The library's path, keyed on the source and the flags."""
    flags = FLAGS + (["-fopenmp"] if openmp else [])
    digest = hashlib.sha256(" ".join(flags).encode() + b"\0")
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libcrop_flip-{digest.hexdigest()[:16]}.so")


def _build(openmp: bool) -> str:
    """Build the library unless it exists; returns its path.  Raises
    OSError or subprocess.SubprocessError when g++ fails or is missing."""
    out = library_path(openmp)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *FLAGS, *(["-fopenmp"] if openmp else []), SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: racing builds load whole files
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    errors = []
    for openmp in (True, False):
        try:
            lib = ctypes.CDLL(_build(openmp))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            errors.append(f"{e} {detail.decode(errors='replace')}".strip())
            continue
        lib.crop_flip_u8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64]
        lib.crop_flip_u8.restype = None
        return lib
    print("WARNING: the C++ crop/flip did not build; host augmentation "
          "runs in numpy: " + " | ".join(errors), file=sys.stderr)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when
    ``DDP_TPU_NATIVE=0`` or the build failed."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if os.environ.get("DDP_TPU_NATIVE", "1") != "0":
                _lib = _load()
        return _lib


def path() -> str:
    """``"native"`` when the C++ library runs the crop/flip, ``"numpy"``
    when the numpy version does."""
    return "native" if get_lib() is not None else "numpy"


def crop_flip(batch: np.ndarray, ys: np.ndarray, xs: np.ndarray,
              flip: np.ndarray) -> Optional[np.ndarray]:
    """The C++ RandomCrop + HFlip of a uint8 ``[N,32,32,3]`` batch; None
    when the library is unavailable or the batch is not uint8 (the numpy
    version takes any dtype)."""
    lib = get_lib()
    if lib is None or batch.dtype != np.uint8:
        return None
    if batch.ndim != 4 or batch.shape[1:] != (32, 32, 3):
        raise ValueError(f"crop_flip: batch must be [N,32,32,3], got "
                         f"{batch.shape}")
    n = batch.shape[0]
    batch = np.ascontiguousarray(batch)
    ys = np.ascontiguousarray(ys, dtype=np.int64)
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    flip_u8 = np.ascontiguousarray(flip, dtype=np.uint8)
    if not ys.shape == xs.shape == flip_u8.shape == (n,):
        raise ValueError(f"crop_flip: draws of shapes {ys.shape}, "
                         f"{xs.shape}, {flip_u8.shape} for {n} images")
    out = np.empty_like(batch)
    lib.crop_flip_u8(batch.ctypes.data, out.ctypes.data, ys.ctypes.data,
                     xs.ctypes.data, flip_u8.ctypes.data, n)
    return out
