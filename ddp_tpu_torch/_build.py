"""Builds the package's CUDA sources (``csrc/*.cu``) with ``nvcc`` into shared
libraries that have a plain C interface, and loads them with ``ctypes``.

Each library is built at first use into ``ddp_tpu_torch/_build/`` (listed in
``.gitignore``), under a name keyed on the hash of its source, the shared
headers of ``csrc/`` and the compiler flags, so an edited source or header is
rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once, so the build of
several kernels takes the time of the slowest.  Nothing is built when a
module is imported: the wrappers call :func:`load` on their first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
# sm_90a, not sm_90: the Hopper-only instructions (wgmma, setmaxnreg) exist
# only for that target.  Nothing else is linked: the TMA tensor maps' driver
# entry point is looked up through the runtime.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> List[str]:
    """Names (without ``.cu``) of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {path} and on PATH); the CUDA "
            f"kernels are built on the machine with the card")
    return found


def library_path(name: str) -> str:
    """The library's path, keyed on the source, every shared header
    (``csrc/*.cuh``) it may include, and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(process or None, temporary path, final path)``."""
    out = library_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    # Atomic: a concurrent build of the same source writes the same bytes.
    os.replace(tmp, out)


def build_all() -> None:
    """Build every source in ``csrc/`` that is not built yet, all at once."""
    started = [(name, *_start(name)) for name in sources()]
    errors = []
    for name, proc, tmp, out in started:
        try:
            _finish(name, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
        return lib
