"""Checkpoint save and restore (counterpart of the gathered, version-1 half of
``ddp_tpu/train/checkpoint.py``).

The file is the JAX package's v1 file, key for key and layout for layout,
so either package restores what the other wrote, for each of the three
models: one ``.npz`` of flat ``section/key/subkey`` arrays (``/`` joins the
nesting; ResNet's keys hold dots, ``layer1.block0``),

- ``params/...``, the model's JAX tree (for VGG
  ``params/backbone/conv{i}/kernel`` (HWIO), ``params/backbone/bn{i}/scale``
  and ``/bias``, ``params/classifier/weight`` (``[in, out]``) and
  ``/bias``);
- ``batch_stats/...`` (for VGG ``batch_stats/bn{i}/mean`` and ``/var``;
  none for DeepNN, which has no BatchNorm);
- ``momentum/...``, mirroring ``params``;
- ``meta/step``, ``meta/epoch``, ``meta/format_version`` (1) and
  ``meta/data_state_json`` (the resume position as a uint8 JSON blob).

The file does not name its model: :func:`restore` checks its trees against
the model it is given and refuses a mismatch before it copies anything.
The layouts go through :mod:`ddp_tpu_torch.interop`.  The write is atomic
(a temporary file, then a rename) and hashed while it is written.  Reads
are eager: every array is read at load time (the JAX package reads lazily,
one leaf at a time, which matters only for models far larger than VGG).
The sharded v2 format (``ddp_tpu/train/ckpt_shard.py``) is not ported yet
and is refused by name (:class:`UnportedFormatError`; it belongs to the
storage half of the resilience port, ROADMAP A7b).  Retention, the sha256
manifest and the restore walk over retained files are
``resilience/lineage.py``'s.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import interop

_SECTIONS = ("params", "batch_stats", "momentum")
_SEP = "/"
GATHERED_FORMAT_VERSION = 1


class CheckpointError(ValueError):
    """A checkpoint file that cannot be restored (torn write, foreign file,
    or a format the port does not read), named with its path."""


class UnportedFormatError(CheckpointError):
    """A checkpoint in a format the port does not read yet (the sharded v2
    index).  The lineage walk raises it instead of falling back past the
    file to an older one."""


class Checkpoint(NamedTuple):
    """What a file holds, in ``ddp_tpu``'s trees of numpy arrays."""
    params: Dict[str, Any]
    batch_stats: Dict[str, Any]
    momentum: Dict[str, Any]
    step: int
    epoch: int
    # {"version", "epoch", "offset", "seed", "rng_folds"}: the position to
    # resume from ("epoch" to run next, "offset" batches of it done), or
    # None on files written without it.
    data_state: Optional[Dict[str, Any]] = None


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            if _SEP in k:
                raise ValueError(f"checkpoint key {k!r} contains {_SEP!r}")
            _flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix else k, out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    nested: Dict[str, Any] = {}
    for key, val in flat.items():
        node = nested
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return nested


class _Sha256Writer:
    """Write-only stream that hashes every byte on its way to disk.  Not
    seekable, so ``zipfile`` (under ``np.savez``) writes strictly in order
    and the running digest is the digest of the file's final bytes."""

    def __init__(self, f):
        self._f = f
        self._h = hashlib.sha256()

    def write(self, b) -> int:
        self._h.update(b)
        return self._f.write(b)

    def flush(self) -> None:
        self._f.flush()

    def seekable(self) -> bool:
        return False

    def read(self, *args):
        # Present only so numpy takes the stream branch; never called.
        raise OSError("_Sha256Writer is write-only")

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def sha256_of_file(path: str, chunk: int = 1 << 20) -> str:
    """Streaming sha256 of a file: what the lineage manifest records of
    each checkpoint, and checks it against."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def write_npz_hashed(path: str, flat: Dict[str, np.ndarray]) -> str:
    """Atomic temporary write + rename of one npz (written through a file
    handle: ``np.savez`` appends ``.npz`` to a bare path); returns the
    file's sha256."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            w = _Sha256Writer(f)
            np.savez(w, **flat)
        os.replace(tmp, path)
        return w.hexdigest()
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(path: str, model: nn.Module,
                    momentum: List[torch.Tensor], step: int, epoch: int,
                    data_state: Optional[Dict[str, Any]] = None) -> str:
    """Write ``model``'s weights and BatchNorm buffers, the SGD
    ``momentum`` (parallel to ``model.parameters()``), ``step`` and
    ``epoch`` to ``path`` as a v1 file, atomically; returns its sha256."""
    params, stats = interop.jax_from_state_dict(model.name,
                                                model.state_dict())
    trees = (params, stats, interop.momentum_tree_from_list(model, momentum))
    flat: Dict[str, np.ndarray] = {}
    for section, tree in zip(_SECTIONS, trees):
        sect: Dict[str, np.ndarray] = {}
        _flatten(tree, "", sect)
        flat.update({f"{section}/{k}": v for k, v in sect.items()})
    flat["meta/step"] = np.asarray(int(step), np.int64)
    flat["meta/epoch"] = np.asarray(int(epoch), np.int64)
    flat["meta/format_version"] = np.asarray(GATHERED_FORMAT_VERSION,
                                             np.int64)
    if data_state is not None:
        flat["meta/data_state_json"] = np.frombuffer(
            json.dumps(data_state).encode("utf-8"), np.uint8)
    return write_npz_hashed(path, flat)


def _decode_data_state(blob) -> Optional[Dict[str, Any]]:
    """A missing or unparseable record reads as None (epoch-boundary
    resume), as in the JAX package."""
    if blob is None:
        return None
    try:
        ds = json.loads(np.asarray(blob, np.uint8).tobytes().decode("utf-8"))
    except ValueError:  # bad UTF-8 or JSON
        return None
    return ds if isinstance(ds, dict) else None


def load_checkpoint(path: str) -> Checkpoint:
    """Read a v1 file written by either package.  Raises
    :class:`CheckpointError` on a torn or foreign file, a member that fails
    its CRC, or a v2 sharded index; a missing path keeps
    ``FileNotFoundError``."""
    try:
        z = np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:  # BadZipFile, OSError, pickle guard, EOF
        raise CheckpointError(
            f"checkpoint {path!r} is not a readable npz archive "
            f"({type(e).__name__}: {e}); the file is torn or is not a "
            f"ddp_tpu checkpoint") from e
    with z:
        files = set(z.files)
        try:
            flat = {k: z[k] for k in files}
        except Exception as e:  # zlib / CRC / zipfile damage in a member
            raise CheckpointError(
                f"checkpoint {path!r} has unreadable member data "
                f"({type(e).__name__}: {e}); the file is torn") from e

    def scalar(key: str) -> int:
        try:
            return int(flat[key])
        except (TypeError, ValueError) as e:
            raise CheckpointError(
                f"checkpoint {path!r} has a non-scalar {key} entry; the "
                f"file was not written by ddp_tpu or is damaged") from e

    version = (scalar("meta/format_version")
               if "meta/format_version" in files else 1)
    if version == 2:
        raise UnportedFormatError(
            f"checkpoint {path!r} is a sharded (format_version 2) index; "
            f"the port reads the gathered format_version 1 only (the "
            f"sharded format, ddp_tpu/train/ckpt_shard.py, is not ported "
            f"yet: ROADMAP A7b)")
    if version != GATHERED_FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path!r} has format_version {version}; the port "
            f"reads format_version 1")
    sections: Dict[str, Dict[str, np.ndarray]] = {s: {} for s in _SECTIONS}
    for key, val in flat.items():
        section, _, rest = key.partition(_SEP)
        if section in sections:
            sections[section][rest] = val
    missing = [k for k in ("meta/step", "meta/epoch") if k not in files]
    if missing or not sections["params"] or not sections["momentum"]:
        what = (f"missing keys {missing}" if missing
                else "no params/ entries" if not sections["params"]
                else "params/ present but no momentum/ entries")
        raise CheckpointError(
            f"checkpoint {path!r} is a valid npz but not a ddp_tpu "
            f"checkpoint ({what}); it may be truncated or written by "
            f"another tool")
    return Checkpoint(
        params=_unflatten(sections["params"]),
        batch_stats=_unflatten(sections["batch_stats"]),
        momentum=_unflatten(sections["momentum"]),
        step=scalar("meta/step"), epoch=scalar("meta/epoch"),
        data_state=_decode_data_state(flat.get("meta/data_state_json")))


def _mismatch(ckpt: Checkpoint, model: nn.Module, why: str
              ) -> CheckpointError:
    found = interop.model_of_tree(ckpt.params)
    return CheckpointError(
        f"the checkpoint holds {'a ' + found if found else 'an unknown'} "
        f"tree and the model is {model.name} ({why}); restore it with the "
        f"model it was trained with (--model)")


def _same_shapes(got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor]) -> Optional[str]:
    """Why ``got`` cannot load into tensors shaped as ``want``, or None."""
    if set(got) != set(want):
        return (f"missing {sorted(set(want) - set(got))[:4]}, unexpected "
                f"{sorted(set(got) - set(want))[:4]}")
    for k, v in want.items():
        if tuple(got[k].shape) != tuple(v.shape):
            return f"{k} is {tuple(got[k].shape)}, not {tuple(v.shape)}"
    return None


def _checked(ckpt: Checkpoint, model: nn.Module, tree: Dict[str, Any],
             stats: Dict[str, Any], want: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """``(tree, stats)`` of ``ckpt`` as the port's tensors keyed as
    ``want``, or :class:`CheckpointError` when they do not fit it."""
    try:
        got = interop.state_dict_from_jax(model.name, tree, stats)
    except ValueError as e:
        raise _mismatch(ckpt, model, str(e)) from None
    why = _same_shapes(got, want)
    if why:
        raise _mismatch(ckpt, model, why)
    return got


@torch.no_grad()
def restore(ckpt: Checkpoint, model: nn.Module,
            momentum: Optional[List[torch.Tensor]] = None) -> None:
    """Copy ``ckpt``'s weights and BatchNorm buffers into ``model`` and,
    unless ``momentum`` is None (serving), its momentum into ``momentum``
    (parallel to ``model.parameters()``), in place, on their devices.  A
    file whose trees are not ``model``'s (another model, another width)
    raises :class:`CheckpointError` naming both, before anything is
    copied."""
    sd = _checked(ckpt, model, ckpt.params, ckpt.batch_stats,
                  model.state_dict())
    params = dict(model.named_parameters())
    saved = None if momentum is None else \
        _checked(ckpt, model, ckpt.momentum, {}, params)
    model.load_state_dict(sd)
    if saved is not None:
        for buf, name in zip(momentum, params):
            buf.copy_(saved[name])
