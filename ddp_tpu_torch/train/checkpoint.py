"""Checkpoint save and restore (counterpart of ``ddp_tpu/train/checkpoint.py``).

The gathered file is the JAX package's v1 file, key for key and layout for
layout, so either package restores what the other wrote, for each of the
three models: one ``.npz`` of flat ``section/key/subkey`` arrays (``/``
joins the nesting; ResNet's keys hold dots, ``layer1.block0``),

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
:func:`load_checkpoint` hands a sharded (format_version 2) index to
``train/ckpt_shard.py``, which verifies and assembles its shard set, and
refuses a format newer than 2 (:class:`UnportedFormatError`), as the JAX
package refuses one.  Retention, the sha256 manifest and the restore walk
over retained files are ``resilience/lineage.py``'s.

:class:`HostSnapshot` is the trainer's asynchronous save's copy of the
state: the live tensors are updated in place by the next step, so the
writer thread reads a host pool that the copies filled, never them.
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
# The newest format this build reads: the sharded index (ckpt_shard.py).
FORMAT_VERSION = 2


class CheckpointError(ValueError):
    """A checkpoint file that cannot be restored (torn write, foreign file,
    or a format the port does not read), named with its path."""


class UnportedFormatError(CheckpointError):
    """A checkpoint whose ``format_version`` is newer than this build's
    :data:`FORMAT_VERSION`.  The lineage walk falls back past it, as past
    any file it cannot restore."""


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


def state_arrays(name: str, state_dict: Dict[str, torch.Tensor],
                 momentum: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Model ``name``'s ``state_dict`` and its momentum (keyed by parameter
    name) as the checkpoint's flat ``params/``, ``batch_stats/`` and
    ``momentum/`` arrays, in the file's order (sections in turn, keys
    sorted within each)."""
    params, stats = interop.jax_from_state_dict(name, state_dict)
    trees = (params, stats, interop.jax_from_state_dict(name, momentum)[0])
    flat: Dict[str, np.ndarray] = {}
    for section, tree in zip(_SECTIONS, trees):
        sect: Dict[str, np.ndarray] = {}
        _flatten(tree, "", sect)
        flat.update({f"{section}/{k}": v for k, v in sect.items()})
    return flat


def encode_data_state(data_state: Optional[Dict[str, Any]]):
    """A ``data_state`` dict as an npz member (a uint8 JSON blob), or None
    when there is nothing to record; shared by the v1 file and the v2
    index."""
    if data_state is None:
        return None
    return np.frombuffer(json.dumps(data_state).encode("utf-8"), np.uint8)


def write_gathered(path: str, arrays: Dict[str, np.ndarray], step: int,
                   epoch: int, data_state: Optional[Dict[str, Any]] = None
                   ) -> str:
    """Write :func:`state_arrays`' ``arrays`` with ``step``, ``epoch`` and
    ``data_state`` to ``path`` as a v1 file, atomically; returns its
    sha256."""
    flat = dict(arrays)
    flat["meta/step"] = np.asarray(int(step), np.int64)
    flat["meta/epoch"] = np.asarray(int(epoch), np.int64)
    flat["meta/format_version"] = np.asarray(GATHERED_FORMAT_VERSION,
                                             np.int64)
    blob = encode_data_state(data_state)
    if blob is not None:
        flat["meta/data_state_json"] = blob
    return write_npz_hashed(path, flat)


def _named_momentum(model: nn.Module, momentum: List[torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    return dict(zip((n for n, _ in model.named_parameters()), momentum))


def save_checkpoint(path: str, model: nn.Module,
                    momentum: List[torch.Tensor], step: int, epoch: int,
                    data_state: Optional[Dict[str, Any]] = None) -> str:
    """Write ``model``'s weights and BatchNorm buffers, the SGD
    ``momentum`` (parallel to ``model.parameters()``), ``step`` and
    ``epoch`` to ``path`` as a v1 file, atomically; returns its sha256."""
    return write_gathered(path, state_arrays(
        model.name, model.state_dict(), _named_momentum(model, momentum)),
        step, epoch, data_state)


class HostSnapshot:
    """A host copy of a model's ``state_dict`` and momentum, taken on the
    caller's thread and read on another (the trainer's asynchronous
    checkpoint writer).

    The pool is allocated at the first :meth:`capture` and reused: pinned
    memory on a card, where each tensor is copied with ``non_blocking`` on
    the current stream and an event is recorded after the copies.  The
    stream's order puts the next step's in-place updates after the copies,
    so the pool holds the state as of the capture; :meth:`arrays` waits on
    the event before it reads.  On the CPU the copies are synchronous.  A
    capture overwrites the pool: the caller joins the previous reader
    first."""

    def __init__(self):
        self._sd: Optional[Dict[str, torch.Tensor]] = None
        self._momentum: Optional[Dict[str, torch.Tensor]] = None
        self._event: Optional[torch.cuda.Event] = None
        self.name: Optional[str] = None

    @staticmethod
    def _pool(tensors: Dict[str, torch.Tensor], pin: bool
              ) -> Dict[str, torch.Tensor]:
        return {k: torch.empty(v.shape, dtype=v.dtype, device="cpu",
                               pin_memory=pin) for k, v in tensors.items()}

    def capture(self, model: nn.Module, momentum: List[torch.Tensor]
                ) -> None:
        """Copy ``model``'s state and ``momentum`` into the pool."""
        self.capture_state(model.name, model.state_dict(),
                           _named_momentum(model, momentum))

    @torch.no_grad()
    def capture_state(self, name: str, sd: Dict[str, torch.Tensor],
                      mom: Dict[str, torch.Tensor]) -> None:
        """Copy model ``name``'s ``state_dict`` ``sd`` and its momentum
        ``mom`` (keyed by parameter name) into the pool: a model's own, or
        the whole state a tensor-parallel run gathered."""
        cuda = next(iter(sd.values())).device.type == "cuda"
        if self._sd is None or self.name != name or any(
                self._sd[k].shape != v.shape for k, v in sd.items()):
            self._sd, self._momentum = self._pool(sd, cuda), \
                self._pool(mom, cuda)
        self.name = name
        for pool, src in ((self._sd, sd), (self._momentum, mom)):
            for k, v in src.items():
                pool[k].copy_(v, non_blocking=cuda)
        self._event = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def arrays(self) -> Dict[str, np.ndarray]:
        """The captured state as :func:`state_arrays`, once the copies have
        landed."""
        if self._event is not None:
            self._event.synchronize()
        return state_arrays(self.name, self._sd, self._momentum)


def decode_data_state(blob) -> Optional[Dict[str, Any]]:
    """Inverse of :func:`encode_data_state`.  A missing or unparseable
    record reads as None (epoch-boundary resume), as in the JAX
    package."""
    if blob is None:
        return None
    try:
        ds = json.loads(np.asarray(blob, np.uint8).tobytes().decode("utf-8"))
    except ValueError:  # bad UTF-8 or JSON
        return None
    return ds if isinstance(ds, dict) else None


def open_npz(path: str):
    """``np.load`` with a torn or foreign file as :class:`CheckpointError`
    (a missing path keeps ``FileNotFoundError``)."""
    try:
        return np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:  # BadZipFile, OSError, pickle guard, EOF
        raise CheckpointError(
            f"checkpoint {path!r} is not a readable npz archive "
            f"({type(e).__name__}: {e}); the file is torn or is not a "
            f"ddp_tpu checkpoint") from e


def load_checkpoint(path: str) -> Checkpoint:
    """Read a v1 file or a v2 sharded index written by either package.
    Raises :class:`CheckpointError` on a torn or foreign file, a member
    that fails its CRC, a torn or missing shard, or a format newer than
    :data:`FORMAT_VERSION` (:class:`UnportedFormatError`); a missing path
    keeps ``FileNotFoundError``."""
    with open_npz(path) as z:
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
    if version > FORMAT_VERSION:
        raise UnportedFormatError(
            f"checkpoint {path!r} has format_version {version}, newer than "
            f"this build's {FORMAT_VERSION}; upgrade ddp_tpu_torch to "
            f"restore it")
    if version == 2:
        from .ckpt_shard import assemble_checkpoint
        return assemble_checkpoint(path)
    if version != GATHERED_FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path!r} has format_version {version}; the port "
            f"reads format_versions 1 and 2")
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
        data_state=decode_data_state(flat.get("meta/data_state_json")))


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
    copied.  A tensor-parallel rank's model holds its slices: hand it
    ``ckpt_shard.shard_checkpoint``'s cut of the file."""
    sd = _checked(ckpt, model, ckpt.params, ckpt.batch_stats,
                  model.state_dict())
    params = dict(model.named_parameters())
    saved = None if momentum is None else \
        _checked(ckpt, model, ckpt.momentum, {}, params)
    model.load_state_dict(sd)
    if saved is not None:
        for buf, name in zip(momentum, params):
            buf.copy_(saved[name])
