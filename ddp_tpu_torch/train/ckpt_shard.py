"""The sharded (format_version 2) checkpoint (counterpart of
``ddp_tpu/train/ckpt_shard.py``): one shard file per model-axis slot plus a
small index at the head path, either package reading the other's.

The format, as the JAX package writes it:

- each shard file ``P.ep<8 digits>.shard<5 digits>-of-<5 digits>.npz``
  (:func:`shard_file_name`, epoch-qualified so rotation never invalidates
  a retained epoch's set) holds slot k's slice of every leaf that is
  sharded over the model axis, and slot 0 every replicated leaf, under the
  v1 file's ``section/key`` names;
- the index at ``P`` holds ``meta/format_version`` (2), ``meta/step``,
  ``meta/epoch``, ``meta/data_state_json`` and :data:`INDEX_KEY`, a JSON
  blob ``{"format", "mesh_shape", "n_slots", "shards": [{"file",
  "sha256"}], "leaves": {key: {"spec", "shape", "dtype", "shard_dim"}}}``.

The lineage manifest hashes and rotates the index, so the walk's torn-file
fallback carries over: a torn or missing shard fails the candidate with a
named :class:`~ddp_tpu_torch.train.checkpoint.CheckpointError`.

**Save** (:func:`save_checkpoint_sharded`) is at the port's one layout, a
model axis of 1: one slot, written by rank 0, every leaf replicated (an
empty spec and no shard dim, as the JAX package records its data-parallel
leaves) and ``mesh_shape`` ``[world, 1]``.  For the same state it writes
the bytes the JAX package's save at mesh ``(world, 1)`` writes.  More
slots need a model axis (ROADMAP A10): the per-host writers and the
multi-host ``.sha256`` sidecars come with it, and a save with ``n_slots >
1`` is refused by name.

**Read** (:func:`assemble_checkpoint`) takes any v2 set, any ``n_slots``,
the JAX package's tensor-parallel sets included: every shard's sha256 is
checked as a stream first, then each leaf is assembled on the host, one at
a time, from the slots along its shard dim (:func:`_read_leaf`).  The
JAX package's spec lists are plain JSON lists here (``spec_to_json``,
``spec_from_json``); the port has no ``PartitionSpec``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .checkpoint import (Checkpoint, CheckpointError, _SECTIONS, _unflatten,
                         decode_data_state, encode_data_state, open_npz,
                         sha256_of_file, write_npz_hashed)

SHARD_FORMAT_VERSION = 2
INDEX_KEY = "meta/shard_index_json"


class UnportedLayoutError(CheckpointError):
    """A sharded save the port cannot write yet: more than one model-axis
    slot (ROADMAP A10)."""


def shard_file_name(path: str, epoch: int, slot: int, n_slots: int) -> str:
    """The shard file name of ``slot`` of ``n_slots`` for the head path
    ``path``'s state of ``epoch`` (a sibling of the head)."""
    return (f"{os.path.basename(path)}.ep{int(epoch):08d}"
            f".shard{slot:05d}-of-{n_slots:05d}.npz")


def spec_to_json(spec: Sequence) -> list:
    """A partition spec (a sequence of entries: ``None``, an axis name or a
    sequence of axis names) as the index's JSON list."""
    return [e if e is None or isinstance(e, str) else list(e)
            for e in spec]


def spec_from_json(entries) -> tuple:
    """Inverse of :func:`spec_to_json`."""
    return tuple(tuple(e) if isinstance(e, list) else e
                 for e in (entries or []))


# -- save side -------------------------------------------------------------


def save_checkpoint_sharded(path: str, arrays: Dict[str, np.ndarray],
                            step: int, epoch: int, *, world: int = 1,
                            n_slots: int = 1,
                            data_state: Optional[Dict[str, Any]] = None
                            ) -> Tuple[str, List[str]]:
    """Write ``arrays`` (``checkpoint.state_arrays``' flat leaves) as a v2
    set: the one shard file, then the index at ``path``.  Returns the
    index's sha256 and the shard file names (the lineage's ``shards=``)."""
    if n_slots != 1:
        raise UnportedLayoutError(
            f"a sharded save with n_slots={n_slots} needs a model axis, and "
            f"its per-host writers, which the port does not have yet "
            f"(ROADMAP A10); the port writes n_slots=1")
    leaves = {key: {"spec": spec_to_json(()),
                    "shape": [int(s) for s in np.shape(a)],
                    "dtype": str(np.asarray(a).dtype), "shard_dim": None}
              for key, a in arrays.items()}
    names = [shard_file_name(path, epoch, 0, 1)]
    d = os.path.dirname(os.path.abspath(path))
    sha = write_npz_hashed(os.path.join(d, names[0]), dict(arrays))
    index = {"format": SHARD_FORMAT_VERSION,
             "mesh_shape": [int(world), 1], "n_slots": 1,
             "shards": [{"file": names[0], "sha256": sha}],
             "leaves": leaves}
    flat = {"meta/format_version": np.asarray(SHARD_FORMAT_VERSION,
                                              np.int64),
            "meta/step": np.asarray(int(step), np.int64),
            "meta/epoch": np.asarray(int(epoch), np.int64),
            INDEX_KEY: np.frombuffer(json.dumps(index).encode(),
                                     dtype=np.uint8)}
    blob = encode_data_state(data_state)
    if blob is not None:
        flat["meta/data_state_json"] = blob
    return write_npz_hashed(path, flat), names


# -- read side -------------------------------------------------------------


def read_shard_index(path: str) -> Optional[Dict[str, Any]]:
    """The v2 index at ``path`` (with ``step``, ``epoch`` and
    ``data_state`` folded in), or None for a v1 file.
    :class:`CheckpointError` on a torn or future-format file."""
    with open_npz(path) as z:
        ver = (int(z["meta/format_version"])
               if "meta/format_version" in z.files else 1)
        if ver > SHARD_FORMAT_VERSION:
            raise CheckpointError(
                f"checkpoint {path!r} has format_version {ver}, newer "
                f"than this build's {SHARD_FORMAT_VERSION}; upgrade "
                "ddp_tpu_torch to restore it")
        if INDEX_KEY not in z.files:
            if ver >= SHARD_FORMAT_VERSION:
                raise CheckpointError(
                    f"checkpoint {path!r} claims format_version {ver} but "
                    "carries no shard index; the file is damaged")
            return None
        try:
            index = json.loads(bytes(bytearray(z[INDEX_KEY])).decode())
            index["step"] = int(z["meta/step"])
            index["epoch"] = int(z["meta/epoch"])
            index["data_state"] = decode_data_state(
                z["meta/data_state_json"]
                if "meta/data_state_json" in z.files else None)
            n_slots = int(index["n_slots"])
            for entry in index.get("leaves", {}).values():
                entry["n_slots"] = n_slots
        except Exception as e:  # bad JSON, keys, CRC of a member
            raise CheckpointError(
                f"checkpoint {path!r} has an unparseable shard index "
                f"({type(e).__name__}: {e}); the file is damaged") from e
    return index


def open_shard_set(path: str, index: Dict[str, Any]) -> Dict[int, Any]:
    """slot -> open ``NpzFile`` for every shard the index names, each
    file's sha256 checked against the index first (a streamed pass), so a
    torn or missing shard fails here, named."""
    d = os.path.dirname(os.path.abspath(path))
    out: Dict[int, Any] = {}
    try:
        for slot, rec in enumerate(index.get("shards", [])):
            fpath = os.path.join(d, str(rec.get("file", "")))
            if not os.path.exists(fpath):
                raise CheckpointError(
                    f"checkpoint {path!r}: shard file {rec.get('file')!r} "
                    "is MISSING; the shard set is incomplete — fall back "
                    "to a retained snapshot")
            if rec.get("sha256") and sha256_of_file(fpath) != rec["sha256"]:
                raise CheckpointError(
                    f"checkpoint {path!r}: shard file {rec.get('file')!r} "
                    "sha256 mismatch (torn or damaged shard) — fall back "
                    "to a retained snapshot")
            out[slot] = open_npz(fpath)
        return out
    except BaseException:
        for z in out.values():
            z.close()
        raise


def _read_leaf(zs: Dict[int, Any], key: str, entry: Dict[str, Any],
               path: str) -> np.ndarray:
    """One whole leaf from the shard set: slot 0's array for a replicated
    leaf, else every slot's slice joined along the saved shard dim (the
    JAX package's ``_read_range`` over the full index)."""
    dim = entry["shard_dim"]
    slots = range(int(entry["n_slots"])) if dim is not None else [0]
    parts = []
    for slot in slots:
        z = zs.get(slot)
        if z is None or key not in z.files:
            raise CheckpointError(
                f"checkpoint {path!r}: array {key!r} missing from shard "
                f"slot {slot}; the shard set is inconsistent")
        try:
            parts.append(z[key])
        except Exception as e:
            raise CheckpointError(
                f"checkpoint {path!r}: shard member {key!r} is unreadable "
                f"({type(e).__name__}: {e}); torn shard") from e
    leaf = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=dim)
    if list(leaf.shape) != list(entry["shape"]):
        raise CheckpointError(
            f"checkpoint {path!r}: {key!r} assembles to {leaf.shape}, the "
            f"index says {tuple(entry['shape'])}; the shard set is "
            f"inconsistent")
    return leaf


def assemble_checkpoint(path: str) -> Checkpoint:
    """The v2 set at ``path`` as a :class:`Checkpoint` of host arrays (the
    ``load_checkpoint`` delegate): every shard verified, then each leaf
    assembled whole, one at a time."""
    index = read_shard_index(path)
    if index is None:
        raise CheckpointError(
            f"checkpoint {path!r} is not a sharded (v2) checkpoint")
    zs = open_shard_set(path, index)
    try:
        sections: Dict[str, Dict[str, Any]] = {s: {} for s in _SECTIONS}
        for key, entry in index.get("leaves", {}).items():
            section, _, rest = key.partition("/")
            if section in sections:
                sections[section][rest] = _read_leaf(zs, key, entry, path)
    finally:
        for z in zs.values():
            z.close()
    if not sections["params"] or not sections["momentum"]:
        raise CheckpointError(
            f"checkpoint {path!r} has a shard index but no params/momentum "
            "leaves; it was not written by ddp_tpu or is damaged")
    return Checkpoint(params=_unflatten(sections["params"]),
                      batch_stats=_unflatten(sections["batch_stats"]),
                      momentum=_unflatten(sections["momentum"]),
                      step=int(index["step"]), epoch=int(index["epoch"]),
                      data_state=index.get("data_state"))
