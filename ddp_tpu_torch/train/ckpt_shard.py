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

**Save** (:func:`save_checkpoint_sharded`): at a model axis of 1, one
slot written by rank 0, every leaf replicated (an empty spec and no shard
dim, as the JAX package records its data-parallel leaves) and
``mesh_shape`` ``[world, 1]``; for the same state it writes the bytes the
JAX package's save at mesh ``(world, 1)`` writes.  Under ``--mesh_shape
D,M`` there are ``n_slots = M`` slots, each written by the data-row-0 rank
of its model index from its own slices (nothing is gathered; the JAX
package's per-host writers, ``ddp_tpu/train/ckpt_shard.py:170-320``):
:func:`write_slot` on ranks 1..M-1, each with a ``.sha256`` sidecar
(:func:`_write_sidecar`), and :func:`save_checkpoint_sharded` on rank 0,
which writes slot 0 (every replicated leaf and its own slices), waits for
every sidecar of this save (:func:`_collect_sidecars`) and writes the
index last.  The index records each leaf's spec, shard dim and whole shape
in the JAX package's layout (the plan's ``tree_specs``).

**Read** (:func:`assemble_checkpoint`) takes any v2 set, any ``n_slots``,
the JAX package's tensor-parallel sets included: every shard's sha256 is
checked as a stream first, then each leaf is assembled on the host, one at
a time, from the slots along its shard dim (:func:`_read_leaf`).  The
JAX package's spec lists are plain JSON lists here (``spec_to_json``,
``spec_from_json``); the port has no ``PartitionSpec``.

**Restore onto a mesh** (:func:`load_for_mesh`, :func:`shard_checkpoint`):
any v1 or v2 file, of any saved ``(d, m)``, onto any live ``(D, M)``: the
file is assembled whole (the port's models are small; the JAX package
reads only the overlapping slots of each leaf) and each leaf the live plan
shards is cut to this rank's model slice.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..interop import split_dim
from .checkpoint import (Checkpoint, CheckpointError, _SECTIONS, _unflatten,
                         decode_data_state, encode_data_state, open_npz,
                         sha256_of_file, write_npz_hashed)

SHARD_FORMAT_VERSION = 2
INDEX_KEY = "meta/shard_index_json"
# How long rank 0 waits for the other slots' sidecars before the save
# fails.
SIDECAR_TIMEOUT_SECS = 300.0


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


def _tree_spec(tree_specs: Optional[Dict[str, tuple]], key: str) -> tuple:
    """The JAX-layout spec of flat leaf ``key`` (``section/path``): the
    plan's for params and momentum, replicated for the rest."""
    section, _, path = key.partition("/")
    if tree_specs is None or section not in ("params", "momentum"):
        return ()
    return tuple(tree_specs.get(path, ()))


def write_slot(path: str, arrays: Dict[str, np.ndarray], step: int,
               epoch: int, *, slot: int, n_slots: int,
               tree_specs: Dict[str, tuple]) -> str:
    """Slot ``slot`` (> 0) of a v2 set: this rank's slices of the leaves
    ``tree_specs`` shards, from its flat ``arrays``, and the ``.sha256``
    sidecar rank 0 waits for.  Returns the file's sha256."""
    d = os.path.dirname(os.path.abspath(path))
    fpath = os.path.join(d, shard_file_name(path, epoch, slot, n_slots))
    sha = write_npz_hashed(fpath, {
        k: a for k, a in arrays.items()
        if split_dim(_tree_spec(tree_specs, k)) is not None})
    _write_sidecar(fpath, sha, step=step, epoch=epoch)
    return sha


def save_checkpoint_sharded(path: str, arrays: Dict[str, np.ndarray],
                            step: int, epoch: int, *, world: int = 1,
                            n_slots: int = 1,
                            data_state: Optional[Dict[str, Any]] = None,
                            tree_specs: Optional[Dict[str, tuple]] = None,
                            mesh_shape: Optional[Sequence[int]] = None
                            ) -> Tuple[str, List[str]]:
    """Write a v2 set from rank 0: slot 0 from ``arrays`` (``checkpoint.
    state_arrays``' flat leaves, this rank's slices of the sharded ones),
    then, with ``n_slots`` > 1, its sidecar and every other slot's awaited,
    then the index at ``path``.  ``tree_specs`` (the plan's) says which
    leaves are sharded and how; ``mesh_shape`` is the run's ``(D, M)``
    (``(world, 1)`` by default).  Returns the index's sha256 and the shard
    file names (the lineage's ``shards=``)."""
    if n_slots != 1 and tree_specs is None:
        raise ValueError(
            f"a sharded save with n_slots={n_slots} needs the plan's leaf "
            f"specs (tree_specs): they say which leaves each slot holds")
    leaves = {}
    for key, a in arrays.items():
        spec = _tree_spec(tree_specs, key)
        dim = split_dim(spec)
        shape = [int(v) for v in np.shape(a)]
        if dim is not None:
            shape[dim] *= n_slots
        leaves[key] = {"spec": spec_to_json(spec), "shape": shape,
                       "dtype": str(np.asarray(a).dtype), "shard_dim": dim}
    names = [shard_file_name(path, epoch, k, n_slots)
             for k in range(n_slots)]
    d = os.path.dirname(os.path.abspath(path))
    fpath = os.path.join(d, names[0])
    shas = {0: write_npz_hashed(fpath, dict(arrays))}
    if n_slots > 1:
        _write_sidecar(fpath, shas[0], step=step, epoch=epoch)
        shas = _collect_sidecars(d, names, step=step, epoch=epoch,
                                 have=shas)
    index = {"format": SHARD_FORMAT_VERSION,
             "mesh_shape": [int(v) for v in (mesh_shape or (world, 1))],
             "n_slots": int(n_slots),
             "shards": [{"file": names[k], "sha256": shas[k]}
                        for k in range(n_slots)],
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


def _write_sidecar(fpath: str, sha: str, *, step: int, epoch: int) -> None:
    """``fpath.sha256``: the slot file's sha256 with the save's step and
    epoch, written atomically (the directory made again if it was wiped)."""
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    tmp = f"{fpath}.sha256.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"sha256": sha, "step": int(step), "epoch": int(epoch)},
                  f)
    os.replace(tmp, f"{fpath}.sha256")


def _collect_sidecars(d: str, names: List[str], *, step: int, epoch: int,
                      have: Dict[int, str]) -> Dict[int, str]:
    """Rank 0: wait for every other slot's sidecar, matched on (step,
    epoch) so that a stale file of an earlier save of the same path never
    passes for this one."""
    deadline = time.monotonic() + SIDECAR_TIMEOUT_SECS
    out = dict(have)
    pending = [k for k in range(len(names)) if k not in out]
    while pending:
        still = []
        for k in pending:
            try:
                with open(os.path.join(d, names[k]) + ".sha256") as f:
                    rec = json.load(f)
                if (int(rec.get("step", -1)) == int(step)
                        and int(rec.get("epoch", -1)) == int(epoch)):
                    out[k] = rec["sha256"]
                    continue
            except (OSError, ValueError, KeyError):
                pass
            still.append(k)
        pending = still
        if pending:
            if time.monotonic() > deadline:
                raise CheckpointError(
                    f"sharded save: peer shard(s) "
                    f"{[names[k] for k in pending]} never landed within "
                    f"{SIDECAR_TIMEOUT_SECS:.0f}s; is the checkpoint "
                    "directory on shared storage?")
            time.sleep(0.05)
    return out


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


# -- the restore onto a mesh -----------------------------------------------


def _slice_tree(tree: Dict[str, Any], tree_specs: Dict[str, tuple],
                n: int, k: int, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, v in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(v, dict):
            out[key] = _slice_tree(v, tree_specs, n, k, path)
            continue
        dim = split_dim(tuple(tree_specs.get(path, ())))
        if dim is not None:
            w = v.shape[dim] // n
            v = np.ascontiguousarray(np.take(v, range(k * w, (k + 1) * w),
                                             axis=dim))
        out[key] = v
    return out


def shard_checkpoint(ckpt: Checkpoint, plan, model_index: int
                     ) -> Checkpoint:
    """``ckpt`` (whole trees, any saved layout) cut to model index
    ``model_index``'s slices under the live ``plan``: the weights and the
    momentum the plan shards, in the JAX package's layout, which
    ``checkpoint.restore`` loads into the rank's sharded model.  ``ckpt``
    itself without a plan or at a model axis of 1."""
    if plan is None or plan.model_size == 1:
        return ckpt
    specs, n = plan.tree_specs, plan.model_size
    return ckpt._replace(
        params=_slice_tree(ckpt.params, specs, n, model_index),
        momentum=_slice_tree(ckpt.momentum, specs, n, model_index))


def load_for_mesh(path: str, plan=None, model_index: int = 0,
                  pp_plan=None, stage: int = 0) -> Checkpoint:
    """The v1 file or v2 set at ``path`` (any saved mesh) for the live
    layout: model index ``model_index``'s slices under ``plan``
    (:func:`shard_checkpoint`), and under a stage plan ``pp_plan`` stage
    ``stage``'s subtrees of them (``parallel/pp/schedule.py::
    stage_checkpoint``), or the whole state without either.  Raises
    :class:`CheckpointError` where ``load_checkpoint`` does."""
    from .checkpoint import load_checkpoint
    ckpt = shard_checkpoint(load_checkpoint(path), plan, model_index)
    if pp_plan is None:
        return ckpt
    from ..parallel.pp.schedule import stage_checkpoint
    return stage_checkpoint(ckpt, pp_plan, stage)
