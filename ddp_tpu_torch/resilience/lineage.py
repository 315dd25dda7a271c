"""Checkpoint lineage: retained rotating snapshots and a sha256 manifest
(counterpart of ``ddp_tpu/resilience/lineage.py``, a copy: the JAX
module needs only numpy, but the port imports nothing of ``ddp_tpu``).

The reference overwrites one fixed ``checkpoint.pt`` in place
(multigpu.py:111).  ``save_checkpoint`` writes atomically, so a crash
mid-save never tears the head, but outside damage (a preempted copy, a
truncated upload) can; the lineage keeps older states to fall back to.

Layout (all siblings of the head path ``P``), byte for byte the JAX
package's, so a lineage written by either package is walked by the other:
  ``P``                    the head, always the newest checkpoint
  ``P.ep<NNNNNNNN>``       rotated snapshots of former heads (hard links
                           made before each overwrite, so the old inode
                           survives ``os.replace``), newest ``keep - 1``
  ``P.manifest.json``      ``{"format": 1, "head": {...}, "retained":
                           [...]}``: per file its name, epoch, step,
                           sha256, size and the head's ``data_state``,
                           written atomically after each head write

One writer: rank 0 runs preserve, write and commit in turn on the
trainer's thread (the port's checkpoint write is synchronous), so rotation
never touches a file being written (an in-flight write is a ``*.tmp``
name this module never touches).

Not here yet (ROADMAP A7b, the storage half): the mirror tier (the JAX
walk's ``store=`` fallback and the manifest's ``mirror`` stamps) and the
sharded v2 format's shard entries.  The walk refuses both by name rather
than fall back past them.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..train.checkpoint import (Checkpoint, CheckpointError,
                                UnportedFormatError, load_checkpoint,
                                sha256_of_file)

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_FORMAT = 1


def lineage_name(path: str, epoch: int) -> str:
    """Rotated-snapshot name for the head state of ``epoch``."""
    return f"{path}.ep{int(epoch):08d}"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.stderr.flush()


def _fsync_dir(d: str) -> None:
    """fsync a directory, where the platform and filesystem allow it."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The head path's manifest, or None when absent or unparseable (a torn
    manifest is logged and treated as missing: the files themselves are
    still tried, so a damaged 1 KB JSON never blocks a restore)."""
    mpath = path + MANIFEST_SUFFIX
    try:
        with open(mpath) as f:
            m = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        _log(f"WARNING: checkpoint manifest {mpath!r} is unreadable "
             f"({type(e).__name__}: {e}); proceeding without sha "
             "verification")
        return None
    return m if isinstance(m, dict) else None


def _refuse_sharded(entry: Any, path: str) -> None:
    if isinstance(entry, dict) and entry.get("shards"):
        raise UnportedFormatError(
            f"checkpoint lineage {path!r} lists a sharded (format_version "
            f"2) snapshot {entry.get('file')!r}; the sharded format is not "
            f"ported yet (ROADMAP A7b)")


class CheckpointLineage:
    """Rank-0 retention bookkeeping around one head checkpoint path."""

    def __init__(self, path: str, keep: int = 1):
        if keep < 1:
            raise ValueError(f"keep_checkpoints must be >= 1, got {keep}")
        self.path = path
        self.keep = int(keep)
        self.manifest_path = path + MANIFEST_SUFFIX

    def preserve_head(self) -> None:
        """Hard-link the current head to its epoch-numbered lineage name
        before the next save overwrites it (``os.replace`` drops the old
        inode's last name otherwise).  A no-op with ``keep == 1``, with no
        head yet, or when the head is unreadable (a torn head is not worth
        an epoch slot)."""
        if self.keep < 2 or not os.path.exists(self.path):
            return
        epoch = self._head_epoch()
        if epoch is None:
            return
        dst = lineage_name(self.path, epoch)
        if os.path.exists(dst):
            # A resumed run commits an epoch again: the head is the newest
            # authority for it, so it replaces the old name.
            try:
                os.unlink(dst)
            except OSError:
                return
        try:
            os.link(self.path, dst)
        except OSError:
            try:  # filesystems without hard links
                shutil.copy2(self.path, dst)
            except OSError as e:
                _log(f"WARNING: could not preserve outgoing checkpoint "
                     f"{self.path!r} as {dst!r} ({e}); retention shrinks "
                     "by one this round")

    def _head_epoch(self) -> Optional[int]:
        # From the file, not the manifest: a torn head fails the read, so
        # the answer doubles as a tear check.
        try:
            with np.load(self.path) as z:
                return int(z["meta/epoch"])
        except Exception:  # any damage: the head is not worth keeping
            return None

    def commit(self, *, epoch: int, step: int, sha256: str,
               data_state: Optional[Dict[str, Any]] = None) -> None:
        """Record the just-written head and trim retention to ``keep``
        states (the head plus ``keep - 1`` rotated snapshots)."""
        m = read_manifest(self.path) or {}
        retained: List[Dict[str, Any]] = [
            e for e in m.get("retained", []) if isinstance(e, dict)]
        prev_head = m.get("head")
        if isinstance(prev_head, dict) and self.keep >= 2 and \
                "epoch" in prev_head:
            fname = os.path.basename(
                lineage_name(self.path, int(prev_head["epoch"])))
            if os.path.exists(self._resolve(fname)):
                retained.insert(0, {**prev_head, "file": fname})
        # Dedupe by file name (a resume commits epochs again), newest first.
        seen: set = set()
        retained = [e for e in retained
                    if e.get("file") not in seen
                    and not seen.add(e.get("file"))]
        for dropped in retained[max(self.keep - 1, 0):]:
            self._unlink_rotated(dropped.get("file"))
        retained = retained[:max(self.keep - 1, 0)]
        head: Dict[str, Any] = {"file": os.path.basename(self.path),
                                "epoch": int(epoch), "step": int(step),
                                "sha256": sha256,
                                "size": os.path.getsize(self.path)}
        if data_state is not None:
            # The checkpoint's own resume position, readable from the 1 KB
            # manifest; the checkpoint file stays authoritative.
            head["data_state"] = data_state
        manifest = {"format": MANIFEST_FORMAT, "head": head,
                    "retained": retained}
        d = os.path.dirname(os.path.abspath(self.manifest_path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            # The bytes reach the disk before the rename publishes them,
            # and the directory after, so the rename itself is durable.
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.manifest_path)
            _fsync_dir(d)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _resolve(self, fname: str) -> str:
        return os.path.join(os.path.dirname(os.path.abspath(self.path)),
                            fname)

    def _unlink_rotated(self, fname) -> None:
        """Delete a dropped rotation target: only ever a ``P.ep*`` sibling
        this module made; the head and an in-flight ``*.tmp`` are never
        candidates."""
        if not fname or not str(fname).startswith(
                os.path.basename(self.path) + ".ep"):
            return
        try:
            os.unlink(self._resolve(str(fname)))
        except OSError:
            pass  # already gone: retention is best-effort


def _candidates(path: str) -> List[Tuple[str, Optional[str]]]:
    """(file, expected sha256) restore candidates, newest first: the head,
    then the manifest's retained snapshots; without a manifest, the
    ``P.ep<digits>`` siblings, newest epoch first."""
    m = read_manifest(path)
    out: List[Tuple[str, Optional[str]]] = []
    head_sha = None
    if m is not None and isinstance(m.get("head"), dict):
        _refuse_sharded(m["head"], path)
        head_sha = m["head"].get("sha256")
    if os.path.exists(path):
        out.append((path, head_sha))
    if m is not None:
        for e in m.get("retained", []):
            if not isinstance(e, dict) or not e.get("file"):
                continue
            _refuse_sharded(e, path)
            fp = os.path.join(os.path.dirname(os.path.abspath(path)),
                              str(e["file"]))
            if os.path.exists(fp):
                out.append((fp, e.get("sha256")))
            else:
                _log(f"WARNING: checkpoint manifest lists {fp!r} but the "
                     "file is gone; skipping it as a restore candidate")
    else:
        # Rotated heads are exactly ``P.ep<digits>``; the sharded format's
        # ``P.ep*.shard*`` files share the namespace and are not candidates.
        rotated = sorted(
            (fp for fp in glob.glob(glob.escape(path) + ".ep*")
             if re.fullmatch(r"\.ep\d+", fp[len(path):])),
            reverse=True)
        out.extend((fp, None) for fp in rotated)
    return out


def _resolve_head(path: str) -> str:
    """A head checkpoint path, or a directory holding one: the head its
    manifest names, or without a manifest the reference's
    ``checkpoint.pt`` (multigpu.py:111).  Several manifests in one
    directory are an error, not a guess."""
    if not os.path.isdir(path):
        return path
    manifests = sorted(glob.glob(os.path.join(glob.escape(path),
                                              "*" + MANIFEST_SUFFIX)))
    if len(manifests) > 1:
        raise CheckpointError(
            f"checkpoint directory {path!r} holds {len(manifests)} lineage "
            f"manifests ({[os.path.basename(m) for m in manifests]}); pass "
            "the head checkpoint path explicitly")
    if manifests:
        return manifests[0][:-len(MANIFEST_SUFFIX)]
    return os.path.join(path, "checkpoint.pt")


def latest_verifiable(path: Optional[str], store=None
                      ) -> Optional[Tuple[Checkpoint, str]]:
    """The newest verifiable checkpoint under ``path`` (a head path, or a
    directory resolved by :func:`_resolve_head`): the one walk both the
    trainer's resume and restore and the serve engine's load go through.

    Tries the head, then each retained snapshot newest first.  A candidate
    whose manifest sha256 mismatches is logged and still tried (a stale
    manifest must not discard a good head); one that ``load_checkpoint``
    rejects (torn or foreign) is logged and skipped.  A sharded (v2)
    candidate raises
    :class:`~ddp_tpu_torch.train.checkpoint.UnportedFormatError`, as does
    ``store`` (the mirror tier): both belong to ROADMAP A7b.

    Returns ``(checkpoint, file used)``; None when no candidate exists
    (fresh training); raises ``CheckpointError`` naming every candidate
    tried when candidates exist but none restores."""
    if store is not None:
        raise UnportedFormatError(
            "the mirror tier (latest_verifiable's store=, --mirror) is not "
            "ported yet (ROADMAP A7b)")
    if not path:
        return None
    path = _resolve_head(path)
    cands = _candidates(path)
    tried: List[Tuple[str, str]] = []
    for fp, expected_sha in cands:
        if expected_sha:
            try:
                actual = sha256_of_file(fp)
            except OSError as e:
                tried.append((fp, f"unreadable ({e})"))
                continue
            if actual != expected_sha:
                _log(f"WARNING: checkpoint {fp!r} sha256 mismatch vs "
                     "manifest (stale manifest or file damage); attempting "
                     "restore anyway")
        try:
            ck = load_checkpoint(fp)
        except FileNotFoundError:
            tried.append((fp, "vanished before it could be read"))
            continue
        except UnportedFormatError:
            raise
        except CheckpointError as e:
            tried.append((fp, str(e)))
            _log(f"WARNING: checkpoint {fp!r} is not restorable ({e}); "
                 "falling back to the next retained snapshot")
            continue
        if fp != path:
            _log(f"WARNING: restored FALLBACK checkpoint {fp!r} "
                 f"(epoch {ck.epoch}) — the head {path!r} was torn or "
                 "missing")
        return ck, fp
    if not cands and not tried:
        return None
    raise CheckpointError(
        f"no verifiable checkpoint under {path!r}; candidates tried: "
        + "; ".join(f"{fp!r}: {why}" for fp, why in tried))


def head_fingerprint(path: Optional[str]):
    """A cheap token that changes whenever a new head lands under ``path``,
    read from the manifest alone (a manifest-less head gives its stat
    signature); None when nothing resolvable exists yet.  A change is a
    hint to run :func:`latest_verifiable`, never a load decision: a torn
    head changes it too."""
    if not path:
        return None
    try:
        head = _resolve_head(path)
    except CheckpointError:
        return None
    m = read_manifest(head)
    if m is not None and isinstance(m.get("head"), dict):
        h = m["head"]
        return ("manifest", h.get("epoch"), h.get("step"), h.get("sha256"))
    try:
        st = os.stat(head)
    except OSError:
        return None
    return ("stat", st.st_mtime_ns, st.st_size, None)
