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

Shard entries: a head written with ``--ckpt_format sharded`` is a v2 index
whose manifest entry lists its shard files (``"shards"``); each commit
unlinks exactly the shard files no surviving entry references any more.
The mirror tier: with ``mirror_state`` set (``resilience/store.py``'s
uploader), each entry is stamped ``"mirror": "pending"`` or
``"mirrored"``, and :func:`latest_verifiable`'s ``store=`` falls back to
the mirror's objects when no local candidate restores.

One writer: rank 0 runs preserve, write and commit in turn on the
trainer's checkpoint writer thread (one in flight at a time), so rotation
never touches a file being written (an in-flight write is a ``*.tmp``
name this module never touches).
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

from ..train.checkpoint import (Checkpoint, CheckpointError, load_checkpoint,
                                sha256_of_file)

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_FORMAT = 1


def _entry_shards(entry) -> List[str]:
    """A manifest entry's shard file names (none for a v1 head or a
    malformed entry)."""
    if not isinstance(entry, dict):
        return []
    return [str(s) for s in entry.get("shards", []) if s]


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


class CheckpointLineage:
    """Rank-0 retention bookkeeping around one head checkpoint path."""

    def __init__(self, path: str, keep: int = 1):
        if keep < 1:
            raise ValueError(f"keep_checkpoints must be >= 1, got {keep}")
        self.path = path
        self.keep = int(keep)
        self.manifest_path = path + MANIFEST_SUFFIX
        # The mirror tier's hook: epoch -> "pending" / "mirrored", stamped
        # on each entry at commit.  Set once before the writer starts and
        # called only from it; None without a mirror (no stamps).
        self.mirror_state = None

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
               shards: Optional[List[str]] = None,
               data_state: Optional[Dict[str, Any]] = None) -> None:
        """Record the just-written head and trim retention to ``keep``
        states (the head plus ``keep - 1`` rotated snapshots).  ``shards``
        names a v2 head's shard files; the files of a dropped entry that
        no surviving entry (nor the new head) references are unlinked."""
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
        # Shard files referenced before this commit, dropped entries'
        # included...
        old_shards = set(_entry_shards(prev_head))
        for e in retained:
            old_shards |= set(_entry_shards(e))
        for dropped in retained[max(self.keep - 1, 0):]:
            self._unlink_rotated(dropped.get("file"))
        retained = retained[:max(self.keep - 1, 0)]
        head: Dict[str, Any] = {"file": os.path.basename(self.path),
                                "epoch": int(epoch), "step": int(step),
                                "sha256": sha256,
                                "size": os.path.getsize(self.path)}
        if shards:
            head["shards"] = [os.path.basename(s) for s in shards]
        if data_state is not None:
            # The checkpoint's own resume position, readable from the 1 KB
            # manifest; the checkpoint file stays authoritative.
            head["data_state"] = data_state
        # ...less those still referenced after it: the ones to trim.
        new_shards = set(_entry_shards(head))
        for e in retained:
            new_shards |= set(_entry_shards(e))
        for fname in sorted(old_shards - new_shards):
            self._unlink_shard(fname)
        if self.mirror_state is not None:
            head["mirror"] = self.mirror_state(int(epoch))
            for e in retained:
                if e.get("mirror") != "mirrored" and "epoch" in e:
                    e["mirror"] = self.mirror_state(int(e["epoch"]))
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

    def _unlink_shard(self, fname) -> None:
        """Delete one dropped shard file (and a multi-host ``.sha256``
        sidecar beside it): only the epoch-qualified ``P.ep*.shard*`` names
        the sharded save makes."""
        name = str(fname or "")
        if not (name.startswith(os.path.basename(self.path) + ".ep")
                and ".shard" in name):
            return
        for victim in (name, name + ".sha256"):
            try:
                os.unlink(self._resolve(victim))
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
        head_sha = m["head"].get("sha256")
    if os.path.exists(path):
        out.append((path, head_sha))
    if m is not None:
        for e in m.get("retained", []):
            if not isinstance(e, dict) or not e.get("file"):
                continue
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


def _restore_from_mirror(path: str, store, tried: List[Tuple[str, str]]
                         ) -> Optional[Tuple[Checkpoint, str]]:
    """The mirror tier of :func:`latest_verifiable`: download the mirror
    manifest's objects (head first, then retained, newest first) back
    into the head's directory, recreating it when the whole local
    directory is gone, and load each as the local walk would.  A v1 head
    is one object; a v2 entry is its index plus every shard file it lists.
    Failures are added to ``tried``."""
    base = os.path.basename(path)
    d = os.path.dirname(os.path.abspath(path))
    mname = base + MANIFEST_SUFFIX
    try:
        if store.stat(mname) is None:
            return None  # nothing ever mirrored: not an error
        rm = json.loads(store.get_bytes(mname).decode())
    except Exception as e:  # any store or parse damage
        tried.append((f"<mirror>/{mname}",
                      f"mirror manifest unreadable ({e})"))
        _log(f"WARNING: mirror manifest {mname!r} in {store.describe()} "
             f"is unreadable ({e}); no mirror fallback")
        return None
    if not isinstance(rm, dict):
        tried.append((f"<mirror>/{mname}", "mirror manifest malformed"))
        return None
    for e in [rm.get("head")] + list(rm.get("retained") or []):
        if not isinstance(e, dict) or not e.get("file"):
            continue
        fname = str(e["file"])
        local = os.path.join(d, fname)
        try:
            os.makedirs(d, exist_ok=True)
            store.get(fname, local)
            for s in _entry_shards(e):
                store.get(s, os.path.join(d, s))
        except Exception as ex:  # skip to the older object
            tried.append((f"<mirror>/{fname}", str(ex)))
            _log(f"WARNING: mirror object {fname!r} is not restorable "
                 f"({ex}); falling back to the next mirrored snapshot")
            continue
        expected = e.get("sha256")
        if expected:
            try:
                actual = sha256_of_file(local)
            except OSError as ex:
                tried.append((f"<mirror>/{fname}", f"unreadable ({ex})"))
                continue
            if actual != expected:
                _log(f"WARNING: downloaded mirror object {fname!r} "
                     "sha256 mismatch vs mirror manifest; attempting "
                     "restore anyway")
        try:
            ck = load_checkpoint(local)
        except (FileNotFoundError, CheckpointError) as ex:
            tried.append((f"<mirror>/{fname}", str(ex)))
            _log(f"WARNING: mirror object {fname!r} downloaded but does "
                 f"not restore ({ex}); falling back")
            continue
        _log(f"WARNING: restored checkpoint from MIRROR object {fname!r} "
             f"(epoch {ck.epoch}) via {store.describe()} — no local "
             f"candidate under {path!r} was verifiable")
        return ck, local
    return None


def latest_verifiable(path: Optional[str], store=None
                      ) -> Optional[Tuple[Checkpoint, str]]:
    """The newest verifiable checkpoint under ``path`` (a head path, or a
    directory resolved by :func:`_resolve_head`): the one walk the
    trainer's resume and restore and the serve engine's load go through.

    Tries the head, then each retained snapshot newest first.  A candidate
    whose manifest sha256 mismatches is logged and still tried (a stale
    manifest must not discard a good head); one that ``load_checkpoint``
    rejects (torn or foreign, a torn or missing shard of a v2 set, a
    format newer than this build's) is logged and skipped.  ``store`` (a
    ``resilience.store.CheckpointStore``, the mirror tier) is tried when
    no local candidate restores, the local directory gone included
    (:func:`_restore_from_mirror`); local candidates win when verifiable,
    since the mirror only uploads committed states.

    Returns ``(checkpoint, file used)``; None when no candidate exists
    (fresh training); raises ``CheckpointError`` naming every candidate
    tried, both tiers, when candidates exist but none restores."""
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
    if store is not None:
        got = _restore_from_mirror(path, store, tried)
        if got is not None:
            return got
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
