"""Durable checkpoint tiering: a pluggable object store and an asynchronous
mirror (counterpart of ``ddp_tpu/resilience/store.py``, a copy: the JAX
module needs only the standard library, but the port imports nothing of
``ddp_tpu``).

Every recovery path (``--resume``, ``--on_nan restore``, the drift
restore, the supervisor's relaunch) ends in ``lineage.latest_verifiable``
over one local directory, and a preempted VM can take its disk with it.
This module adds the second failure domain:

- :class:`CheckpointStore`: the put/get/list/delete/stat protocol with
  object-level sha256 verification.  A cloud backend is a subclass over
  its blob client, shaped as :class:`DirStore`.
- :class:`LocalStore`: a plain directory seen through the protocol
  (integrity computed on read; the local tier has the lineage manifest).
- :class:`DirStore`: a second directory standing in for a remote object
  store: atomic object visibility (temporary file and rename), a
  ``.meta.json`` integrity sidecar per object (the stand-in for blob
  metadata), per-op deadlines, and fault hooks (``fail_put``,
  ``slow_put``, ``torn_remote_object``, driven by ``faults.py``).
- :class:`MirrorUploader`: one worker thread that uploads each checkpoint
  after its lineage commit, off the training loop, with bounded jittered
  exponential-backoff retries (the supervisor's ``backoff_delay``) and
  per-op timeouts.  A flaky or stalled remote never blocks or fails a
  step: it grows the ``ddp_mirror_lag_epochs`` gauge, which the watchdog's
  stall line and the flight recorder report.

The objects, the sidecars and the remote manifest are the JAX package's
byte for byte, so either package restores from the other's mirror.
Threading: every remote mutation (uploads, the remote manifest, the trim)
happens on the uploader's one thread, so the trim cannot race an upload;
it is guarded by the ``_in_flight`` set all the same, and the newest
mirrored head is always kept.  Cross-thread state is guarded by ``_lock``.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import random
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .lineage import MANIFEST_SUFFIX, lineage_name
from .supervisor import backoff_delay

_CHUNK = 1 << 20


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.stderr.flush()


class StoreError(Exception):
    """An object-store operation failed (I/O error, integrity mismatch,
    injected fault).  Retryable by policy; never propagates into the
    training loop."""


class StoreTimeout(StoreError):
    """A store operation exceeded its per-op deadline."""


def _check_deadline(deadline: Optional[float], what: str) -> None:
    if deadline is not None and time.monotonic() > deadline:
        raise StoreTimeout(f"{what} exceeded its per-op deadline")


class CheckpointStore:
    """The pluggable durability-tier protocol.

    Objects are flat names (checkpoint lineage file basenames); every
    transfer returns the sha256 of the bytes moved, so callers get
    end-to-end integrity without a second disk pass.  ``get`` MUST verify
    the object against the store's own integrity record when one exists
    and raise :class:`StoreError` on mismatch — a torn remote object is
    a skip-to-next-candidate event, never a silent bad restore.  All
    methods raise :class:`StoreError` (or :class:`StoreTimeout`) on
    failure; ``deadline`` is an absolute ``time.monotonic()`` cutoff.
    """

    def put(self, local_path: str, name: str, *,
            deadline: Optional[float] = None) -> str:
        """Upload ``local_path`` as object ``name``; returns its sha256."""
        raise NotImplementedError

    def put_bytes(self, name: str, data: bytes, *,
                  deadline: Optional[float] = None) -> str:
        """Upload a small blob (the mirror manifest) as ``name``."""
        raise NotImplementedError

    def get(self, name: str, local_path: str, *,
            deadline: Optional[float] = None) -> str:
        """Download + verify object ``name`` to ``local_path`` (atomic:
        the file appears only after verification); returns its sha256."""
        raise NotImplementedError

    def get_bytes(self, name: str, *,
                  deadline: Optional[float] = None) -> bytes:
        """Download + verify a small object into memory."""
        raise NotImplementedError

    def list(self) -> List[str]:
        """Names of every object in the store."""
        raise NotImplementedError

    def delete(self, name: str) -> None:
        """Remove one object (idempotent — absent is not an error)."""
        raise NotImplementedError

    def stat(self, name: str) -> Optional[Dict[str, Any]]:
        """``{"size": int, "sha256": str|None}`` or None when absent."""
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


def _copy_hashed(src_path: str, out, deadline: Optional[float],
                 what: str) -> Tuple[str, int]:
    """Stream-copy ``src_path`` into the open binary file ``out``,
    hashing while copying (one disk pass) and checking the deadline
    between chunks; returns ``(sha256, size)``."""
    h = hashlib.sha256()
    total = 0
    with open(src_path, "rb") as src:
        while True:
            _check_deadline(deadline, what)
            chunk = src.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
            total += len(chunk)
            out.write(chunk)
    return h.hexdigest(), total


class LocalStore(CheckpointStore):
    """A plain directory as a store — the tier-0 backend.

    No sidecar metadata: the local tier's integrity record is the
    lineage manifest itself, so ``stat``/``get`` compute the sha from
    the bytes (callers compare against the manifest)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def describe(self) -> str:
        return f"LocalStore({self.root!r})"

    def _obj(self, name: str) -> str:
        if not name or os.sep in name or name.startswith("."):
            raise StoreError(f"invalid object name {name!r}")
        return os.path.join(self.root, name)

    def put(self, local_path, name, *, deadline=None):
        dst = self._obj(name)
        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                sha, _ = _copy_hashed(local_path, out, deadline,
                                      f"put {name!r}")
            os.replace(tmp, dst)
        except StoreError:
            _unlink_quiet(tmp)
            raise
        except OSError as e:
            _unlink_quiet(tmp)
            raise StoreError(f"put {name!r} failed: {e}") from e
        return sha

    def put_bytes(self, name, data, *, deadline=None):
        dst = self._obj(name)
        os.makedirs(self.root, exist_ok=True)
        _check_deadline(deadline, f"put {name!r}")
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                out.write(data)
            os.replace(tmp, dst)
        except OSError as e:
            _unlink_quiet(tmp)
            raise StoreError(f"put {name!r} failed: {e}") from e
        return hashlib.sha256(data).hexdigest()

    def get(self, name, local_path, *, deadline=None):
        src = self._obj(name)
        if not os.path.exists(src):
            raise StoreError(f"no object {name!r} in {self.describe()}")
        d = os.path.dirname(os.path.abspath(local_path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                sha, _ = _copy_hashed(src, out, deadline, f"get {name!r}")
            os.replace(tmp, local_path)
        except StoreError:
            _unlink_quiet(tmp)
            raise
        except OSError as e:
            _unlink_quiet(tmp)
            raise StoreError(f"get {name!r} failed: {e}") from e
        return sha

    def get_bytes(self, name, *, deadline=None):
        src = self._obj(name)
        _check_deadline(deadline, f"get {name!r}")
        try:
            with open(src, "rb") as f:
                return f.read()
        except OSError as e:
            raise StoreError(f"get {name!r} failed: {e}") from e

    def list(self):
        try:
            return sorted(n for n in os.listdir(self.root)
                          if not n.endswith(".tmp"))
        except OSError:
            return []

    def delete(self, name):
        _unlink_quiet(self._obj(name))

    def stat(self, name):
        try:
            st = os.stat(self._obj(name))
        except OSError:
            return None
        return {"size": int(st.st_size), "sha256": None}


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class DirStore(CheckpointStore):
    """A directory standing in for a remote object store.

    Object semantics a blob store would give us, reproduced on a
    filesystem so the whole durability protocol is testable in CI:

    - atomic visibility — an object appears only after its bytes are
      complete (tmp + rename), and its ``<name>.meta.json`` integrity
      sidecar (the stand-in for blob metadata/etag) is written LAST, so
      a reader never sees a verifiable-looking half-object;
    - ``get`` verifies the sha256 recorded at put time and raises
      :class:`StoreError` on mismatch — a torn upload is detected at
      restore time, not trusted;
    - ``delete`` removes the sidecar FIRST, so a concurrent reader sees
      "absent", never "present but unverifiable".

    Fault hooks (installed via ``DDP_TPU_FAULT`` — resilience/faults.py):
    ``inject_fail_puts(n)`` fails the next n puts, ``inject_slow_put(s)``
    stalls every put (the per-op deadline then times it out),
    ``inject_torn_next_put()`` truncates the next object's bytes while
    recording the full-length sha — the lie a torn network upload tells.
    """

    META_SUFFIX = ".meta.json"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._lock = threading.Lock()
        self._fail_puts_remaining = 0
        self._slow_put_s = 0.0
        self._torn_next_put = False

    def describe(self) -> str:
        return f"DirStore({self.root!r})"

    # -- fault hooks (main thread) ----------------------------------------

    def inject_fail_puts(self, n: int) -> None:
        with self._lock:
            self._fail_puts_remaining = int(n)

    def inject_slow_put(self, seconds: float) -> None:
        with self._lock:
            self._slow_put_s = float(seconds)

    def inject_torn_next_put(self) -> None:
        with self._lock:
            self._torn_next_put = True

    def _take_put_faults(self) -> Tuple[bool, float, bool]:
        with self._lock:
            fail = self._fail_puts_remaining > 0
            if fail:
                self._fail_puts_remaining -= 1
            slow = self._slow_put_s
            torn = self._torn_next_put
            if torn:
                self._torn_next_put = False
        return fail, slow, torn

    # -- object ops --------------------------------------------------------

    def _obj(self, name: str) -> str:
        if not name or os.sep in name or name.startswith("."):
            raise StoreError(f"invalid object name {name!r}")
        return os.path.join(self.root, name)

    def _meta_path(self, name: str) -> str:
        return self._obj(name) + self.META_SUFFIX

    def _apply_put_faults(self, name: str,
                          deadline: Optional[float]) -> bool:
        """Honor injected put faults; returns the torn flag."""
        fail, slow, torn = self._take_put_faults()
        if slow:
            end = time.monotonic() + slow
            while time.monotonic() < end:
                _check_deadline(deadline, f"put {name!r} (slow remote)")
                time.sleep(min(0.05, end - time.monotonic()))
        if fail:
            raise StoreError(f"injected put failure for {name!r}")
        return torn

    def put(self, local_path, name, *, deadline=None):
        torn = self._apply_put_faults(name, deadline)
        dst = self._obj(name)
        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                sha, size = _copy_hashed(local_path, out, deadline,
                                         f"put {name!r}")
                if torn:
                    # The torn-upload lie: half the bytes land, the
                    # integrity record below still claims the full sha.
                    out.truncate(max(0, size // 2))
            os.replace(tmp, dst)
        except StoreError:
            _unlink_quiet(tmp)
            raise
        except OSError as e:
            _unlink_quiet(tmp)
            raise StoreError(f"put {name!r} failed: {e}") from e
        self._write_meta(name, sha, size)
        return sha

    def put_bytes(self, name, data, *, deadline=None):
        torn = self._apply_put_faults(name, deadline)
        dst = self._obj(name)
        os.makedirs(self.root, exist_ok=True)
        body = data[: len(data) // 2] if torn else data
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                out.write(body)
            os.replace(tmp, dst)
        except OSError as e:
            _unlink_quiet(tmp)
            raise StoreError(f"put {name!r} failed: {e}") from e
        sha = hashlib.sha256(data).hexdigest()
        self._write_meta(name, sha, len(data))
        return sha

    def _write_meta(self, name: str, sha: str, size: int) -> None:
        meta = {"sha256": sha, "size": int(size)}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, self._meta_path(name))
        except OSError as e:
            _unlink_quiet(tmp)
            raise StoreError(f"meta write for {name!r} failed: {e}") from e

    def get(self, name, local_path, *, deadline=None):
        meta = self.stat(name)
        if meta is None:
            raise StoreError(f"no object {name!r} in {self.describe()}")
        d = os.path.dirname(os.path.abspath(local_path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                sha, _ = _copy_hashed(self._obj(name), out, deadline,
                                      f"get {name!r}")
            expected = meta.get("sha256")
            if expected and sha != expected:
                _unlink_quiet(tmp)
                raise StoreError(
                    f"object {name!r} failed sha-256 verification (torn "
                    f"upload or remote rot): bytes hash {sha[:12]}…, "
                    f"store records {expected[:12]}…")
            os.replace(tmp, local_path)
        except StoreError:
            _unlink_quiet(tmp)
            raise
        except OSError as e:
            _unlink_quiet(tmp)
            raise StoreError(f"get {name!r} failed: {e}") from e
        return sha

    def get_bytes(self, name, *, deadline=None):
        meta = self.stat(name)
        if meta is None:
            raise StoreError(f"no object {name!r} in {self.describe()}")
        _check_deadline(deadline, f"get {name!r}")
        try:
            with open(self._obj(name), "rb") as f:
                data = f.read()
        except OSError as e:
            raise StoreError(f"get {name!r} failed: {e}") from e
        expected = meta.get("sha256")
        if expected and hashlib.sha256(data).hexdigest() != expected:
            raise StoreError(
                f"object {name!r} failed sha-256 verification (torn "
                "upload or remote rot)")
        return data

    def list(self):
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in names
                      if not n.endswith(self.META_SUFFIX)
                      and not n.endswith(".tmp"))

    def delete(self, name):
        # Sidecar first: a concurrent reader sees "absent" (stat None),
        # never "present but unverifiable".
        _unlink_quiet(self._meta_path(name))
        _unlink_quiet(self._obj(name))

    def stat(self, name):
        try:
            with open(self._meta_path(name)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        if not os.path.exists(self._obj(name)):
            return None
        return {"size": int(meta.get("size", 0)),
                "sha256": meta.get("sha256")}


def open_store(uri) -> CheckpointStore:
    """Resolve a ``--mirror`` URI to a backend.

    A plain path or ``dir://PATH`` is the :class:`DirStore` remote
    stand-in; ``local://PATH`` is the thin :class:`LocalStore`.  A cloud
    scheme is refused by name: its backend is a :class:`CheckpointStore`
    subclass over the blob client, passed to the Trainer."""
    if isinstance(uri, CheckpointStore):
        return uri
    uri = str(uri)
    for scheme in ("gs://", "s3://", "az://"):
        if uri.startswith(scheme):
            raise StoreError(
                f"no {scheme.rstrip('/:')} backend is bundled — subclass "
                "CheckpointStore over the blob client (put/get/list/"
                "delete/stat + sha-256 metadata; see DirStore for the "
                "shape) and pass it to the Trainer")
    if uri.startswith("dir://"):
        return DirStore(uri[len("dir://"):])
    if uri.startswith("local://"):
        return LocalStore(uri[len("local://"):])
    return DirStore(uri)


class RetryPolicy:
    """Bounded jittered exponential backoff for store ops — the same
    decorrelation math as the supervisor's relaunch backoff
    (``supervisor.backoff_delay``): attempt ``k`` waits
    ``min(base * 2**k, cap) * (1 ± jitter)``; after ``retries`` failed
    retries the op is abandoned (the caller degrades, never crashes)."""

    def __init__(self, *, retries: int = 4, base: float = 0.25,
                 cap: float = 4.0, jitter: float = 0.25):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if base < 0 or cap < 0 or not 0 <= jitter <= 1:
            raise ValueError(
                f"invalid backoff (base={base}, cap={cap}, jitter={jitter})")
        self.retries = int(retries)
        self.base = float(base)
        self.cap = float(cap)
        self.jitter = float(jitter)

    def delay(self, attempt: int, rng: random.Random) -> float:
        return backoff_delay(attempt, base=self.base, cap=self.cap,
                             jitter=self.jitter, rng=rng)


MIRROR_MANIFEST_FORMAT = 1


class MirrorUploader:
    """Asynchronous checkpoint mirroring, strictly off the critical path.

    The trainer's writer thread calls :meth:`enqueue` right after each
    ``lineage.commit`` (so only durable, sha-recorded states are ever
    mirrored); this class's ONE worker thread does everything remote:
    upload the head snapshot (+ v2 shard files and sidecars), publish the
    remote mirror manifest, then trim remote objects that fell out of
    retention.  ``enqueue`` never blocks and upload failure never
    propagates — the remote tier degrades to visible
    ``ddp_mirror_lag_epochs``, never a blocked or failed step.

    The head is snapshotted by hard link at enqueue time (the live head
    path is overwritten by the NEXT save while an upload may still be in
    queue); each upload's returned sha is compared against the lineage
    commit's sha so a changed-under-us file is detected and treated as
    superseded, not mirrored wrong.
    """

    def __init__(self, store, path: str, *, keep: int = 1, registry=None,
                 tracer=None, policy: Optional[RetryPolicy] = None,
                 op_timeout: float = 30.0,
                 rng: Optional[random.Random] = None):
        self.store = open_store(store)
        self.path = os.path.abspath(path)
        self.base = os.path.basename(path)
        self.keep = max(1, int(keep))
        self.policy = policy if policy is not None else RetryPolicy()
        self.op_timeout = float(op_timeout)
        self._rng = rng if rng is not None else random.Random(0x5EED)
        if tracer is None:
            from ..obs.tracer import get_tracer
            tracer = get_tracer()
        self.tracer = tracer
        self._m_seconds = self._m_retries = self._m_failures = None
        if registry is not None:
            from ..obs.registry import SECONDS_BUCKETS
            self._m_seconds = registry.histogram(
                "ddp_ckpt_upload_seconds",
                "Wall time of one mirrored checkpoint upload (all files)",
                buckets=SECONDS_BUCKETS)
            self._m_retries = registry.counter(
                "ddp_ckpt_upload_retries_total",
                "Mirror upload attempts retried after a store error or "
                "per-op timeout")
            self._m_failures = registry.counter(
                "ddp_ckpt_upload_failures_total",
                "Mirror uploads abandoned after the retry budget — the "
                "checkpoint stays local-only and mirror lag grows")
            registry.gauge(
                "ddp_mirror_lag_epochs",
                "Committed checkpoint epochs not yet durably mirrored "
                "(0 = mirror current)").set_function(
                    lambda: float(self.lag_epochs()))
        self._q: "queue.Queue" = queue.Queue()
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._pending = {}       # epoch -> True, committed-not-yet-mirrored
        self._mirrored = []      # mirror manifest entries, newest first
        self._in_flight = set()  # remote names being uploaded right now
        self._outstanding = 0    # queued-or-running jobs (drain watches it)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-mirror")
        self._thread.start()

    # -- writer-thread side ------------------------------------------------

    def enqueue(self, *, epoch: int, step: int, sha256: str,
                shards: Sequence[str] = (),
                data_state: Optional[Dict[str, Any]] = None) -> None:
        """Queue one freshly-committed checkpoint for mirroring.  Called
        on the trainer's checkpoint writer thread right after
        ``lineage.commit``; never blocks, never raises into the save."""
        epoch = int(epoch)
        d = os.path.dirname(self.path)
        remote_head = os.path.basename(lineage_name(self.path, epoch))
        snap = os.path.join(d, remote_head + ".mirror")
        try:
            if os.path.exists(snap):
                os.unlink(snap)
            try:
                os.link(self.path, snap)
            except OSError:  # filesystems without hard links
                shutil.copy2(self.path, snap)
        except OSError as e:
            _log(f"WARNING: mirror: could not snapshot head for epoch "
                 f"{epoch} ({e}); this epoch stays local-only")
            return
        files = [(snap, remote_head, sha256, True)]
        for s in shards or ():
            name = os.path.basename(str(s))
            files.append((os.path.join(d, name), name, None, False))
            sidecar = os.path.join(d, name + ".sha256")
            if os.path.exists(sidecar):
                files.append((sidecar, name + ".sha256", None, False))
        entry: Dict[str, Any] = {"file": remote_head, "epoch": epoch,
                                 "step": int(step), "sha256": sha256}
        if shards:
            entry["shards"] = [os.path.basename(str(s)) for s in shards]
        if data_state is not None:
            entry["data_state"] = data_state
        with self._lock:
            self._pending[epoch] = True
            self._outstanding += 1
        self._q.put({"epoch": epoch, "files": files, "entry": entry})

    def state_of_epoch(self, epoch: int) -> str:
        """Lineage manifests stamp this per entry: ``"mirrored"`` once
        the epoch's objects + remote manifest landed, else ``"pending"``."""
        with self._lock:
            if any(e.get("epoch") == int(epoch) for e in self._mirrored):
                return "mirrored"
        return "pending"

    def lag_epochs(self) -> int:
        """Committed-but-not-yet-mirrored epochs (the ``/healthz`` number:
        0 = the mirror is current; growth = remote falling behind)."""
        with self._lock:
            return len(self._pending)

    def mirrored_entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._mirrored]

    def drain(self, timeout: float) -> bool:
        """Best-effort wait for the queue to empty (emergency-checkpoint
        exits give the mirror a bounded head start); True when idle."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        while True:
            with self._lock:
                idle = self._outstanding == 0
            if idle:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def close(self, timeout: float = 5.0) -> None:
        """Drain (bounded), then stop the worker.  Safe to call twice."""
        self.drain(timeout)
        self._stop_evt.set()
        self._q.put(None)
        self._thread.join(timeout=max(1.0, timeout))

    # -- uploader-thread side ----------------------------------------------

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                self._process(job)
            except BaseException as e:  # the uploader must never die loud
                _log(f"WARNING: mirror uploader error for epoch "
                     f"{job['epoch']}: {type(e).__name__}: {e}")
            finally:
                with self._lock:
                    self._outstanding -= 1

    def _process(self, job: Dict[str, Any]) -> None:
        epoch, entry = job["epoch"], job["entry"]
        t0 = time.monotonic()
        outcome = "ok"
        for local, remote, sha, is_snap in job["files"]:
            got = self._put_with_retry(local, remote,
                                       step=entry["step"],
                                       expected_sha=sha)
            if is_snap:
                _unlink_quiet(local)
            if got != "ok":
                outcome = got
                break
        if outcome == "superseded":
            # The local bytes rotated away / changed before upload — a
            # newer committed epoch is (or will be) in the queue; this
            # epoch no longer needs durability of its own.
            with self._lock:
                self._pending.pop(epoch, None)
            return
        if outcome != "ok":
            if self._m_failures is not None:
                self._m_failures.inc()
            _log(f"WARNING: mirror: epoch {epoch} NOT mirrored (upload "
                 "abandoned after retries); training continues, "
                 "mirror lag grows until a newer epoch lands")
            return
        if self._m_seconds is not None:
            self._m_seconds.observe(time.monotonic() - t0)
        with self._lock:
            self._mirrored = [e for e in self._mirrored
                              if e.get("epoch") != epoch]
            self._mirrored.insert(0, dict(entry))
            self._mirrored.sort(key=lambda e: -int(e.get("epoch", -1)))
            self._mirrored = self._mirrored[: self.keep]
            # Anything at or below the epoch just mirrored is covered:
            # the mirror head is now at least this new.
            self._pending = {ep: True for ep in self._pending
                             if ep > epoch}
            manifest = {
                "format": MIRROR_MANIFEST_FORMAT,
                "mirror": True,
                "head": dict(self._mirrored[0]),
                "retained": [dict(e) for e in self._mirrored[1:]],
            }
        self._publish_manifest(manifest, step=entry["step"])
        self._trim_remote()

    def _publish_manifest(self, manifest: Dict[str, Any],
                          *, step: int) -> None:
        name = self.base + MANIFEST_SUFFIX
        blob = json.dumps(manifest, indent=1).encode()
        got = self._op_with_retry(
            lambda deadline: self.store.put_bytes(name, blob,
                                                  deadline=deadline),
            name, step=step)
        if got != "ok":
            if self._m_failures is not None:
                self._m_failures.inc()
            _log("WARNING: mirror: remote manifest publish failed; the "
                 "mirror head is stale until the next successful commit")

    def _trim_remote(self) -> None:
        """GC remote objects that fell out of retention.  Runs on the
        same thread as every upload (no concurrent put to race), and is
        still guarded: never deletes an in-flight name, and the newest
        mirrored head's file set is always in the keep-set."""
        with self._lock:
            keep_names = {self.base + MANIFEST_SUFFIX}
            for e in self._mirrored:
                keep_names.add(str(e.get("file")))
                for s in e.get("shards", []) or []:
                    keep_names.add(str(s))
                    keep_names.add(str(s) + ".sha256")
            in_flight = set(self._in_flight)
        try:
            names = self.store.list()
        except StoreError:
            return
        for name in names:
            if name in keep_names or name in in_flight:
                continue
            try:
                self.store.delete(name)
            except StoreError:
                pass  # retention is best-effort, next trim retries

    def _put_with_retry(self, local: str, remote: str, *, step: int,
                        expected_sha: Optional[str]) -> str:
        """Upload one file with bounded retries; ``"ok"`` /
        ``"superseded"`` (local bytes gone or changed) / ``"failed"``."""
        def op(deadline):
            return self.store.put(local, remote, deadline=deadline)
        return self._op_with_retry(op, remote, step=step,
                                   expected_sha=expected_sha)

    def _op_with_retry(self, op, remote: str, *, step: int,
                       expected_sha: Optional[str] = None) -> str:
        for attempt in range(self.policy.retries + 1):
            deadline = time.monotonic() + self.op_timeout
            with self._lock:
                self._in_flight.add(remote)
            try:
                with self.tracer.span("ckpt_upload", step=int(step),
                                      overlap=True):
                    sha = op(deadline)
                if expected_sha is not None and sha != expected_sha:
                    _log(f"WARNING: mirror: {remote!r} changed under the "
                         "uploader (rotation outpaced the mirror); "
                         "treating as superseded")
                    try:
                        self.store.delete(remote)
                    except StoreError:
                        pass  # next trim collects the mismatched object
                    return "superseded"
                return "ok"
            except FileNotFoundError:
                _log(f"mirror: local source for {remote!r} rotated away "
                     "before upload; superseded")
                return "superseded"
            except (StoreError, OSError) as e:
                if attempt >= self.policy.retries:
                    _log(f"WARNING: mirror upload of {remote!r} abandoned "
                         f"after {attempt + 1} attempt(s) "
                         f"({type(e).__name__}: {e})")
                    return "failed"
                delay = self.policy.delay(attempt, self._rng)
                if self._m_retries is not None:
                    self._m_retries.inc()
                _log(f"WARNING: mirror upload of {remote!r} attempt "
                     f"{attempt + 1} failed ({type(e).__name__}: {e}); "
                     f"retrying in {delay:.2f}s")
                if self._stop_evt.wait(delay):
                    return "failed"
            finally:
                with self._lock:
                    self._in_flight.discard(remote)
        return "failed"
