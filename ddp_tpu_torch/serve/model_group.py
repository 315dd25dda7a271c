"""A serving replica's model group: the M ranks of a
:class:`~ddp_tpu_torch.serve.kvcache.KVCacheEngine` whose heads are split
over a serving model axis (counterpart of the JAX engine's ``plan=`` path,
``ddp_tpu/serve/kvcache.py``, which one program runs over a ``(1, M)``
mesh).

The port runs one process a rank (ROADMAP C5).  Rank 0 lives in the
serving process: its engine is the one the token batcher calls.  Ranks 1
to M-1 are follower processes on the same device (:meth:`ModelGroup.spawn`
starts them; each runs :func:`follow`), each with its engine's slices of
the weights and its heads' slice of the KV cache.  All M ranks share that
one device whatever cards are visible: the group splits the work of one
card and checks the tensor-parallel decomposition; it spreads neither the
weights nor the cache over cards (ROADMAP C4).
The group is not the process group of a run: the ranks meet at a TCP store
of rank 0's, and gloo groups are made over it, whatever else the serving
process runs:

- ``sums``, the model's row sums (``parallel/dist.py::all_reduce_model_``
  takes it as a model group); a gloo sum cannot sit inside a CUDA graph,
  so each program's capture splits at its sums
  (``train/step.py::GraphProgram``);
- ``ctl``, the side group: every call of a rank-0 engine reaches the
  followers, before its device work, as one header (``int64[8 + W]``: the
  op, the engine's generation and its arguments) broadcast over it, under
  the group's lock, in the order rank 0 issues them.

A load and a warm end in a vote, one MIN all-reduce over a third group,
``votes`` (not ``sums``: a rank that failed half way through a warm
leaves its peers waiting on a row sum, which must not meet its vote):
all ranks keep the result, or none.  Every wait of rank 0's, and a
follower's sums and votes, end after SUM_TIMEOUT (3 minutes):
a follower that hangs, in a load, a warm or a step, fails the call that
waits for it, and the lock it holds is free again after at most that
long.  Only a follower's wait for its next header is open-ended
(IDLE_TIMEOUT): it idles as long as the replica serves.

The ops: ``LOAD`` (a generation's shards from a checkpoint file, its path
in a second broadcast; each follower reads its slices with
``ckpt_shard.load_for_mesh`` at its model index and checks the step and
epoch rank 0 names), ``WARM``, ``START`` (slot, prompt), ``DECODE`` (each
slot's token, -1 where no stream, and position), ``RELEASE`` (slot),
``RETIRE`` (a generation dropped after a hot swap) and ``STOP``.  A
follower exits on ``STOP``, when its header broadcast fails (rank 0 gone)
or when its parent process has gone.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ..parallel import dist

(OP_STOP, OP_LOAD, OP_RETIRE, OP_WARM, OP_START, OP_DECODE,
 OP_RELEASE) = range(7)
HEADER_INTS = 8
# A follower process's program (``-c``: the package's import of this
# module must not precede its run as ``__main__``).
FOLLOWER = "from ddp_tpu_torch.serve.model_group import follow; follow()"
# A sum, a vote or a header of rank 0's waits this long for a peer; a
# follower waits for its next header as long as the replica serves.
SUM_TIMEOUT = datetime.timedelta(minutes=3)
IDLE_TIMEOUT = datetime.timedelta(days=30)


def header_width(slots: int, prompt_buckets: Sequence[int]) -> int:
    """The header's payload ints: a prompt, or a decode step's tokens and
    positions."""
    return max(max(prompt_buckets), 2 * int(slots))


class _Gloo:
    """One gloo group over a store, outside any process group of a run."""

    def __init__(self, store, rank: int, size: int,
                 timeout: datetime.timedelta):
        self.pg = tdist.ProcessGroupGloo(store, rank, size, timeout)
        self.rank, self.size = rank, size

    def all_reduce_(self, t: torch.Tensor,
                    op=tdist.ReduceOp.SUM) -> torch.Tensor:
        opts = tdist.AllreduceOptions()
        opts.reduceOp = op
        self.pg.allreduce([t], opts).wait()
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        opts = tdist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = 0, 0
        self.pg.broadcast([t], opts).wait()
        return t


class ModelGroup:
    """The M ranks of one serving replica, seen from rank ``rank``."""

    backend = "gloo"

    def __init__(self, store, rank: int, size: int, width: int,
                 procs: Sequence[subprocess.Popen] = ()):
        self.rank, self.size, self.width = int(rank), int(size), int(width)
        self.lead = self.rank == 0
        self.bound = bound = SUM_TIMEOUT
        self.sums = _Gloo(tdist.PrefixStore("sums/", store), rank, size,
                          bound)
        self.ctl = _Gloo(tdist.PrefixStore("ctl/", store), rank, size,
                         bound if self.lead else IDLE_TIMEOUT)
        self.votes = _Gloo(tdist.PrefixStore("votes/", store), rank, size,
                           bound)
        self._procs: List[subprocess.Popen] = list(procs)
        self._header = torch.zeros(HEADER_INTS + self.width,
                                   dtype=torch.int64)
        # Serialises rank 0's calls (header, device work, vote) across the
        # engines of its generations.
        self.lock = threading.RLock()
        self.closed = False
        # Rank 0's record of the generations every rank holds: loaded and
        # not yet retired (the followers' follow the same headers).
        self.gens = set()

    @classmethod
    def spawn(cls, size: int, *, device: torch.device, slots: int,
              prompt_buckets: Sequence[int],
              compute_dtype: Optional[torch.dtype] = None) -> "ModelGroup":
        """Rank 0 of a new group of ``size`` ranks: its store, and the
        ``size - 1`` follower processes, each on ``device``, serving
        engines of ``slots`` slots and ``prompt_buckets``."""
        port = dist.free_port()
        store = tdist.TCPStore("127.0.0.1", port, size, True,
                               timeout=SUM_TIMEOUT, wait_for_workers=False)
        argv = ["--port", str(port), "--size", str(size),
                "--device", str(device), "--slots", str(slots),
                "--prompt_buckets", ",".join(map(str, prompt_buckets)),
                "--dtype", "" if compute_dtype is None
                else str(compute_dtype).rsplit(".", 1)[1],
                "--parent", str(os.getpid())]
        procs = [subprocess.Popen(
            [sys.executable, "-c", FOLLOWER, "--rank", str(k), *argv])
            for k in range(1, size)]
        try:
            return cls(store, 0, size, header_width(slots, prompt_buckets),
                       procs)
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise

    # -- rank 0 ----------------------------------------------------------

    def send(self, op: int, gen: int, ints: Sequence[int] = (),
             payload: Optional[np.ndarray] = None) -> None:
        """Broadcast one header to the followers (rank 0, under
        :attr:`lock`)."""
        h = self._header.numpy()
        h[:] = 0
        h[0], h[1] = op, gen
        h[2:2 + len(ints)] = ints
        if payload is not None:
            h[HEADER_INTS:HEADER_INTS + len(payload)] = payload
        self.ctl.broadcast_(self._header)

    def agree(self, ok: bool) -> bool:
        """True on every rank when ``ok`` is true on all (one MIN
        all-reduce over ``votes``); raises when a rank does not vote
        within SUM_TIMEOUT."""
        t = torch.tensor([1 if ok else 0], dtype=torch.int32)
        try:
            self.votes.all_reduce_(t, tdist.ReduceOp.MIN)
        except RuntimeError as e:
            raise RuntimeError(f"model group rank {self.rank}: a rank did "
                               f"not vote within {self.bound} ({e})"
                               ) from None
        return bool(t.item())

    def load(self, gen: int, path: str, step: int, epoch: int,
             build: Callable):
        """Generation ``gen`` from the checkpoint ``path`` (of ``step`` and
        ``epoch``) on every rank: the followers read their slices, rank 0
        calls ``build()`` for its engine, which is returned once every rank
        has loaded; a rank that failed fails it on all."""
        data = bytearray(path.encode())
        with self.lock:
            self.send(OP_LOAD, gen, (len(data), step, epoch))
            self.ctl.broadcast_(torch.frombuffer(data, dtype=torch.uint8))
            err = None
            try:
                engine = build()
            except Exception as e:
                err = e
            ok = self.agree(err is None)
        if err is not None:
            raise err
        if not ok:
            raise RuntimeError(f"a follower of the model group failed to "
                               f"load its shards of {path!r} (see its "
                               f"stderr)")
        self.gens.add(gen)
        return engine

    def retire(self, gen: int) -> None:
        """Drop generation ``gen`` on the followers (rank 0's engine is
        dropped by its owner); nothing once the group is closed."""
        with self.lock:
            if self.closed:
                return
            self.send(OP_RETIRE, gen)
            self.gens.discard(gen)

    def close(self, timeout: float = 30.0) -> None:
        """Stop the followers and wait for them (killed after
        ``timeout``).  Idempotent."""
        with self.lock:
            if self.closed:
                return
            self.closed = True
            try:
                self.send(OP_STOP, 0)
            except RuntimeError:
                pass  # a follower is gone already
        deadline = time.monotonic() + timeout
        for p in self._procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    # -- a follower ------------------------------------------------------

    def recv(self) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """The next header: ``(op, gen, ints, payload)``."""
        self.ctl.broadcast_(self._header)
        h = self._header.numpy().copy()
        return int(h[0]), int(h[1]), h[2:HEADER_INTS], h[HEADER_INTS:]

    def recv_bytes(self, n: int) -> bytes:
        buf = torch.zeros(n, dtype=torch.uint8)
        self.ctl.broadcast_(buf)
        return bytes(buf.numpy())


def _watch_parent(pid: int) -> None:
    """Exit when the serving process that started this follower is
    gone."""
    while True:
        time.sleep(1.0)
        if os.getppid() != pid:
            os._exit(0)


def follow(argv: Optional[Sequence[str]] = None) -> None:
    """A follower rank: join the group, then serve its headers until
    ``STOP``."""
    from ..device import resolve_device
    from ..models import get_model
    from ..models import transformer as tfm
    from ..parallel.tp.plan import plan_for_model
    from ..train.ckpt_shard import load_for_mesh
    from .kvcache import KVCacheEngine
    p = argparse.ArgumentParser()
    for flag in ("--port", "--rank", "--size", "--slots", "--parent"):
        p.add_argument(flag, type=int, required=True)
    for flag in ("--device", "--prompt_buckets", "--dtype"):
        p.add_argument(flag, required=True)
    args = p.parse_args(argv)
    threading.Thread(target=_watch_parent, args=(args.parent,),
                     daemon=True).start()
    device = resolve_device(args.device)
    buckets = [int(b) for b in args.prompt_buckets.split(",")]
    dtype = getattr(torch, args.dtype) if args.dtype else None
    store = tdist.TCPStore("127.0.0.1", args.port, args.size, False,
                           timeout=SUM_TIMEOUT)
    group = ModelGroup(store, args.rank, args.size,
                       header_width(args.slots, buckets))
    plan = plan_for_model(tfm.LM_NAME, get_model(tfm.LM_NAME, device="meta"),
                          model_size=args.size)
    engines = {}
    while True:
        op, gen, ints, payload = group.recv()
        if op == OP_STOP:
            return
        if op == OP_LOAD:
            path = group.recv_bytes(int(ints[0])).decode()
            engine = None
            try:
                ckpt = load_for_mesh(path, plan, args.rank)
                if (ckpt.step, ckpt.epoch) != (int(ints[1]), int(ints[2])):
                    raise RuntimeError(
                        f"{path!r} holds step {ckpt.step} epoch "
                        f"{ckpt.epoch}; rank 0 loaded step {int(ints[1])} "
                        f"epoch {int(ints[2])} (a publish came between)")
                engine = KVCacheEngine.from_shard(
                    ckpt, plan, group, gen, device=device,
                    slots=args.slots, prompt_buckets=buckets,
                    compute_dtype=dtype)
            except Exception as e:
                print(f"model group rank {args.rank}: load of {path!r} "
                      f"failed ({type(e).__name__}: {e})", file=sys.stderr,
                      flush=True)
            if group.agree(engine is not None):
                engines[gen] = engine
        elif op == OP_RETIRE:
            engines.pop(gen, None)
        else:
            engines[gen].follow(op, ints, payload)
