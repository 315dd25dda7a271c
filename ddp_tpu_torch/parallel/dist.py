"""Process groups and the data-parallel collectives (counterpart of
``ddp_tpu/parallel/dist.py``, the reference's ``ddp_setup``,
multigpu.py:24-33, and the JAX CLI's ``--spawn`` fan-out).

Rendezvous comes from torch's standard environment, as ``torchrun`` sets it
and as the reference sets its own two knobs (multigpu.py:30-31):
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``.  Without it :func:`initialize` does nothing and the process
is world 1 on its own, as the JAX package is single-host without its
coordinator.  The backend is NCCL on the card and gloo on the CPU; nothing
falls back from one to the other.

Each of the step's collectives is one ``all_reduce`` (or one ``broadcast``)
of one flat buffer; under ``--shard_update`` the gradients' all-reduce
becomes one ``reduce_scatter`` and one ``all_gather`` of the parameters
(:func:`reduce_scatter_flat`, :func:`all_gather_flat`), and under
``--sync_bn`` each BatchNorm layer adds small all-reduces of its statistics
(:func:`all_reduce_sum_`).  They run whenever a process group exists, at
world 1 too (the only world of a one-card machine), and are the identity
without one.  ``collective_calls`` counts the collectives issued, by kind
(``all_reduce``, ``broadcast``, ``reduce_scatter``, ``all_gather``), in
this process (as each kernel wrapper counts its launches).

Two more for the resilience layer.  :func:`any_rank` is the preemption
stop vote, an OR of one flag over the ranks: a CPU tensor over a gloo
side group made once at :func:`initialize` (world > 1 only), so a per-step
vote never waits for the card's queue; it counts as ``stop_vote``.  The
per-epoch straggler record's gather (:func:`all_gather_rows`, one row of
phase medians a rank) takes the same group and counts as
``straggler_gather``.  The
drift audit's two sums count as ``drift_audit``.  :func:`abort` is the
teardown of the failure paths: it never blocks.

Under ``--mesh_shape D,M`` (:func:`init_mesh`, ``parallel/mesh.py``) the
data-parallel collectives above reduce over this rank's data group (its
model column) only, and :func:`data_size`/:func:`data_rank` are the data
axis's extent and this rank's data index, where they are the world and the
rank without a mesh.  The tensor-parallel layers' all-reduces over the
model group (``parallel/tp/layers.py``) count as ``psum_model_fwd`` (a
row-parallel layer's partial sums) and ``psum_model_bwd`` (a
column-parallel layer's input gradient), and the checkpoint's gather of the
model-sharded state over that group as ``ckpt_gather_model``.  At ``M = 1``
(and ``S = 1``) no group is made: the data group is the world and the run
is the 1-D one.

Under a stage axis (``--mesh_shape D,M,S``, ``parallel/pp/``) the data
group is the ranks of this rank's (model, stage) position and the model
group those of its (data, stage) position.  The stages of one pipeline
hand activations forward and cotangents back point to point
(:func:`send_stage`, :func:`recv_stage`; ``pp_handoff``, one a send or a
receive, with their bytes and host seconds in :data:`handoff_stats`), each
direction between two neighbouring stages over a group of its own (NCCL
runs the operations of one communicator in the order each rank issues
them, and a schedule's sends and receives between two stages do not
alternate alike on both), move
state to stage 0 or rank 0 the same way (``pp_state``), and broadcast the
last stage's losses and stage 0's accuracy over their pipe group
(``pp_broadcast``).  gloo takes no CUDA tensor point to point, so on a
card its handoffs are staged through pinned host buffers; NCCL sends the
device tensors.
"""
from __future__ import annotations

import collections
import datetime
import os
import re
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn

RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# A lost peer fails the collective that waits on it after this long,
# instead of hanging the run.
TIMEOUT = datetime.timedelta(minutes=3)
# --spawn in every spelling argparse accepts: the full name, the unambiguous
# abbreviations --sp/--spa/--spaw (no other option starts with --sp), each
# bare (the count follows) or with =N.
_SPAWN_FLAG = re.compile(r"--sp(a(wn?)?)?(=.*)?")
collective_calls: collections.Counter = collections.Counter()
# The stop vote's gloo group (world > 1), and whether abort() gave the
# process group up.
_vote_group = None
_aborted = False
# Under --mesh_shape: the grid, this rank's data group (None: the world),
# its model group (None: no tensor parallelism), its pipe group (None: no
# stage axis) and the groups of the links to its neighbouring stages, by
# (from stage, to stage).
_mesh = None
_data_group = None
_model_group = None
_pipe_group = None
_links: Dict[Tuple[int, int], Any] = {}
# The pipeline's point-to-point traffic in this process: sends, receives,
# bytes each way and the host seconds spent in the calls.
handoff_stats: collections.Counter = collections.Counter()


def in_rendezvous() -> bool:
    """True when this process was started as a rank: any of the rendezvous
    variables is set (:func:`initialize` then requires all of them)."""
    return any(k in os.environ for k in RENDEZVOUS_ENV)


def initialize(device: torch.device,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group the environment describes and return this
    rank's device: ``cuda:{LOCAL_RANK}`` (made current before the group is
    created) for a CUDA ``device``, else ``device``.  The backend is
    ``nccl`` for CUDA and ``gloo`` for the CPU; ``backend`` overrides it
    (gloo on the card is the only way to run two ranks on one card).
    Without a rendezvous environment this is a no-op returning ``device``."""
    if tdist.is_initialized():
        raise RuntimeError("dist.initialize: a process group exists already")
    if not in_rendezvous():
        return device
    missing = [k for k in RENDEZVOUS_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"dist.initialize: the rendezvous environment "
                           f"lacks {', '.join(missing)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method="env://", rank=rank, world_size=world, timeout=TIMEOUT)
    global _vote_group, _aborted
    _aborted = False
    if world > 1:
        # Every rank makes it, in the same order: new_group is collective.
        _vote_group = tdist.new_group(backend="gloo", timeout=TIMEOUT)
    return device


def rank() -> int:
    """This process's rank (``process_index``); 0 without a group."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks (``process_count``); 1 without a group."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def backend() -> Optional[str]:
    """The process group's backend, or None without a group."""
    return tdist.get_backend() if tdist.is_initialized() else None


def init_mesh(mesh) -> None:
    """Lay this run's ranks out as ``mesh`` (a
    :class:`~ddp_tpu_torch.parallel.mesh.Mesh` of ``world_size()`` ranks
    seen from this rank) and make its process groups.  Every rank makes
    every data group (one for each (model, stage) position), then at a
    model axis above 1 every model group (one for each (data, stage)
    position), then at a stage axis above 1 every pipe group (one for each
    (data, model) position) and every link group (two for each pair of
    neighbouring stages of a pipe, one a direction), in the same order, the
    groups it is not in included: ``new_group`` is collective.  On a 2-D
    grid with a model axis of 1 no group is made."""
    global _mesh, _data_group, _model_group, _pipe_group
    if mesh.size != world_size():
        raise ValueError(f"mesh {','.join(map(str, mesh.dims))} has "
                         f"{mesh.size} ranks; this run's world is "
                         f"{world_size()}")
    _mesh, _data_group, _model_group, _pipe_group = mesh, None, None, None
    _links.clear()
    d, m, s = mesh.dims[0], mesh.dims[1], mesh.stages
    if (m == 1 and s == 1) or not tdist.is_initialized():
        return
    for k in range(m):
        for st in range(s):
            g = tdist.new_group(mesh.data_ranks(k, st), timeout=TIMEOUT)
            if (k, st) == (mesh.model_index, mesh.stage_index):
                _data_group = g
    if m > 1:
        for j in range(d):
            for st in range(s):
                g = tdist.new_group(mesh.model_ranks(j, st), timeout=TIMEOUT)
                if (j, st) == (mesh.data_index, mesh.stage_index):
                    _model_group = g
    if s > 1:
        for j in range(d):
            for k in range(m):
                g = tdist.new_group(mesh.stage_ranks(j, k), timeout=TIMEOUT)
                if (j, k) == (mesh.data_index, mesh.model_index):
                    _pipe_group = g
                for st in range(s - 1):
                    for link in ((st, st + 1), (st + 1, st)):
                        g = tdist.new_group(
                            [mesh.rank_of(j, k, st),
                             mesh.rank_of(j, k, st + 1)], timeout=TIMEOUT)
                        if (j, k) == (mesh.data_index, mesh.model_index):
                            _links[link] = g


def mesh():
    """The run's mesh (:func:`init_mesh`), or None."""
    return _mesh


def data_size() -> int:
    """The data axis's extent: the number of batch shards (the world
    without a mesh)."""
    return _mesh.dims[0] if _mesh is not None else world_size()


def data_rank() -> int:
    """This rank's data index: the batch shard it trains on (the rank
    without a mesh)."""
    return _mesh.data_index if _mesh is not None else rank()


def model_group():
    """This rank's model group, or None when the model axis is 1."""
    return _model_group


def stage_index() -> int:
    """This rank's pipeline stage (0 without a stage axis)."""
    return _mesh.stage_index if _mesh is not None else 0


def num_stages() -> int:
    """The stage axis's extent (1 without one)."""
    return _mesh.stages if _mesh is not None else 1


def clear_mesh() -> None:
    """Forget the mesh and its groups (the 1-D layout again)."""
    global _mesh, _data_group, _model_group, _pipe_group
    _mesh = _data_group = _model_group = _pipe_group = None
    _links.clear()


def _stage_rank(stage: int) -> int:
    return _mesh.rank_of(_mesh.data_index, _mesh.model_index, stage)


def _staged() -> bool:
    """gloo point to point takes CPU tensors only."""
    return tdist.get_backend() == "gloo"


def send_stage(t: torch.Tensor, stage: int, tag: int = 0, *,
               kind: str = "pp_handoff") -> list:
    """Send ``t`` to this pipeline's stage ``stage`` without waiting: one
    ``isend`` (over the link's group to a neighbour, the world's to
    another stage), counted under ``kind``.  Returns what the caller keeps
    until :func:`wait_sends`: the work and the buffer it reads (on gloo
    with a CUDA tensor, a pinned host copy)."""
    t0 = time.perf_counter()
    buf = t.detach().contiguous()
    if buf.is_cuda and _staged():
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf)
        buf = host
    work = tdist.isend(buf, _stage_rank(stage), tag=tag,
                       group=_links.get((_mesh.stage_index, stage)))
    collective_calls[kind] += 1
    if kind == "pp_handoff":
        handoff_stats["sends"] += 1
        handoff_stats["bytes_sent"] += buf.numel() * buf.element_size()
        handoff_stats["seconds"] += time.perf_counter() - t0
    return [work, buf]


def wait_sends(pending: list) -> None:
    """Wait for the sends :func:`send_stage` returned."""
    for work, _ in pending:
        work.wait()
    pending.clear()


def recv_stage(shape, dtype: torch.dtype, device: torch.device,
               stage: int, tag: int = 0, *, kind: str = "pp_handoff"
               ) -> torch.Tensor:
    """A ``shape``/``dtype`` tensor on ``device`` received from this
    pipeline's stage ``stage``: one ``recv`` (over the link's group from a
    neighbour), counted under ``kind``.  On gloo with a CUDA ``device`` it
    lands in pinned host memory and is copied to the card on the current
    stream."""
    t0 = time.perf_counter()
    device = torch.device(device)
    staged = device.type == "cuda" and _staged()
    buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device,
                      pin_memory=staged)
    tdist.recv(buf, _stage_rank(stage), tag=tag,
               group=_links.get((stage, _mesh.stage_index)))
    if staged:
        buf = buf.to(device, non_blocking=True)
    collective_calls[kind] += 1
    if kind == "pp_handoff":
        handoff_stats["recvs"] += 1
        handoff_stats["bytes_recv"] += buf.numel() * buf.element_size()
        handoff_stats["seconds"] += time.perf_counter() - t0
    return buf


def pipe_broadcast_(t: torch.Tensor, stage: int) -> torch.Tensor:
    """``t`` as stage ``stage`` of this pipeline holds it, in place on
    every stage (one ``broadcast`` over the pipe group, counted as
    ``pp_broadcast``); ``t`` itself without a stage axis."""
    if _pipe_group is None:
        return t
    tdist.broadcast(t, src=_stage_rank(stage), group=_pipe_group)
    collective_calls["pp_broadcast"] += 1
    return t


def shutdown() -> None:
    """``destroy_process_group()`` (multigpu.py:250) if a group exists and
    :func:`abort` has not given it up."""
    global _vote_group
    _vote_group = None
    clear_mesh()
    if tdist.is_initialized() and not _aborted:
        tdist.destroy_process_group()


def abort() -> None:
    """Give the process group up without tearing it down, for the paths
    that hard-exit next (the watchdog's expiry, a failing rank of a world
    > 1).  Never blocks: ``destroy_process_group`` can wait on the very
    peer that is stuck (NCCL does), so this only flushes the standard
    streams and makes :func:`shutdown` a no-op; the ``os._exit`` that
    follows closes the sockets, which fails the peers' pending
    collectives (``ddp_tpu/cli.py:555-563``'s discipline)."""
    global _aborted
    _aborted = True
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):  # a closed or broken stream
            pass


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any: one MAX
    all-reduce of a CPU int over the gloo side group, so the card's stream
    is never touched (the preemption guard's per-step stop vote).  Every
    rank must call it at the same point; without a group, or at world 1,
    it is ``flag``."""
    if _vote_group is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=_vote_group)
    collective_calls["stop_vote"] += 1
    return bool(t.item())


def all_gather_rows(row: np.ndarray, kind: str = "straggler_gather"
                    ) -> List[np.ndarray]:
    """Every rank's float32 ``row``, in rank order: one ``all_gather`` of
    CPU tensors over the gloo side group, so it never waits for the card's
    queue (counted under ``kind``).  Every rank must call it at the same
    point with a row of the same length; without a group, or at world 1, it
    is ``[row]``."""
    if _vote_group is None:
        return [np.asarray(row, np.float32)]
    t = torch.from_numpy(np.ascontiguousarray(row, np.float32))
    out = [torch.empty_like(t) for _ in range(world_size())]
    tdist.all_gather(out, t, group=_vote_group)
    collective_calls[kind] += 1
    return [o.numpy() for o in out]


def _all_reduce_sum(t: torch.Tensor, kind: str = "all_reduce") -> None:
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=_data_group)
    collective_calls[kind] += 1


def all_reduce_model_(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``t`` summed over the model ``group`` in place (one ``all_reduce``,
    counted under ``kind``): the tensor-parallel layers' reduction."""
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    collective_calls[kind] += 1
    return t


def all_gather_model(flat: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's 1-D ``flat`` of this rank's model group, in model
    order: one ``all_gather``, counted as ``ckpt_gather_model`` (the
    gathered checkpoint's collective); ``[flat]`` without a model group."""
    if _model_group is None:
        return [flat]
    out = [torch.empty_like(flat) for _ in range(_mesh.dims[1])]
    tdist.all_gather(out, flat, group=_model_group)
    collective_calls["ckpt_gather_model"] += 1
    return out


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _views(flat: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in like]), like)]


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients summed over the ranks: one ``all_reduce`` (SUM) of one
    flat copy, returned as views of it.  Each rank's gradient is that of its
    share ``ce_sum / (count * world)`` of the global-mean loss, so the sum
    is the global-mean loss's gradient (``ddp_tpu/train/step.py:107``)."""
    grads = list(grads)
    if not tdist.is_initialized():
        return grads
    flat = _flat(grads)
    _all_reduce_sum(flat)
    return _views(flat, grads)


def _buffers(model: nn.Module) -> List[torch.Tensor]:
    return [b for b in model.buffers() if b.is_floating_point()]


@torch.no_grad()
def average_buffers(model: nn.Module) -> None:
    """BatchNorm's running buffers averaged over the ranks, in place: one
    ``all_reduce`` (SUM) of one flat copy, divided by the world (the JAX
    step's ``pmean(new_stats)``, ``ddp_tpu/train/step.py:132``).  A model
    without buffers (DeepNN) issues none, as JAX's ``pmean`` of an empty
    tree issues none."""
    bufs = _buffers(model)
    if not tdist.is_initialized() or not bufs:
        return
    flat = _flat(bufs)
    _all_reduce_sum(flat)
    flat.div_(data_size())
    torch._foreach_copy_(bufs, _views(flat, bufs))


@torch.no_grad()
def broadcast_state(model: nn.Module,
                    momentum: Sequence[torch.Tensor]) -> None:
    """Rank 0's weights, buffers and momentum on every rank, in place: one
    ``broadcast`` of one flat copy.  DDP makes the same broadcast when it
    wraps a model; JAX's replicated state needs none.  Under a mesh each
    data group takes its data-row-0 rank's (its model slice's)."""
    if not tdist.is_initialized():
        return
    tensors = list(model.parameters()) + _buffers(model) + list(momentum)
    flat = _flat(tensors)
    src = 0 if _mesh is None else _mesh.rank_of(0, _mesh.model_index,
                                                 _mesh.stage_index)
    tdist.broadcast(flat, src=src, group=_data_group)
    collective_calls["broadcast"] += 1
    torch._foreach_copy_(tensors, _views(flat, tensors))


def all_reduce_sum_(t: torch.Tensor, kind: str = "all_reduce"
                    ) -> torch.Tensor:
    """``t`` summed over the ranks in place (one ``all_reduce``, counted
    under ``kind``); ``t`` itself without a group.  The epoch's loss and
    eval sums, sync-BN's statistics (``ops/layers.py``) and the drift
    audit's fingerprints (``kind="drift_audit"``) go through it."""
    if tdist.is_initialized():
        _all_reduce_sum(t, kind)
    return t


def reduce_scatter_flat(flat: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``flat`` summed over the ranks: one
    ``reduce_scatter`` (SUM) of the 1-D ``flat``, whose length must be a
    multiple of the world (pad it), into a new buffer of ``1/world`` of it,
    elements ``[rank * s, (rank + 1) * s)``.  ``flat`` itself without a
    group (the JAX package's ``psum_scatter``, ``ddp_tpu/train/zero.py``)."""
    if not tdist.is_initialized():
        return flat
    world = data_size()
    if flat.dim() != 1 or flat.numel() % world:
        raise ValueError(f"reduce_scatter_flat: {tuple(flat.shape)} is not "
                         f"a flat buffer of a multiple of {world} elements")
    out = flat.new_empty(flat.numel() // world)
    tdist.reduce_scatter_tensor(out, flat, op=tdist.ReduceOp.SUM,
                                group=_data_group)
    collective_calls["reduce_scatter"] += 1
    return out


def all_gather_flat(shard: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``shard`` side by side, in rank order: one
    ``all_gather`` into a new buffer of ``world`` times its length.
    ``shard`` itself without a group (``lax.all_gather(tiled=True)``)."""
    if not tdist.is_initialized():
        return shard
    out = shard.new_empty(shard.numel() * data_size())
    tdist.all_gather_into_tensor(out, shard, group=_data_group)
    collective_calls["all_gather"] += 1
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(cmd: Sequence[str], n: int, *,
                 env: Optional[Mapping[str, str]] = None,
                 same_device: bool = False,
                 timeout: Optional[float] = None) -> int:
    """Run ``cmd`` as ``n`` ranks on this machine, wired to a fresh
    localhost rendezvous (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` per rank,
    on top of ``env`` or this process's environment), and return the
    largest exit code.  Children share this process's stdout and stderr.

    ``LOCAL_RANK`` is the rank, or 0 for all with ``same_device`` (several
    ranks on one card).  When a rank fails, the others (which would wait on
    it in a collective) are terminated, and the failed rank's code is
    returned; when ``timeout`` seconds pass first, all are terminated and
    124 is returned.  A rank killed by signal s counts as 128 + s."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    procs: List[subprocess.Popen] = []
    done = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for r in range(n):
            procs.append(subprocess.Popen(list(cmd), env=dict(
                base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                RANK=str(r), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                LOCAL_RANK="0" if same_device else str(r))))
        while len(done) < n and not any(done.values()):
            if deadline is not None and time.monotonic() > deadline:
                return 124
            for r, p in enumerate(procs):
                code = p.poll()
                if code is not None and r not in done:
                    done[r] = code if code >= 0 else 128 - code
            time.sleep(0.05)
        return max(done.values())
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def strip_spawn(argv: Sequence[str]) -> List[str]:
    """``argv`` without ``--spawn N`` (or ``--spawn=N``) in any spelling
    argparse accepts, so a spawned child cannot spawn again."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif _SPAWN_FLAG.fullmatch(a):
            skip = "=" not in a  # the bare flag takes the next word
        else:
            out.append(a)
    return out


def spawn_local(n: int, module: str, argv: Sequence[str]) -> int:
    """The reference's ``mp.spawn(main, nprocs=world_size)``
    (multigpu.py:262-263) and the JAX CLI's ``--spawn N``: run ``python -m
    module argv`` (``--spawn`` removed) as ``n`` local ranks through
    :func:`launch_local`, and return the largest exit code.  A process that
    is already a rank (:func:`in_rendezvous`) must not call this; the entry
    point checks."""
    if in_rendezvous():
        raise RuntimeError("spawn_local: this process is a rank already; a "
                           "rank never spawns")
    return launch_local([sys.executable, "-m", module, *strip_spawn(argv)], n)
