"""The epoch loop (counterpart of ``ddp_tpu/train/trainer.py``), on the
resident or the streaming data path: one optimizer step per batch, or per
group of ``grad_accum`` micro-batches, enqueued without waiting for the
device; each epoch's losses summed over the ranks and read to the host once
at its end, checked by the step health guard and printed (and, on rank 0,
written to the metrics stream one record a step); a checkpoint every
``save_every`` epochs (written by rank 0, committed to the checkpoint
lineage); ``resume`` from the newest verifiable one, mid-epoch included;
and a caller's ``epoch_callback`` after each epoch's checkpoint gate.

Resident, the dataset is uploaded once and each epoch runs its index
matrix.  Streaming (``_epoch_losses_streaming``,
``ddp_tpu/train/trainer.py:461-553``), host batches come through the
prefetch engine (``data/prefetch.py``): the loader's pool under
``grad_accum`` 1, the group stream of :func:`_stack_groups` on one
producer thread otherwise, fast-forwarded to a mid-epoch resume's batch.

The resilience hooks (``resilience/``; ``ddp_tpu/train/trainer.py:879-1155``):
the streaming loop asks the preemption guard before each dispatch, drops
the batches a guard rollback condemned, runs the drift audit when it is due
and beats the watchdog; the epoch boundary asks the guard too (the resident
path's only stop point).  :meth:`Trainer.train` is restartable: a
``RestoreFromLastGood`` verdict (``--on_nan restore``, a guard rollback,
``--drift_action restore``) reloads the newest verifiable checkpoint and
goes on from its position, and a preemption ends in an emergency
checkpoint and ``PreemptionInterrupt``.

Storage (``ddp_tpu/train/trainer.py:682-877``): a checkpoint is written on
one writer thread.  The main thread copies the state into a reused host
pool (:class:`~ddp_tpu_torch.train.checkpoint.HostSnapshot`) and hands the
file write (gathered v1 or ``ckpt_format="sharded"`` v2), the lineage's
preserve and commit, the mirror's enqueue and the "checkpoint saved" line
to the writer; :meth:`Trainer._join_pending_save` waits for it, before the
next save, a restore, an emergency exit and the end of :meth:`Trainer.train`,
and re-raises its error there.  With ``mirror`` (a store URI,
``resilience/store.py``) each committed checkpoint is also uploaded by the
mirror's own thread, and resume and restore fall back to it when no local
file restores.

Tensor parallelism (``tp_plan``, under ``--mesh_shape D,M``;
``ddp_tpu/train/trainer.py:765-800``): the model is cut to this rank's
slices, its steps run the tensor-parallel forward, the loader and the
draws follow the rank's data index (every rank of a data row takes the
same batch and the same dropout mask), and the data-parallel collectives
run over the data group.  A gathered (v1) checkpoint joins the slices over
the model group on every rank, then rank 0 writes the one whole file; a
sharded (v2) one is written slot by slot by the data-row-0 ranks
(``train/ckpt_shard.py``).  A restore cuts any file to the live slices.

Pipeline parallelism (``pp_plan``, under ``--mesh_shape D,M,S``;
``ddp_tpu/train/trainer.py:185-208, 369-384, 468-490``): the model is cut to
this rank's stage (and tensor-parallel) slices, each streamed group goes
to its stages (images to stage 0, labels to the others;
``parallel/pp/schedule.py::pp_feed``) and one optimizer step is the
``pp_schedule`` pipeline over its micro-batches (``PPStep``).  The last
stage's losses are summed over its data group and broadcast to the other
stages.  A save gathers each stage's whole state to rank 0, which writes
the canonical v1 file; a restore cuts any file to the live stage's
slices.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import (Callable, Deque, Dict, Iterable, Iterator, List,
                    Optional, Tuple)

import numpy as np
import torch
from torch import nn

from ..data.device_augment import Draws, make_draws
from ..data.loader import TrainLoader, optimizer_groups
from ..data.prefetch import PrefetchStats, prefetch_to_device
from ..data.resident import ResidentData
from ..obs.aggregate import epoch_straggler_record
from ..obs.tracer import get_tracer
from ..optim.sgd import SGDConfig
from ..parallel import dist
from ..resilience.drift import DriftAuditor
from ..resilience.guard import (NonFiniteLossError, RestoreFromLastGood,
                                StepHealthGuard)
from ..resilience.lineage import CheckpointLineage, latest_verifiable
from ..resilience.preemption import PreemptionInterrupt
from ..resilience.store import MirrorUploader, open_store
from . import checkpoint as ckpt_lib
from .. import interop
from ..parallel.pp import schedule as pp_lib
from ..parallel.tp.plan import shard_module_, wiring
from .ckpt_shard import save_checkpoint_sharded, shard_checkpoint, write_slot
from .epoch import make_train_epoch, make_train_step
from .step import init_train_state, make_group_update
from .zero import list_to_opt_shard, opt_shard_to_list


def _stack_groups(batches: Iterable[Dict[str, np.ndarray]], accum: int
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Consecutive host batches stacked into ``[A, B, ...]`` groups of up to
    ``accum`` (``ddp_tpu/train/trainer.py:52-72``).  The ragged last batch
    cannot join a group of full ones, so a change of batch size flushes the
    group: it becomes an optimizer step of its own, as
    :func:`~ddp_tpu_torch.data.loader.optimizer_groups` groups the resident
    path's rows."""
    group: list = []

    def flush():
        out = {k: np.stack([b[k] for b in group]) for k in group[0]}
        group.clear()
        return out

    for b in batches:
        if group and len(b["label"]) != len(group[0]["label"]):
            yield flush()
        group.append(b)
        if len(group) == accum:
            yield flush()
    if group:
        yield flush()


def micro_batches(batch: Dict[str, torch.Tensor], grad_accum: int
                  ) -> List[Dict[str, torch.Tensor]]:
    """A streamed batch's micro-batches: the batch itself, or under
    ``grad_accum`` > 1 (0: a pipeline's group, stacked at any A) each row
    ``i`` of a stacked ``[A, B, ...]`` group as views into the group's
    tensors."""
    if grad_accum == 1:
        return [batch]
    return [{k: v[i] for k, v in batch.items()}
            for i in range(batch["label"].shape[0])]


def draw_seed(seed: int, epoch: int, step: int, rank: int = 0,
              micro: int = 0, folds: int = 0) -> int:
    """The augmentation generator's seed for micro-batch ``micro`` of
    optimizer step ``step`` of one rank, keyed on ``(seed, epoch, step)``
    and, for rank r > 0 or micro-batch k > 0, ``r`` and then ``k`` after
    them, so a micro-batch's crops and flips do not depend on what ran
    before it and differ between ranks (the JAX step's ``fold_in(rng,
    axis_index)``, ``ddp_tpu/train/step.py:298``) and between micro-batches
    (``make_accum_scan``'s ``fold_in(rng, k)``).  Rank 0's micro-batch 0
    keeps the single-device key, so a world-1 run without accumulation
    draws what ``singlegpu`` draws.  After ``folds`` > 0 restores of the
    run (``--on_nan restore``, a rollback) the key ends in
    ``[_FOLD_TAG, folds]``, so the replayed steps draw anew, as the JAX
    step's ``fold_in(rng, restores)`` re-keys them; without a restore the
    key is unchanged."""
    key = [seed, epoch, step] + ([rank] if rank or micro else []) + \
        ([micro] if micro else [])
    return _seed_of(_folded(key, folds))


def _seed_of(key: List[int]) -> int:
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


# Appended to the dropout stream's key: draw_seed's keys are at most five
# long, so the two streams never share a key.
_DROPOUT_STREAM = 0xD80
# Before the restore count in a key: a key without folds never holds it
# where a folded key does (it would have to be a rank or a micro-batch
# index), so no folded key meets an unfolded one.
_FOLD_TAG = 0xF01D


def _folded(key: List[int], folds: int) -> List[int]:
    return key + [_FOLD_TAG, folds] if folds else key


def dropout_seed(seed: int, epoch: int, step: int, rank: int = 0,
                 micro: int = 0, folds: int = 0) -> int:
    """The dropout generator's seed for micro-batch ``micro`` of optimizer
    step ``step`` of rank ``rank``: keyed on all five and a stream tag, a
    stream apart from :func:`draw_seed`'s, as the JAX step keeps dropout's
    key apart from augmentation's ``fold_in(rng, 1)``
    (``ddp_tpu/train/step.py:206-213,243-249``).  Rank 0's stream does not
    depend on the world, so a world-1 ``multigpu`` run draws what
    ``singlegpu`` draws.  ``folds`` re-keys it as in :func:`draw_seed`."""
    return _seed_of(_folded([seed, epoch, step, rank, micro,
                             _DROPOUT_STREAM], folds))


def tp_full_state(model: nn.Module, momentum: List[torch.Tensor], plan
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """``model``'s whole ``state_dict`` and its per-parameter ``momentum``
    (keyed by parameter name).  Under a ``plan`` (the model holds this
    rank's slices) a collective: every rank of the model group joins one
    all-gather of its flat slices (``dist.all_gather_model``), and each
    gets the whole state (``interop.gather_state``); without one, the
    model's own."""
    names = [n for n, _ in model.named_parameters()]
    sd = model.state_dict()
    mom = dict(zip(names, momentum))
    # analysis: divergence-ok(plan is the run's configuration, the same on every rank)
    if plan is None:
        return sd, mom
    like = list(sd.values()) + list(mom.values())
    parts = dist.all_gather_model(torch.cat([t.reshape(-1) for t in like]))
    slices = []
    for part in parts:
        views = [v.view_as(t) for v, t in zip(
            part.split([t.numel() for t in like]), like)]
        slices.append((dict(zip(sd, views[:len(sd)])),
                       dict(zip(mom, views[len(sd):]))))
    return (interop.gather_state(plan, [a for a, _ in slices]),
            interop.gather_state(plan, [b for _, b in slices]))


def pp_refusal(*, resident: bool, shard_update: bool, sync_bn: bool,
               drift_audit_every: int, ckpt_format: str) -> Optional[str]:
    """Why these flags cannot train under a stage axis above 1, in the JAX
    trainer's words (``ddp_tpu/train/trainer.py:189-208``), or None."""
    incompatible = [flag for flag, on in (
        ("--resident (per-stage programs dispatch per step)", resident),
        ("--shard_update (ZeRO shards momentum over data; pp shards it "
         "over stages)", shard_update),
        ("--sync_bn (stage programs do not exchange batch stats)",
         sync_bn),
        ("--drift_audit_every (params are stage-partitioned, not "
         "replicated over data)", bool(drift_audit_every)),
        ("--ckpt_format sharded (pipeline checkpoints stay "
         "canonical/gathered so any (d,m,s) restores anywhere)",
         ckpt_format == "sharded"),
    ) if on]
    if not incompatible:
        return None
    return ("pipeline parallelism (stage axis s>1) is incompatible "
            "with:\n" + "\n".join(f"  - {f}" for f in incompatible))


class Trainer:
    """Trains ``model`` on ``train_loader.dataset`` on ``device``, as this
    process's rank of the process group (world 1 without one);
    ``train_loader.num_replicas`` must be the world size.

    With ``resident`` (the default), the dataset is kept on the device and
    each rank runs its columns of the epoch's index matrix, grouped into
    optimizer steps of ``grad_accum`` micro-batches
    (``data/loader.py::optimizer_groups``); each micro-batch is cropped and
    flipped on the device (resident mode implies device augmentation, as in
    the JAX CLI).  Without it, each rank streams its own replica's host
    batches (``train_loader.local_replicas`` must be ``[rank]``), cropped
    and flipped on the host when the loader augments, or on the device with
    ``device_augment``, through :func:`~ddp_tpu_torch.data.prefetch
    .prefetch_to_device` at ``prefetch_depth``/``prefetch_workers``
    (``prefetch_stats`` counts its time); every micro-batch goes through
    ``gather_batch`` on the device either way.  Device draws come from a
    device :class:`torch.Generator` seeded by :func:`draw_seed`, and each
    micro-batch's dropout mask (DeepNN) from another seeded by
    :func:`dropout_seed`, so a
    streamed run with ``device_augment`` takes the resident run's steps bit
    for bit.  ``sync_bn`` synchronises BatchNorm's statistics over
    the ranks; ``shard_update`` shards the weight update (``train/zero.py``;
    ``state.momentum`` is then the rank's flat slice).  ``compute_dtype``
    (``torch.bfloat16`` under ``--bf16``) is the step's compute dtype; the
    state and the checkpoint stay float32.  After :meth:`train`,
    ``loss_history`` holds every optimizer step's global-mean loss, the
    same on every rank, ``epoch_seconds`` each epoch's wall time (its
    first enqueue to its losses on the host) and, on a CUDA device,
    ``step_ms`` every optimizer step's device time on this rank (between
    CUDA events after consecutive steps).  The process tracer's
    ``dispatch`` spans cover each streamed step's enqueue, or each resident
    call's (one an optimizer-step shape an epoch), and ``loss_flush`` each
    epoch's read of its losses.

    On rank 0, ``metrics`` (a :class:`~ddp_tpu_torch.utils.metrics
    .MetricsLogger`) gets one ``log_step`` an optimizer step, with
    ``lr_schedule(step)``, once the epoch's losses are on the host
    (``ddp_tpu/train/trainer.py:660-665``); and ``live`` (a
    :class:`~ddp_tpu_torch.obs.live.LiveStats`) each streamed step's
    duration (the resident epoch's steps are enqueued without a consumer
    loop to time, as the JAX package's scan is).  On a card that is the
    step's device time, between the CUDA events after the step before it
    and after it, fed once the later event has completed (the host runs
    ahead of the card, so its own loop would time enqueues until the
    launch queue fills); on the CPU, the consumer loop's time.

    Every epoch with ``epoch % save_every == 0`` (epoch 0 included, as in
    the reference) ends with a checkpoint at ``snapshot_path``, written by
    rank 0 (multigpu.py:118) and committed to its lineage
    (``resilience/lineage.py``: the head, ``keep_checkpoints - 1`` rotated
    snapshots and the sha256 manifest); ``None`` turns checkpoints off.
    Its ``data_state`` is the position to resume from (the next epoch's
    first batch, or after a preemption the first batch not consumed) with
    the seed and the restore count.  With ``resume``, every rank reads the
    newest verifiable checkpoint under ``snapshot_path`` (falling back past
    a torn head), which restores the weights, BatchNorm buffers, momentum,
    step and restore count, and training starts at its position, mid-epoch
    on the streaming path; nothing to read starts fresh.  Either way rank
    0's state is then broadcast to every rank, and only then, under
    ``shard_update``, is the momentum cut to each rank's slice.  A
    checkpoint always holds the per-parameter momentum.

    Resilience (the JAX trainer's arguments, meanings and messages):
    ``on_nan`` and ``guard_window``/``guard_spike_factor``/``guard_action``
    make the step health guard (``resilience/guard.py``), which checks each
    epoch's losses where they are read; ``preemption`` (a
    :class:`~ddp_tpu_torch.resilience.preemption.PreemptionGuard`) is asked
    before each streamed step and at each epoch boundary;
    ``drift_audit_every`` K > 0 (streaming only) audits the replicas'
    parameters every K steps with ``drift_action`` on a divergence
    (``resilience/drift.py``); ``watchdog`` gets a beat at each epoch, step
    and loss read.

    Observability (``obs/``; ``ddp_tpu/train/trainer.py:954-1027``): each
    epoch boundary, after the epoch callback and before the preemption
    vote, turns the tracer's spans since the epoch began into the
    ``phase_stragglers`` record (``obs/aggregate.py``; a gather over the
    ranks at world > 1, on every rank alike, whenever the process tracer is
    on).  ``step_probe`` (rank 0 only; the CLI's ``.prom`` rewrite and
    profile trigger) is called with the global step after each optimizer
    step, streamed or resident (the resident epoch is a loop of steps here,
    where the JAX package's is one program).

    Storage: ``ckpt_format`` is ``"gathered"`` (the v1 file) or
    ``"sharded"`` (the v2 index and its one shard, ``train/ckpt_shard.py``);
    rank 0 writes either on its writer thread (see the module docstring).
    ``saves`` records each save: its epoch and step, the main thread's ms
    for the join of the previous write (``join_ms``) and for the snapshot
    and the hand-off (``main_ms``), the writer's seconds (``writer_s``:
    file, sha256, commit), the bytes written and the optimizer steps the
    main thread dispatched while it wrote.  ``mirror`` (a URI or a
    :class:`~ddp_tpu_torch.resilience.store.CheckpointStore`) adds the
    second durability tier; its uploader registers its counters and the
    ``ddp_mirror_lag_epochs`` gauge on ``registry``, and ``mirror_lag``
    holds the lag before and after the end of training's drain."""

    def __init__(self, model: nn.Module, train_loader: TrainLoader, *,
                 device: torch.device,
                 lr_schedule: Callable[[int], float],
                 sgd_config: SGDConfig = SGDConfig(), seed: int = 0,
                 save_every: int = 1,
                 snapshot_path: Optional[str] = "checkpoint.pt",
                 resume: bool = False, grad_accum: int = 1,
                 sync_bn: bool = False, shard_update: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 resident: bool = True, device_augment: bool = False,
                 prefetch_depth: int = 2, prefetch_workers: int = 4,
                 prefetch_stats: Optional[PrefetchStats] = None,
                 metrics=None, live=None, keep_checkpoints: int = 1,
                 on_nan: str = "abort", watchdog=None, preemption=None,
                 drift_audit_every: int = 0, drift_action: str = "abort",
                 guard_window: int = 64, guard_spike_factor: float = 0.0,
                 guard_action: str = "rollback",
                 ckpt_format: str = "gathered", mirror=None,
                 registry=None,
                 step_probe: Optional[Callable[[int], None]] = None,
                 tp_plan=None, pp_plan=None, pp_schedule: str = "1f1b"):
        if train_loader.num_replicas != dist.data_size():
            raise ValueError(f"the train loader has "
                             f"{train_loader.num_replicas} replicas; the "
                             f"data axis is {dist.data_size()}")
        self.train_loader = train_loader
        self.device = device
        self.rank = dist.rank()
        # The batch shard this rank trains on (its data index under a
        # mesh), which keys its loader columns and its draws.
        self.replica = dist.data_rank()
        mesh = dist.mesh()
        model_axis = mesh.dims[1] if mesh is not None else 1
        if tp_plan is not None and tp_plan.model_size != model_axis:
            raise ValueError(f"the plan is for a model axis of "
                             f"{tp_plan.model_size}; the mesh has "
                             f"{model_axis}")
        self.tp_plan = tp_plan
        self._tp = wiring(tp_plan, dist.model_group())
        self._model_index = mesh.model_index if mesh is not None else 0
        stage_axis = mesh.stages if mesh is not None else 1
        if pp_plan is not None and pp_plan.num_stages != stage_axis:
            raise ValueError(f"the stage plan has {pp_plan.num_stages} "
                             f"stages; the mesh's stage axis is "
                             f"{stage_axis}")
        self.pp_plan = pp_plan
        self.pp_schedule = pp_schedule
        self._stage = dist.stage_index()
        if pp_plan is not None:
            why = pp_refusal(resident=resident, shard_update=shard_update,
                             sync_bn=sync_bn,
                             drift_audit_every=drift_audit_every,
                             ckpt_format=ckpt_format)
            if why:
                raise ValueError(why)
        self._base_lr_schedule = lr_schedule
        self._lr_scale = 1.0  # the guard's lr_backoff scale
        self.metrics = metrics if self.rank == 0 else None
        self._live = live if self.rank == 0 else None
        # Streamed steps not yet fed to live on a card: (step, the CUDA
        # events after the step before it and after it).
        self._live_pending: Deque[Tuple[int, torch.cuda.Event,
                                        torch.cuda.Event]] = deque()
        self.seed = seed
        self.save_every = save_every
        self.snapshot_path = snapshot_path
        self.grad_accum = grad_accum
        self.shard_update = shard_update
        self.prefetch_depth = prefetch_depth
        self.prefetch_workers = prefetch_workers
        self.prefetch_stats = prefetch_stats
        self.lineage = (CheckpointLineage(snapshot_path, keep_checkpoints)
                        if snapshot_path else None)
        if ckpt_format not in ("gathered", "sharded"):
            raise ValueError(f"ckpt_format must be 'gathered' or 'sharded', "
                             f"got {ckpt_format!r}")
        self.ckpt_format = ckpt_format
        # One writer in flight; its error is written only by the writer and
        # read only after its join.
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        self._snapshot = ckpt_lib.HostSnapshot()
        self.saves: List[dict] = []
        # The mirror tier: the store on every rank (resume and restore may
        # need it), the uploader on rank 0 (made after the resume below).
        self._mirror_store = (open_store(mirror)
                              if mirror is not None and snapshot_path
                              else None)
        self._mirror: Optional[MirrorUploader] = None
        self.mirror_lag: List[int] = []
        self._health = StepHealthGuard(on_nan, window=guard_window,
                                       spike_factor=guard_spike_factor,
                                       spike_action=guard_action,
                                       metrics=self.metrics,
                                       registry=registry)
        self._health.on_lr_backoff = self._apply_lr_backoff
        self._watchdog = watchdog
        self._preemption = preemption
        self._step_probe = step_probe if self.rank == 0 else None
        # The batch offset the first trained epoch starts at (a mid-epoch
        # data_state); (epoch, batch) positions a guard rollback condemned;
        # epoch -> (its first global step, its start offset), to map a
        # loss's step back to its batch; and (epoch, the first batch not
        # consumed) when a preemption stopped the streaming loop.
        self._resume_offset = 0
        self._skip_batches: set = set()
        self._epoch_origin: Dict[int, Tuple[int, int]] = {}
        self._preempt_pending: Optional[Tuple[int, int]] = None
        if self._tp is not None:
            if drift_audit_every:
                raise ValueError(
                    "--drift_audit_every compares every rank's parameters "
                    "bit for bit, and under a model axis the ranks of a "
                    "data row hold different slices; drop it with "
                    "--mesh_shape D,M (M > 1)")
            shard_module_(model, tp_plan, self._model_index)
        if pp_plan is not None:
            pp_lib.stage_module_(model, pp_plan, self._stage)
        self.state = init_train_state(model)
        self.resident: Optional[ResidentData] = None
        kw = dict(sync_bn=sync_bn, shard_update=shard_update,
                  compute_dtype=compute_dtype, tp=self._tp)
        if resident:
            if train_loader.augment:
                raise ValueError(
                    "the resident path never builds host batches, so the "
                    "loader's host augmentation would be skipped without a "
                    "word; build the TrainLoader with augment=False (the "
                    "resident path crops and flips on the device)")
            if drift_audit_every:
                raise ValueError(
                    "--drift_audit_every audits at step boundaries, which "
                    "the resident whole-epoch dispatch does not have; "
                    "drop --resident to enable the drift audit")
            self.resident = ResidentData(train_loader.dataset, device)
            self.train_epoch = make_train_epoch(
                model, sgd_config, self.lr_schedule, device_augment=True,
                **kw)
        else:
            if train_loader.local_replicas != [self.replica]:
                raise ValueError(
                    f"the streaming loader builds replicas "
                    f"{train_loader.local_replicas}; rank {self.rank} "
                    f"streams its own: pass "
                    f"local_replicas=[{self.replica}]")
            if pp_plan is not None:
                self.train_step = self.pp_step = pp_lib.PPStep(
                    model, pp_plan, self._stage,
                    make_group_update(sgd_config, self.lr_schedule),
                    device=device, device_augment=device_augment,
                    compute_dtype=compute_dtype, tp=self._tp,
                    schedule=pp_schedule, tracer=get_tracer())
            else:
                self.train_step = make_train_step(
                    model, sgd_config, self.lr_schedule, device_augment,
                    **kw)
        self._drift = (DriftAuditor(model, every=drift_audit_every,
                                    action=drift_action)
                       if drift_audit_every else None)
        self._generator = torch.Generator(device=device)
        self._dropout_generator = torch.Generator(device=device)
        self._epoch = 0
        self.start_epoch = 0
        self.loss_history: List[float] = []
        self.step_ms: List[float] = []
        self.epoch_seconds: List[float] = []
        if resume and snapshot_path:
            self._resume(snapshot_path)
        if self._mirror_store is not None and self.rank == 0:
            self._mirror = MirrorUploader(self._mirror_store, snapshot_path,
                                          keep=keep_checkpoints,
                                          registry=registry,
                                          tracer=get_tracer())
            self.lineage.mirror_state = self._mirror.state_of_epoch
        # loss_history[i] is global step _history_base + i: where a restore
        # cuts the discarded trajectory.  _position: (epoch, batch offset)
        # after the last epoch trained, for data_state().
        self._history_base = self.state.step
        self._position = (self.start_epoch, self._resume_offset)
        dist.broadcast_state(self.state.model, self.state.momentum)
        if shard_update:
            self.state.momentum = list_to_opt_shard(self.state.momentum)

    def lr_schedule(self, step: int) -> float:
        """The learning rate of global step ``step``: the schedule, scaled
        by the guard's ``lr_backoff`` (1.0, exactly the schedule, until one
        fires)."""
        return self._base_lr_schedule(step) * self._lr_scale

    def _apply_lr_backoff(self, scale: float) -> None:
        """The guard's ``lr_backoff`` hook: every later step's rate is the
        schedule's times ``scale`` (the steps read it as a Python float
        each, so nothing is rebuilt)."""
        self._lr_scale = scale

    def _restore_into_state(self, ckpt: ckpt_lib.Checkpoint, path: str,
                            sharded: bool = False) -> None:
        """``ckpt``'s weights, buffers, momentum and step into the state,
        cut to this rank's model slices under a plan; with ``sharded`` (a
        live ``shard_update`` state) the momentum is cut to this rank's
        slice again."""
        if self._tp is not None:
            ckpt = shard_checkpoint(ckpt, self.tp_plan, self._model_index)
        if self.pp_plan is not None:
            ckpt = pp_lib.stage_checkpoint(ckpt, self.pp_plan, self._stage)
        momentum = ([torch.zeros_like(p)
                     for p in self.state.model.parameters()]
                    if sharded else self.state.momentum)
        try:
            ckpt_lib.restore(ckpt, self.state.model, momentum)
        except ckpt_lib.CheckpointError as e:
            raise ckpt_lib.CheckpointError(f"checkpoint {path!r}: {e}"
                                           ) from None
        if sharded:
            self.state.momentum = list_to_opt_shard(momentum)
        self.state.step = ckpt.step

    def _resume(self, path: str) -> None:
        loaded = latest_verifiable(path, store=self._mirror_store)
        if loaded is None:
            return  # nothing saved yet: a fresh start
        ckpt, used = loaded
        ds = ckpt.data_state
        if isinstance(ds, dict) and "epoch" in ds:
            # data_state is the position to resume from: (epoch + 1, 0)
            # after an epoch's save, (epoch, offset) after a preemption's.
            self.start_epoch = int(ds["epoch"])
            self._resume_offset = int(ds.get("offset", 0))
            self._health.restores = int(ds.get("rng_folds", 0))
        else:
            self.start_epoch = ckpt.epoch + 1
            print("WARNING: checkpoint has no data_state record; resuming "
                  "at the next epoch boundary", file=sys.stderr)
        if self.resident is not None and self._resume_offset:
            raise ckpt_lib.CheckpointError(
                f"resident mode dispatches whole epochs and cannot "
                f"fast-forward to batch offset {self._resume_offset} of a "
                f"mid-epoch checkpoint ({used!r}); resume this file with "
                f"the streaming loop (drop --resident)")
        self._restore_into_state(ckpt, used)
        print(f"Resuming training from snapshot at Epoch {ckpt.epoch}"
              + ("" if used == path else f" (fallback snapshot {used})"))

    def _data_state(self, epoch: int, offset: int) -> dict:
        """A checkpoint's resume position: batch ``offset`` of ``epoch``,
        with the seed and the restore count the draws are keyed on."""
        return {"version": 1, "epoch": int(epoch), "offset": int(offset),
                "seed": self.seed, "rng_folds": int(self._health.restores)}

    @property
    def restores(self) -> int:
        """Restores of this run (``--on_nan restore``, rollbacks, drift
        restores), and of the runs it resumed."""
        return self._health.restores

    def full_state(self, momentum: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
        """The whole ``state_dict`` and per-parameter momentum (keyed by
        parameter name; the state's own when ``momentum`` is None); under
        a plan a collective (:func:`tp_full_state`).  Under a stage plan a
        collective of every rank, whose whole state lands on rank 0
        (``pp_lib.gather_whole_state``); the other ranks get their stage's
        own (tensor-parallel gathered)."""
        sd, mom = tp_full_state(self.state.model,
                                self.state.momentum if momentum is None
                                else momentum,
                                self.tp_plan if self._tp is not None
                                else None)
        if self.pp_plan is None:
            return sd, mom
        whole = pp_lib.gather_whole_state(sd, mom, self.state.model.name,
                                          self.pp_plan)
        return (sd, mom) if whole is None else whole

    def eval_model(self) -> Optional[nn.Module]:
        """The model to evaluate: the state's own, or under a stage plan
        (a collective of each pipeline) a whole model of this rank's
        tensor-parallel slices on stage 0's ranks and None on the others
        (``pp_lib.gather_eval_model``)."""
        if self.pp_plan is None:
            return self.state.model
        return pp_lib.gather_eval_model(
            self.state.model, self.pp_plan,
            self.tp_plan if self._tp is not None else None,
            self._model_index)

    def pp_share(self, value: float) -> float:
        """Stage 0's ``value`` on every stage of its pipeline (one
        broadcast); ``value`` itself without a stage plan."""
        # analysis: divergence-ok(pp_plan is the run's configuration, the same on every rank)
        if self.pp_plan is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        return float(dist.pipe_broadcast_(t, 0)[0])

    def _checkpoint(self, epoch: int, data_state: Optional[dict] = None
                    ) -> None:
        """Save the state as of ``epoch`` on every rank's call (gathering
        the sharded momentum, and under a plan the gathered format's
        slices, are collectives).  The writing rank joins its previous
        write, copies the state into the host pool and hands the write to
        its writer thread: rank 0 (:meth:`_write`), and under a plan with
        ``ckpt_format="sharded"`` each data-row-0 rank its own slot
        (:meth:`_write_slot`).  ``data_state`` defaults to the next epoch's
        first batch."""
        t0 = time.perf_counter()
        tracer = get_tracer()
        with tracer.span("ckpt_write", step=self.state.step):
            momentum = (opt_shard_to_list(list(self.state.model.parameters()),
                                          self.state.momentum)
                        if self.shard_update else self.state.momentum)
            slots = self._tp is not None and self.ckpt_format == "sharded"
            state = None
            if (self._tp is not None or self.pp_plan is not None) \
                    and not slots:
                state = self.full_state(momentum)
            if self.rank != 0 and not (slots and self.replica == 0):
                return
            if data_state is None:
                data_state = self._data_state(epoch + 1, 0)
            # At most one writer, and the pool is overwritten only after
            # the previous write has read it.
            self._join_pending_save()
            t1 = time.perf_counter()
            if state is None:
                self._snapshot.capture(self.state.model, momentum)
            else:
                self._snapshot.capture_state(self.state.model.name, *state)
            record = {"epoch": int(epoch), "step": int(self.state.step),
                      "join_ms": (t1 - t0) * 1e3}
            self.saves.append(record)
            self._save_thread = threading.Thread(
                target=self._write if self.rank == 0 else self._write_slot,
                args=(epoch, data_state, record), name="ckpt-writer",
                daemon=True)
            self._save_thread.start()
            record["main_ms"] = (time.perf_counter() - t1) * 1e3

    def _write_slot(self, epoch: int, data_state: dict, record: dict
                    ) -> None:
        """A data-row-0 rank's writer thread under a plan: its slot's shard
        file and sidecar (``ckpt_shard.write_slot``), which rank 0's
        :meth:`_write` waits for.  An error is kept for the next join."""
        t0 = time.perf_counter()
        try:
            with get_tracer().span("ckpt_write", step=record["step"],
                                   overlap=True):
                write_slot(self.snapshot_path, self._snapshot.arrays(),
                           record["step"], epoch, slot=self._model_index,
                           n_slots=self.tp_plan.model_size,
                           tree_specs=self.tp_plan.tree_specs)
            record["writer_s"] = time.perf_counter() - t0
        except BaseException as e:  # surfaced at the next join
            self._save_error = e

    def _write(self, epoch: int, data_state: dict, record: dict) -> None:
        """The writer thread: the lineage's preserve, the file (hashed as it
        is written), the commit, the mirror's enqueue (only committed,
        sha-recorded states are mirrored) and the reference's print.  An
        error is kept for the next join."""
        step = record["step"]
        t0 = time.perf_counter()
        try:
            with get_tracer().span("ckpt_write", step=step, overlap=True):
                self.lineage.preserve_head()
                arrays = self._snapshot.arrays()
                shards = None
                if self.ckpt_format == "sharded":
                    mesh = dist.mesh()
                    slotted = self._tp is not None
                    sha, shards = save_checkpoint_sharded(
                        self.snapshot_path, arrays, step, epoch,
                        world=dist.world_size(),
                        n_slots=(self.tp_plan.model_size if slotted
                                 else 1),
                        tree_specs=(self.tp_plan.tree_specs if slotted
                                    else None),
                        mesh_shape=(mesh.dims if mesh is not None
                                    else None),
                        data_state=data_state)
                else:
                    sha = ckpt_lib.write_gathered(self.snapshot_path, arrays,
                                                  step, epoch, data_state)
                self.lineage.commit(epoch=epoch, step=step, sha256=sha,
                                    shards=shards, data_state=data_state)
            if self._mirror is not None:
                self._mirror.enqueue(epoch=epoch, step=step, sha256=sha,
                                     shards=shards or (),
                                     data_state=data_state)
            d = os.path.dirname(os.path.abspath(self.snapshot_path))
            record.update(
                writer_s=time.perf_counter() - t0,
                bytes=os.path.getsize(self.snapshot_path) + sum(
                    os.path.getsize(os.path.join(d, f))
                    for f in shards or ()),
                steps_during=self.state.step - step)
            # Reference print, singlegpu.py:122.
            print(f"Epoch {epoch} | Training checkpoint saved at "
                  f"{self.snapshot_path}")
        except BaseException as e:  # surfaced at the next join
            self._save_error = e

    def _join_pending_save(self) -> None:
        """Wait for the write in flight and re-raise its error: a lost
        checkpoint must not look saved.  At world > 1 only rank 0 writes,
        so only rank 0 raises; it gives the process group up first, so
        that peers waiting in a collective end instead of hanging."""
        if self._save_thread is None:
            return
        self._save_thread.join()
        self._save_thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            if dist.world_size() > 1:
                print(f"[GPU{self.rank}] FATAL: async checkpoint write "
                      f"failed: {err!r}; aborting the process group so "
                      f"peer ranks end instead of hanging in the next "
                      f"collective", file=sys.stderr)
                dist.abort()
            raise err

    def _mirror_drain(self, timeout: float = 30.0) -> None:
        """A bounded wait for the queued uploads (an emergency exit gives
        the remote copy a head start).  Never raises and never waits longer
        than ``timeout``: the local checkpoint is durable already."""
        if self._mirror is None:
            return
        if not self._mirror.drain(timeout):
            print(f"[GPU{self.rank}] mirror: still "
                  f"{self._mirror.lag_epochs()} epoch(s) behind after "
                  f"{timeout:.0f}s drain window; newest state is "
                  "local-only", file=sys.stderr)

    def draws(self, step: int, n: int, micro: int = 0) -> Draws:
        """This rank's crop/flip draws of micro-batch ``micro`` of optimizer
        step ``step`` for ``n`` images."""
        self._generator.manual_seed(draw_seed(
            self.seed, self._epoch, step, self.replica, micro,
            self._health.restores))
        return make_draws(self._generator, n, self.device)

    def dropout(self, step: int, micro: int = 0) -> torch.Generator:
        """This rank's dropout generator for micro-batch ``micro`` of
        optimizer step ``step``, seeded by :func:`dropout_seed`."""
        return self._dropout_generator.manual_seed(dropout_seed(
            self.seed, self._epoch, step, self.replica, micro,
            self._health.restores))

    def _epoch_losses_resident(self, events) -> List[torch.Tensor]:
        """The epoch's index matrix in optimizer-step groups, each group
        one call of the resident epoch."""
        full, tail = self.train_loader.rank_index_matrix(self.replica)
        tracer = get_tracer()
        parts = []
        for idx in optimizer_groups(full, tail, self.grad_accum):
            with tracer.span("dispatch", step=self.state.step):
                parts.append(self.train_epoch(
                    self.state, self.resident.images, self.resident.labels,
                    torch.from_numpy(idx).to(self.device), self.draws,
                    events, self.dropout, self._step_probe))
        return parts

    def _epoch_losses_streaming(self, epoch: int, events, start: int = 0
                                ) -> List[torch.Tensor]:
        """Per-step dispatch over streamed host batches (the reference's
        loop, multigpu.py:104-107), from batch ``start``: each batch (or
        stacked group) waits for its copy on the compute stream, then runs
        one optimizer step.  Before each dispatch the preemption guard is
        asked (a stop records ``(epoch, k)``, k the first batch not
        consumed); a condemned batch is dropped without a step; after each
        step come the drift audit when due, the watchdog's beat and the
        step probe."""
        if self.pp_plan is not None:
            # A pipeline's micro-batches are the group stream's, at any A.
            source = pp_lib.pp_feed(
                _stack_groups(self.train_loader, self.grad_accum),
                self._stage)
        elif self.grad_accum == 1:
            source = self.train_loader
        else:
            source = _stack_groups(self.train_loader, self.grad_accum)
        batches = prefetch_to_device(
            source, self.device, depth=self.prefetch_depth,
            workers=self.prefetch_workers, stats=self.prefetch_stats,
            step0=self.state.step, start=start)
        tracer = get_tracer()
        losses = []
        k = start  # the epoch's batch offset, data_state's coordinate
        t_prev = time.monotonic()
        try:
            for batch in batches:
                step = self.state.step
                if self._preemption is not None and \
                        self._preemption.should_stop_step(step):
                    self._preempt_pending = (epoch, k)
                    break
                if (epoch, k) in self._skip_batches:
                    # A guard rollback condemned it: no step, no update.
                    if self.metrics is not None:
                        self.metrics.log_event("batch_skipped", epoch=epoch,
                                               batch=k, step=step)
                    k += 1
                    continue
                with tracer.span("dispatch", step=step):
                    losses.append(self.train_step(
                        self.state,
                        micro_batches(batch.wait(), 0 if self.pp_plan
                                      is not None else self.grad_accum),
                        self.draws, self.dropout))
                k += 1
                if events is not None:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events.append(ev)
                if self._live is not None:
                    # The step's id is its dispatch span's: the streams
                    # join on it.
                    if events is None:
                        now = time.monotonic()
                        self._live.step(now - t_prev, step=step)
                        t_prev = now
                    else:
                        self._live_pending.append((step, events[-2],
                                                   events[-1]))
                        self._feed_live()
                self._after_step(self.state.step)
        finally:
            batches.close()  # joins the prefetch threads on a stop too
        return losses

    def _after_step(self, step: int) -> None:
        if self._drift is not None and self._drift.due(step):
            # Synchronous: the verdict comes before the next dispatch.
            with get_tracer().span("drift_audit", step=step):
                self._drift.audit(self.state.model, step,
                                  metrics=self.metrics, guard=self._health)
        if self._watchdog is not None:
            self._watchdog.beat()
        if self._step_probe is not None:
            self._step_probe(step)

    def _feed_live(self) -> None:
        """Feed ``live``, in order, each pending streamed step whose end
        event has completed; never waits for the card."""
        while self._live_pending and self._live_pending[0][2].query():
            step, before, after = self._live_pending.popleft()
            self._live.step(before.elapsed_time(after) / 1e3, step=step)

    def _run_epoch(self, epoch: int, start_offset: int = 0) -> None:
        loader = self.train_loader
        print(f"[GPU{self.rank}] Epoch {epoch} | Batchsize: "
              f"{loader.per_replica_batch} | Steps: {len(loader)}")
        if start_offset:
            print(f"Mid-epoch resume: fast-forwarding epoch {epoch} to "
                  f"batch offset {start_offset}")
        t0 = time.perf_counter()
        self._epoch = epoch
        loader.set_epoch(epoch)
        start_step = self.state.step
        self._epoch_origin[epoch] = (start_step, start_offset)
        events: Optional[List[torch.cuda.Event]] = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True)]
            events[0].record()
        if self.resident is not None:
            parts = self._epoch_losses_resident(events)
        else:
            step_losses = self._epoch_losses_streaming(epoch, events,
                                                       start_offset)
            parts = [torch.stack(step_losses)] if step_losses else []
        with get_tracer().span("loss_flush", step=start_step):
            losses = self._sum_losses(parts)
        self.epoch_seconds.append(time.perf_counter() - t0)
        if self._live_pending:
            self._feed_live()  # the flush has waited for every step
        if events is not None:
            self.step_ms.extend(a.elapsed_time(b)
                                for a, b in zip(events, events[1:]))
        self._flush_losses(epoch, start_step, losses)

    def _sum_losses(self, parts: List[torch.Tensor]) -> List[float]:
        """The epoch's global-mean losses on the host: the ranks' shares
        summed over the data group; under a stage plan the last stage's,
        then broadcast to the other stages."""
        if not parts:
            return []
        flat = torch.cat(parts)
        last = self.pp_plan is None or \
            self._stage == self.pp_plan.num_stages - 1
        # analysis: divergence-ok(the sum runs over this stage's data group, whose ranks all share the stage)
        if last:
            dist.all_reduce_sum_(flat)
        # analysis: divergence-ok(pp_plan is the run's configuration, the same on every rank)
        if self.pp_plan is not None:
            dist.pipe_broadcast_(flat, self.pp_plan.num_stages - 1)
        return flat.tolist()

    def _flush_losses(self, epoch: int, start_step: int,
                      losses: List[float]) -> None:
        """The epoch's losses, read once: into ``loss_history``, through
        the health guard (no further device read; it may raise
        ``NonFiniteLossError``, ``LossSpikeError`` or
        ``RestoreFromLastGood``), then to the metrics stream and the
        epoch's loss line."""
        if self._watchdog is not None:
            self._watchdog.beat()
        self.loss_history.extend(losses)
        if losses:
            self._health.check(np.asarray(losses), epoch=epoch,
                               start_step=start_step)
        if self.metrics is not None:
            for i, loss in enumerate(losses):
                self.metrics.log_step(
                    step=start_step + i, epoch=epoch, loss=loss,
                    lr=float(self.lr_schedule(start_step + i)))
        if losses:
            print(f"[GPU{self.rank}] Epoch {epoch} | mean loss "
                  f"{sum(losses) / len(losses):.4f} | last loss "
                  f"{losses[-1]:.4f}")

    def _restore_last_good(self) -> Tuple[int, int]:
        """``--on_nan restore``, a guard rollback or a drift restore: reload
        the newest verifiable checkpoint (lineage fall-back included) on
        every rank, drop the discarded steps from ``loss_history``, and
        return the ``(epoch, batch offset)`` to go on from.  The restore
        count the guard raised re-keys the draws from here on."""
        self._join_pending_save()  # let an in-flight (good) write land
        self._preempt_pending = None
        loaded = (latest_verifiable(self.snapshot_path,
                                    store=self._mirror_store)
                  if self.snapshot_path else None)
        if loaded is None:
            raise NonFiniteLossError(
                "--on_nan restore: no checkpoint to restore from "
                f"(snapshot_path={self.snapshot_path!r}); nothing good was "
                "ever saved")
        ckpt, used = loaded
        self._restore_into_state(ckpt, used, sharded=self.shard_update)
        del self.loss_history[max(ckpt.step - self._history_base, 0):]
        print(f"[GPU{self.rank}] restored last-good checkpoint {used} "
              f"(epoch {ckpt.epoch}, step {ckpt.step}); re-seeded the step "
              "RNG and resuming", file=sys.stderr)
        if self.metrics is not None:
            self.metrics.log_event("restore_from_checkpoint",
                                   epoch=ckpt.epoch, step=ckpt.step,
                                   snapshot=used,
                                   restores=self._health.restores)
        ds = ckpt.data_state
        if isinstance(ds, dict) and "epoch" in ds:
            return int(ds["epoch"]), int(ds.get("offset", 0))
        return ckpt.epoch + 1, 0

    def _mark_poisoned(self, epoch: int, steps: List[int]) -> None:
        """Map a rollback verdict's global steps to their ``(epoch,
        batch)`` positions and condemn them: the streaming loop drops them
        on the replay."""
        origin = self._epoch_origin.get(epoch)
        if origin is None:
            return
        start_step, start_offset = origin
        marked = [(int(epoch), start_offset + int(s) - start_step)
                  for s in steps]
        self._skip_batches.update(marked)
        print(f"[GPU{self.rank}] guard rollback: skipping poisoned batch "
              f"window {[m[1] for m in marked[:8]]} of epoch {epoch} on "
              f"replay", file=sys.stderr)

    def _emergency_exit(self, epoch: int, what: str, **event) -> None:
        """Land the emergency checkpoint (the write joined, the mirror given
        a bounded head start), report it, force the metrics tail and the
        span spill to disk (a SIGKILL follows SIGTERM), and raise
        :class:`PreemptionInterrupt`."""
        self._join_pending_save()
        self._mirror_drain()
        print(f"[GPU{self.rank}] preemption: {what}"
              + (f" is on disk at {self.snapshot_path}" if self.snapshot_path
                 else " — DISABLED (snapshot_path=None), state lost"),
              file=sys.stderr)
        if self.metrics is not None:
            self.metrics.log_event("preemption_checkpoint", epoch=epoch,
                                   step=self.state.step,
                                   snapshot=self.snapshot_path, **event)
            self.metrics.fsync()
        get_tracer().flush(fsync=True)
        raise PreemptionInterrupt(epoch, self.snapshot_path)

    def _emergency_checkpoint(self, epoch: int) -> None:
        """The stop at the boundary after ``epoch``: its checkpoint, taken
        now if the ``save_every`` gate skipped it."""
        if self.snapshot_path and epoch % self.save_every != 0:
            self._checkpoint(epoch)
        self._emergency_exit(epoch, f"emergency checkpoint for epoch "
                                    f"{epoch}")

    def _emergency_checkpoint_midepoch(self) -> None:
        """The stop inside an epoch: its losses so far were read and checked
        with the epoch's, and the checkpoint's ``data_state`` names the
        first batch not consumed."""
        epoch, k = self._preempt_pending
        self._preempt_pending = None
        if self.snapshot_path:
            self._checkpoint(epoch, data_state=self._data_state(epoch, k))
        self._emergency_exit(
            epoch, f"mid-epoch emergency checkpoint at epoch {epoch}, batch "
                   f"offset {k} (global step {self.state.step})", offset=k)

    def _train_one(self, epoch: int, epoch_callback, start_offset: int
                   ) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()
        t_epoch = get_tracer().now()  # the straggler record's window
        self._run_epoch(epoch, start_offset)
        if self._preempt_pending is not None:
            self._emergency_checkpoint_midepoch()
        if self.snapshot_path and epoch % self.save_every == 0:
            self._checkpoint(epoch)
        if epoch_callback is not None:
            epoch_callback(epoch)
        self._log_stragglers(epoch, t_epoch)
        # analysis: divergence-ok(the CLI gives every rank a guard, installed or not)
        if self._preemption is not None:
            # A collective at world > 1: every rank asks at every boundary.
            # The resident path's stop point is the epoch; the streaming
            # path's the step, whose count is the boundary's id.
            stop = (self._preemption.should_stop(epoch)
                    if self.resident is not None else
                    self._preemption.should_stop_step(self.state.step))
            if stop:
                self._emergency_checkpoint(epoch)

    def _log_stragglers(self, epoch: int, since: float) -> None:
        """The epoch's ``phase_stragglers`` record.  At world > 1 it is a
        gather over the ranks, so its gate is the tracer's setting, which
        every rank shares, never rank-local state; it comes before the
        preemption vote, which keeps the boundary's collectives in one
        order.  At world 1 it is skipped where no stream would take it."""
        tracer = get_tracer()
        if not tracer.enabled:
            # analysis: divergence-ok(enabled is shared CLI config)
            return
        gather = dist.world_size() > 1
        if not gather and (self.metrics is None
                           or not getattr(self.metrics, "active", True)):
            return
        epoch_straggler_record(tracer, gather, since, metrics=self.metrics,
                               epoch=epoch)

    def data_state(self) -> dict:
        """Where a run resumed from the current state would start."""
        return self._data_state(*self._position)

    def train(self, max_epochs: int, epoch_callback=None) -> None:
        """Epochs ``start_epoch`` to ``max_epochs - 1`` (the first from a
        mid-epoch resume's batch; each call starts there again, as the JAX
        trainer's does), each followed by the rank-0
        ``save_every`` checkpoint gate, then ``epoch_callback(epoch)``
        (``--eval_every``'s, on every rank;
        ``ddp_tpu/train/trainer.py:1105-1110``) and the preemption check.
        Restartable: a ``RestoreFromLastGood`` verdict rewinds to the
        reloaded checkpoint's position instead of ending the run."""
        epoch, offset = self.start_epoch, self._resume_offset
        try:
            while epoch < max_epochs:
                try:
                    self._train_one(epoch, epoch_callback, offset)
                except RestoreFromLastGood as e:
                    if e.skip_steps:
                        self._mark_poisoned(e.skip_epoch, e.skip_steps)
                    epoch, offset = self._restore_last_good()
                    continue
                epoch, offset = epoch + 1, 0
                self._position = (epoch, offset)
        finally:
            # The last write lands before train() returns, also when the
            # loop unwinds (the daemon writer dies with the interpreter);
            # then its error must not replace the one in flight.
            if sys.exc_info()[1] is None:
                if self._save_thread is not None:
                    # The main thread waits for the last write here: a
                    # serial ckpt_write span, as a save's covers its join
                    # of the write before it.
                    with get_tracer().span("ckpt_write",
                                           step=self.state.step):
                        self._join_pending_save()
                if self._mirror is not None:
                    self.mirror_lag.append(self._mirror.lag_epochs())
                    self._mirror_drain()
                    self.mirror_lag.append(self._mirror.lag_epochs())
            else:
                try:
                    self._join_pending_save()
                except BaseException as e:
                    print(f"checkpoint write failed during shutdown: {e!r}",
                          file=sys.stderr)
                self._mirror_drain(timeout=5.0)
