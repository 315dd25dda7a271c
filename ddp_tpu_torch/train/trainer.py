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
"""
from __future__ import annotations

import sys
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
from ..obs.tracer import get_tracer
from ..optim.sgd import SGDConfig
from ..parallel import dist
from ..resilience.drift import DriftAuditor
from ..resilience.guard import (NonFiniteLossError, RestoreFromLastGood,
                                StepHealthGuard)
from ..resilience.lineage import CheckpointLineage, latest_verifiable
from ..resilience.preemption import PreemptionInterrupt
from . import checkpoint as ckpt_lib
from .epoch import make_train_epoch, make_train_step
from .step import init_train_state
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
    ``grad_accum`` > 1 each row ``i`` of a stacked ``[A, B, ...]`` group
    as views into the group's tensors."""
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
    and loss read.  ``_step_probe``, when set, is called with the global
    step after each streamed step."""

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
                 guard_action: str = "rollback"):
        if train_loader.num_replicas != dist.world_size():
            raise ValueError(f"the train loader has "
                             f"{train_loader.num_replicas} replicas; the "
                             f"world is {dist.world_size()}")
        self.train_loader = train_loader
        self.device = device
        self.rank = dist.rank()
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
        self._health = StepHealthGuard(on_nan, window=guard_window,
                                       spike_factor=guard_spike_factor,
                                       spike_action=guard_action,
                                       metrics=self.metrics)
        self._health.on_lr_backoff = self._apply_lr_backoff
        self._watchdog = watchdog
        self._preemption = preemption
        self._step_probe: Optional[Callable[[int], None]] = None
        # The batch offset the first trained epoch starts at (a mid-epoch
        # data_state); (epoch, batch) positions a guard rollback condemned;
        # epoch -> (its first global step, its start offset), to map a
        # loss's step back to its batch; and (epoch, the first batch not
        # consumed) when a preemption stopped the streaming loop.
        self._resume_offset = 0
        self._skip_batches: set = set()
        self._epoch_origin: Dict[int, Tuple[int, int]] = {}
        self._preempt_pending: Optional[Tuple[int, int]] = None
        self.state = init_train_state(model)
        self.resident: Optional[ResidentData] = None
        kw = dict(sync_bn=sync_bn, shard_update=shard_update,
                  compute_dtype=compute_dtype)
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
            if train_loader.local_replicas != [self.rank]:
                raise ValueError(
                    f"the streaming loader builds replicas "
                    f"{train_loader.local_replicas}; rank {self.rank} "
                    f"streams its own: pass local_replicas=[{self.rank}]")
            self.train_step = make_train_step(
                model, sgd_config, self.lr_schedule, device_augment, **kw)
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
        """``ckpt``'s weights, buffers, momentum and step into the state;
        with ``sharded`` (a live ``shard_update`` state) the momentum is
        cut to this rank's slice again."""
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
        loaded = latest_verifiable(path)
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

    def _checkpoint(self, epoch: int, data_state: Optional[dict] = None
                    ) -> None:
        """Save the state as of ``epoch`` on every rank's call (gathering
        the sharded momentum is a collective); rank 0 writes it, between
        the lineage's preserve and commit.  ``data_state`` defaults to the
        next epoch's first batch."""
        momentum = (opt_shard_to_list(list(self.state.model.parameters()),
                                      self.state.momentum)
                    if self.shard_update else self.state.momentum)
        if self.rank != 0:
            return
        if data_state is None:
            data_state = self._data_state(epoch + 1, 0)
        self.lineage.preserve_head()
        sha = ckpt_lib.save_checkpoint(self.snapshot_path, self.state.model,
                                       momentum, self.state.step, epoch,
                                       data_state=data_state)
        self.lineage.commit(epoch=epoch, step=self.state.step, sha256=sha,
                            data_state=data_state)
        print(f"Epoch {epoch} | Training checkpoint saved at "
              f"{self.snapshot_path}")

    def draws(self, step: int, n: int, micro: int = 0) -> Draws:
        """This rank's crop/flip draws of micro-batch ``micro`` of optimizer
        step ``step`` for ``n`` images."""
        self._generator.manual_seed(draw_seed(
            self.seed, self._epoch, step, self.rank, micro,
            self._health.restores))
        return make_draws(self._generator, n, self.device)

    def dropout(self, step: int, micro: int = 0) -> torch.Generator:
        """This rank's dropout generator for micro-batch ``micro`` of
        optimizer step ``step``, seeded by :func:`dropout_seed`."""
        return self._dropout_generator.manual_seed(dropout_seed(
            self.seed, self._epoch, step, self.rank, micro,
            self._health.restores))

    def _epoch_losses_resident(self, events) -> List[torch.Tensor]:
        """The epoch's index matrix in optimizer-step groups, each group
        one call of the resident epoch."""
        full, tail = self.train_loader.rank_index_matrix(self.rank)
        tracer = get_tracer()
        parts = []
        for idx in optimizer_groups(full, tail, self.grad_accum):
            with tracer.span("dispatch", step=self.state.step):
                parts.append(self.train_epoch(
                    self.state, self.resident.images, self.resident.labels,
                    torch.from_numpy(idx).to(self.device), self.draws,
                    events, self.dropout))
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
        source = self.train_loader if self.grad_accum == 1 else \
            _stack_groups(self.train_loader, self.grad_accum)
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
                        micro_batches(batch.wait(), self.grad_accum),
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
            losses = dist.all_reduce_sum_(torch.cat(parts)).tolist() \
                if parts else []
        self.epoch_seconds.append(time.perf_counter() - t0)
        if self._live_pending:
            self._feed_live()  # the flush has waited for every step
        if events is not None:
            self.step_ms.extend(a.elapsed_time(b)
                                for a, b in zip(events, events[1:]))
        self._flush_losses(epoch, start_step, losses)

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
        self._preempt_pending = None
        loaded = (latest_verifiable(self.snapshot_path)
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
        """Report the emergency checkpoint, force the metrics tail and the
        span spill to disk (a SIGKILL follows SIGTERM), and raise
        :class:`PreemptionInterrupt`."""
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
        self._run_epoch(epoch, start_offset)
        if self._preempt_pending is not None:
            self._emergency_checkpoint_midepoch()
        if self.snapshot_path and epoch % self.save_every == 0:
            self._checkpoint(epoch)
        if epoch_callback is not None:
            epoch_callback(epoch)
        if self._preemption is not None:
            # A collective at world > 1: every rank asks at every boundary.
            # The resident path's stop point is the epoch; the streaming
            # path's the step, whose count is the boundary's id.
            stop = (self._preemption.should_stop(epoch)
                    if self.resident is not None else
                    self._preemption.should_stop_step(self.state.step))
            if stop:
                self._emergency_checkpoint(epoch)

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
