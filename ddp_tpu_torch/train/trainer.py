"""The epoch loop (counterpart of ``ddp_tpu/train/trainer.py``), on the
resident or the streaming data path: one optimizer step per batch, or per
group of ``grad_accum`` micro-batches, enqueued without waiting for the
device; each epoch's losses summed over the ranks and read to the host once
at its end and printed (and, on rank 0, written to the metrics stream one
record a step); a checkpoint every ``save_every`` epochs (written by rank
0); ``resume`` from one at an epoch boundary; and a caller's
``epoch_callback`` after each epoch's checkpoint gate.

Resident, the dataset is uploaded once and each epoch runs its index
matrix.  Streaming (``_epoch_losses_streaming``,
``ddp_tpu/train/trainer.py:461-553``), host batches come through the
prefetch engine (``data/prefetch.py``): the loader's pool under
``grad_accum`` 1, the group stream of :func:`_stack_groups` on one
producer thread otherwise.  The JAX loop's per-step preemption check, the
guard's condemned batches, the drift audit and the watchdog belong to the
resilience slice and are not here; nor is a mid-epoch resume, although the
epoch's batch offset reaches the prefetch engine.
"""
from __future__ import annotations

import os
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
              micro: int = 0) -> int:
    """The augmentation generator's seed for micro-batch ``micro`` of
    optimizer step ``step`` of one rank, keyed on ``(seed, epoch, step)``
    and, for rank r > 0 or micro-batch k > 0, ``r`` and then ``k`` after
    them, so a micro-batch's crops and flips do not depend on what ran
    before it and differ between ranks (the JAX step's ``fold_in(rng,
    axis_index)``, ``ddp_tpu/train/step.py:298``) and between micro-batches
    (``make_accum_scan``'s ``fold_in(rng, k)``).  Rank 0's micro-batch 0
    keeps the single-device key, so a world-1 run without accumulation
    draws what ``singlegpu`` draws."""
    key = [seed, epoch, step] + ([rank] if rank or micro else []) + \
        ([micro] if micro else [])
    return _seed_of(key)


def _seed_of(key: List[int]) -> int:
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


# Appended to the dropout stream's key: draw_seed's keys are at most five
# long, so the two streams never share a key.
_DROPOUT_STREAM = 0xD80


def dropout_seed(seed: int, epoch: int, step: int, rank: int = 0,
                 micro: int = 0) -> int:
    """The dropout generator's seed for micro-batch ``micro`` of optimizer
    step ``step`` of rank ``rank``: keyed on all five and a stream tag, a
    stream apart from :func:`draw_seed`'s, as the JAX step keeps dropout's
    key apart from augmentation's ``fold_in(rng, 1)``
    (``ddp_tpu/train/step.py:206-213,243-249``).  Rank 0's stream does not
    depend on the world, so a world-1 ``multigpu`` run draws what
    ``singlegpu`` draws."""
    return _seed_of([seed, epoch, step, rank, micro, _DROPOUT_STREAM])


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
    rank 0 (multigpu.py:118); ``None`` turns checkpoints off.  With
    ``resume``, every rank reads an existing file at ``snapshot_path``,
    which restores the weights, BatchNorm buffers, momentum and step, and
    training starts at the file's resume position (the epoch after the
    saved one); a missing file starts fresh.  Either way rank 0's state is
    then broadcast to every rank, and only then, under ``shard_update``, is
    the momentum cut to each rank's slice.  A checkpoint always holds the
    per-parameter momentum."""

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
                 metrics=None, live=None):
        if train_loader.num_replicas != dist.world_size():
            raise ValueError(f"the train loader has "
                             f"{train_loader.num_replicas} replicas; the "
                             f"world is {dist.world_size()}")
        self.train_loader = train_loader
        self.device = device
        self.rank = dist.rank()
        self.lr_schedule = lr_schedule
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
            self.resident = ResidentData(train_loader.dataset, device)
            self.train_epoch = make_train_epoch(
                model, sgd_config, lr_schedule, device_augment=True, **kw)
        else:
            if train_loader.local_replicas != [self.rank]:
                raise ValueError(
                    f"the streaming loader builds replicas "
                    f"{train_loader.local_replicas}; rank {self.rank} "
                    f"streams its own: pass local_replicas=[{self.rank}]")
            self.train_step = make_train_step(
                model, sgd_config, lr_schedule, device_augment, **kw)
        self._generator = torch.Generator(device=device)
        self._dropout_generator = torch.Generator(device=device)
        self._epoch = 0
        self.start_epoch = 0
        self.loss_history: List[float] = []
        self.step_ms: List[float] = []
        self.epoch_seconds: List[float] = []
        if resume and snapshot_path and os.path.exists(snapshot_path):
            self._resume(snapshot_path)
        dist.broadcast_state(self.state.model, self.state.momentum)
        if shard_update:
            self.state.momentum = list_to_opt_shard(self.state.momentum)

    def _resume(self, path: str) -> None:
        ckpt = ckpt_lib.load_checkpoint(path)
        ds = ckpt.data_state
        if isinstance(ds, dict) and "epoch" in ds:
            if int(ds.get("offset", 0)) > 0:
                raise ckpt_lib.CheckpointError(
                    f"checkpoint {path!r} was saved mid-epoch (epoch "
                    f"{ds['epoch']}, batch offset {ds['offset']}); the port "
                    f"resumes at epoch boundaries only (mid-epoch resume "
                    f"belongs to the resilience slice)")
            self.start_epoch = int(ds["epoch"])
        else:
            self.start_epoch = ckpt.epoch + 1
            print("WARNING: checkpoint has no data_state record; resuming "
                  "at the next epoch boundary", file=sys.stderr)
        try:
            ckpt_lib.restore(ckpt, self.state.model, self.state.momentum)
        except ckpt_lib.CheckpointError as e:
            raise ckpt_lib.CheckpointError(f"checkpoint {path!r}: {e}"
                                           ) from None
        self.state.step = ckpt.step
        print(f"Resuming training from snapshot at Epoch {ckpt.epoch}")

    def _save(self, epoch: int, momentum: List[torch.Tensor]) -> None:
        data_state = {"version": 1, "epoch": epoch + 1, "offset": 0,
                      "seed": self.seed, "rng_folds": 0}
        ckpt_lib.save_checkpoint(self.snapshot_path, self.state.model,
                                 momentum, self.state.step, epoch,
                                 data_state=data_state)
        print(f"Epoch {epoch} | Training checkpoint saved at "
              f"{self.snapshot_path}")

    def draws(self, step: int, n: int, micro: int = 0) -> Draws:
        """This rank's crop/flip draws of micro-batch ``micro`` of optimizer
        step ``step`` for ``n`` images."""
        self._generator.manual_seed(draw_seed(self.seed, self._epoch, step,
                                              self.rank, micro))
        return make_draws(self._generator, n, self.device)

    def dropout(self, step: int, micro: int = 0) -> torch.Generator:
        """This rank's dropout generator for micro-batch ``micro`` of
        optimizer step ``step``, seeded by :func:`dropout_seed`."""
        return self._dropout_generator.manual_seed(dropout_seed(
            self.seed, self._epoch, step, self.rank, micro))

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

    def _epoch_losses_streaming(self, events, start: int = 0
                                ) -> List[torch.Tensor]:
        """Per-step dispatch over streamed host batches (the reference's
        loop, multigpu.py:104-107), from batch ``start``: each batch (or
        stacked group) waits for its copy on the compute stream, then runs
        one optimizer step."""
        source = self.train_loader if self.grad_accum == 1 else \
            _stack_groups(self.train_loader, self.grad_accum)
        batches = prefetch_to_device(
            source, self.device, depth=self.prefetch_depth,
            workers=self.prefetch_workers, stats=self.prefetch_stats,
            step0=self.state.step, start=start)
        tracer = get_tracer()
        losses = []
        t_prev = time.monotonic()
        for batch in batches:
            step = self.state.step
            with tracer.span("dispatch", step=step):
                losses.append(self.train_step(
                    self.state, micro_batches(batch.wait(), self.grad_accum),
                    self.draws, self.dropout))
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            if self._live is None:
                continue
            # The step's id is its dispatch span's: the streams join on it.
            if events is None:
                now = time.monotonic()
                self._live.step(now - t_prev, step=step)
                t_prev = now
            else:
                self._live_pending.append((step, events[-2], events[-1]))
                self._feed_live()
        return losses

    def _feed_live(self) -> None:
        """Feed ``live``, in order, each pending streamed step whose end
        event has completed; never waits for the card."""
        while self._live_pending and self._live_pending[0][2].query():
            step, before, after = self._live_pending.popleft()
            self._live.step(before.elapsed_time(after) / 1e3, step=step)

    def _run_epoch(self, epoch: int) -> None:
        loader = self.train_loader
        print(f"[GPU{self.rank}] Epoch {epoch} | Batchsize: "
              f"{loader.per_replica_batch} | Steps: {len(loader)}")
        t0 = time.perf_counter()
        self._epoch = epoch
        loader.set_epoch(epoch)
        start_step = self.state.step
        events: Optional[List[torch.cuda.Event]] = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True)]
            events[0].record()
        if self.resident is not None:
            parts = self._epoch_losses_resident(events)
        else:
            step_losses = self._epoch_losses_streaming(events)
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
        self.loss_history.extend(losses)
        if self.metrics is not None:
            for i, loss in enumerate(losses):
                self.metrics.log_step(
                    step=start_step + i, epoch=epoch, loss=loss,
                    lr=float(self.lr_schedule(start_step + i)))
        if losses:
            print(f"[GPU{self.rank}] Epoch {epoch} | mean loss "
                  f"{sum(losses) / len(losses):.4f} | last loss "
                  f"{losses[-1]:.4f}")

    def train(self, max_epochs: int, epoch_callback=None) -> None:
        """Epochs ``start_epoch`` to ``max_epochs - 1``, each followed by
        the rank-0 ``save_every`` checkpoint gate and then
        ``epoch_callback(epoch)`` (``--eval_every``'s, on every rank;
        ``ddp_tpu/train/trainer.py:1105-1110``)."""
        for epoch in range(self.start_epoch, max_epochs):
            self._run_epoch(epoch)
            if self.snapshot_path and epoch % self.save_every == 0:
                # Gathering the sharded momentum is a collective: every rank
                # runs it, before the rank-0 gate.
                momentum = (opt_shard_to_list(
                    list(self.state.model.parameters()), self.state.momentum)
                    if self.shard_update else self.state.momentum)
                if self.rank == 0:
                    self._save(epoch, momentum)
            if epoch_callback is not None:
                epoch_callback(epoch)
