"""The resident epoch loop (counterpart of the resident half of
``ddp_tpu/train/trainer.py``): the dataset uploaded once, one epoch of
device steps per call, each epoch's losses summed over the ranks and read
to the host once at its end and printed, a checkpoint every ``save_every``
epochs (written by rank 0), and ``resume`` from one at an epoch
boundary."""
from __future__ import annotations

import os
import sys
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from ..data.device_augment import Draws, make_draws
from ..data.loader import TrainLoader
from ..data.resident import ResidentData
from ..optim.sgd import SGDConfig
from ..parallel import dist
from . import checkpoint as ckpt_lib
from .epoch import make_train_epoch
from .step import init_train_state


def draw_seed(seed: int, epoch: int, step: int, rank: int = 0) -> int:
    """The augmentation generator's seed for one step of one rank, keyed on
    ``(seed, epoch, step)`` and, for rank r > 0, ``r`` after them, so a
    step's crops and flips do not depend on what ran before it and differ
    between ranks (the JAX step's ``fold_in(rng, axis_index)``,
    ``ddp_tpu/train/step.py:298``).  Rank 0 keeps the single-device key, so
    a world-1 run draws what ``singlegpu`` draws."""
    key = [seed, epoch, step] + ([rank] if rank else [])
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


class Trainer:
    """Trains ``model`` on ``train_loader.dataset`` kept on ``device``, as
    this process's rank of the process group (world 1 without one).

    Each rank runs its columns of the epoch's index matrix
    (``train_loader.num_replicas`` must be the world size).  Each batch is
    cropped and flipped on the device (resident mode implies device
    augmentation, as in the JAX CLI) with draws from a device
    :class:`torch.Generator` seeded by :func:`draw_seed`.
    After :meth:`train`, ``loss_history`` holds every step's global-mean
    loss, the same on every rank, and, on a CUDA device, ``step_ms`` every
    step's device time on this rank.

    Every epoch with ``epoch % save_every == 0`` (epoch 0 included, as in
    the reference) ends with a checkpoint at ``snapshot_path``, written by
    rank 0 (multigpu.py:118); ``None`` turns checkpoints off.  With
    ``resume``, every rank reads an existing file at ``snapshot_path``,
    which restores the weights, BatchNorm buffers, momentum and step, and
    training starts at the file's resume position (the epoch after the
    saved one); a missing file starts fresh.  Either way rank 0's state is
    then broadcast to every rank."""

    def __init__(self, model: nn.Module, train_loader: TrainLoader, *,
                 device: torch.device,
                 lr_schedule: Callable[[int], float],
                 sgd_config: SGDConfig = SGDConfig(), seed: int = 0,
                 save_every: int = 1,
                 snapshot_path: Optional[str] = "checkpoint.pt",
                 resume: bool = False):
        if train_loader.num_replicas != dist.world_size():
            raise ValueError(f"the train loader has "
                             f"{train_loader.num_replicas} replicas; the "
                             f"world is {dist.world_size()}")
        self.train_loader = train_loader
        self.device = device
        self.rank = dist.rank()
        self.seed = seed
        self.save_every = save_every
        self.snapshot_path = snapshot_path
        self.resident = ResidentData(train_loader.dataset, device)
        self.state = init_train_state(model)
        self.train_epoch = make_train_epoch(model, sgd_config, lr_schedule,
                                            device_augment=True)
        self._generator = torch.Generator(device=device)
        self._epoch = 0
        self.start_epoch = 0
        self.loss_history: List[float] = []
        self.step_ms: List[float] = []
        if resume and snapshot_path and os.path.exists(snapshot_path):
            self._resume(snapshot_path)
        dist.broadcast_state(self.state.model, self.state.momentum)

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
        ckpt_lib.restore(ckpt, self.state.model, self.state.momentum)
        self.state.step = ckpt.step
        print(f"Resuming training from snapshot at Epoch {ckpt.epoch}")

    def _save(self, epoch: int) -> None:
        data_state = {"version": 1, "epoch": epoch + 1, "offset": 0,
                      "seed": self.seed, "rng_folds": 0}
        ckpt_lib.save_checkpoint(self.snapshot_path, self.state.model,
                                 self.state.momentum, self.state.step, epoch,
                                 data_state=data_state)
        print(f"Epoch {epoch} | Training checkpoint saved at "
              f"{self.snapshot_path}")

    def draws(self, step: int, n: int) -> Draws:
        """This rank's crop/flip draws of global step ``step`` for ``n``
        images."""
        self._generator.manual_seed(draw_seed(self.seed, self._epoch, step,
                                              self.rank))
        return make_draws(self._generator, n, self.device)

    def _run_epoch(self, epoch: int) -> None:
        loader = self.train_loader
        print(f"[GPU{self.rank}] Epoch {epoch} | Batchsize: "
              f"{loader.per_replica_batch} | Steps: {len(loader)}")
        self._epoch = epoch
        loader.set_epoch(epoch)
        full, tail = loader.rank_index_matrix(self.rank)
        events: Optional[List[torch.cuda.Event]] = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True)]
            events[0].record()
        parts = []
        for idx in ([full] if full.shape[0] else []) + \
                ([tail[None]] if tail is not None else []):
            parts.append(self.train_epoch(
                self.state, self.resident.images, self.resident.labels,
                torch.from_numpy(idx).to(self.device), self.draws, events))
        losses = dist.sum_over_ranks(torch.cat(parts)).tolist() \
            if parts else []
        if events is not None:
            self.step_ms.extend(a.elapsed_time(b)
                                for a, b in zip(events, events[1:]))
        self.loss_history.extend(losses)
        if losses:
            print(f"[GPU{self.rank}] Epoch {epoch} | mean loss "
                  f"{sum(losses) / len(losses):.4f} | last loss "
                  f"{losses[-1]:.4f}")

    def train(self, max_epochs: int) -> None:
        for epoch in range(self.start_epoch, max_epochs):
            self._run_epoch(epoch)
            if self.snapshot_path and epoch % self.save_every == 0 and \
                    self.rank == 0:
                self._save(epoch)
