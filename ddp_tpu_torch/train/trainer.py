"""The resident epoch loop (counterpart of the resident half of
``ddp_tpu/train/trainer.py``): the dataset uploaded once, one epoch of
device steps per call, each epoch's losses read to the host once at its end
and printed, a checkpoint every ``save_every`` epochs, and ``resume`` from
one at an epoch boundary."""
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
from . import checkpoint as ckpt_lib
from .epoch import make_train_epoch
from .step import init_train_state


def draw_seed(seed: int, epoch: int, step: int) -> int:
    """The augmentation generator's seed for one step, keyed on
    ``(seed, epoch, step)`` so a step's crops and flips do not depend on
    what ran before it."""
    state = np.random.SeedSequence([seed, epoch, step]).generate_state(
        1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


class Trainer:
    """Trains ``model`` on ``train_loader.dataset`` kept on ``device``.

    Each batch is cropped and flipped on the device (resident mode implies
    device augmentation, as in the JAX CLI) with draws from a device
    :class:`torch.Generator` seeded by :func:`draw_seed`.
    After :meth:`train`, ``loss_history`` holds every step's loss and, on a
    CUDA device, ``step_ms`` every step's device time.

    Every epoch with ``epoch % save_every == 0`` (epoch 0 included, as in
    the reference) ends with a checkpoint at ``snapshot_path``; ``None``
    turns checkpoints off.  With ``resume``, an existing file at
    ``snapshot_path`` restores the weights, BatchNorm buffers, momentum and
    step, and training starts at the file's resume position (the epoch
    after the saved one); a missing file starts fresh."""

    def __init__(self, model: nn.Module, train_loader: TrainLoader, *,
                 device: torch.device,
                 lr_schedule: Callable[[int], float],
                 sgd_config: SGDConfig = SGDConfig(), seed: int = 0,
                 save_every: int = 1,
                 snapshot_path: Optional[str] = "checkpoint.pt",
                 resume: bool = False):
        self.train_loader = train_loader
        self.device = device
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
        """The crop/flip draws of global step ``step`` for ``n`` images."""
        self._generator.manual_seed(draw_seed(self.seed, self._epoch, step))
        return make_draws(self._generator, n, self.device)

    def _run_epoch(self, epoch: int) -> None:
        loader = self.train_loader
        print(f"[GPU0] Epoch {epoch} | Batchsize: "
              f"{loader.per_replica_batch} | Steps: {len(loader)}")
        self._epoch = epoch
        loader.set_epoch(epoch)
        full, tail = loader.epoch_index_matrix()
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
        losses = torch.cat(parts).tolist() if parts else []
        if events is not None:
            self.step_ms.extend(a.elapsed_time(b)
                                for a, b in zip(events, events[1:]))
        self.loss_history.extend(losses)
        if losses:
            print(f"[GPU0] Epoch {epoch} | mean loss "
                  f"{sum(losses) / len(losses):.4f} | last loss "
                  f"{losses[-1]:.4f}")

    def train(self, max_epochs: int) -> None:
        for epoch in range(self.start_epoch, max_epochs):
            self._run_epoch(epoch)
            if self.snapshot_path and epoch % self.save_every == 0:
                self._save(epoch)
