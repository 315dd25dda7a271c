"""Index samplers with ``DistributedSampler`` / ``DataLoader(shuffle=True)``
semantics (counterpart of ``ddp_tpu/data/sampler.py``; the same numpy
permutations, so both packages visit the data in the same order).

- ``num_samples = ceil(len / world)``; the index list is padded to
  ``num_samples * world`` by repeating its head (``drop_last=False``).
- The shuffle is a permutation seeded with ``seed + epoch``.
- Rank r takes ``indices[r::world]``.
"""
from __future__ import annotations

import numpy as np


class DistributedShardSampler:
    def __init__(self, dataset_size: int, world_size: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world {world_size}")
        self.dataset_size = dataset_size
        self.world_size = world_size
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_size % world_size != 0:
            self.num_samples = dataset_size // world_size
        else:
            self.num_samples = -(-dataset_size // world_size)  # ceil
        self.total_size = self.num_samples * world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """This rank's index shard for the current epoch."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(self.dataset_size)
        else:
            idx = np.arange(self.dataset_size)
        if not self.drop_last and self.total_size > len(idx):
            pad = self.total_size - len(idx)
            reps = -(-pad // len(idx))
            idx = np.concatenate([idx] + [idx] * reps)[: self.total_size]
        else:
            idx = idx[: self.total_size]
        return idx[self.rank:self.total_size:self.world_size]

    def __len__(self) -> int:
        return self.num_samples


class ShuffleSampler:
    """Single-process ``shuffle=True`` DataLoader order: a fresh permutation
    every epoch, no padding (the last batch may be ragged)."""

    def __init__(self, dataset_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset_size = dataset_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.dataset_size)
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(self.dataset_size)

    def __len__(self) -> int:
        return self.dataset_size
