"""The loaders (counterpart of ``ddp_tpu/data/loader.py``): host batches
for the streaming path, and epoch index matrices for the device-resident
path.

Streaming: :meth:`TrainLoader.materialize` builds global batch k as uint8
images and int64 labels on the host, cropped and flipped there when
``augment`` (``data/augment.py``), with the augmentation generator keyed on
``(seed, epoch, k, global replica id, 0x5EED)`` as in the JAX package, so
replica r's rows and crops are the same in both packages and in any
process that builds them.  A data-parallel rank builds its own replica's
rows only (``local_replicas=[rank]``).  The ragged last batch comes at its
true size.  :class:`EvalLoader` yields the test set in order, padded to a
multiple of the world and masked.

Resident: row k of a train matrix holds the sample indices of global batch
k, replica blocks side by side; the ragged last batch comes separately at
its true size.  Eval matrices are padded with masked index-0 rows instead.
Rank r of a data-parallel run takes block r of each row
(:func:`replica_columns`), the columns the JAX package's ``P(None,
DATA_AXIS)`` sharding gives device r
(``ddp_tpu/train/epoch.py::put_index_matrix``).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .augment import random_crop_flip
from .cifar10 import Dataset
from .sampler import DistributedShardSampler, ShuffleSampler


def replica_columns(matrix: np.ndarray, rank: int,
                    num_replicas: int) -> np.ndarray:
    """Block ``rank`` of the last axis of ``matrix`` (replica blocks side by
    side), contiguous: columns ``[rank*b, (rank+1)*b)`` for ``b`` the width
    over ``num_replicas``."""
    if not 0 <= rank < num_replicas or matrix.shape[-1] % num_replicas:
        raise ValueError(f"rank {rank} of {num_replicas} replicas over "
                         f"{matrix.shape[-1]} columns")
    b = matrix.shape[-1] // num_replicas
    return np.ascontiguousarray(matrix[..., rank * b:(rank + 1) * b])


def optimizer_groups(full: np.ndarray, tail: Optional[np.ndarray],
                     grad_accum: int) -> List[np.ndarray]:
    """A rank's ``(full [n_full, B], tail [B_tail])`` index matrices split
    into optimizer-step groups, each ``[G, A', B']``, in order: the full
    batches in groups of ``grad_accum`` (``[G, A, B]``), the remainder of
    full batches as one group (``[1, rem, B]``), and the ragged tail alone
    (``[1, 1, B_tail]``), as the JAX trainer groups them
    (``ddp_tpu/train/trainer.py:555-575``).  At ``grad_accum`` 1 that is
    ``[n_full, 1, B]`` and ``[1, 1, B_tail]``: one step per batch."""
    n_groups, rem = divmod(full.shape[0], grad_accum)
    groups = []
    if n_groups:
        groups.append(full[:n_groups * grad_accum].reshape(
            n_groups, grad_accum, -1))
    if rem:
        groups.append(full[n_groups * grad_accum:][None])
    if tail is not None:
        groups.append(tail[None, None, :])
    return groups


class TrainLoader:
    """``per_replica_batch`` is the reference's ``--batch_size``; the global
    batch is ``per_replica_batch * num_replicas``.  ``local_replicas`` are
    the replicas whose rows :meth:`materialize` builds (all by default; a
    data-parallel rank passes ``[rank]``); the index matrices always cover
    every replica.  ``augment`` crops and flips the host batches
    (``--resident`` and ``--device_augment`` leave it off, the default)."""

    def __init__(self, dataset: Dataset, per_replica_batch: int,
                 num_replicas: int = 1, *, shuffle: bool = True,
                 augment: bool = False, seed: int = 0,
                 local_replicas: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.per_replica_batch = per_replica_batch
        self.num_replicas = num_replicas
        self.augment = augment
        self.seed = seed
        self.epoch = 0
        self.local_replicas = list(range(num_replicas)
                                   if local_replicas is None
                                   else local_replicas)
        if not all(0 <= r < num_replicas for r in self.local_replicas):
            raise ValueError(f"local replicas {self.local_replicas} of "
                             f"{num_replicas}")
        if num_replicas > 1:
            self.samplers = [
                DistributedShardSampler(len(dataset), num_replicas, r,
                                        shuffle=shuffle, seed=seed)
                for r in range(num_replicas)]
        else:
            self.samplers = [ShuffleSampler(len(dataset), shuffle=shuffle,
                                            seed=seed)]
        self.steps_per_epoch = -(-len(self.samplers[0]) // per_replica_batch)
        # The prefetch pool calls materialize() from several threads; the
        # epoch's shards are built once, under this lock.
        self._shards_lock = threading.Lock()
        self._shards: Optional[List[np.ndarray]] = None

    def set_epoch(self, epoch: int) -> None:
        """Reference ``sampler.set_epoch`` (multigpu.py:103)."""
        self.epoch = epoch
        for s in self.samplers:
            s.set_epoch(epoch)
        self._shards = None  # rebuilt for the new epoch at first use

    def __len__(self) -> int:
        return self.steps_per_epoch

    def optimizer_steps_per_epoch(self, grad_accum: int = 1) -> int:
        """How many optimizer steps one epoch takes under ``--grad_accum``
        (``ddp_tpu/data/loader.py:80-94``): the full batches in groups of
        ``grad_accum``, the last group partial, and the ragged final batch
        always a step of its own (:func:`optimizer_groups`), so
        ``ceil(n_full / A) + (1 if ragged else 0)``.  The LR schedule counts
        optimizer steps, so it is built from this number."""
        a = max(grad_accum, 1)
        n_full, rem = divmod(len(self.samplers[0]), self.per_replica_batch)
        return -(-n_full // a) + (1 if rem else 0)

    def _epoch_shards(self) -> List[np.ndarray]:
        """Every replica's index shard of the current epoch, built once."""
        with self._shards_lock:
            if self._shards is None:
                self._shards = [s.indices() for s in self.samplers]
            return self._shards

    def materialize(self, k: int) -> Dict[str, np.ndarray]:
        """Global batch ``k`` of the current epoch, the local replicas' rows
        side by side: ``{"image": uint8 [R_local*b, 32, 32, 3], "label":
        int64 [R_local*b]}`` (``b`` smaller for the ragged last batch).
        Thread-safe and order-free: each replica's crops come from
        ``np.random.default_rng((seed, epoch, k, r, 0x5EED))``, a function
        of the batch alone."""
        shards = self._epoch_shards()
        b = self.per_replica_batch
        idx = np.concatenate([shards[r][k * b:(k + 1) * b]
                              for r in self.local_replicas])
        images = self.dataset.images[idx]
        if self.augment:
            parts = [random_crop_flip(part, np.random.default_rng(
                (self.seed, self.epoch, k, int(r), 0x5EED)))
                for r, part in zip(self.local_replicas,
                                   np.split(images, len(self.local_replicas)))]
            images = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return {"image": images,
                "label": self.dataset.labels[idx].astype(np.int64)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return (self.materialize(k) for k in range(self.steps_per_epoch))

    def epoch_index_matrix(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(full, tail)``: int32 ``full`` of shape ``[steps_full,
        replicas * b]`` and the ragged last batch's indices ``tail``
        (``[replicas * b_tail]``), or ``None`` when the batch divides the
        shard."""
        shards = self._epoch_shards()
        b = self.per_replica_batch
        n_full = len(shards[0]) // b
        full = np.concatenate(
            [sh[:n_full * b].reshape(n_full, b) for sh in shards],
            axis=1).astype(np.int32)
        tails = [sh[n_full * b:] for sh in shards]
        tail = (np.concatenate(tails).astype(np.int32)
                if len(tails[0]) else None)
        return full, tail

    def rank_index_matrix(self, rank: int
                          ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Rank ``rank``'s ``(full [steps_full, b], tail [b_tail])``: its
        block of :meth:`epoch_index_matrix`, which is
        ``DistributedShardSampler(rank=rank)``'s stream batch by batch."""
        full, tail = self.epoch_index_matrix()
        return (replica_columns(full, rank, self.num_replicas),
                None if tail is None else
                replica_columns(tail, rank, self.num_replicas))


class EvalLoader:
    """Sequential test-set batches of ``per_replica_batch * num_replicas``
    rows: padded and masked to whole batches in the index matrices, to a
    multiple of the world in the host batches of :meth:`__iter__`, which
    hold the ``local_replicas``' rows only (all by default)."""

    def __init__(self, dataset: Dataset, per_replica_batch: int,
                 num_replicas: int = 1,
                 local_replicas: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.global_batch = per_replica_batch * num_replicas
        self.local_replicas = list(range(num_replicas)
                                   if local_replicas is None
                                   else local_replicas)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.global_batch)

    def epoch_index_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(idx, mask)`` of shape ``[steps, global_batch]``: indices in
        order, padded with index 0 under mask 0."""
        n = len(self.dataset)
        steps = len(self)
        total = steps * self.global_batch
        idx = np.zeros(total, np.int32)
        idx[:n] = np.arange(n, dtype=np.int32)
        mask = np.zeros(total, np.float32)
        mask[:n] = 1.0
        return (idx.reshape(steps, self.global_batch),
                mask.reshape(steps, self.global_batch))

    def rank_index_matrix(self, rank: int) -> Tuple[np.ndarray, np.ndarray]:
        """Rank ``rank``'s block of :meth:`epoch_index_matrix`: ``(idx,
        mask)`` of shape ``[steps, per_replica_batch]``."""
        return tuple(replica_columns(m, rank, self.num_replicas)
                     for m in self.epoch_index_matrix())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """``{"image", "label", "mask"}`` host batches in order (uint8,
        int64, float32): each global batch padded with zero rows under mask
        0 to a multiple of the world (``ddp_tpu/data/loader.py:198-216``),
        then cut to the local replicas' row blocks."""
        n = len(self.dataset)
        local = len(self.local_replicas) != self.num_replicas
        for start in range(0, n, self.global_batch):
            images = self.dataset.images[start:start + self.global_batch]
            labels = self.dataset.labels[start:start + self.global_batch
                                         ].astype(np.int64)
            size = len(images)
            pad = -size % self.num_replicas
            mask = np.ones(size, np.float32)
            if pad:
                images = np.concatenate([images, np.zeros_like(images[:pad])])
                labels = np.concatenate([labels, np.zeros(pad, np.int64)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            if local:
                per = len(images) // self.num_replicas
                rows = np.concatenate([np.arange(r * per, (r + 1) * per)
                                       for r in self.local_replicas])
                images, labels, mask = images[rows], labels[rows], mask[rows]
            yield {"image": images, "label": labels, "mask": mask}
