"""Epoch index matrices for the device-resident path (counterpart of the
index-matrix half of ``ddp_tpu/data/loader.py``; the host-augment streaming
loader is not ported yet).

Row k of a train matrix holds the sample indices of global batch k, replica
blocks side by side; the ragged last batch comes separately at its true size.
Eval matrices are padded with masked index-0 rows instead.  Rank r of a
data-parallel run takes block r of each row (:func:`replica_columns`), the
columns the JAX package's ``P(None, DATA_AXIS)`` sharding gives device r
(``ddp_tpu/train/epoch.py::put_index_matrix``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

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
    batch is ``per_replica_batch * num_replicas``."""

    def __init__(self, dataset: Dataset, per_replica_batch: int,
                 num_replicas: int = 1, *, shuffle: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.per_replica_batch = per_replica_batch
        self.num_replicas = num_replicas
        self.seed = seed
        self.epoch = 0
        if num_replicas > 1:
            self.samplers = [
                DistributedShardSampler(len(dataset), num_replicas, r,
                                        shuffle=shuffle, seed=seed)
                for r in range(num_replicas)]
        else:
            self.samplers = [ShuffleSampler(len(dataset), shuffle=shuffle,
                                            seed=seed)]
        self.steps_per_epoch = -(-len(self.samplers[0]) // per_replica_batch)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for s in self.samplers:
            s.set_epoch(epoch)

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

    def epoch_index_matrix(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(full, tail)``: int32 ``full`` of shape ``[steps_full,
        replicas * b]`` and the ragged last batch's indices ``tail``
        (``[replicas * b_tail]``), or ``None`` when the batch divides the
        shard."""
        shards = [s.indices() for s in self.samplers]
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
    rows, padded and masked to whole batches."""

    def __init__(self, dataset: Dataset, per_replica_batch: int,
                 num_replicas: int = 1):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.global_batch = per_replica_batch * num_replicas

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
