"""The rank grid of a ``--mesh_shape D,M[,S]`` run (counterpart of
``ddp_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a named ``(data, model[, stage])``
mesh in one program; the port runs one process a rank, and :class:`Mesh`
is that layout seen from one rank: rank r sits at data index
``r // (M * S)``, model index ``(r // S) % M`` and stage index ``r % S``,
the device order of ``make_mesh(shape=(d, m, s))``
(``devices[:d*m*s].reshape(d, m, s)``).  The batch is split over the data
axis and replicated over the model and stage axes, so every piece of batch
math divides by :func:`data_axis_size`, never by the rank count.

The process groups follow the grid (``parallel/dist.py::init_mesh``): one
data group for each (model, stage) position (the ranks over which the
gradients, the loss sums and the sharded update reduce), one model group
for each (data, stage) position (over which the tensor-parallel layers
reduce, ``parallel/tp/layers.py``), and under a stage axis ``S > 1`` one
pipe group for each (data, model) position: the S stages of one pipeline,
which hand activations and cotangents to their neighbours
(``parallel/pp/``).  ``(D, M, 1)`` is the 2-D grid.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"

_AXIS_ORDER = (DATA_AXIS, MODEL_AXIS, STAGE_AXIS)


def _check_shape(shape) -> Tuple[int, ...]:
    """Validate a requested (d[, m[, s]]) mesh shape; returns it as ints.

    The three named axes, in fixed order, are ``data`` (batch shards),
    ``model`` (tensor-parallel) and ``stage`` (pipeline-parallel); errors
    name all three so a malformed ``--mesh_shape`` points straight at the
    contract rather than at an unpacking traceback."""
    dims = tuple(shape)
    if not 1 <= len(dims) <= 3:
        raise ValueError(
            f"mesh shape wants 1-3 axes (data[, model[, stage]]), got "
            f"{len(dims)} entries: {shape!r}")
    try:
        dims = tuple(int(v) for v in dims)
    except (TypeError, ValueError):
        raise ValueError(
            f"mesh shape entries must be integers "
            f"(data[, model[, stage]]), got {shape!r}") from None
    if any(v < 1 for v in dims):
        raise ValueError(
            f"mesh shape axes (data, model, stage) must all be positive, "
            f"got {shape!r}")
    return dims


class Mesh:
    """A ``(data, model[, stage])`` grid of ``D * M * S`` ranks, seen from
    ``rank``.

    ``shape`` is ``(D,)``, ``(D, M)`` or ``(D, M, S)``; ``(D, M, 1)`` is the
    2-D grid, as ``make_mesh`` collapses it.  ``dims`` is ``(D, M)``, or
    ``(D, M, S)`` with ``S > 1``; ``devices`` is the grid of ranks,
    ``data_index``/``model_index``/``stage_index`` this rank's place in
    it."""

    def __init__(self, shape, rank: int = 0):
        dims = _check_shape(shape)
        if len(dims) == 3 and dims[2] == 1:
            dims = dims[:2]
        if len(dims) == 1:
            dims = (dims[0], 1)
        self.dims: Tuple[int, ...] = dims
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside the "
                             f"{'x'.join(map(str, dims))} mesh of "
                             f"{self.size} ranks")
        self.rank = int(rank)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return _AXIS_ORDER[:len(self.dims)]

    @property
    def shape(self) -> Dict[str, int]:
        """``{"data": D, "model": M[, "stage": S]}``, as
        ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def stages(self) -> int:
        """The stage axis's extent S (1 on a 2-D grid)."""
        return self.dims[2] if len(self.dims) == 3 else 1

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    @property
    def devices(self) -> np.ndarray:
        """The ``[D, M]`` or ``[D, M, S]`` grid of ranks."""
        return np.arange(self.size).reshape(self.dims)

    @property
    def data_index(self) -> int:
        return self.rank // (self.dims[1] * self.stages)

    @property
    def model_index(self) -> int:
        return (self.rank // self.stages) % self.dims[1]

    @property
    def stage_index(self) -> int:
        return self.rank % self.stages

    def rank_of(self, data_index: int, model_index: int,
                stage_index: int = 0) -> int:
        return (data_index * self.dims[1] + model_index) * self.stages \
            + stage_index

    def data_ranks(self, model_index: int, stage_index: int = 0
                   ) -> List[int]:
        """The ranks at (``model_index``, ``stage_index``): one data
        group."""
        return [self.rank_of(j, model_index, stage_index)
                for j in range(self.dims[0])]

    def model_ranks(self, data_index: int, stage_index: int = 0
                    ) -> List[int]:
        """The ranks at (``data_index``, ``stage_index``): one model
        group."""
        return [self.rank_of(data_index, k, stage_index)
                for k in range(self.dims[1])]

    def stage_ranks(self, data_index: int, model_index: int) -> List[int]:
        """The ranks at (``data_index``, ``model_index``), stage 0 first:
        one pipeline (its pipe group)."""
        return [self.rank_of(data_index, model_index, k)
                for k in range(self.stages)]

    def stage_plane(self, stage_index: int) -> List[int]:
        """Every rank of stage ``stage_index``: its ``(data, model)``
        plane, in rank order."""
        return [self.rank_of(j, k, stage_index) for j in range(self.dims[0])
                for k in range(self.dims[1])]

    def __repr__(self) -> str:
        where = (self.data_index, self.model_index) + (
            (self.stage_index,) if self.stages > 1 else ())
        return (f"Mesh({'x'.join(map(str, self.dims))}, rank {self.rank} at "
                f"{where})")


def make_mesh(shape, rank: int = 0) -> Mesh:
    """``Mesh(shape, rank)``."""
    return Mesh(shape, rank)


def data_axis_size(mesh: Mesh) -> int:
    """Number of batch shards — the ``data`` axis extent.  THE divisor for
    every piece of batch math: the batch is split over ``data`` only
    (replicated over ``model``), so the rank count overcounts by the
    model-axis factor."""
    return int(mesh.shape.get(DATA_AXIS, 1))


def model_axis_size(mesh: Mesh) -> int:
    """Model-axis extent (1 on a data-parallel grid)."""
    return int(mesh.shape.get(MODEL_AXIS, 1))


def stage_axis_size(mesh: Mesh) -> int:
    """Stage-axis extent (1 on a 2-D grid: no pipeline)."""
    return int(mesh.shape.get(STAGE_AXIS, 1))


def local_replica_ids(mesh: Mesh) -> List[int]:
    """The ``data``-axis positions this process feeds: the data row of its
    one rank.  A "replica" is a data-axis ROW (its model-axis ranks all
    consume the same batch shard), not a rank, which would overcount by the
    model-axis factor."""
    return [mesh.data_index]


def local_batch_slice(global_batch: int, mesh: Mesh) -> int:
    """This process's slice of a global batch.

    Batch math uses the ``data`` axis size ONLY: the batch is split over
    ``data`` and replicated over ``model``, so dividing by the rank count
    would shrink every shard by the model-axis factor (and reject batches
    a (2,4) mesh handles fine)."""
    n_shards = data_axis_size(mesh)
    if global_batch % n_shards:
        raise ValueError(
            f"global batch {global_batch} not divisible by the mesh's "
            f"{n_shards}-way data axis")
    per_shard = global_batch // n_shards
    return per_shard * len(local_replica_ids(mesh))
