"""The rank grid of a ``--mesh_shape D,M`` run (counterpart of
``ddp_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a named ``(data, model)`` mesh in
one program; the port runs one process a rank, and :class:`Mesh` is that
layout seen from one rank: rank r sits at data index ``r // M`` and model
index ``r % M``, the device order of ``make_mesh(shape=(d, m))``
(``devices[:d*m].reshape(d, m)``).  The batch is split over the data axis
and replicated over the model axis, so every piece of batch math divides
by :func:`data_axis_size`, never by the rank count.

The process groups follow the grid (``parallel/dist.py::init_mesh``): one
data group for each model index (the ranks of a model column, over which
the gradients, the loss sums and the sharded update reduce) and one model
group for each data index (the ranks of a data row, over which the
tensor-parallel layers reduce, ``parallel/tp/layers.py``).  A third axis
``S > 1`` is pipeline parallelism, which the port does not have yet
(ROADMAP A11); ``(D, M, 1)`` is the 2-D grid.
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
    """A ``(data, model)`` grid of ``D * M`` ranks, seen from ``rank``.

    ``shape`` is ``(D,)``, ``(D, M)`` or ``(D, M, 1)``; a stage axis above 1
    is refused (pipeline parallelism, ROADMAP A11).  ``devices`` is the
    ``[D, M]`` grid of ranks, ``data_index``/``model_index`` this rank's
    place in it."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, shape, rank: int = 0):
        dims = _check_shape(shape)
        if len(dims) == 3:
            if dims[2] != 1:
                raise ValueError(
                    f"mesh shape {'x'.join(map(str, dims))} has a pipeline "
                    f"stage axis of {dims[2]}: pipeline parallelism is not "
                    f"ported yet (ROADMAP A11); use D,M")
            dims = dims[:2]
        if len(dims) == 1:
            dims = (dims[0], 1)
        self.dims: Tuple[int, int] = dims
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside the "
                             f"{'x'.join(map(str, dims))} mesh of "
                             f"{self.size} ranks")
        self.rank = int(rank)

    @property
    def shape(self) -> Dict[str, int]:
        """``{"data": D, "model": M}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return self.dims[0] * self.dims[1]

    @property
    def devices(self) -> np.ndarray:
        """The ``[D, M]`` grid of ranks."""
        return np.arange(self.size).reshape(self.dims)

    @property
    def data_index(self) -> int:
        return self.rank // self.dims[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.dims[1]

    def rank_of(self, data_index: int, model_index: int) -> int:
        return data_index * self.dims[1] + model_index

    def data_ranks(self, model_index: int) -> List[int]:
        """The ranks of model column ``model_index``: one data group."""
        return [self.rank_of(j, model_index) for j in range(self.dims[0])]

    def model_ranks(self, data_index: int) -> List[int]:
        """The ranks of data row ``data_index``: one model group."""
        return [self.rank_of(data_index, k) for k in range(self.dims[1])]

    def __repr__(self) -> str:
        return (f"Mesh({self.dims[0]}x{self.dims[1]}, rank {self.rank} at "
                f"({self.data_index}, {self.model_index}))")


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
