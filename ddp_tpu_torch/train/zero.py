"""Weight-update sharding, ZeRO-1 (counterpart of ``ddp_tpu/train/zero.py``,
the reference's optimizer-state sharding that torch ships as
``ZeroRedundancyOptimizer``).

    local gradients -> reduce_scatter (SUM)   [this rank's 1/world slice]
                    -> SGD on the rank's slice of the parameters
                    -> all_gather of the updated slices

The parameters and their gradients are flattened in ``list(model
.parameters())`` order and padded to a multiple of the world; each rank
keeps the momentum of its slice only (``n_pad / world`` elements, where the
replicated path keeps all ``n``).  The flat order is internal: a checkpoint
holds the per-parameter momentum every mode reads
(:func:`opt_shard_to_list`, ``ddp_tpu/train/trainer.py:755-766``).  The
update is the replicated one, element for element: at world 1 it is
bit-equal to it.  Under ``--bf16`` the gradients it flattens are float32,
as the parameters are (``ddp_tpu/train/zero.py:188-235``).

Under ``--mesh_shape D,M`` (``ddp_tpu/train/zero.py``'s TP composition,
``:100-180, 189-230``) "the ranks" are the rank's data group and "the
world" is the data axis ``D``: each rank's LOCAL flat vector (its model
slices of the sharded leaves and the replicated leaves,
``parallel/tp/plan.py::local_param_count``) is padded and split over its
data group, so each rank holds ``local / D`` of the momentum and both
savings compose.  :func:`opt_shard_to_list` then gives the rank's local
per-parameter momentum, which the checkpoint joins over the model group
(``train/trainer.py``).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..optim import sgd as sgd_lib
from ..parallel import dist
from .step import TrainState


def padded_size(params: Sequence[torch.Tensor], world: int) -> int:
    """The flat parameter count padded up to a multiple of ``world``."""
    n = sum(p.numel() for p in params)
    return n + (-n) % world


def _padded_flat(tensors: Sequence[torch.Tensor], n_pad: int
                 ) -> torch.Tensor:
    flat = [t.reshape(-1) for t in tensors]
    n = sum(t.numel() for t in flat)
    return torch.cat(flat + [flat[0].new_zeros(n_pad - n)])


def _unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Views of ``flat``'s leading elements shaped like ``like``."""
    sizes = [t.numel() for t in like]
    parts = flat[:sum(sizes)].split(sizes)
    return [v.view_as(t) for v, t in zip(parts, like)]


def _rank_slice(flat: torch.Tensor, world: int, rank: int) -> torch.Tensor:
    s = flat.numel() // world
    return flat[rank * s:(rank + 1) * s]


def init_opt_shard(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """This rank's momentum: one flat zero buffer of ``n_pad / world``."""
    world = dist.data_size()
    p = next(iter(params))
    return [p.new_zeros(padded_size(params, world) // world)]


def list_to_opt_shard(momentum: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Per-parameter momentum (the same on every rank) -> this rank's flat
    slice (``pytree_to_opt_shard``, ``ddp_tpu/train/zero.py:151-185``)."""
    world = dist.data_size()
    flat = _padded_flat(momentum, padded_size(momentum, world))
    return [_rank_slice(flat, world, dist.data_rank()).clone()]


def opt_shard_to_list(params: Sequence[torch.Tensor],
                      opt_shard: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Every rank's slice -> the per-parameter momentum, shaped like
    ``params`` (``opt_shard_to_pytree``, ``ddp_tpu/train/zero.py:107-148``).
    A collective (one all-gather): every rank calls it, also where only
    rank 0 writes the checkpoint."""
    return [v.clone() for v in
            _unflatten(dist.all_gather_flat(opt_shard[0]), params)]


def make_zero_update(sgd_config: sgd_lib.SGDConfig,
                     lr_schedule: Callable[[int], float]):
    """``update(state, grads)``, the sharded update stage (the counterpart
    of ``ddp_tpu/train/zero.py::_make_zero_update``), with the arguments of
    :func:`~ddp_tpu_torch.train.step.make_group_update`: BatchNorm's
    running buffers averaged over the ranks (one all-reduce), the rank's
    local gradients flattened, padded and reduce-scattered, SGD at
    ``lr_schedule(state.step)`` on the rank's slice of the flat parameters
    with ``state.momentum`` (its flat slice, :func:`init_opt_shard`) through
    ``optim/sgd.py::apply_updates`` itself, the slices all-gathered and
    copied back into the parameters; then ``state.step += 1``.  Build it
    after the process group exists."""
    world, rank = dist.data_size(), dist.data_rank()

    @torch.no_grad()
    def update(state: TrainState, grads) -> None:
        params = list(state.model.parameters())
        if any(g.dtype != torch.float32 for g in grads):
            raise TypeError(f"the sharded update takes float32 gradients, "
                            f"got {sorted({str(g.dtype) for g in grads})}")
        n_pad = padded_size(params, world)
        dist.average_buffers(state.model)
        g_shard = dist.reduce_scatter_flat(_padded_flat(grads, n_pad))
        p_shard = _rank_slice(_padded_flat(params, n_pad), world, rank)
        sgd_lib.apply_updates([p_shard], [g_shard], state.momentum,
                              lr_schedule(state.step), sgd_config)
        torch._foreach_copy_(
            params, _unflatten(dist.all_gather_flat(p_shard), params))
        state.step += 1

    return update
