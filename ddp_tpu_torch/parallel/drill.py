"""One epoch and one sharded eval, data-parallel, from a given start: the
data-parallel path below the CLI, for parity checks.

    python -m ddp_tpu_torch.parallel.drill SPEC OUT_DIR

runs as one rank of a process group (its rendezvous environment set, as
:func:`~ddp_tpu_torch.parallel.dist.launch_local` sets it) and writes
``OUT_DIR/rank{r}.pt``; :func:`run` launches the ranks and reads their
results.  The spec (:func:`spec`) holds the model (a name of
``models.get_model``, or a VGG architecture list) and its weights, the
datasets, the per-rank batch, the learning rate and seed, whether to crop
and flip, the device, an optional backend, the strategy
flags (``grad_accum``, ``sync_bn``, ``shard_update``), the compute dtype
(``compute_dtype``: ``"bfloat16"`` for ``--bf16``, ``""`` for float32),
the data path (``streaming``, with its ``prefetch_depth``), an optional
``mesh_shape`` ``(D, M)`` (tensor parallelism: the ranks laid out as
``parallel/mesh.py``'s grid, the model cut to each rank's slices by its
``TP_RECIPE``, the loader, the draws and the dropout masks keyed on the
data index; each rank's result holds its slices, which
``interop.gather_state`` joins) or ``(D, M, S)`` (pipeline parallelism,
streaming only: the trainer's ``pp_schedule`` pipeline over the stages of
``parallel/pp/``; rank 0's result holds the whole state, gathered as a
save gathers it, and stage 0's ranks the eval counts), ``deterministic``
(cuDNN's deterministic algorithms and ``use_deterministic_algorithms``, as
``repeat_check --deterministic`` sets them) and an optional
``save_path`` (after the epoch the state is saved there as the trainer
saves it, in ``ckpt_format``).
:func:`margins` says how far a drill epoch's ReLU and max-pool decisions
lie from flipping.

Resident (the default): crop/flip draws come from numpy, keyed on ``(seed,
rank, step)`` (the data index under a mesh) and, for micro-batch k > 0, ``k`` after them, and DeepNN's
dropout masks from a CPU generator keyed on ``(seed, rank, step, k)``
(:func:`dropout_generator`; the mask is drawn on the CPU and copied), so a
run on the card and a run on the CPU draw the same.  Each rank runs its columns of the
epoch in optimizer-step groups (the full batches, then the ragged tail;
``data/loader.py::optimizer_groups``) through
:func:`~ddp_tpu_torch.train.epoch.make_train_epoch` and of the test set
through :func:`~ddp_tpu_torch.train.epoch.make_eval_epoch`.

Streaming: each rank runs the trainer's streaming epoch over its own
replica's host batches (``TrainLoader(..., local_replicas=[rank])``,
cropped and flipped on the host with the JAX package's keys when
``augment``) through the prefetch engine, and the streaming eval
(:func:`~ddp_tpu_torch.train.evaluate.eval_counts`).  Its dropout masks are
the trainer's, drawn on the rank's device: a streamed DeepNN drill on the
card draws other masks than on the CPU.
"""
from __future__ import annotations

import copy
import functools
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.cifar10 import Dataset
from ..data.loader import EvalLoader, TrainLoader, optimizer_groups
from ..data.resident import ResidentData
from ..device import resolve_device, set_tf32
from ..models import get_model
from ..models.vgg import VGG
from ..ops.gather import gather_batch, gather_batch_plain
from ..optim import SGDConfig, triangular_lr
from .. import interop
from ..train import checkpoint as ckpt_lib
from ..train.ckpt_shard import save_checkpoint_sharded, write_slot
from ..train.epoch import make_eval_epoch, make_train_epoch
from ..train.evaluate import eval_counts
from ..train.step import _as_input, init_train_state
from ..train.trainer import Trainer, tp_full_state
from ..train.zero import init_opt_shard, opt_shard_to_list
from . import dist
from .mesh import Mesh
from .pp.partition import plan_stages
from .tp.plan import plan_for_model, shard_module_, wiring


def spec(model: Union[str, Sequence[Union[int, str]]],
         state_dict: Dict[str, torch.Tensor],
         train: Dataset, test: Dataset, *, batch: int, lr: float, seed: int,
         augment: bool, device: str, backend: Optional[str] = None,
         grad_accum: int = 1, sync_bn: bool = False,
         shard_update: bool = False, compute_dtype: str = "",
         streaming: bool = False, prefetch_depth: int = 2,
         mesh_shape: Optional[Sequence[int]] = None,
         pp_schedule: str = "1f1b", deterministic: bool = False,
         save_path: Optional[str] = None,
         ckpt_format: str = "gathered") -> Dict:
    """The drill's input as a dict of tensors and plain values; ``model`` is
    a model name or a VGG architecture list."""
    named = isinstance(model, str)
    return {"model": model if named else "vgg",
            "arch": None if named else list(model),
            "state_dict": {k: v.detach().cpu().clone()
                           for k, v in state_dict.items()},
            "train_images": torch.from_numpy(np.array(train.images)),
            "train_labels": torch.from_numpy(np.array(train.labels)),
            "test_images": torch.from_numpy(np.array(test.images)),
            "test_labels": torch.from_numpy(np.array(test.labels)),
            "batch": batch, "lr": lr, "seed": seed, "augment": augment,
            "device": device, "backend": backend or "",
            "grad_accum": grad_accum, "sync_bn": sync_bn,
            "shard_update": shard_update, "compute_dtype": compute_dtype,
            "streaming": streaming, "prefetch_depth": prefetch_depth,
            "mesh_shape": list(mesh_shape) if mesh_shape else [],
            "pp_schedule": pp_schedule, "deterministic": deterministic,
            "save_path": save_path or "", "ckpt_format": ckpt_format}


def draws_np(seed: int, rank: int, step: int, n: int, micro: int = 0):
    """The drill's crop/flip draws of micro-batch ``micro`` of optimizer
    step ``step`` on rank ``rank``, as numpy ``(ys, xs, flip)``."""
    rng = np.random.default_rng([seed, rank, step] +
                                ([micro] if micro else []))
    off = rng.integers(0, 9, (2, n))
    return off[0], off[1], rng.random(n) < 0.5


def dropout_generator(seed: int, rank: int, step: int,
                      micro: int = 0) -> torch.Generator:
    """The drill's dropout generator of micro-batch ``micro`` of optimizer
    step ``step`` on rank ``rank``: a CPU generator, so the card's masks
    are the CPU's."""
    key = np.random.SeedSequence([seed, rank, step, micro, 0xD80])
    return torch.Generator().manual_seed(
        int(key.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))


def _pool_args(input, kernel_size, stride=None, padding=0, *_, **__):
    return input, kernel_size, stride or kernel_size, padding


class Margins(torch.overrides.TorchFunctionMode):
    """Within it, a forward records the smallest nonzero |input| of any
    ReLU (``relu``, and ``bn_relu``'s clamp at 0 of a 4-D activation) as
    ``kink`` (an exact 0 comes of exact arithmetic, as BatchNorm over a
    count of 1 gives it, which every run computes alike), and the smallest
    nonzero gap between the two largest inputs
    of a max-pool window whose largest is above 0 as ``gap`` (a window of
    ReLU zeros routes its gradient into a zero whichever it picks).  Two
    float32 runs that round otherwise (the card and the CPU, or two
    packages) can take opposite sides of a decision closer than their
    rounding, and their gradients then part by that element's whole
    cotangent: a parity check at a tolerance needs these margins well above
    the rounding."""

    def __init__(self):
        super().__init__()
        self.kink = self.gap = math.inf

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "relu" or (name == "clamp" and args[0].dim() == 4 and
                              kwargs.get("min") == 0.0):
            a = args[0].detach().abs()
            a = a[a > 0]
            if a.numel():
                self.kink = min(self.kink, float(a.min()))
        elif name == "max_pool2d":
            x, k, stride, pad = _pool_args(*args, **kwargs)
            x = x.detach()
            n, c, h, w = x.shape
            cols = torch.nn.functional.unfold(
                torch.nn.functional.pad(x.reshape(n * c, 1, h, w),
                                        (pad,) * 4, value=-math.inf),
                k, stride=stride)
            top = cols.topk(2, dim=1).values
            d = top[:, 0] - top[:, 1]
            d = d[(top[:, 0] > 0) & (d > 0)]
            if d.numel():
                self.gap = min(self.gap, float(d.min()))
        return func(*args, **kwargs)


def margins(model: torch.nn.Module, train: Dataset, *, batch: int,
            seed: int, world: int, accum: int,
            device: str = "cpu") -> Tuple[float, float]:
    """``(kink, gap)`` of :class:`Margins` over a sync-BN drill epoch
    (:func:`spec` with ``augment=True``) at the start weights, in float64
    on ``device`` (BatchNorm's statistics in float32, as the port computes
    them): each global micro-batch, the ranks' gathered and cropped rows
    together, through the model in training mode with the drill's dropout
    masks of rank 0."""
    m64 = copy.deepcopy(model).to(device).double().train()
    loader = TrainLoader(train, batch, world, seed=seed)
    loader.set_epoch(0)
    table = torch.from_numpy(np.array(train.images))
    labels = torch.from_numpy(np.array(train.labels))
    mode, step = Margins(), 0
    with torch.no_grad(), mode:
        for calls in zip(*(optimizer_groups(
                *loader.rank_index_matrix(r), accum) for r in range(world))):
            for g in range(calls[0].shape[0]):
                for k in range(calls[0].shape[1]):
                    xs = [gather_batch_plain(
                        table, labels, torch.from_numpy(c[g, k]),
                        tuple(torch.from_numpy(d) for d in draws_np(
                            seed, r, step, c.shape[2], k)))[0]
                        for r, c in enumerate(calls)]
                    m64(_as_input(torch.cat(xs)).double().to(device),
                        sync_bn=True,
                        generator=dropout_generator(seed, 0, step, k))
                step += 1
    return mode.kink, mode.gap


def _dataset(s: Dict, which: str) -> Dataset:
    return Dataset(s[f"{which}_images"].numpy(), s[f"{which}_labels"].numpy())


def rank_main(spec_path: str, out_dir: str) -> None:
    """This process's rank of the drill."""
    torch.set_num_threads(1)
    s = torch.load(spec_path, weights_only=True)
    if s.get("deterministic"):
        # cuBLAS reads its workspace setting when CUDA starts, below.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True)
    device = dist.initialize(resolve_device(s["device"]),
                             backend=s["backend"] or None)
    try:
        rank, world = dist.rank(), dist.world_size()
        set_tf32(False)
        cd = getattr(torch, s["compute_dtype"]) if s["compute_dtype"] \
            else None
        model = VGG(s["arch"]) if s["arch"] is not None else \
            get_model(s["model"])
        model.load_state_dict(s["state_dict"])
        model.to(device)
        plan = tp = stages = None
        if s["mesh_shape"]:
            mesh = Mesh(s["mesh_shape"], rank)
            dist.init_mesh(mesh)
            plan = plan_for_model(s["model"], model,
                                  model_size=mesh.dims[1])
            if mesh.stages > 1:
                stages = plan_stages(s["model"], mesh.stages,
                                     model_size=mesh.dims[1],
                                     model=get_model(s["model"],
                                                     device="meta"))
            tp = wiring(plan, dist.model_group())
            if tp is not None and not s["streaming"]:
                # The streaming path's Trainer cuts the model itself.
                shard_module_(model, plan, mesh.model_index)
        replica, replicas = dist.data_rank(), dist.data_size()
        train, test = _dataset(s, "train"), _dataset(s, "test")
        loader = TrainLoader(train, s["batch"], replicas, seed=s["seed"],
                             augment=s["augment"] and s["streaming"],
                             local_replicas=[replica])
        sched = functools.partial(
            triangular_lr, base_lr=s["lr"], num_epochs=1,
            steps_per_epoch=loader.optimizer_steps_per_epoch(
                s["grad_accum"]))
        launches = gather_batch.launches
        t0 = _synced_clock(device)
        trainer = None
        if s["streaming"]:
            trainer = _streaming(s, model, loader, sched, cd, device, plan,
                                 stages)
            state = trainer.state
            losses = torch.tensor(trainer.loss_history)
        else:
            state, losses = _resident(s, model, loader, sched, cd, device,
                                      replica, tp)
        train_s = _synced_clock(device) - t0
        train_launches = gather_batch.launches - launches
        launches = gather_batch.launches
        if s["streaming"]:
            whole = trainer.eval_model()
            correct = total = torch.zeros(())
            if whole is not None:
                correct, total = eval_counts(
                    whole, EvalLoader(test, s["batch"], replicas,
                                      local_replicas=[replica]), cd, tp)
        else:
            idx, mask = EvalLoader(test, s["batch"],
                                   replicas).rank_index_matrix(replica)
            tres = ResidentData(test, device)
            correct, total = make_eval_epoch(model, cd, tp)(
                tres.images, tres.labels, torch.from_numpy(idx).to(device),
                torch.from_numpy(mask).to(device))
        eval_launches = gather_batch.launches - launches
        momentum = state.momentum
        if s["shard_update"]:
            momentum = opt_shard_to_list(list(model.parameters()),
                                         state.momentum)
        sd = model.state_dict()
        if stages is not None:
            # The whole state on rank 0 (a collective of every rank), saved
            # there as the trainer saves it.
            sd, named = trainer.full_state()
            momentum = list(named.values())
            if s["save_path"] and rank == 0:
                ckpt_lib.write_gathered(s["save_path"], ckpt_lib.state_arrays(
                    model.name, sd, named), state.step, 0,
                    trainer.data_state())
        elif s["save_path"]:
            _save(s, model, momentum, plan if tp is not None else None,
                  state.step)
        torch.save({
            "rank": rank, "world": world, "backend": dist.backend(),
            "device": str(device), "losses": losses.cpu(),
            "state_dict": {k: v.cpu() for k, v in sd.items()},
            "momentum": [m.cpu() for m in momentum],
            "momentum_numel": sum(m.numel() for m in state.momentum),
            "steps": state.step, "correct": float(correct),
            "total": float(total), "train_launches": train_launches,
            "eval_launches": eval_launches, "train_s": train_s,
            "mesh_shape": s["mesh_shape"],
            "data_index": replica,
            "model_index": dist.mesh().model_index if dist.mesh() else 0,
            "stage_index": dist.stage_index(),
            "pp_bubble": None if stages is None else trainer.pp_step.bubble,
            "pp_peak_inflight": (None if stages is None
                                 else trainer.pp_step.peak_inflight),
            "handoff": dict(dist.handoff_stats),
            "step_ms": [] if trainer is None else list(trainer.step_ms),
            "collectives": dict(dist.collective_calls)},
            os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


def _synced_clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _save(s: Dict, model: torch.nn.Module, momentum, plan, step: int
          ) -> None:
    """The end state at ``s["save_path"]`` as epoch 0, as the trainer saves
    it: under a plan, ``gathered`` joins the slices over the model group
    (every rank) and rank 0 writes the v1 file; ``sharded`` has each
    data-row-0 rank write its slot and rank 0 the index.  Without a plan,
    rank 0 writes its state."""
    path, rank = s["save_path"], dist.rank()
    names = [n for n, _ in model.named_parameters()]
    if plan is not None and s["ckpt_format"] == "sharded":
        if dist.data_rank() != 0:
            return
        arrays = ckpt_lib.state_arrays(model.name, model.state_dict(),
                                       dict(zip(names, momentum)))
        if rank == 0:
            save_checkpoint_sharded(
                path, arrays, step, 0, n_slots=plan.model_size,
                tree_specs=plan.tree_specs, mesh_shape=dist.mesh().dims)
        else:
            write_slot(path, arrays, step, 0, slot=rank,
                       n_slots=plan.model_size, tree_specs=plan.tree_specs)
        return
    sd, mom = (tp_full_state(model, momentum, plan) if plan is not None
               else (model.state_dict(), dict(zip(names, momentum))))
    if rank != 0:
        return
    arrays = ckpt_lib.state_arrays(model.name, sd, mom)
    if s["ckpt_format"] == "sharded":
        save_checkpoint_sharded(path, arrays, step, 0,
                                world=dist.world_size())
    else:
        ckpt_lib.write_gathered(path, arrays, step, 0)


def _resident(s: Dict, model: torch.nn.Module, loader: TrainLoader, sched,
              cd, device: torch.device, rank: int, tp=None):
    """The resident epoch with the drill's numpy draws keyed on ``rank``
    (the data index): ``(state, the global-mean losses)``."""
    loader.set_epoch(0)
    state = init_train_state(model)
    dist.broadcast_state(model, state.momentum)
    if s["shard_update"]:
        state.momentum = init_opt_shard(list(model.parameters()))
    run = make_train_epoch(model, SGDConfig(lr=s["lr"]), sched,
                           device_augment=s["augment"], sync_bn=s["sync_bn"],
                           shard_update=s["shard_update"], compute_dtype=cd,
                           tp=tp)

    def draws(step: int, n: int, micro: int = 0):
        return tuple(torch.from_numpy(d).to(device) for d in
                     draws_np(s["seed"], rank, step, n, micro))

    def dropout(step: int, micro: int = 0) -> torch.Generator:
        return dropout_generator(s["seed"], rank, step, micro)

    res = ResidentData(loader.dataset, device)
    full, tail = loader.rank_index_matrix(rank)
    parts = [run(state, res.images, res.labels,
                 torch.from_numpy(rows).to(device), draws, None, dropout)
             for rows in optimizer_groups(full, tail, s["grad_accum"])]
    return state, dist.all_reduce_sum_(torch.cat(parts))


def _streaming(s: Dict, model: torch.nn.Module, loader: TrainLoader, sched,
               cd, device: torch.device, plan=None, stages=None) -> Trainer:
    """The trainer after its streaming epoch."""
    trainer = Trainer(model, loader, device=device, lr_schedule=sched,
                      sgd_config=SGDConfig(lr=s["lr"]), seed=s["seed"],
                      snapshot_path=None, grad_accum=s["grad_accum"],
                      sync_bn=s["sync_bn"], shard_update=s["shard_update"],
                      compute_dtype=cd, resident=False,
                      prefetch_depth=s["prefetch_depth"], tp_plan=plan,
                      pp_plan=stages, pp_schedule=s["pp_schedule"])
    trainer.train(1)
    return trainer


def run(drill_spec: Dict, world: int, *, same_device: bool = False,
        timeout: float = 120.0, env: Optional[Dict[str, str]] = None
        ) -> List[Dict]:
    """Run the drill as ``world`` local ranks (all on one card with
    ``same_device``) and return each rank's result, rank 0 first.  Raises
    RuntimeError when a rank fails or ``timeout`` seconds pass."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.pt")
        torch.save(drill_spec, path)
        code = dist.launch_local(
            [sys.executable, "-m", "ddp_tpu_torch.parallel.drill", path, tmp],
            world, env=env, same_device=same_device, timeout=timeout)
        if code != 0:
            raise RuntimeError(f"drill: a rank exited with {code}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(world)]


if __name__ == "__main__":
    rank_main(*sys.argv[1:])
