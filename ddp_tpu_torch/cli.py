"""Command line of the port (counterpart of ``ddp_tpu/cli.py`` and
``ddp_tpu/entry.py``), on one card or data-parallel over several:

    python -m ddp_tpu_torch.singlegpu <total_epochs> <save_every> \\
        [--batch_size 512] [--model vgg|deepnn|resnet18] \\
        [--init_from_torch STATE_DICT] [--export_torch PATH] \\
        [--resident | [--device_augment] \\
        [--prefetch_depth 2] [--prefetch_workers 4]] \\
        [--synthetic --synthetic_size N [--synthetic_label_noise P]] \\
        [--seed 0] [--lr 0.4] [--momentum 0.9] [--weight_decay 5e-4] \\
        [--grad_accum A] [--sync_bn] [--shard_update] [--bf16] \\
        [--snapshot_path checkpoint.pt] [--resume] [--device cuda|cpu] \\
        [--result_json PATH]
    python -m ddp_tpu_torch.multigpu <same arguments> [--spawn N]

``--model`` trains VGG-11 (the default, the reference's model), DeepNN (the
reference's second model) or ResNet-18 at their full widths, each through
every path and flag below.  ``--init_from_torch`` starts from a reference
torch ``state_dict`` file instead of random weights (the reference's
``checkpoint.pt``; torchvision's ``resnet18`` keys for ResNet-18), and
``--export_torch`` makes rank 0 write the trained model in that format
after training (``interop.py``).

Without ``--resident`` the data streams from the host, as the reference's
does (RUNBOOK.md:66-67): each rank's batches are gathered and cropped and
flipped on the host (the C++ library of ``data/native.py``, keyed as the
JAX package keys them), or only gathered there with ``--device_augment``,
which crops and flips on the card; a pool of ``--prefetch_workers``
threads builds them up to ``--prefetch_depth`` steps ahead, and each is
pinned and copied to the card on a side stream (``data/prefetch.py``).
``--resident`` keeps the dataset on the card instead and implies
``--device_augment``.  Either way every batch becomes the step's input in
one ``gather_batch`` launch.

``singlegpu`` is one process at world 1.  ``multigpu`` is one process per
rank: under a rendezvous environment (``torchrun``'s, or ``--spawn``'s) it
is that rank; otherwise it spawns ``--spawn N`` local ranks, or on ``cuda``
one per visible card (the reference's ``mp.spawn`` over
``torch.cuda.device_count()``, multigpu.py:262-263), and returns the
largest exit code of its ranks.  ``--batch_size`` is the per-rank batch.
The strategy flags have the JAX CLI's meaning (``ddp_tpu/cli.py:215-227``)
and compose with each other and with ``--resume``: ``--grad_accum A`` takes
one optimizer step per A micro-batches (the LR schedule counts optimizer
steps), ``--sync_bn`` takes BatchNorm's statistics over every rank's batch,
``--shard_update`` shards the weight update (ZeRO-1).  At world 1 without a
process group (``singlegpu``) each collective is the identity.  ``--bf16``
computes in bfloat16 where the JAX package's ``compute_dtype`` does
(``models/``), training and eval alike, and composes with all of
them; weights, momentum, BatchNorm's buffers and the checkpoint stay
float32.

Prints what the JAX CLI prints: each epoch's header and loss on every rank
(``[GPU{rank}]``), the checkpoint line of every ``save_every``-th epoch,
and on rank 0 ``Total training time``, ``fp32 model has size=... MiB`` and
``fp32 model has accuracy=...%``.  The checkpoint is the JAX package's v1
file, written by rank 0: either package's ``load_checkpoint`` reads the
other's.  It runs on ``cuda`` unless ``--device cpu`` is given, and refuses
to run without a card otherwise.  A failing rank exits 1.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import interop
from .data import EvalLoader, ResidentData, TrainLoader, cifar10, native
from .data.prefetch import PrefetchStats
from .device import dtype_name, resolve_device, set_tf32
from .models import NAMES as MODEL_NAMES, get_model
from .ops.conv_candidates import conv3x3_fused
from .ops.gather import gather_batch, gather_rows
from .optim import SGDConfig, triangular_lr
from .parallel import dist
from .train.evaluate import evaluate, evaluate_resident
from .train.trainer import Trainer

# The reference's unit constants: model sizes are kept in bits.
MiB = 1024 * 1024 * 8


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("total_epochs", type=int,
                   help="Total epochs to train the model")
    p.add_argument("save_every", type=int,
                   help="Save a checkpoint at the end of every epoch "
                        "whose number is a multiple of this (epoch 0 "
                        "included)")
    p.add_argument("--batch_size", default=512, type=int,
                   help="Input batch size (default: 512)")
    p.add_argument("--model", default="vgg", choices=list(MODEL_NAMES),
                   help="Model to train (reference trains VGG)")
    p.add_argument("--data_root", default=cifar10.DEFAULT_ROOT,
                   help="CIFAR-10 root holding cifar-10-batches-py")
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic dataset (no CIFAR files needed)")
    p.add_argument("--synthetic_size", default=2048, type=int,
                   help="Training-set size for --synthetic (default 2048)")
    p.add_argument("--synthetic_label_noise", default=0.0, type=float,
                   help="Relabel this fraction of --synthetic examples "
                        "(train and test) uniformly at random, putting "
                        "held-out accuracy in a non-saturated regime "
                        "(Bayes ceiling = 1 - 0.9*p)")
    p.add_argument("--resident", action="store_true",
                   help="Keep the whole dataset in device memory and gather "
                        "each batch there (implies on-device augmentation)")
    p.add_argument("--device_augment", "--augment_device",
                   action="store_true",
                   help="Run RandomCrop+HFlip on the card inside the step "
                        "instead of on the host (same distribution): the "
                        "host ships raw uint8 rows")
    p.add_argument("--prefetch_depth", default=2, type=int, metavar="D",
                   help="Streaming: keep up to D prepared batches in flight "
                        "beyond the augment workers' hands, so host "
                        "augment, H2D and compute overlap; 0 builds and "
                        "copies each batch inline (the reference's serial "
                        "loop).  The batches are the same at every setting")
    p.add_argument("--prefetch_workers", default=4, type=int, metavar="W",
                   help="Streaming: host threads building batches (default "
                        "4; the --grad_accum group stream uses one)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the checkpoint if present")
    p.add_argument("--snapshot_path", default="checkpoint.pt",
                   help="Checkpoint path (reference: checkpoint.pt)")
    p.add_argument("--lr", default=0.4, type=float,
                   help="Peak learning rate (reference: 0.4)")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--grad_accum", type=int, default=1, metavar="A",
                   help="Accumulate gradients over A micro-batches per "
                        "optimizer step (effective batch = A * --batch_size "
                        "per replica)")
    p.add_argument("--sync_bn", action="store_true",
                   help="Synchronise BatchNorm statistics across replicas "
                        "(the SyncBatchNorm line the reference keeps "
                        "commented out, multigpu.py:127)")
    p.add_argument("--shard_update", action="store_true",
                   help="ZeRO-1-style weight-update sharding: "
                        "reduce-scatter grads, update a 1/R momentum+param "
                        "slice per rank, all-gather params (same math as "
                        "plain DP, 1/R optimizer memory)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (BASELINE.json config #4)")
    p.add_argument("--init_from_torch", default=None, metavar="STATE_DICT",
                   help="Initialise weights from a torch state_dict "
                        "checkpoint of the reference (e.g. its "
                        "checkpoint.pt) instead of random init")
    p.add_argument("--export_torch", default=None, metavar="PATH",
                   help="After training, also write the model in the "
                        "reference's torch state_dict checkpoint format "
                        "(reference keys for vgg/deepnn, torchvision keys "
                        "for resnet18)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    p.add_argument("--spawn", default=0, type=int, metavar="N",
                   help="multigpu: run N local ranks wired by a fresh "
                        "rendezvous (default: one per visible card on "
                        "cuda, world 1 on cpu)")
    p.add_argument("--result_json", default=None, metavar="PATH",
                   help="Rank 0 writes the run's summary here as JSON: "
                        "world, backend, the data path and its prefetch "
                        "times, the strategy flags, the compute dtype, "
                        "losses, step times, accuracy, and the port's "
                        "kernel launches and the collectives in this "
                        "process")
    return p


def build_schedule(args: argparse.Namespace,
                   train_loader: TrainLoader) -> Callable[[int], float]:
    """The triangular LR over ``args.total_epochs``, advanced per optimizer
    step: ``train_loader.optimizer_steps_per_epoch(args.grad_accum)`` steps
    an epoch (``ddp_tpu/cli.py:760``, ``build_schedule``)."""
    return functools.partial(
        triangular_lr, base_lr=args.lr, num_epochs=args.total_epochs,
        steps_per_epoch=train_loader.optimizer_steps_per_epoch(
            args.grad_accum))


def load_torch_init(model: torch.nn.Module, path: str) -> None:
    """``--init_from_torch``: ``model``'s weights and BatchNorm buffers from
    a reference torch ``state_dict`` file (``ddp_tpu/cli.py:449-465``),
    loaded strictly: a file of another model or width raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(interop.from_reference(model.name, sd))


def export_torch(model: torch.nn.Module, path: str) -> None:
    """``--export_torch``: ``model`` as the reference's torch ``state_dict``
    file (``ddp_tpu/cli.py:482-507``)."""
    torch.save(interop.to_reference(model.name, model.state_dict()), path)
    print(f"Torch state_dict exported to {path}")


def _check_args(args: argparse.Namespace) -> None:
    if args.synthetic_label_noise > 0 and not args.synthetic:
        raise SystemExit(
            "--synthetic_label_noise only applies to the --synthetic "
            "dataset; it would be silently ignored for real CIFAR-10. "
            "Pass --synthetic, or drop the flag.")
    if args.grad_accum < 1:
        raise SystemExit(f"--grad_accum must be at least 1, not "
                         f"{args.grad_accum}")


def run(args: argparse.Namespace, *, data_parallel: bool = False) -> Dict:
    """Train and evaluate; returns ``{"accuracy", "training_seconds",
    "eval_seconds", "loss_history", "step_ms", "state", "rank", "world",
    "backend"}``, where ``state`` is the trained
    :class:`~ddp_tpu_torch.train.step.TrainState`.

    With ``data_parallel`` this process first joins the process group its
    environment describes (:func:`~ddp_tpu_torch.parallel.dist.initialize`;
    world 1 without one) and leaves it at the end, failed or not."""
    _check_args(args)
    device = resolve_device(args.device)
    if data_parallel:
        device = dist.initialize(device)
    try:
        return _train_and_evaluate(args, device)
    finally:
        if data_parallel:
            dist.shutdown()


def _train_and_evaluate(args: argparse.Namespace,
                        device: torch.device) -> Dict:
    rank, world = dist.rank(), dist.world_size()
    set_tf32(False)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.synthetic:
        train_ds, test_ds = cifar10.synthetic(
            n_train=args.synthetic_size,
            n_test=max(args.synthetic_size // 4, 64),
            label_noise=args.synthetic_label_noise)
    else:
        train_ds, test_ds = cifar10.load(args.data_root)

    generator = torch.Generator().manual_seed(args.seed)
    model = get_model(args.model, device=device, generator=generator)
    if args.init_from_torch:
        load_torch_init(model, args.init_from_torch)
    device_augment = args.device_augment or args.resident
    train_loader = TrainLoader(train_ds, args.batch_size, world,
                               seed=args.seed, augment=not device_augment,
                               local_replicas=[rank])
    # What crops and flips on the host: the C++ library (built here, before
    # the clock starts) or numpy; None where the card does it.
    host_augment = native.path() if train_loader.augment else None
    prefetch = PrefetchStats()
    trainer = Trainer(
        model, train_loader, device=device,
        lr_schedule=build_schedule(args, train_loader),
        sgd_config=SGDConfig(args.lr, args.momentum, args.weight_decay),
        seed=args.seed, save_every=args.save_every,
        snapshot_path=args.snapshot_path, resume=args.resume,
        grad_accum=args.grad_accum, sync_bn=args.sync_bn,
        shard_update=args.shard_update, compute_dtype=compute_dtype,
        resident=args.resident, device_augment=device_augment,
        prefetch_depth=args.prefetch_depth,
        prefetch_workers=args.prefetch_workers, prefetch_stats=prefetch)

    start = time.time()
    trainer.train(args.total_epochs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    training_seconds = time.time() - start
    n_params = sum(p.numel() for p in model.parameters())
    if rank == 0:
        print(f"Total training time: {training_seconds:.2f} seconds")
        print(f"fp32 model has size={n_params * 32 / MiB:.2f} MiB")
        if args.export_torch:
            export_torch(model, args.export_torch)

    start = time.time()
    eval_loader = EvalLoader(test_ds, args.batch_size, world,
                             local_replicas=[rank])
    if args.resident:
        accuracy = evaluate_resident(model, ResidentData(test_ds, device),
                                     eval_loader, compute_dtype)
    else:
        accuracy = evaluate(model, eval_loader, compute_dtype)
    eval_seconds = time.time() - start
    out = {"accuracy": accuracy, "training_seconds": training_seconds,
           "eval_seconds": eval_seconds,
           "loss_history": list(trainer.loss_history),
           "step_ms": list(trainer.step_ms),
           "epoch_seconds": list(trainer.epoch_seconds), "rank": rank,
           "world": world, "backend": dist.backend(), "model": args.model,
           "grad_accum": args.grad_accum, "sync_bn": args.sync_bn,
           "shard_update": args.shard_update,
           "compute_dtype": dtype_name(compute_dtype),
           "data_path": "resident" if args.resident else "streaming",
           "device_augment": device_augment, "host_augment": host_augment,
           "prefetch": None if args.resident else prefetch.per_step_ms(),
           "prefetch_depth": args.prefetch_depth,
           "prefetch_workers": args.prefetch_workers}
    if rank == 0:
        print(f"fp32 model has accuracy={accuracy:.2f}%")
        if args.result_json:
            launches = {"gather_batch": gather_batch.launches,
                        "gather_batch_bf16": gather_batch.launches_bf16,
                        "row_gather": gather_rows.launches,
                        "conv3x3": conv3x3_fused.launches}
            with open(args.result_json, "w") as f:
                json.dump(dict(out, device=str(device),
                               kernel_launches=launches,
                               collectives=dict(dist.collective_calls)), f)
    return dict(out, state=trainer.state)


def main(argv: Optional[List[str]] = None) -> Dict:
    """``singlegpu``: one process, world 1."""
    args = build_parser("Single-card training (PyTorch port)"
                        ).parse_args(argv)
    if args.spawn:
        raise SystemExit("singlegpu runs one process; --spawn belongs to "
                         "multigpu")
    return run(args)


def main_multi(argv: Optional[List[str]] = None) -> Dict:
    """``multigpu``: this process's rank of the run, or the spawner of its
    ranks (see the module's docstring), which exits with their largest
    exit code.  A rank never spawns."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser("Data-parallel training (PyTorch port)"
                        ).parse_args(argv)
    if not dist.in_rendezvous():
        _check_args(args)
        device = resolve_device(args.device)
        n = args.spawn or (torch.cuda.device_count()
                           if device.type == "cuda" else 0)
        if n:
            raise SystemExit(dist.spawn_local(n, "ddp_tpu_torch.multigpu",
                                              argv))
    return run(args, data_parallel=True)
