"""Command line of the port (counterpart of ``ddp_tpu/cli.py``), for the
resident single-card path:

    python -m ddp_tpu_torch.singlegpu <total_epochs> <save_every> \\
        [--batch_size 512] --resident [--synthetic --synthetic_size N] \\
        [--seed 0] [--lr 0.4] [--momentum 0.9] [--weight_decay 5e-4] \\
        [--snapshot_path checkpoint.pt] [--resume] [--device cuda|cpu]

Prints what the JAX CLI prints: each epoch's header and loss, the
checkpoint line of every ``save_every``-th epoch, ``Total training time``,
``fp32 model has size=... MiB`` and ``fp32 model has accuracy=...%``.  The
checkpoint is the JAX package's v1 file: either package's
``load_checkpoint`` reads the other's.  It runs on ``cuda`` unless
``--device cpu`` is given, and refuses to run without a card otherwise.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Dict, List, Optional

import torch

from .data import EvalLoader, ResidentData, TrainLoader, cifar10
from .device import resolve_device, set_tf32
from .models import get_model
from .optim import SGDConfig, triangular_lr
from .train.evaluate import evaluate_resident
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
    p.add_argument("--data_root", default=cifar10.DEFAULT_ROOT,
                   help="CIFAR-10 root holding cifar-10-batches-py")
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic dataset (no CIFAR files needed)")
    p.add_argument("--synthetic_size", default=2048, type=int,
                   help="Training-set size for --synthetic (default 2048)")
    p.add_argument("--resident", action="store_true",
                   help="Keep the whole dataset in device memory and gather "
                        "each batch there (implies on-device augmentation); "
                        "the only data path ported so far")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the checkpoint if present")
    p.add_argument("--snapshot_path", default="checkpoint.pt",
                   help="Checkpoint path (reference: checkpoint.pt)")
    p.add_argument("--lr", default=0.4, type=float,
                   help="Peak learning rate (reference: 0.4)")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    return p


def run(args: argparse.Namespace) -> Dict:
    """Train and evaluate; returns ``{"accuracy", "training_seconds",
    "eval_seconds", "loss_history", "step_ms", "state"}``, where ``state``
    is the trained :class:`~ddp_tpu_torch.train.step.TrainState`."""
    device = resolve_device(args.device)
    if not args.resident:
        raise SystemExit("only the --resident data path is ported so far; "
                         "pass --resident")
    set_tf32(False)
    if args.synthetic:
        train_ds, test_ds = cifar10.synthetic(
            n_train=args.synthetic_size,
            n_test=max(args.synthetic_size // 4, 64))
    else:
        train_ds, test_ds = cifar10.load(args.data_root)

    generator = torch.Generator().manual_seed(args.seed)
    model = get_model("vgg", device=device, generator=generator)
    train_loader = TrainLoader(train_ds, args.batch_size, seed=args.seed)
    lr_schedule = functools.partial(
        triangular_lr, base_lr=args.lr, num_epochs=args.total_epochs,
        steps_per_epoch=len(train_loader))
    trainer = Trainer(
        model, train_loader, device=device, lr_schedule=lr_schedule,
        sgd_config=SGDConfig(args.lr, args.momentum, args.weight_decay),
        seed=args.seed, save_every=args.save_every,
        snapshot_path=args.snapshot_path, resume=args.resume)

    start = time.time()
    trainer.train(args.total_epochs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    training_seconds = time.time() - start
    print(f"Total training time: {training_seconds:.2f} seconds")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"fp32 model has size={n_params * 32 / MiB:.2f} MiB")

    start = time.time()
    accuracy = evaluate_resident(model, ResidentData(test_ds, device),
                                 EvalLoader(test_ds, args.batch_size))
    eval_seconds = time.time() - start
    print(f"fp32 model has accuracy={accuracy:.2f}%")
    return {"accuracy": accuracy, "training_seconds": training_seconds,
            "eval_seconds": eval_seconds,
            "loss_history": list(trainer.loss_history),
            "step_ms": list(trainer.step_ms), "state": trainer.state}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser("Single-card resident training (PyTorch port)"
                        ).parse_args(argv)
    return run(args)
