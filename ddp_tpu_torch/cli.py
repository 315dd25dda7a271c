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
        [--schedule_epochs E] [--schedule_steps_per_epoch S] \\
        [--eval_every E] [--metrics_path PATH [--log_every 50]] \\
        [--tensorboard_dir DIR] [--num_devices N] [--result_json PATH] \\
        [--keep_checkpoints N] [--on_nan abort|skip|restore] \\
        [--guard_window W] [--guard_spike_factor F] \\
        [--guard_action abort|skip|lr_backoff|rollback] \\
        [--drift_audit_every K] [--drift_action abort|restore] \\
        [--watchdog_secs S]
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

``singlegpu`` is one process at world 1 (``--num_devices`` may only say
1).  ``multigpu`` is one process per rank: under a rendezvous environment
(``torchrun``'s, or ``--spawn``'s) it is that rank; otherwise it spawns
``--num_devices N`` or ``--spawn N`` local ranks (the two are one world
size and must agree), or on ``cuda`` one per visible card (the reference's
``mp.spawn`` over ``torch.cuda.device_count()``, multigpu.py:262-263), and
returns the largest exit code of its ranks.  ``--batch_size`` is the
per-rank batch.  The strategy flags have the JAX CLI's meaning
(``ddp_tpu/cli.py:215-227``) and compose with each other and with
``--resume``: ``--grad_accum A`` takes
one optimizer step per A micro-batches (the LR schedule counts optimizer
steps), ``--sync_bn`` takes BatchNorm's statistics over every rank's batch,
``--shard_update`` shards the weight update (ZeRO-1).  At world 1 without a
process group (``singlegpu``) each collective is the identity.  ``--bf16``
computes in bfloat16 where the JAX package's ``compute_dtype`` does
(``models/``), training and eval alike, and composes with all of
them; weights, momentum, BatchNorm's buffers and the checkpoint stay
float32.

The run's shape (``ddp_tpu/cli.py``'s flags): ``--schedule_epochs`` and
``--schedule_steps_per_epoch`` pin the LR triangle's span and its steps an
epoch (default ``total_epochs`` and the loader's optimizer steps an epoch),
so a run split in two (``1 1 --schedule_epochs 2``, then ``2 1 --resume
--schedule_epochs 2``) takes the uninterrupted run's steps.
``--eval_every E`` evaluates after every E-th epoch on every rank (rank 0
prints ``Epoch {e} | eval accuracy=...%``), and the final accuracy reuses
the last of these when it came after the last epoch.  ``--metrics_path``
makes rank 0 append the JAX package's JSONL records (``utils/metrics.py``):
one ``{step, epoch, loss, lr}`` an optimizer step, the periodic and final
eval accuracies and, on the streaming path, a ``live`` record every
``--log_every`` steps (``obs/live.py``: rolling median and p90 step time,
on a card the device's between CUDA events, samples/s, MFU against the card's data-sheet peak for the compute dtype,
prefetch occupancy).  The resident path has no consumer loop to time and
says so on stderr instead, as the JAX CLI does.  ``--tensorboard_dir``
mirrors the curves where a TensorBoard writer is installed, and is refused
otherwise.

A run that survives (``ddp_tpu/cli.py:251-327``'s flags, the same
defaults and meanings; ``resilience/``): ``--keep_checkpoints N`` keeps the
head and N-1 rotated snapshots with a sha256 manifest, and ``--resume``
falls back to the newest verifiable one when the head is torn;
``--on_nan`` and the ``--guard_*`` flags set the step health guard on each
epoch's losses (``restore``/``rollback`` reload the newest verifiable
checkpoint and go on, re-keying the step's random draws);
``--drift_audit_every K`` compares the ranks' parameters bit for bit every
K streamed steps (``--drift_action``); ``--watchdog_secs S`` hard-exits a
run that makes no progress for S seconds.  SIGTERM or SIGINT takes an
emergency checkpoint at the next step boundary of the streaming loop (the
epoch boundary with ``--resident``), whose ``data_state`` lets
``--resume`` continue from that exact batch.  Exit codes, as the JAX
CLI's: 75 after the emergency checkpoint, 124 on a watchdog stall, 1 on a
guard or drift abort or any other failure; a failing rank of a world > 1
hard-exits so that its peers do not wait on it.  ``DDP_TPU_FAULT``
injects the drills' faults (``resilience/faults.py``).  ``--mirror`` and
``--ckpt_format sharded`` (the storage half, ROADMAP A7b) are refused by
name.

Prints what the JAX CLI prints: each epoch's header and loss on every rank
(``[GPU{rank}]``), the checkpoint line of every ``save_every``-th epoch,
and on rank 0 ``Total training time``, ``fp32 model has size=... MiB`` and
``fp32 model has accuracy=...%``.  The checkpoint is the JAX package's v1
file, written by rank 0: either package's ``load_checkpoint`` reads the
other's.  It runs on ``cuda`` unless ``--device cpu`` is given, and refuses
to run without a card otherwise.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

from . import interop
from .data import EvalLoader, ResidentData, TrainLoader, cifar10, native
from .data.prefetch import PrefetchStats
from .device import device_kind, dtype_name, resolve_device, set_tf32
from .models import NAMES as MODEL_NAMES, get_model
from .obs.live import LiveStats
from .ops.conv_candidates import conv3x3_fused
from .ops.gather import gather_batch, gather_rows
from .optim import SGDConfig, triangular_lr
from .parallel import dist
from .resilience.faults import install_env_faults
from .resilience.preemption import (EMERGENCY_CHECKPOINT_EXIT_STATUS,
                                    PreemptionGuard, PreemptionInterrupt)
from .resilience.watchdog import Watchdog
from .train.evaluate import evaluate, evaluate_resident
from .train.trainer import Trainer
from .utils.metrics import MetricsLogger, require_tensorboard

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
    p.add_argument("--num_devices", default=None, type=int, metavar="N",
                   help="World size: multigpu's rank count (the same as "
                        "--spawn, which must agree); singlegpu takes only "
                        "1")
    p.add_argument("--schedule_epochs", default=None, type=int,
                   help="Pin the LR triangle's epoch span (the reference "
                        "hardcodes 20, multigpu.py:136; default: "
                        "total_epochs)")
    p.add_argument("--schedule_steps_per_epoch", default=None, type=int,
                   help="Pin steps_per_epoch in the LR schedule (the "
                        "reference hardcodes 98/49, multigpu.py:137; "
                        "default: derived from the real shard size)")
    p.add_argument("--eval_every", type=int, default=0, metavar="E",
                   help="Evaluate on the test set every E epochs during "
                        "training (0 = only the reference's single "
                        "end-of-run eval)")
    p.add_argument("--metrics_path", default=None,
                   help="Append per-step {step, epoch, loss, lr, wall_s} "
                        "JSON lines here (rank 0), with the eval "
                        "accuracies and the live records")
    p.add_argument("--log_every", default=50, type=int, metavar="N",
                   help="Write a live record (rolling median/p90 step "
                        "time, samples/s, MFU, prefetch occupancy) into "
                        "the metrics stream every N steps of the streaming "
                        "path (rank 0; needs --metrics_path or "
                        "--tensorboard_dir; 0 = off)")
    p.add_argument("--tensorboard_dir", default=None,
                   help="Also mirror the loss, LR, eval accuracy and live "
                        "curves as TensorBoard scalars here (rank 0; needs "
                        "the tensorboard package)")
    p.add_argument("--result_json", default=None, metavar="PATH",
                   help="Rank 0 writes the run's summary here as JSON: "
                        "world, backend, the data path and its prefetch "
                        "times, the strategy and run-shape flags, the "
                        "compute dtype, losses, step times, the periodic "
                        "and final accuracies, the restores and the final "
                        "data_state, and the port's kernel launches and "
                        "the collectives in this process")
    p.add_argument("--ckpt_format", default="gathered",
                   choices=["gathered", "sharded"],
                   help="Checkpoint file format: 'gathered' = the "
                        "canonical single-file v1 npz (the default and the "
                        "only one ported); 'sharded' is refused (ROADMAP "
                        "A7b)")
    p.add_argument("--keep_checkpoints", default=1, type=int, metavar="N",
                   help="Retain the newest N checkpoints: the head plus "
                        "N-1 rotated snapshots with a sha-256 manifest "
                        "(resilience/lineage.py); --resume falls back to "
                        "the newest verifiable one when the head is torn. "
                        "Default 1 = head only, the reference's "
                        "overwrite-in-place (multigpu.py:111)")
    p.add_argument("--mirror", default=None, metavar="URI",
                   help="Second checkpoint durability tier (an object-store "
                        "mirror): not ported yet, refused (ROADMAP A7b)")
    p.add_argument("--on_nan", default="abort",
                   choices=["abort", "skip", "restore"],
                   help="Non-finite loss policy, checked where each "
                        "epoch's losses are read (no extra device read): "
                        "abort = fail fast (default); skip = log and "
                        "continue; restore = reload the last good "
                        "checkpoint and re-key the step's random draws.  "
                        "The step health guard (resilience/guard.py) also "
                        "hosts the spike detector below")
    p.add_argument("--guard_window", default=64, type=int, metavar="W",
                   help="Rolling window (steps) for the guard's "
                        "median/MAD loss-spike detector (default 64; "
                        "only read when --guard_spike_factor > 0)")
    p.add_argument("--guard_spike_factor", default=0.0, type=float,
                   metavar="F",
                   help="Flag a step whose loss exceeds median * F + "
                        "3*MAD over the last --guard_window finite "
                        "losses (checked on the same loss read as "
                        "--on_nan).  0 = spike detection off (default)")
    p.add_argument("--guard_action", default="rollback",
                   choices=["abort", "skip", "lr_backoff", "rollback"],
                   help="What a loss spike triggers: abort = fail fast; "
                        "skip = log and continue; lr_backoff = halve the "
                        "LR schedule going forward; rollback (default) = "
                        "restore the last verified checkpoint, re-key, "
                        "and skip the poisoned batch window on replay "
                        "(shares the --on_nan restore budget)")
    p.add_argument("--drift_audit_every", default=0, type=int, metavar="K",
                   help="Cross-replica SDC audit (resilience/drift.py): "
                        "every K optimizer steps, fingerprint each rank's "
                        "parameters bit-level (a uint32 checksum per "
                        "leaf, NOT a float sum) and compare across the "
                        "ranks with two small all-reduces.  Replicated "
                        "parameters must agree bit-for-bit, so any "
                        "mismatch is silent data corruption: a "
                        "drift_detected event names the offending leaves "
                        "and replicas.  Streaming only (refused with "
                        "--resident).  0 = off (default)")
    p.add_argument("--drift_action", default="abort",
                   choices=["abort", "restore"],
                   help="What a drift detection triggers: abort = fail "
                        "fast with the event on disk (default); restore "
                        "= reload the newest verifiable checkpoint "
                        "(shares the guard's restore budget, so "
                        "persistent corruption cannot restore-loop)")
    p.add_argument("--watchdog_secs", default=0.0, type=float, metavar="S",
                   help="Abort the run (non-blocking dist.abort + exit "
                        "status 124) when no step/epoch progress happens "
                        "for S seconds: a stalled peer then fails the job "
                        "fast instead of riding the process group's "
                        "timeout.  Must exceed the worst epoch wall time "
                        "INCLUDING the first step's CUDA kernel build "
                        "(nvcc at the first launch on a cold build "
                        "directory).  0 = off (default)")
    return p


def build_schedule(args: argparse.Namespace,
                   train_loader: TrainLoader) -> Callable[[int], float]:
    """The triangular LR advanced per optimizer step
    (``ddp_tpu/cli.py::build_schedule``): over ``--schedule_epochs`` or
    else ``total_epochs``, at ``--schedule_steps_per_epoch`` or else
    ``train_loader.optimizer_steps_per_epoch(args.grad_accum)`` steps an
    epoch."""
    return functools.partial(
        triangular_lr, base_lr=args.lr,
        num_epochs=args.schedule_epochs or args.total_epochs,
        steps_per_epoch=(args.schedule_steps_per_epoch
                         or train_loader.optimizer_steps_per_epoch(
                             args.grad_accum)))


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
    if args.num_devices is not None and args.num_devices < 1:
        raise SystemExit(f"--num_devices must be at least 1, not "
                         f"{args.num_devices}")
    if args.mirror is not None or args.ckpt_format == "sharded":
        flag = ("--mirror" if args.mirror is not None
                else "--ckpt_format sharded")
        raise SystemExit(
            f"{flag} belongs to the storage half of the resilience layer "
            f"(the checkpoint mirror and the sharded format, ROADMAP A7b), "
            f"which is not ported yet")
    if args.keep_checkpoints < 1:
        raise SystemExit(f"--keep_checkpoints must be at least 1, not "
                         f"{args.keep_checkpoints}")
    if args.tensorboard_dir:
        # Every rank refuses, before any of them joins a collective.
        require_tensorboard()


def run(args: argparse.Namespace, *, data_parallel: bool = False,
        backend: Optional[str] = None) -> Dict:
    """Train and evaluate; returns ``{"accuracy", "training_seconds",
    "eval_seconds", "loss_history", "step_ms", "state", "rank", "world",
    "backend"}``, where ``state`` is the trained
    :class:`~ddp_tpu_torch.train.step.TrainState`.

    With ``data_parallel`` this process first joins the process group its
    environment describes (:func:`~ddp_tpu_torch.parallel.dist.initialize`,
    on ``backend`` when given; world 1 without one) and leaves it at the
    end.  A preemption's emergency checkpoint raises
    ``SystemExit(EMERGENCY_CHECKPOINT_EXIT_STATUS)``.  Any other failure of
    a rank of a world > 1 prints its traceback, gives the process group up
    (:func:`~ddp_tpu_torch.parallel.dist.abort`) and hard-exits 1: a
    graceful teardown would wait on peers that wait on this rank
    (``ddp_tpu/cli.py:543-600``)."""
    _check_args(args)
    device = resolve_device(args.device)
    if data_parallel:
        device = dist.initialize(device, backend)
    try:
        if args.num_devices and args.num_devices != dist.world_size():
            raise SystemExit(
                f"--num_devices {args.num_devices} contradicts this run's "
                f"world of {dist.world_size()}")
        return _train_and_evaluate(args, device)
    except PreemptionInterrupt as e:
        # Every rank stopped at the same boundary with the checkpoint on
        # disk, so the graceful teardown below completes.
        print(f"{e}; exiting with status "
              f"{EMERGENCY_CHECKPOINT_EXIT_STATUS} — relaunch with --resume "
              f"to continue", file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        raise SystemExit(EMERGENCY_CHECKPOINT_EXIT_STATUS) from None
    except BaseException as err:
        if dist.world_size() > 1:
            print(f"FATAL: rank {dist.rank()} failed with {err!r}; giving "
                  f"the process group up and hard-exiting so that peer "
                  f"ranks do not hang in their next collective",
                  file=sys.stderr)
            traceback.print_exc()
            dist.abort()
            _hard_exit(1)
        raise
    finally:
        if data_parallel:
            dist.shutdown()


def _hard_exit(code: int) -> None:  # replaced by in-process tests
    os._exit(code)


def _train_and_evaluate(args: argparse.Namespace,
                        device: torch.device) -> Dict:
    metrics = MetricsLogger(args.metrics_path, enabled=dist.rank() == 0,
                            tensorboard_dir=args.tensorboard_dir)
    # SIGTERM/SIGINT take an emergency checkpoint while this process owns
    # the main thread (signal handlers can only be set there; a caller on
    # another thread keeps its own handling).
    preemption = (PreemptionGuard().install()
                  if threading.current_thread() is threading.main_thread()
                  else None)
    try:
        return _train(args, device, metrics, preemption)
    finally:
        if preemption is not None:
            preemption.uninstall()
        metrics.close()


def _train(args: argparse.Namespace, device: torch.device,
           metrics: MetricsLogger,
           preemption: Optional[PreemptionGuard]) -> Dict:
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
    live = None
    if args.log_every > 0 and metrics.active:
        if args.resident:
            print("note: live telemetry (--log_every) covers the streaming "
                  "path only; --resident epochs have no consumer loop to "
                  "time (python -m ddp_tpu_torch.profile_resident splits "
                  "the step)", file=sys.stderr)
        else:
            # One live step is one optimizer step of grad_accum
            # micro-batches on every rank; the window spans at least the
            # cadence.
            live = LiveStats(
                metrics,
                global_batch=args.batch_size * world * args.grad_accum,
                n_chips=world, log_every=args.log_every,
                window=max(100, args.log_every), model=args.model,
                device_kind=device_kind(device),
                compute_dtype=compute_dtype, prefetch_stats=prefetch)
    watchdog = None
    if args.watchdog_secs > 0:
        watchdog = Watchdog(args.watchdog_secs, context=lambda: (
            f"last completed step {trainer.state.step}, guard "
            f"{trainer._health.last_decision}"))
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
        prefetch_workers=args.prefetch_workers, prefetch_stats=prefetch,
        metrics=metrics, live=live, keep_checkpoints=args.keep_checkpoints,
        on_nan=args.on_nan, watchdog=watchdog, preemption=preemption,
        drift_audit_every=args.drift_audit_every,
        drift_action=args.drift_action, guard_window=args.guard_window,
        guard_spike_factor=args.guard_spike_factor,
        guard_action=args.guard_action)
    install_env_faults(trainer)  # the drills' faults; nothing unless set

    eval_loader = EvalLoader(test_ds, args.batch_size, world,
                             local_replicas=[rank])
    resident_test: List[ResidentData] = []  # uploaded at most once

    def _eval() -> float:
        if not args.resident:
            return evaluate(model, eval_loader, compute_dtype)
        if not resident_test:
            resident_test.append(ResidentData(test_ds, device))
        return evaluate_resident(model, resident_test[0], eval_loader,
                                 compute_dtype)

    eval_history: List[List] = []  # [epoch, accuracy] of --eval_every

    def _epoch_callback(epoch: int) -> None:
        # A collective: every rank evaluates; rank 0 prints and logs.
        if (epoch + 1) % args.eval_every == 0:
            acc = _eval()
            eval_history.append([epoch, acc])
            if rank == 0:
                print(f"Epoch {epoch} | eval accuracy={acc:.2f}%")
                metrics.log_eval(epoch=epoch, accuracy=acc)

    start = time.time()
    if watchdog is not None:
        watchdog.start()  # armed for training only, as the JAX CLI's
    try:
        trainer.train(args.total_epochs,
                      epoch_callback=_epoch_callback if args.eval_every
                      else None)
    finally:
        if watchdog is not None:
            watchdog.stop()
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
    # The weights after the last epoch were evaluated already when
    # --eval_every's last eval came after it (ddp_tpu/cli.py:1233-1238).
    if eval_history and eval_history[-1][0] == args.total_epochs - 1:
        accuracy = eval_history[-1][1]
    else:
        accuracy = _eval()
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
           "prefetch_workers": args.prefetch_workers,
           "num_devices": args.num_devices,
           "schedule_epochs": args.schedule_epochs,
           "schedule_steps_per_epoch": args.schedule_steps_per_epoch,
           "eval_every": args.eval_every, "eval_history": eval_history,
           "metrics_path": args.metrics_path, "log_every": args.log_every,
           "restores": trainer.restores, "data_state": trainer.data_state()}
    if rank == 0:
        print(f"fp32 model has accuracy={accuracy:.2f}%")
        metrics.log_eval(epoch=args.total_epochs - 1, accuracy=accuracy,
                         final=True)
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
    if args.num_devices not in (None, 1):
        raise SystemExit(f"singlegpu runs on one device; --num_devices "
                         f"{args.num_devices} belongs to multigpu")
    return run(args)


def main_multi(argv: Optional[List[str]] = None, *,
               backend: Optional[str] = None) -> Dict:
    """``multigpu``: this process's rank of the run, or the spawner of its
    ranks (see the module's docstring), which exits with their largest
    exit code.  A rank never spawns.  ``backend`` overrides the process
    group's (gloo is the only one that runs two ranks on one card)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser("Data-parallel training (PyTorch port)"
                        ).parse_args(argv)
    if not dist.in_rendezvous():
        _check_args(args)
        device = resolve_device(args.device)
        if args.spawn and args.num_devices and \
                args.spawn != args.num_devices:
            raise SystemExit(f"--num_devices {args.num_devices} contradicts "
                             f"--spawn {args.spawn}; both give the world "
                             f"size, drop one")
        n = args.num_devices or args.spawn or (
            torch.cuda.device_count() if device.type == "cuda" else 0)
        if device.type == "cuda" and n > torch.cuda.device_count():
            raise SystemExit(f"--num_devices {n} asks for more ranks than "
                             f"the {torch.cuda.device_count()} visible "
                             f"card(s)")
        if n:
            raise SystemExit(dist.spawn_local(n, "ddp_tpu_torch.multigpu",
                                              argv))
    return run(args, data_parallel=True, backend=backend)
