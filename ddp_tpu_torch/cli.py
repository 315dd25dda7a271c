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
        [--watchdog_secs S] [--ckpt_format gathered|sharded] \\
        [--mirror URI] [--trace_spill PATH | --obs_off] \\
        [--inspect_port PORT] [--profile_dir DIR] \\
        [--mesh_shape D,M[,S] [--pp_schedule 1f1b|gpipe]]
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
per-rank batch (per data shard under ``--mesh_shape``).

``--mesh_shape D,M`` (also ``DxM``; ``ddp_tpu/cli.py:87-122, 626-735``)
lays the D×M ranks out as a (data, model) grid (``parallel/mesh.py``):
the batch is split over the data axis and replicated over the model axis,
the parameters are sharded by the model's ``TP_RECIPE``
(``parallel/tp/``; rank 0 prints the plan table at start-up, ``python -m
ddp_tpu_torch.parallel.tp`` prints it offline), and every collective
reduces over one axis.  ``--spawn``/``--num_devices`` must equal D×M; a
malformed shape, a contradicting ``--num_devices``, an infeasible plan and
a model without a recipe at M > 1 are refused in the JAX CLI's words, and
``--auto_plan`` (the auto-plan search, ROADMAP A13c) and ``--audit`` (the
pre-flight program auditor, ROADMAP A13c.2) are refused by name.
At M = 1 the run is the data-parallel one.  A third entry ``S > 1``
(``--mesh_shape D,M,S``, ``--spawn`` D×M×S) adds pipeline parallelism
(``parallel/pp/``): the model's ``PP_BLOCKS`` are cut into S balanced
stages (rank 0 prints the stage table, ``python -m
ddp_tpu_torch.parallel.pp`` prints it offline) and each optimizer step runs
its ``--grad_accum`` micro-batches through the ``--pp_schedule`` pipeline,
bit for bit the ``D,M`` run with the same ``--grad_accum``; evaluation runs
on stage 0 with the gathered parameters, and a model without
``PP_BLOCKS``, ``--resident``, ``--shard_update``, ``--sync_bn``,
``--drift_audit_every`` and ``--ckpt_format sharded`` are refused in the
JAX CLI's words.  Checkpoints stay canonical:
``--ckpt_format gathered`` joins the slices over the model group and rank
0 writes one file, ``sharded`` writes one shard file a model slot, and
``--resume`` restores either, from any mesh, onto this one.  The strategy flags have the JAX CLI's meaning
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
injects the drills' faults (``resilience/faults.py``).  ``python -m
ddp_tpu_torch.supervise -- <this command>`` relaunches it with
``--resume`` on those exits (``resilience/supervisor.py``); the
preemption line then says so (``DDP_TPU_SUPERVISED``).

Storage (``ddp_tpu/cli.py``'s flags): each checkpoint is written on rank
0's writer thread while training goes on (``train/trainer.py``);
``--ckpt_format sharded`` writes the v2 index and its shard file
(``train/ckpt_shard.py``), which ``--resume`` and ``serve`` read as they
read v1; ``--mirror URI`` uploads every committed checkpoint to a second
store (``resilience/store.py``) and falls back to it when no local file
restores.  With ``--metrics_path``, rank 0 keeps a flight recorder
(``obs/blackbox.py``): every abnormal exit (a preemption, the watchdog, a
guard or drift abort, any other exception) leaves a ``postmortem.json``
next to the metrics stream.

Observability (``ddp_tpu/cli.py:137-175``'s flags, their meanings and
defaults; ``obs/``): the span tracer is on for the run (rank N > 0 spills
to ``.hostN``), its spill next to ``--snapshot_path`` unless
``--trace_spill`` says where (``''``: the ring only), and ``python -m
ddp_tpu_torch.obs`` reports on it and exports it to Perfetto; each epoch
boundary writes a ``phase_stragglers`` record (a gather over the ranks);
the watchdog's stall line names the last span of each phase.
``--obs_off`` turns all of it off, the flight recorder and the profile
trigger too.  With ``--metrics_path`` rank 0 rewrites
``<metrics_path>.prom`` every ``--log_every`` steps and at the end.
``--inspect_port`` serves ``/metrics``, ``/healthz``, ``/spans`` and
``/debug/profile?steps=N`` on loopback (rank 0; SIGUSR1 arms the same
capture), and ``--profile_dir`` brackets training with ``torch.profiler``
(CPU and, on a card, CUDA activity) and exports a Chrome trace there.

Prints what the JAX CLI prints: each epoch's header and loss on every rank
(``[GPU{rank}]``), the checkpoint line of every ``save_every``-th epoch,
and on rank 0 ``Total training time``, ``fp32 model has size=... MiB`` and
``fp32 model has accuracy=...%``.  The checkpoint is the JAX package's v1
file (or v2 set), written by rank 0: either package's ``load_checkpoint``
reads the other's.  It runs on ``cuda`` unless ``--device cpu`` is given, and refuses
to run without a card otherwise.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import interop
from .data import EvalLoader, ResidentData, TrainLoader, cifar10, native
from .data.prefetch import PrefetchStats
from .device import device_kind, dtype_name, resolve_device, set_tf32
from .models import NAMES as MODEL_NAMES, get_model
from .obs.blackbox import POSTMORTEM_BASENAME, FlightRecorder
from .obs.inspect import (InspectServer, ProfileTrigger, PromFileWriter,
                          install_sigusr1, start_profiler, stop_profiler)
from .obs.live import LiveStats, model_mfu
from .obs.registry import MetricsRegistry, parse_exposition
from .obs.tracer import (NullTracer, SpanTracer, default_spill_path,
                         set_tracer)
from .ops.conv_candidates import conv3x3_fused
from .ops.gather import gather_batch, gather_rows
from .optim import SGDConfig, triangular_lr
from .parallel import dist
from .parallel.mesh import Mesh
from .parallel.pp.partition import format_stage_table, plan_stages
from .parallel.tp.plan import format_plan_table, plan_for_model
from .resilience.drift import DriftDetectedError
from .resilience.faults import install_env_faults
from .resilience.guard import LossSpikeError, NonFiniteLossError
from .resilience.preemption import (EMERGENCY_CHECKPOINT_EXIT_STATUS,
                                    PreemptionGuard, PreemptionInterrupt)
from .resilience.supervisor import SUPERVISED_ENV
from .resilience.watchdog import WATCHDOG_EXIT_STATUS, Watchdog
from .train.evaluate import evaluate, evaluate_resident
from .train.trainer import Trainer, pp_refusal
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
    p.add_argument("--mesh_shape", default=None, metavar="D,M[,S]",
                   help="2-D (data x model) rank grid for tensor-model "
                        "parallelism (parallel/tp/): D-way data parallel "
                        "x M-way model parallel over D*M ranks, params "
                        "sharded per the model's TP_RECIPE (plan table "
                        "printed at startup; python -m "
                        "ddp_tpu_torch.parallel.tp shows it offline).  "
                        "A third S entry adds S-way PIPELINE parallelism "
                        "(parallel/pp/): the model's PP_BLOCKS are cut "
                        "into S balanced stages (stage table printed at "
                        "startup; python -m ddp_tpu_torch.parallel.pp "
                        "shows it offline) and each optimizer step runs "
                        "--grad_accum micro-batches through the "
                        "--pp_schedule pipeline.  S=1 is bit-identical "
                        "to the 2-D mesh.  Batches split over the data "
                        "axis only; checkpoints stay canonical, so "
                        "snapshots interchange with any other mesh shape "
                        "(incl. 1-D serving).  Default: data parallel "
                        "over every rank")
    p.add_argument("--pp_schedule", default="1f1b",
                   choices=("1f1b", "gpipe"),
                   help="Microbatch schedule for the pipeline stage axis "
                        "(--mesh_shape D,M,S with S>1): '1f1b' "
                        "interleaves one-forward-one-backward (min(S,A) "
                        "in-flight activations), 'gpipe' runs all "
                        "forwards then all backwards (A in flight).  "
                        "Same math, bit-identical results, same bubble "
                        "fraction (S-1)/(A+S-1) — the choice is an "
                        "activation-memory knob")
    p.add_argument("--auto_plan", default=None, metavar="PLAN.json",
                   help="Refused: the auto-plan search's plans are not "
                        "ported (ROADMAP A13c)")
    p.add_argument("--audit", action="store_true",
                   help="Refused: the pre-flight program auditor is not "
                        "ported (ROADMAP A13c.2); the static passes run "
                        "as python -m ddp_tpu_torch.analysis "
                        "--skip-programs --strict")
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
    p.add_argument("--profile_dir", default=None,
                   help="Capture a torch.profiler trace of the training "
                        "loop (CPU activity, and the card's on cuda) and "
                        "export it as a Chrome trace into this directory "
                        "(trace_rank<R>.json; open in ui.perfetto.dev)")
    p.add_argument("--trace_spill", default=None, metavar="PATH",
                   help="Span-tracer spill file (obs/tracer.py): one JSON "
                        "line per completed phase span (data_wait/"
                        "host_augment/h2d/dispatch/loss_flush/ckpt_write/"
                        "eval); analyze or export to Perfetto with "
                        "python -m ddp_tpu_torch.obs.  Ranks >0 append a "
                        ".hostN suffix.  Default: trace_spill.jsonl NEXT "
                        "TO --snapshot_path (the run's output dir, the "
                        "same overwrite discipline as checkpoint.pt); '' "
                        "keeps the in-memory tracer (watchdog/straggler "
                        "telemetry) without a spill file")
    p.add_argument("--obs_off", action="store_true",
                   help="Telemetry kill-switch: no span tracer, no spill "
                        "file, no live stats, no per-epoch straggler "
                        "record, no flight recorder or profile trigger — "
                        "hot paths see the shared no-op tracer")
    p.add_argument("--inspect_port", default=None, type=int, metavar="PORT",
                   help="Serve live run introspection over HTTP on "
                        "127.0.0.1:PORT (rank 0; obs/inspect.py): GET "
                        "/metrics (live registry exposition), /healthz "
                        "(step/epoch, guard/drift/mirror/watchdog state), "
                        "/spans (recent tracer ring), /debug/profile?"
                        "steps=N (capture the next N steps' spans + a "
                        "torch.profiler trace on a card; SIGUSR1 arms the "
                        "same capture on headless boxes).  0 = an "
                        "ephemeral port (printed at startup).  Off by "
                        "default: no socket is bound")
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
                   help="Checkpoint layout (train/ckpt_shard.py): "
                        "'gathered' = the canonical single-file v1 npz "
                        "(model-sharded leaves are all-gathered at save "
                        "time — O(model) host memory and write stream); "
                        "'sharded' = one shard file per model-axis slot "
                        "plus a small index, written by per-host parallel "
                        "writers with no gather — O(model/m) save path.  "
                        "RESTORE accepts either format on any mesh shape "
                        "regardless of this flag: --resume redistributes "
                        "a sharded set onto the live (d', m') mesh "
                        "shard-by-shard (elastic resume after a "
                        "pod-shrinking preemption)")
    p.add_argument("--keep_checkpoints", default=1, type=int, metavar="N",
                   help="Retain the newest N checkpoints: the head plus "
                        "N-1 rotated snapshots with a sha-256 manifest "
                        "(resilience/lineage.py); --resume falls back to "
                        "the newest verifiable one when the head is torn. "
                        "Default 1 = head only, the reference's "
                        "overwrite-in-place (multigpu.py:111)")
    p.add_argument("--mirror", default=None, metavar="URI",
                   help="Second checkpoint durability tier "
                        "(resilience/store.py): asynchronously mirror "
                        "every committed checkpoint to this object-store "
                        "URI — a directory path (or dir://PATH) runs the "
                        "bundled DirStore backend; gs://-style schemes "
                        "name the CheckpointStore paste point (RUNBOOK "
                        "§18).  Uploads run on a background thread AFTER "
                        "each lineage commit with per-op timeouts and "
                        "bounded jittered retries: a flaky or dead remote "
                        "degrades to a visible ddp_mirror_lag_epochs "
                        "gauge, never a blocked or failed step.  --resume "
                        "falls back to verifiable mirror objects when "
                        "every local candidate is gone — training "
                        "survives total local-disk loss (the supervisor "
                        "preserves this flag across relaunches)")
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


def export_torch(model: torch.nn.Module, path: str,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None
                 ) -> None:
    """``--export_torch``: ``model`` (or its whole ``state_dict``, gathered
    from a tensor-parallel run's slices) as the reference's torch
    ``state_dict`` file (``ddp_tpu/cli.py:482-507``)."""
    torch.save(interop.to_reference(
        model.name, model.state_dict() if state_dict is None
        else state_dict), path)
    print(f"Torch state_dict exported to {path}")


def _parse_mesh_shape(text: str) -> tuple:
    """``--mesh_shape`` 'D,M' / 'D,M,S' (or x-separated) as an int tuple
    (``ddp_tpu/cli.py::_parse_mesh_shape``'s words)."""
    try:
        dims = tuple(int(x) for x in str(text).replace("x", ",").split(","))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3) or any(v < 1 for v in dims):
        raise SystemExit(
            f"--mesh_shape wants 'D,M' or 'D,M,S' — positive ints, in "
            f"(data, model, pipeline stage) order, e.g. 2,4 or 2,1,2 — "
            f"got {text!r}")
    return dims


def mesh_dims(args: argparse.Namespace) -> Optional[tuple]:
    """``(D, M)`` or ``(D, M, S)`` of ``--mesh_shape``, or None."""
    return _parse_mesh_shape(args.mesh_shape) if args.mesh_shape else None


def mesh_ranks(dims: Optional[tuple]) -> int:
    """The rank count of a ``--mesh_shape`` (0 without one)."""
    return int(np.prod(dims)) if dims else 0


def tp_plan(args: argparse.Namespace, model=None):
    """The run's tensor-parallel plan: None without ``--mesh_shape``, and at
    M = 1 for a model that declares no recipe (the data-parallel run); else
    ``plan_for_model`` at M against ``model`` (a meta model of
    ``--model`` when None).  An infeasible plan, or a model without a
    recipe at M > 1, is refused in the JAX package's words."""
    dims = mesh_dims(args)
    if dims is None:
        return None
    if model is None:
        model = get_model(args.model, device="meta")
    try:
        return plan_for_model(args.model, model, model_size=dims[1])
    except ValueError as e:
        if dims[1] == 1 and "declares no TP_RECIPE" in str(e):
            return None
        raise SystemExit(str(e)) from None


def pp_plan(args: argparse.Namespace):
    """The run's stage plan under ``--mesh_shape D,M,S`` with S > 1 (None
    otherwise): the balanced cut of the model's ``PP_BLOCKS``, priced with
    its layers' forward flops (``ddp_tpu/cli.py:719-737``).  A model
    without ``PP_BLOCKS`` or an infeasible cut is refused in the JAX CLI's
    words."""
    dims = mesh_dims(args)
    if dims is None or len(dims) < 3 or dims[2] == 1:
        return None
    try:
        return plan_stages(args.model, dims[2], model_size=dims[1],
                           model=get_model(args.model, device="meta"))
    except ValueError as e:
        raise SystemExit(f"--mesh_shape: {e}") from None


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
    if args.keep_checkpoints < 1:
        raise SystemExit(f"--keep_checkpoints must be at least 1, not "
                         f"{args.keep_checkpoints}")
    if args.audit:
        raise SystemExit(
            "--audit: the pre-flight program auditor (the collective "
            "audit of the programs this run builds) is not ported "
            "(ROADMAP A13c.2); run python -m ddp_tpu_torch.analysis "
            "--skip-programs --strict for the static passes, and drop "
            "--audit")
    if args.auto_plan:
        raise SystemExit(
            "--auto_plan: the auto-plan search's plan documents are not "
            "ported (ROADMAP A13c, with the analysis passes); pass "
            "--mesh_shape D,M for the model's TP_RECIPE")
    dims = mesh_dims(args)
    if dims is not None:
        n_mesh = mesh_ranks(dims)
        if args.num_devices and args.num_devices != n_mesh:
            raise SystemExit(
                f"--num_devices {args.num_devices} contradicts "
                f"--mesh_shape {','.join(map(str, dims))} (= {n_mesh} "
                "devices); drop one")
        tp_plan(args)
        if pp_plan(args) is not None:
            why = pp_refusal(resident=args.resident,
                             shard_update=args.shard_update,
                             sync_bn=args.sync_bn,
                             drift_audit_every=args.drift_audit_every,
                             ckpt_format=args.ckpt_format)
            if why:
                raise SystemExit(why)
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
        dims = mesh_dims(args)
        if dims is not None:
            if mesh_ranks(dims) != dist.world_size():
                raise SystemExit(
                    f"--mesh_shape {','.join(map(str, dims))} needs "
                    f"{mesh_ranks(dims)} ranks; this run's world is "
                    f"{dist.world_size()}")
            dist.init_mesh(Mesh(dims, dist.rank()))
        return _train_and_evaluate(args, device)
    except PreemptionInterrupt as e:
        # Every rank stopped at the same boundary with the checkpoint on
        # disk, so the graceful teardown below completes.
        cue = ("the supervisor relaunches with --resume automatically"
               if os.environ.get(SUPERVISED_ENV)
               else "relaunch with --resume to continue")
        print(f"{e}; exiting with status "
              f"{EMERGENCY_CHECKPOINT_EXIT_STATUS} — {cue}", file=sys.stderr)
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
        dist.clear_mesh()
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
    # another thread keeps its own handling).  Every rank holds a guard,
    # installed or not, so every rank takes the stop vote, a collective at
    # world > 1, at the same boundaries.
    preemption = PreemptionGuard()
    if threading.current_thread() is threading.main_thread():
        preemption.install()
    try:
        return _train(args, device, metrics, preemption)
    finally:
        preemption.uninstall()
        metrics.close()


def _train(args: argparse.Namespace, device: torch.device,
           metrics: MetricsLogger,
           preemption: Optional[PreemptionGuard]) -> Dict:
    rank, replicas = dist.rank(), dist.data_size()
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
    plan = tp_plan(args, model)
    if plan is not None and rank == 0:
        print(format_plan_table(plan), flush=True)
    stages = pp_plan(args)
    if stages is not None and rank == 0:
        # The micro-batch count is the group's: the pipeline injects
        # exactly those a step (ddp_tpu/cli.py:720-737).
        print(format_stage_table(stages, num_micro=max(args.grad_accum, 1)),
              flush=True)
    device_augment = args.device_augment or args.resident
    train_loader = TrainLoader(train_ds, args.batch_size, replicas,
                               seed=args.seed, augment=not device_augment,
                               local_replicas=[dist.data_rank()])
    # The span tracer, process-wide for the run (evaluate() and the
    # checkpoint writer read the process tracer), and the null one again
    # after it: a caller that runs again in this process must not inherit
    # a closed spill.
    tracer = open_tracer(args, rank, ring=max(4096, len(train_loader) * 8))
    set_tracer(tracer)
    try:
        return _train_traced(args, device, metrics, preemption, tracer,
                             model, train_loader, test_ds, compute_dtype,
                             device_augment, plan, stages)
    finally:
        set_tracer(None)
        tracer.close()


def open_tracer(args: argparse.Namespace, rank: int, ring: int):
    """The run's tracer (``ddp_tpu/cli.py:782-830``): a
    :class:`~ddp_tpu_torch.obs.tracer.SpanTracer` of ``ring`` spans (an
    epoch's, so the straggler record's window is whole), spilling to
    ``--trace_spill`` (default: next to ``--snapshot_path``; ``''`` keeps
    the ring only; ``.hostN`` for rank N > 0); an unwritable spill warns
    and keeps the ring.  ``--obs_off`` gives the null tracer and removes a
    spill an earlier run left at the path, which would otherwise pass for
    this run's."""
    spill = args.trace_spill
    if spill is None:
        spill = default_spill_path(args.snapshot_path, "trace_spill.jsonl")
    if spill and rank > 0:
        spill = f"{spill}.host{rank}"
    if args.obs_off:
        if spill:
            with contextlib.suppress(OSError):
                os.unlink(spill)
        return NullTracer()
    try:
        return SpanTracer(spill_path=spill or None, ring=ring, host=rank)
    except OSError as e:
        print(f"WARNING: cannot open --trace_spill {spill!r} ({e}); "
              "tracing continues in-memory only (no spill file)",
              file=sys.stderr)
        return SpanTracer(spill_path=None, ring=ring, host=rank)


def _train_traced(args: argparse.Namespace, device: torch.device,
                  metrics: MetricsLogger,
                  preemption: Optional[PreemptionGuard], tracer,
                  model: torch.nn.Module, train_loader: TrainLoader,
                  test_ds, compute_dtype: Optional[torch.dtype],
                  device_augment: bool, plan=None, stages=None) -> Dict:
    rank, world = dist.rank(), dist.world_size()
    # What crops and flips on the host: the C++ library (built here, before
    # the clock starts) or numpy; None where the card does it.
    host_augment = native.path() if train_loader.augment else None
    # One registry a run: the prefetch engine, guard, watchdog and mirror
    # put their counters here; /metrics and <metrics_path>.prom expose it.
    registry = MetricsRegistry()
    live = None
    live_wanted = (not args.obs_off and args.log_every > 0
                   and metrics.active)
    if live_wanted and args.resident:
        print("note: live telemetry (--log_every) covers the streaming "
              "path only; --resident epochs have no consumer loop to "
              "time (python -m ddp_tpu_torch.profile_resident splits "
              "the step)", file=sys.stderr)
    # The occupancy counters join the registry where the live records
    # read them (ddp_tpu/cli.py:1005).
    prefetch = PrefetchStats(registry=registry if live_wanted
                             and not args.resident else None)
    if live_wanted and not args.resident:
        # One live step is one optimizer step of grad_accum micro-batches
        # on every rank; the window spans at least the cadence.
        live = LiveStats(
            metrics,
            global_batch=(args.batch_size * dist.data_size()
                          * args.grad_accum),
            n_chips=world, log_every=args.log_every,
            window=max(100, args.log_every), model=args.model,
            device_kind=device_kind(device),
            compute_dtype=compute_dtype, prefetch_stats=prefetch)
        # The FLOP count and the peak before the clock starts: the first
        # live record would otherwise pay them inside the traced run.
        model_mfu(1.0, args.model, device_kind(device), compute_dtype)
    trainer_ref: List[Trainer] = []  # the trainer is built below

    def _mirror_lag():
        t = trainer_ref[0]
        return t._mirror.lag_epochs() if t._mirror is not None else None

    def _health() -> dict:
        # The run's state for /healthz and the flight recorder: host-side
        # reads only, nothing here touches the card or blocks.
        snap: dict = {}
        if trainer_ref:
            t = trainer_ref[0]
            snap.update(step=t.state.step, epoch=t._epoch,
                        guard_last_decision=t._health.last_decision,
                        guard_restores=t._health.restores,
                        drift_last_audit_step=(
                            t._drift.last_audit_step
                            if t._drift is not None else None),
                        mirror_lag_epochs=_mirror_lag())
        if watchdog is not None:
            snap["watchdog_last_beat_age_s"] = round(
                watchdog.last_beat_age(), 3)
            snap["watchdog_timeout_s"] = watchdog.timeout_s
        if not args.resident:
            snap["prefetch"] = prefetch.per_step_ms()
        return snap

    # The flight recorder (obs/blackbox.py): rank 0, next to the metrics
    # stream, off under --obs_off.
    recorder = None
    if not args.obs_off and args.metrics_path and rank == 0:
        recorder = FlightRecorder(
            os.path.join(os.path.dirname(os.path.abspath(args.metrics_path)),
                         POSTMORTEM_BASENAME),
            config=vars(args), tracer=tracer, context=_health)
        metrics.attach_recorder(recorder)

    def _stall_context() -> str:
        # The stall line: the last span of each phase, then the guard, the
        # drift audit and the mirror.  Every read is bounded: the tracer's
        # lock may be held by a thread wedged in a spill write.
        parts = []
        if tracer.enabled:
            parts.append(tracer.describe_last(lock_timeout=2.0))
        if trainer_ref:
            t = trainer_ref[0]
            parts.append(
                f"last completed step {t.state.step}; guard: last "
                f"decision {t._health.last_decision}; drift audit: "
                + (f"last at step {t._drift.last_audit_step}"
                   if t._drift is not None else "off"))
            parts.append("mirror: " + (
                f"lag {_mirror_lag()} epoch(s)" if t._mirror is not None
                else "off"))
        return "\n".join(p for p in parts if p)

    def _on_expire() -> None:
        # Land the spill's tail and the postmortem before os._exit(124),
        # each on a side thread with a bounded join (fsync can hang on a
        # wedged mount; the exit must come regardless).
        if tracer.enabled:
            t = threading.Thread(
                target=lambda: tracer.flush(fsync=True, lock_timeout=2.0),
                daemon=True, name="obs-spill-flush")
            t.start()
            t.join(timeout=3.0)
        if recorder is not None:
            recorder.dump("watchdog_stall", exit_status=WATCHDOG_EXIT_STATUS,
                          error="watchdog: no progress heartbeat within "
                                f"{args.watchdog_secs}s", bounded=True)

    watchdog = None
    if args.watchdog_secs > 0:
        watchdog = Watchdog(
            args.watchdog_secs, context=_stall_context,
            on_expire=(_on_expire if tracer.enabled or recorder is not None
                       else None),
            registry=registry)
    # The step probe: the periodic .prom rewrite (whenever the end-of-run
    # file is written) and the profile trigger (it needs live spans).
    prom_writer = None
    if args.metrics_path and rank == 0:
        prom_writer = PromFileWriter(registry, args.metrics_path + ".prom",
                                     every=max(args.log_every, 1))
    profile_trigger = None
    if not args.obs_off and rank == 0:
        # --profile_dir owns the process's profiler for the whole run; on
        # the CPU a capture is spans only, as the JAX CLI's is.
        profile_trigger = ProfileTrigger(
            tracer, (os.path.dirname(os.path.abspath(args.metrics_path))
                     if args.metrics_path else os.getcwd()),
            profiler_available=(not args.profile_dir
                                and device.type == "cuda"))
    probes = [p.step for p in (prom_writer, profile_trigger)
              if p is not None]
    if args.log_every <= 0 and prom_writer is not None:
        probes.remove(prom_writer.step)  # the end-of-run write only
    step_probe = None
    if len(probes) == 1:
        step_probe = probes[0]
    elif probes:
        def step_probe(step, _probes=tuple(probes)):
            for p in _probes:
                p(step)
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
        guard_action=args.guard_action, ckpt_format=args.ckpt_format,
        mirror=args.mirror, registry=registry, step_probe=step_probe,
        tp_plan=plan, pp_plan=stages, pp_schedule=args.pp_schedule)
    trainer_ref.append(trainer)
    install_env_faults(trainer)  # the drills' faults; nothing unless set
    # The inspect server binds only for --inspect_port, after the trainer,
    # so /healthz describes a live object from its first request.  A taken
    # port warns and the run goes on without it.
    inspect_server = None
    uninstall_sigusr1 = None
    try:
        if args.inspect_port is not None and rank == 0:
            try:
                inspect_server = InspectServer(
                    args.inspect_port, registry=registry, tracer=tracer,
                    health=_health, profile=profile_trigger)
                print(f"inspect: serving /metrics /healthz /spans "
                      f"/debug/profile on 127.0.0.1:{inspect_server.port}",
                      file=sys.stderr, flush=True)
            except OSError as e:
                print(f"WARNING: cannot bind --inspect_port "
                      f"{args.inspect_port}: {e}; continuing without the "
                      "inspect server", file=sys.stderr)
        if profile_trigger is not None:
            uninstall_sigusr1 = install_sigusr1(profile_trigger)
        return _run_training(args, device, metrics, trainer, recorder,
                             watchdog, model, train_loader, test_ds,
                             compute_dtype, device_augment, host_augment,
                             prefetch, registry)
    finally:
        # The final exposition lands next to the metrics stream, also after
        # a failure.
        if prom_writer is not None:
            prom_writer.write()
        if uninstall_sigusr1 is not None:
            uninstall_sigusr1()
        if inspect_server is not None:
            inspect_server.close()


def _run_training(args: argparse.Namespace, device: torch.device,
                  metrics: MetricsLogger, trainer: Trainer, recorder,
                  watchdog, model: torch.nn.Module,
                  train_loader: TrainLoader, test_ds,
                  compute_dtype: Optional[torch.dtype],
                  device_augment: bool, host_augment: Optional[str],
                  prefetch: PrefetchStats,
                  registry: MetricsRegistry) -> Dict:
    rank, world = dist.rank(), dist.world_size()
    eval_loader = EvalLoader(test_ds, args.batch_size, dist.data_size(),
                             local_replicas=[dist.data_rank()])
    resident_test: List[ResidentData] = []  # uploaded at most once
    tp = trainer._tp

    def _eval() -> float:
        if trainer.pp_plan is not None:
            # On stage 0's plane with the gathered parameters
            # (ddp_tpu/cli.py:1132-1144); its accuracy to every stage.
            whole = trainer.eval_model()
            return trainer.pp_share(
                evaluate(whole, eval_loader, compute_dtype, tp)
                if whole is not None else 0.0)
        if not args.resident:
            return evaluate(model, eval_loader, compute_dtype, tp)
        if not resident_test:
            resident_test.append(ResidentData(test_ds, device))
        return evaluate_resident(model, resident_test[0], eval_loader,
                                 compute_dtype, tp)

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
    # --profile_dir brackets training, as the JAX CLI's trace does, and
    # lands its trace even after a failure (an unstopped session is lost).
    prof = (start_profiler(device.type == "cuda") if args.profile_dir
            else None)
    if watchdog is not None:
        watchdog.start()  # armed for training only, as the JAX CLI's
    try:
        trainer.train(args.total_epochs,
                      epoch_callback=_epoch_callback if args.eval_every
                      else None)
    except BaseException as err:
        # The black box lands before the error reaches run()'s teardown
        # (which may hard-exit at world > 1).
        if recorder is not None and recorder.dumped is None:
            reason, status = _postmortem_reason(err)
            recorder.dump(reason, exit_status=status, error=repr(err))
        raise
    finally:
        if watchdog is not None:
            watchdog.stop()
        if prof is not None:
            try:
                path = stop_profiler(prof, os.path.join(
                    args.profile_dir, f"trace_rank{rank}.json"),
                    device.type == "cuda")
                print(f"profile: wrote {path}", file=sys.stderr)
            except Exception as e:  # must not replace the error in flight
                print(f"WARNING: --profile_dir trace export failed: {e!r}",
                      file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    training_seconds = time.time() - start
    n_params = sum(p.numel() for p in model.parameters())
    whole = None
    if tp is not None or trainer.pp_plan is not None:
        # The whole model: its size, and the file --export_torch writes
        # (a gather over the model group and the stages, on every rank).
        n_params = sum(p.numel() for p in
                       get_model(args.model, device="meta").parameters())
        if args.export_torch:
            whole = trainer.full_state()[0]
    if rank == 0:
        print(f"Total training time: {training_seconds:.2f} seconds")
        print(f"fp32 model has size={n_params * 32 / MiB:.2f} MiB")
        if args.export_torch:
            export_torch(model, args.export_torch, whole)

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
           "restores": trainer.restores, "data_state": trainer.data_state(),
           "ckpt_format": args.ckpt_format,
           "mesh_shape": (list(mesh_dims(args)) if args.mesh_shape
                          else None),
           "model_axis_collectives": {
               k: dist.collective_calls[k]
               for k in ("psum_model_fwd", "psum_model_bwd")},
           "pp_schedule": (args.pp_schedule if trainer.pp_plan is not None
                           else None),
           "pp_bubble": (trainer.pp_step.bubble
                         if trainer.pp_plan is not None else None),
           "pp_handoff": (dict(dist.handoff_stats, peak_inflight=(
               trainer.pp_step.peak_inflight))
               if trainer.pp_plan is not None else None),
           "checkpoint_saves": list(trainer.saves),
           "mirror": _mirror_summary(trainer, registry)}
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


def _postmortem_reason(err: BaseException) -> tuple:
    """The flight recorder's reason and the exit status the process will
    report, for the error that ends training."""
    if isinstance(err, PreemptionInterrupt):
        return "preemption", EMERGENCY_CHECKPOINT_EXIT_STATUS
    if isinstance(err, DriftDetectedError):
        return "drift_abort", 1
    if isinstance(err, (NonFiniteLossError, LossSpikeError)):
        return "guard_abort", 1
    return "crash", 1


def _mirror_summary(trainer: Trainer, registry: MetricsRegistry
                    ) -> Optional[Dict]:
    """Rank 0's mirror at the end of training, read from the uploader's
    own series: the lag before and after the final drain, the retries,
    the abandoned uploads, the uploads that landed and the epochs the
    mirror holds."""
    if trainer._mirror is None:
        return None
    fams = parse_exposition(registry.exposition())

    def value(family: str, sample: str) -> float:
        return sum(v for (name, _), v in fams[family]["samples"].items()
                   if name == sample)

    return {"lag_epochs": list(trainer.mirror_lag),
            "retries": value("ddp_ckpt_upload_retries_total",
                             "ddp_ckpt_upload_retries_total"),
            "failures": value("ddp_ckpt_upload_failures_total",
                              "ddp_ckpt_upload_failures_total"),
            "uploads": value("ddp_ckpt_upload_seconds",
                             "ddp_ckpt_upload_seconds_count"),
            "mirrored_epochs": [e["epoch"] for e in
                                trainer._mirror.mirrored_entries()]}


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
    if mesh_ranks(mesh_dims(args)) > 1:
        raise SystemExit(f"singlegpu runs one process; --mesh_shape "
                         f"{args.mesh_shape} belongs to multigpu")
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
        dims = mesh_dims(args)
        n_mesh = mesh_ranks(dims)
        if n_mesh and args.spawn and args.spawn != n_mesh:
            axes = "D×M×S" if len(dims) == 3 else "D×M"
            raise SystemExit(f"--spawn {args.spawn} must equal {axes} = "
                             f"{n_mesh} of --mesh_shape {args.mesh_shape}")
        # Without --spawn/--num_devices: the mesh's ranks (one per card,
        # or on the CPU gloo ranks), else one rank per visible card.
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        default = (n_mesh if n_mesh > 1 or cards else 0) if n_mesh \
            else cards
        n = args.num_devices or args.spawn or default
        if device.type == "cuda" and n > torch.cuda.device_count():
            raise SystemExit(f"--num_devices {n} asks for more ranks than "
                             f"the {torch.cuda.device_count()} visible "
                             f"card(s)")
        if n:
            raise SystemExit(dist.spawn_local(n, "ddp_tpu_torch.multigpu",
                                              argv))
    return run(args, data_parallel=True, backend=backend)
