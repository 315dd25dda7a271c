"""Benchmarks of the port (counterpart of ``bench.py``'s modes that need
no mesh):

    python -m ddp_tpu_torch.bench [--model vgg|deepnn|resnet18] \\
        [--batch_size 512] [--bf16 | --no_bf16] [--primary_only] \\
        [--steps 50] [--warmup 10] [--repeats 5] [--shard_update] \\
        [--device cuda|cpu] [--result_json PATH]
    python -m ddp_tpu_torch.bench --e2e [--resident] [--e2e_steps 16] \\
        [--prefetch_depth 2] [--prefetch_workers 4] [...]
    python -m ddp_tpu_torch.bench --inspect_overhead [--steps 50] [...]
    python -m ddp_tpu_torch.bench --guard_overhead [--steps 50] [...]
    python -m ddp_tpu_torch.bench --serve [--fleet N] [--serve_secs 4] \\
        [--serve_loads auto] [--serve_buckets 1,8,32,128] [--snapshot_path P]
    python -m ddp_tpu_torch.bench --serve --generate [--gen_streams 1,2,4,8] \\
        [--gen_slots 8] [--gen_new_tokens 16] [--snapshot_path P]
    python -m ddp_tpu_torch.bench --batch_sweep 256,512 \\
        [--batch_sweep_flavors fp32_step,bf16_step]
    python -m ddp_tpu_torch.bench --sweep 1,2 [--sweep_platform cpu|real]
    python -m ddp_tpu_torch.bench --stream_attr [--e2e_steps 16] [...]
    python -m ddp_tpu_torch.bench --pipeline [--batch_size 512]
    python -m ddp_tpu_torch.bench --chaos [--chaos_out CHAOS_r01.json] \\
        [--chaos_drills D1,D2]

Prints one JSON line on stdout, with ``bench.py``'s record fields and
metric strings: ``metric``, ``value`` (samples/s a chip of the median
window), ``unit``, ``vs_baseline``, ``wall_ms_per_step`` (the median
window's), ``window_ms_per_step`` (every window), ``median_ms_per_step``,
``best_window_ms_per_step``, ``window_spread_pct``, ``mfu``,
``mfu_peak_tflops`` and ``mfu_peak_source``; and ``device`` (name and
count) and ``power_limit_w`` (``nvidia-smi``'s ``power.limit`` of the card
the record ran on, null on the CPU).  ``vs_baseline`` is 1.0:
``bench.py``'s baselines were measured on a TPU and do not carry over.
``mfu`` is :func:`~ddp_tpu_torch.obs.live.model_mfu`: the model's conv and
matmul FLOPs a sample (JAX's count) over the data-sheet peak of the card
for the compute dtype (``obs/live.py``), or a probed peak where the table
has none.

The primary record ("per-step dispatch") steps one fixed device batch of
``synthetic(n_train=batch_size)`` images, with no crop or flip, through
``train/epoch.py::make_train_step``: every step turns it into the model's
input with one ``gather_batch`` launch in its eval form.  After
``--warmup`` steps (at least 1), each of ``--repeats`` windows of
``--steps`` steps is timed on the host clock and ends in
``torch.cuda.synchronize()`` and a host read of its last loss; the
headline is the median window.  Unless ``--primary_only``, a second record
("resident-epoch mode") goes to stderr: ``make_train_epoch`` over a
resident table of ``batch_size x steps`` images, each step's batch
gathered, cropped and flipped on the card by ``gather_batch``, timed the
same way (the counterpart of ``bench.py``'s scan flavour, which an eager
program has no analogue of).  On a card a third record, the primary in
bfloat16, goes to stderr unless ``--bf16`` or ``--no_bf16`` is given.

``--e2e`` times the real ``Trainer`` on ``batch_size x e2e_steps``
synthetic images, streamed (host crop and flip, prefetched) or with
``--resident``: 2 warm-up epochs, then 3 timed ones, its record's
``phase_ms`` the median ms of each traced phase in them
(``obs/aggregate.py::phase_medians``).

``--inspect_overhead`` prices an enabled but idle introspection plane
(``bench.py:2169-2260``): ``--repeats`` round-robin pairs of windows of the
fixed-batch float32 step, bare and with a bound idle ``InspectServer``,
the ``.prom`` rewrite every 50 steps and the unarmed profile trigger
probed each step (``obs/inspect.py``); its one record's value is the
median window's overhead in % (the JAX acceptance is under 1%).
``--profile_dir`` adds one traced, untimed window of the primary record
(``trace_step.json``; the resident-epoch record is then dropped, as
``bench.py`` drops its second flavour) or, with ``--e2e``, one traced
epoch after the timed ones (``trace_e2e.json``), each a ``torch.profiler``
Chrome trace.

``--num_devices N`` (N > 1; the step records, ``--e2e`` and
``--guard_overhead``) runs N ranks through ``parallel/dist.py::
launch_local``: gloo ranks with ``--device cpu``, one rank a card over NCCL
on the cards (more ranks than cards is refused: NCCL runs one rank a
card).  Each rank steps its own rows; rank 0 prints the line and writes
``--result_json``, ``value`` stays samples/s a chip and ``device.count`` is
N.

The modes of ``bench.py`` that need no mesh, each with its flags,
defaults and record fields (plus ``device`` and ``power_limit_w``):

- ``--guard_overhead`` (``bench.py:1972``): the drift audit off, at K=50
  and K=10, and the spike guard's window check, in round-robin windows of
  the fixed-batch float32 step; one audit call priced directly, its
  amortised share at K=50 the headline.  The port's audit moves ``(1 +
  world) x L`` int64 values (a fingerprint row and the mismatch matrix),
  where JAX's moves ``2 x L`` int32: ``audit_payload_bytes`` is the port's.
- ``--serve [--fleet N]`` (``bench.py:1040``): N ``ServeEngine``s, each
  behind a ``DynamicBatcher`` (``LocalReplica``s behind a ``Router`` at N
  > 1), a closed-loop capacity probe, then the open-loop sweep and its
  knee.  ``compiled_executables`` counts the CUDA graphs ``warm()``
  captured (the CPU: buckets warmed).
- ``--serve --generate`` (``bench.py:1272``): the ``tinylm`` KV-cache
  engine (a ``--snapshot_path`` checkpoint, or fresh weights from seed 0)
  behind a ``TokenBatcher``; for each ``--gen_streams`` count S, S
  closed-loop clients loop whole streams (a ``--gen_prompt_len`` random
  prompt, ``--gen_new_tokens`` tokens) for ``--serve_secs`` seconds.  The
  record's ``generate.curve`` holds each point's ``tokens_per_sec``,
  ``ttft_ms`` and ``stream_latency_ms`` percentiles; ``value`` is the
  tokens/s at the largest S; ``compiled_executables`` (CUDA graphs on a
  card) is held to ``compile_bound``.
- ``--batch_sweep`` (``bench.py:814``) and ``--sweep`` (``bench.py:1391``):
  one child process a cell, ``python -m ddp_tpu_torch.bench ...
  --no_bf16 --primary_only``; ``--sweep``'s children run ``--num_devices
  n`` on the bench's ``--device``: gloo ranks with ``--device cpu``
  (``--sweep_platform cpu``), one rank a card otherwise (``real``).
  A failed child fails the mode (:func:`run_child`).  The scan flavours
  have no eager counterpart and are refused; the default flavours are the
  two step ones.
- ``--stream_attr`` (``bench.py:876``): the host stage, the blocking H2D
  copy and the device step, each alone, then the streaming ``Trainer``
  with its ``PrefetchStats`` and a span ring sized to the run, decomposed
  by :func:`~ddp_tpu_torch.utils.profiling.attribute_streaming`.
- ``--pipeline`` (``bench.py:1876``): ``TrainLoader`` materialise+augment
  alone, no device in the loop.
- ``--chaos`` (``bench.py:498``): ``python -m ddp_tpu_torch.chaos_campaign``
  in a subprocess, its exit code passed on.

``--result_json`` writes the records, the train steps that ran in each
dtype, the eval-form calls of ``gather_batch``'s wrapper that launch or
capture its kernel (``--serve``'s ``warm()``: its eager run and its
capture, a bucket an engine, on a card) and the kernels' launch counts of
the process, a sweep's children's included.  The bench runs on ``cuda``
unless ``--device cpu`` is given, in every mode; the flags of
``bench.py``'s other modes are refused by name, each with the ROADMAP item
that ports it.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import ResidentData, TrainLoader, synthetic
from .data.device_augment import make_draws
from .data.prefetch import PrefetchStats
from .device import device_kind, resolve_device, set_tf32
from .models import NAMES as MODEL_NAMES, get_model
from .obs.aggregate import phase_medians
from .obs.inspect import (InspectServer, ProfileTrigger, PromFileWriter,
                          start_profiler, stop_profiler)
from .obs.live import mfu_peak, model_mfu
from .obs.registry import MetricsRegistry
from .obs.tracer import SpanTracer, set_tracer
from .ops.gather import gather_batch
from .optim import SGDConfig, triangular_lr
from .parallel import dist
from .resilience.drift import DriftAuditor
from .resilience.guard import StepHealthGuard
from .serve import (DynamicBatcher, LocalReplica, QueueFull, Router,
                    ServeEngine, percentiles)
from .train.epoch import make_train_epoch, make_train_step
from .train.step import init_train_state, to_device
from .train.trainer import Trainer, draw_seed, dropout_seed
from .train.zero import list_to_opt_shard
from .utils.profiling import attribute_streaming

# bench.py's flags that this entry point does not take yet, with the
# ROADMAP item that ports each.
REFUSED = {
    "--calibrate_cost": "A13c", "--mem_ledger": "A13c",
    "--tp_sweep": "A10b", "--pp_sweep": "A10b",
    "--mesh_shape": "A10b", "--auto_plan": "A13c",
    "--autoplan_bench": "A13c", "--ckpt_bench": "A10b",
    "--dump_hlo": "none: an eager program has no compiled program to dump",
}
BATCH_SWEEP_FLAVORS = ("fp32_step", "bf16_step")
SCAN_FLAVORS = ("fp32_scan", "bf16_scan")

# bench.py's schedule: the reference's 20 epochs of 98 steps.
SCHEDULE = functools.partial(triangular_lr, base_lr=0.4, num_epochs=20,
                             steps_per_epoch=98)
RECORD_FIELDS = ("metric", "value", "unit", "vs_baseline",
                 "wall_ms_per_step", "window_ms_per_step",
                 "median_ms_per_step", "best_window_ms_per_step",
                 "window_spread_pct", "mfu", "mfu_peak_tflops",
                 "mfu_peak_source", "device", "power_limit_w")
E2E_FIELDS = ("metric", "value", "unit", "vs_baseline", "phase_ms", "mfu",
              "mfu_peak_tflops", "mfu_peak_source", "device",
              "power_limit_w")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="vgg", choices=list(MODEL_NAMES))
    p.add_argument("--batch_size", default=512, type=int)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no_bf16", action="store_true",
                   help="Skip the secondary bf16 stderr record")
    p.add_argument("--primary_only", action="store_true",
                   help="Skip the secondary resident-epoch record")
    p.add_argument("--steps", default=50, type=int)
    p.add_argument("--warmup", default=10, type=int)
    p.add_argument("--repeats", default=5, type=int,
                   help="Timed windows; the median is the headline, and "
                        "every window lands in window_ms_per_step")
    p.add_argument("--shard_update", action="store_true",
                   help="ZeRO-1 weight-update sharding (world 1, as "
                        "singlegpu takes it)")
    p.add_argument("--num_devices", default=None, type=int,
                   help="Ranks (default 1): N > 1 runs the step records, "
                        "--e2e or --guard_overhead as N ranks, gloo with "
                        "--device cpu, one a card over NCCL on the cards")
    p.add_argument("--dispatch", default="step", choices=["step", "scan"],
                   help="Only step: an eager program has no scan")
    p.add_argument("--prefetch_depth", default=2, type=int, metavar="D")
    p.add_argument("--prefetch_workers", default=4, type=int, metavar="W")
    p.add_argument("--e2e", action="store_true",
                   help="End-to-end epochs through the real Trainer")
    p.add_argument("--resident", action="store_true",
                   help="--e2e: device-resident data (crop and flip on "
                        "the card)")
    p.add_argument("--e2e_steps", default=16, type=int,
                   help="--e2e: steps an epoch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    p.add_argument("--result_json", default=None, metavar="PATH",
                   help="Write the records, the train steps run in each "
                        "dtype and the kernels' launches here")
    p.add_argument("--inspect_overhead", action="store_true",
                   help="Price an enabled but idle introspection plane: "
                        "round-robin windows of the fixed-batch step loop "
                        "bare and with a bound idle inspect server, the "
                        ".prom rewrite and the unarmed profile trigger "
                        "(acceptance < 1%%)")
    p.add_argument("--profile_dir", default=None,
                   help="Also run one traced, untimed window (the primary "
                        "record's; with --e2e or --stream_attr one epoch "
                        "after the timed ones) under torch.profiler and "
                        "export its Chrome trace into this directory")
    p.add_argument("--guard_overhead", action="store_true",
                   help="Price the step-level fault domain on the "
                        "steady-state step loop: ms/step with the drift "
                        "audit off, at K=50, K=10, and with the spike "
                        "guard's host-side window check on.  The audit's "
                        "synchronous host verdict read (two small "
                        "all-reduces + a host read every K steps) is the "
                        "cost being measured; acceptance is < 1%% ms/step "
                        "at K=50")
    p.add_argument("--batch_sweep", default=None, metavar="B1,B2,...",
                   help="MFU-vs-per-chip-batch sweep: one subprocess per "
                        "(batch, flavor) cell, reporting median-based "
                        "samples/sec/chip + mfu per cell (larger batches "
                        "amortise the batch-invariant work a step; the "
                        "batch knob is the reference's own, "
                        "multigpu.py:259)")
    p.add_argument("--batch_sweep_flavors",
                   default=",".join(BATCH_SWEEP_FLAVORS), metavar="F1,F2,...",
                   help="Cells per batch size: comma list from "
                        "{fp32,bf16}_step (default: both; the scan "
                        "flavours have no eager counterpart)")
    p.add_argument("--sweep", default=None, metavar="N1,N2,...",
                   help="Scaling harness: one subprocess per device count "
                        "(on the bench's --device: gloo ranks with --device "
                        "cpu, one rank a card otherwise), reporting per-N "
                        "samples/sec/chip + efficiency")
    p.add_argument("--sweep_platform", default=None, choices=["cpu", "real"],
                   help="cpu: each sweep child runs N gloo ranks on the CPU "
                        "(a dispatch+collective-overhead trend, no card "
                        "needed); real: children run one rank a card over "
                        "NCCL (the actual scaling measurement).  Follows "
                        "--device (cpu with --device cpu, real otherwise); "
                        "a value that contradicts it is refused")
    p.add_argument("--pipeline", action="store_true",
                   help="Time the HOST side only: loader materialisation + "
                        "augmentation, no device in the loop; isolates "
                        "input-pipeline throughput from H2D bandwidth for "
                        "the host-fed-vs-resident gap attribution")
    p.add_argument("--stream_attr", action="store_true",
                   help="Streaming-gap attribution: measure host-augment, "
                        "H2D upload, and the device step each in ISOLATION "
                        "at the training shape, then the end-to-end "
                        "streaming epoch through the real Trainer + "
                        "prefetch engine, and decompose the wall time by "
                        "the pipeline model (wall == slowest stage when "
                        "perfectly overlapped; the excess is dispatch "
                        "gap).  Composes with --prefetch_depth/"
                        "--prefetch_workers and --bf16")
    p.add_argument("--serve", action="store_true",
                   help="Load-generate against the serving stack "
                        "(ddp_tpu_torch/serve/): closed-loop capacity probe, "
                        "then an open-loop offered-load sweep recording "
                        "p50/p90/p99 latency + achieved throughput per "
                        "point and locating the saturation knee")
    p.add_argument("--fleet", default=1, type=int, metavar="N",
                   help="With --serve: drive N engine replicas behind the "
                        "fault-tolerant router (serve/fleet.py) instead of "
                        "one bare engine+batcher (default 1)")
    p.add_argument("--serve_loads", default="auto", metavar="R1,R2,...",
                   help="Offered loads (requests/sec) for the open-loop "
                        "sweep; 'auto' derives 5 points bracketing the "
                        "measured closed-loop capacity (0.4/0.7/1.0/1.5/"
                        "2.25x) so the knee is inside the sweep by "
                        "construction")
    p.add_argument("--serve_secs", default=4.0, type=float,
                   help="Seconds per load point (default 4)")
    p.add_argument("--serve_buckets", default="1,8,32,128",
                   help="Engine padded-batch bucket set (one CUDA graph "
                        "each, captured at startup; default 1,8,32,128)")
    p.add_argument("--serve_max_wait_ms", default=5.0, type=float,
                   help="Batch-forming wait budget (default 5 ms)")
    p.add_argument("--serve_queue_depth", default=256, type=int,
                   help="Admission queue bound (default 256)")
    p.add_argument("--serve_conc", default=8, type=int,
                   help="Closed-loop concurrent clients (default 8)")
    p.add_argument("--serve_rows", default=1, type=int,
                   help="Image rows per request (default 1, the "
                        "single-user online shape)")
    p.add_argument("--snapshot_path", default=None,
                   help="With --serve: serve this trained checkpoint (head "
                        "path or directory) instead of fresh-init weights")
    p.add_argument("--generate", action="store_true",
                   help="With --serve: bench GENERATIVE decoding (the "
                        "tinylm KV-cache engine + token-level continuous "
                        "batcher) instead of the classifier stack — "
                        "tokens/sec and TTFT vs concurrent streams")
    p.add_argument("--gen_streams", default="1,2,4,8",
                   metavar="S1,S2,...",
                   help="With --generate: concurrent client-stream "
                        "counts to sweep (default 1,2,4,8; each point "
                        "runs --serve_secs seconds)")
    p.add_argument("--gen_prompt_len", default=8, type=int,
                   help="With --generate: prompt tokens per stream "
                        "(default 8)")
    p.add_argument("--gen_new_tokens", default=16, type=int,
                   help="With --generate: tokens generated per stream "
                        "(default 16)")
    p.add_argument("--gen_slots", default=8, type=int,
                   help="With --generate: KV-cache slots (the decode "
                        "batch width; default 8)")
    p.add_argument("--gen_prefill_buckets", default="16,64",
                   help="With --generate: padded prompt buckets "
                        "(default 16,64)")
    p.add_argument("--chaos", action="store_true",
                   help="Run the chaos campaign (python -m "
                        "ddp_tpu_torch.chaos_campaign): the DDP_TPU_FAULT "
                        "drill matrix under the supervisor, scored per "
                        "drill on restarts used, time-to-recover, and "
                        "final-state bit-parity vs an undisturbed control; "
                        "its exit code is this one's")
    p.add_argument("--chaos_out", default="CHAOS_r01.json",
                   help="--chaos scorecard path (default CHAOS_r01.json)")
    p.add_argument("--chaos_drills", default=None, metavar="D1,D2,...",
                   help="--chaos drill subset (default: the full matrix)")
    for flag in REFUSED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def check_args(args: argparse.Namespace) -> None:
    """Refuse, by name, what this entry point does not port."""
    for flag, item in REFUSED.items():
        if getattr(args, flag[2:]) is not None:
            raise SystemExit(f"{flag} is not ported to ddp_tpu_torch.bench "
                             f"(ROADMAP {item})")
    if args.generate and not args.serve:
        raise SystemExit("--generate benches the generative serving stack: "
                         "pass it with --serve")
    if args.dispatch == "scan":
        raise SystemExit("--dispatch scan has no eager counterpart (none: "
                         "the resident-epoch record is the nearest)")
    if args.batch_sweep:
        flavors = [f.strip() for f in args.batch_sweep_flavors.split(",")
                   if f.strip()]
        scan = sorted(set(flavors) & set(SCAN_FLAVORS))
        if scan:
            raise SystemExit(f"--batch_sweep_flavors {','.join(scan)}: no "
                             f"eager counterpart (pick from "
                             f"{','.join(BATCH_SWEEP_FLAVORS)})")
        unknown = sorted(set(flavors) - set(BATCH_SWEEP_FLAVORS))
        if unknown or not flavors:
            raise SystemExit(f"--batch_sweep_flavors: unknown flavor(s) "
                             f"{unknown}; pick from "
                             f"{list(BATCH_SWEEP_FLAVORS)}")
    one_device = [f"--{m}" for m in ("serve", "stream_attr",
                                     "inspect_overhead") if getattr(args, m)]
    if (args.num_devices or 1) > 1 and one_device:
        raise SystemExit(f"--num_devices {args.num_devices} with "
                         f"{one_device[0]}: the port runs it on one device; "
                         f"N ranks run the step records, --e2e and "
                         f"--guard_overhead")


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in W from ``nvidia-smi`` (its row at the
    device's index); None on the CPU.  On a card a missing or unreadable
    ``nvidia-smi`` raises: every card record names its limit."""
    if device.type != "cuda":
        return None
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi is not on PATH: the record would "
                           "lack the card's power limit")
    out = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    row = out.strip().splitlines()[device.index or 0]
    return float(row.rsplit(",", 1)[1].strip().split()[0])


class _Bench:
    """What every record of one run shares: the device, its name and
    power limit, and the train steps run in each compute dtype."""

    def __init__(self, args: argparse.Namespace, device: torch.device):
        self.args = args
        self.device = device
        self.kind = device_kind(device)
        # This process's rank of a --num_devices run (world 1 without one).
        self.rank, self.world = dist.rank(), dist.world_size()
        self.card = {"name": self.kind, "count": self.world}
        self.power_limit_w = power_limit_w(device)
        self.steps_run = {"float32": 0, "bfloat16": 0}
        # Eval-form calls of gather_batch's wrapper that launch or capture
        # its kernel (the serving engines' warm(), on a card).
        self.eval_calls = {"float32": 0, "bfloat16": 0}
        # The launches of the child processes a sweep ran.
        self.child_launches = {"gather_batch": 0, "gather_batch_bf16": 0}

    def add_child(self, summary: Dict) -> None:
        for key in self.steps_run:
            self.steps_run[key] += summary["steps"][key]
            self.eval_calls[key] += summary["eval_calls"][key]
        for key in self.child_launches:
            self.child_launches[key] += summary["launches"][key]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mfu_fields(self, sps_chip: float, bf16: bool) -> Dict:
        if self.rank != 0:
            # Only rank 0's record is printed: the FLOP count's first call
            # costs seconds a process.
            return {"mfu": None, "mfu_peak_tflops": None,
                    "mfu_peak_source": None}
        dtype = "bfloat16" if bf16 else "float32"
        mfu = model_mfu(sps_chip, self.args.model, self.kind, dtype)
        peak = mfu_peak(self.kind, dtype)
        return {"mfu": None if mfu is None else round(mfu, 4),
                "mfu_peak_tflops": None if peak is None
                else round(peak[0], 3),
                "mfu_peak_source": None if peak is None else peak[1]}

    def time_windows(self, run_window) -> List[float]:
        """Each repeat's wall seconds for one window of ``--steps`` steps,
        ending in a synchronize and a host read of its last loss."""
        dts = []
        for _ in range(max(self.args.repeats, 1)):
            t0 = time.perf_counter()
            loss = run_window()
            self.sync()
            float(loss)
            dts.append(time.perf_counter() - t0)
        return dts

    def record(self, tag: str, dts: List[float], bf16: bool) -> Dict:
        a = self.args
        dt = statistics.median(dts)  # the headline window
        sps_chip = a.batch_size * a.steps / dt
        rec = {
            "metric": f"{a.model} train samples/sec/chip "
                      f"(batch {a.batch_size}/chip, "
                      f"{'bf16' if bf16 else 'fp32'}, {self.world} chip(s), "
                      f"{'zero-sharded update, ' if a.shard_update else ''}"
                      f"{tag})",
            "value": round(sps_chip, 2),
            "unit": "samples/sec/chip",
            "vs_baseline": 1.0,
            "wall_ms_per_step": round(dt / a.steps * 1e3, 3),
            "window_ms_per_step": [round(d / a.steps * 1e3, 3) for d in dts],
            "median_ms_per_step": round(dt / a.steps * 1e3, 3),
            "best_window_ms_per_step": round(min(dts) / a.steps * 1e3, 3),
            "window_spread_pct": round(
                (max(dts) - min(dts)) / min(dts) * 100.0, 1),
        }
        rec.update(self.mfu_fields(sps_chip, bf16))
        rec.update(device=self.card, power_limit_w=self.power_limit_w)
        return rec

    def _generators(self):
        """``draws(step, n, micro)`` and ``dropout(step, micro)`` on device
        generators keyed as the trainer keys them (seed 0, epoch 0)."""
        gen = torch.Generator(device=self.device)
        drop = torch.Generator(device=self.device)

        def draws(step: int, n: int, micro: int = 0):
            gen.manual_seed(draw_seed(0, 0, step, 0, micro))
            return make_draws(gen, n, self.device)

        def dropout(step: int, micro: int = 0) -> torch.Generator:
            return drop.manual_seed(dropout_seed(0, 0, step, 0, micro))

        return draws, dropout

    def fixed_batch(self) -> list:
        """This rank's fixed device batch of ``synthetic(n_train=batch_size
        x world)`` images, as the step takes its micro-batches."""
        a, device = self.args, self.device
        ds, _ = synthetic(n_train=a.batch_size * self.world, n_test=1)
        rows = slice(self.rank * a.batch_size, (self.rank + 1) * a.batch_size)
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        return [to_device({"image": ds.images[rows],
                           "label": ds.labels[rows].astype(np.int64)},
                          device, stream=stream).wait()]

    def profiled(self, window, name: str) -> None:
        """One call of ``window`` under ``torch.profiler``, untimed (the
        profiler skews the clock), its Chrome trace written to
        ``--profile_dir``/``name``."""
        cuda = self.device.type == "cuda"
        prof = start_profiler(cuda)
        try:
            out = window()
            if out is not None:
                float(out)
        finally:
            path = stop_profiler(
                prof, os.path.join(self.args.profile_dir, name), cuda)
        print(f"profile: wrote {path}", file=sys.stderr, flush=True)

    def step_records(self, bf16: bool, extras: bool,
                     profile: bool = False) -> List[Dict]:
        """The primary record and, with ``extras``, the resident-epoch
        one; with ``profile`` and ``--profile_dir``, one traced window
        before the timed ones (and no resident-epoch record, as
        ``bench.py``'s ``--profile_dir`` drops its second flavour)."""
        a, device = self.args, self.device
        dtype = torch.bfloat16 if bf16 else None
        key = "bfloat16" if bf16 else "float32"
        model = get_model(a.model, device=device,
                          generator=torch.Generator().manual_seed(0))
        state = init_train_state(model)
        if a.shard_update:
            state.momentum = list_to_opt_shard(state.momentum)
        kw = dict(shard_update=a.shard_update, compute_dtype=dtype)
        draws, dropout = self._generators()

        step_fn = make_train_step(model, SGDConfig(), SCHEDULE, False, **kw)
        micros = self.fixed_batch()

        def step_window(n: int = a.steps) -> torch.Tensor:
            for _ in range(n):
                loss = step_fn(state, micros, None, dropout)
            self.steps_run[key] += n
            return loss

        self.sync()
        float(step_window(max(a.warmup, 1)))
        if profile:
            self.profiled(step_window, "trace_step.json")
        recs = [self.record(f"{a.steps}-step window, per-step dispatch",
                            self.time_windows(step_window), bf16)]
        if not extras or a.profile_dir:
            return recs

        table, _ = synthetic(n_train=a.batch_size * a.steps * self.world,
                             n_test=1)
        resident = ResidentData(table, device)
        loader = TrainLoader(table, a.batch_size, self.world, augment=False,
                             local_replicas=[self.rank])
        full, _ = loader.rank_index_matrix(self.rank)
        idx = torch.from_numpy(full).to(device)
        epoch_fn = make_train_epoch(model, SGDConfig(), SCHEDULE, True, **kw)

        def resident_window(rows: torch.Tensor = idx) -> torch.Tensor:
            losses = epoch_fn(state, resident.images, resident.labels, rows,
                              draws, None, dropout)
            self.steps_run[key] += len(rows)
            return losses[-1]

        float(resident_window(idx[:max(a.warmup, 1)]))
        recs.append(self.record(
            f"{a.steps}-step resident epoch (resident-epoch mode)",
            self.time_windows(resident_window), bf16))
        return recs

    def e2e_record(self) -> Dict:
        """The real Trainer: 2 warm-up epochs, 3 timed (bench.py
        ``_bench_e2e``)."""
        a, device = self.args, self.device
        model = get_model(a.model, device=device,
                          generator=torch.Generator().manual_seed(0))
        n_train = a.batch_size * self.world * a.e2e_steps
        train_ds, _ = synthetic(n_train=n_train, n_test=1)
        loader = TrainLoader(train_ds, a.batch_size, self.world,
                             augment=not a.resident,
                             local_replicas=[self.rank])
        # The ring holds the whole run, so phase_ms covers every timed
        # step.
        tracer = SpanTracer(ring=max(4096, a.e2e_steps * 5 * 8))
        set_tracer(tracer)
        try:
            trainer = Trainer(
                model, loader, device=device, lr_schedule=SCHEDULE,
                sgd_config=SGDConfig(), save_every=10 ** 9,
                snapshot_path=None, shard_update=a.shard_update,
                compute_dtype=torch.bfloat16 if a.bf16 else None,
                resident=a.resident, device_augment=a.resident,
                prefetch_depth=a.prefetch_depth,
                prefetch_workers=a.prefetch_workers)
            with contextlib.redirect_stdout(io.StringIO()):
                trainer.train(2)
                t_window = tracer.now()
                t0 = time.perf_counter()
                trainer.train(3)  # train() starts at epoch 0 again
                self.sync()
                dt = time.perf_counter() - t0
                phase_spans = tracer.spans_since(t_window)
                if a.profile_dir:
                    # One traced epoch after the timed ones, as
                    # bench.py's --e2e --profile_dir.
                    self.profiled(lambda: trainer.train(1),
                                  "trace_e2e.json")
        finally:
            set_tracer(None)
        self.steps_run["bfloat16" if a.bf16 else "float32"] += \
            (5 + bool(a.profile_dir)) * len(loader)
        phase_ms = {k: round(v, 3) for k, v in sorted(
            phase_medians(phase_spans).items())}
        sps_chip = n_train * 3 / dt / self.world
        feed = ("HBM-resident data" if a.resident
                else f"host-fed, prefetch depth {a.prefetch_depth}")
        rec = {
            "metric": f"{a.model} e2e train samples/sec/chip "
                      f"(batch {a.batch_size}/chip, "
                      f"{'bf16' if a.bf16 else 'fp32'}, {self.world} "
                      f"chip(s), {feed}, "
                      f"{'zero-sharded update, ' if a.shard_update else ''}"
                      f"{a.e2e_steps}-step epochs, incl. input pipeline)",
            "value": round(sps_chip, 2),
            "unit": "samples/sec/chip",
            "vs_baseline": 1.0,
            "phase_ms": phase_ms,
        }
        rec.update(self.mfu_fields(sps_chip, a.bf16))
        rec.update(device=self.card, power_limit_w=self.power_limit_w)
        return rec

    def inspect_overhead_record(self) -> Dict:
        """An enabled but idle introspection plane priced on the step loop
        (``bench.py --inspect_overhead``): round-robin windows of the
        fixed-batch float32 step bare, and with what ``--inspect_port``
        adds when nobody scrapes (a bound loopback server on its thread,
        the ``.prom`` rewrite every 50 steps and the unarmed profile
        trigger, probed each step).  The headline is the median window's
        overhead in % (negative medians clamp to 0)."""
        a, device = self.args, self.device
        model = get_model(a.model, device=device,
                          generator=torch.Generator().manual_seed(0))
        state = init_train_state(model)
        step_fn = make_train_step(model, SGDConfig(), SCHEDULE, False)
        micros = self.fixed_batch()
        _, dropout = self._generators()
        counter = [0]
        registry = MetricsRegistry()
        registry.counter("ddp_bench_steps_total", "Bench loop steps"
                         ).set_function(lambda: float(counter[0]))
        tracer = SpanTracer(spill_path=None, ring=1024)

        def window(probe: bool, n: int = a.steps) -> torch.Tensor:
            for _ in range(n):
                loss = step_fn(state, micros, None, dropout)
                if probe:
                    counter[0] += 1
                    writer.step(counter[0])
                    trigger.step(counter[0])
            self.steps_run["float32"] += n
            return loss

        dts: Dict[str, List[float]] = {"inspect_off": [], "inspect_on": []}
        with tempfile.TemporaryDirectory() as tmp:
            writer = PromFileWriter(registry, os.path.join(tmp, "m.prom"),
                                    every=50)
            trigger = ProfileTrigger(tracer, tmp, profiler_available=False)
            server = InspectServer(0, registry=registry, tracer=tracer,
                                   health=lambda: {"step": counter[0]},
                                   profile=trigger)
            try:
                float(window(False, max(a.warmup, 1)))
                float(window(True))  # the probe path's first .prom write
                for _ in range(max(a.repeats, 1)):
                    for name in dts:
                        t0 = time.perf_counter()
                        loss = window(probe=name == "inspect_on")
                        self.sync()
                        float(loss)
                        dts[name].append(time.perf_counter() - t0)
            finally:
                server.close()
                tracer.close()
        per = {name: {
            "median_ms_per_step": round(
                statistics.median(d) / a.steps * 1e3, 4),
            "best_window_ms_per_step": round(min(d) / a.steps * 1e3, 4),
            "window_ms_per_step": [round(x / a.steps * 1e3, 4) for x in d],
        } for name, d in dts.items()}
        base = per["inspect_off"]["median_ms_per_step"]
        overhead = round((per["inspect_on"]["median_ms_per_step"] - base)
                         / base * 100.0, 2)
        per["inspect_on"]["overhead_pct_vs_off"] = overhead
        return {
            "metric": f"{a.model} idle introspection-plane overhead "
                      f"(batch {a.batch_size}/chip, fp32, 1 chip(s), "
                      f"{a.steps}-step round-robin windows: bare loop vs "
                      f"bound idle server + per-step probe)",
            "value": max(overhead, 0.0),
            "unit": "% ms/step of --inspect_port enabled-but-idle vs off "
                    "(median windows; acceptance: < 1%; negative medians "
                    "clamp to 0 — the delta is inside timing noise)",
            "vs_baseline": 1.0,
            "inspect_overhead": per,
            "device": self.card, "power_limit_w": self.power_limit_w,
        }


    def guard_overhead_record(self) -> Dict:
        """The step-level fault domain priced on the fixed-batch float32
        step (``bench.py --guard_overhead``): round-robin windows with the
        drift audit off, every 50 steps, every 10 steps, and the spike
        guard's median/MAD window check over the window's losses (one
        stacked host read, the trainer's flush shape).  One audit call
        (fingerprints, two sum all-reduces, the host read of the mismatch
        matrix) is then priced directly; its amortised share of the
        audit-off median step at K=50 is the headline."""
        a, device = self.args, self.device
        model = get_model(a.model, device=device,
                          generator=torch.Generator().manual_seed(0))
        state = init_train_state(model)
        step_fn = make_train_step(model, SGDConfig(), SCHEDULE, False)
        micros = self.fixed_batch()
        _, dropout = self._generators()
        auditor = DriftAuditor(model, every=1, action="abort")
        n_leaves = len(auditor.paths)

        def window(audit_every: int = 0,
                   guard: Optional[StepHealthGuard] = None) -> torch.Tensor:
            losses = []
            for i in range(1, a.steps + 1):
                loss = step_fn(state, micros, None, dropout)
                if guard is not None:
                    losses.append(loss)
                if audit_every and i % audit_every == 0:
                    auditor.audit(model, i)
            self.steps_run["float32"] += a.steps
            if guard is not None:
                # The trainer's flush shape: ONE stacked host read, then
                # the rolling-window check over the whole stretch.
                stacked = torch.stack(losses).double().cpu().numpy()
                guard.check(stacked, epoch=0, start_step=0)
            return loss

        def make_guard() -> StepHealthGuard:
            # skip on a spike: a measurement must never raise out of the
            # timed window; the decision path costs the same.
            return StepHealthGuard("abort", window=64, spike_factor=2.0,
                                   spike_action="skip")

        # Warm every path before any timed window: the step, the audit's
        # fingerprints and all-reduces, the loss stack, and the guard's
        # median/MAD (numpy's first median costs tens of ms).
        losses = []
        for _ in range(max(a.warmup, 1)):
            losses.append(step_fn(state, micros, None, dropout))
        self.steps_run["float32"] += max(a.warmup, 1)
        auditor.audit(model, 1)
        warm = torch.stack(losses).double().cpu().numpy()
        make_guard().check(np.resize(warm, 64), epoch=0, start_step=0)
        loss = losses[-1]

        # Round-robin windows: a box that drifts (clocks, caches) over the
        # run would otherwise fold its drift into the configs' deltas.
        configs = [("audit_off", {}),
                   ("audit_k50", {"audit_every": 50}),
                   ("audit_k10", {"audit_every": 10}),
                   ("guard_on", {})]
        dts: Dict[str, List[float]] = {name: [] for name, _ in configs}
        for _ in range(max(a.repeats, 1)):
            for name, kw in configs:
                guard = make_guard() if name == "guard_on" else None
                t0 = time.perf_counter()
                loss = window(guard=guard, **kw)
                self.sync()
                float(loss)
                dts[name].append(time.perf_counter() - t0)
        per = {name: {
            "median_ms_per_step": round(
                statistics.median(d) / a.steps * 1e3, 4),
            "best_window_ms_per_step": round(min(d) / a.steps * 1e3, 4),
            "window_ms_per_step": [round(x / a.steps * 1e3, 4) for x in d],
        } for name, d in dts.items()}
        base = per["audit_off"]["median_ms_per_step"]
        for k in ("audit_k50", "audit_k10", "guard_on"):
            per[k]["overhead_pct_vs_off"] = round(
                (per[k]["median_ms_per_step"] - base) / base * 100.0, 2)
        # The window deltas sit inside the timing noise: one audit call
        # priced directly gives the amortised cost audit_ms / K / step_ms.
        a_dts = []
        for _ in range(max(a.repeats, 1) * 4):
            t0 = time.perf_counter()
            auditor.audit(model, 1)
            a_dts.append(time.perf_counter() - t0)
        audit_call_ms = round(statistics.median(a_dts) * 1e3, 4)
        derived = {f"k{k}": round(audit_call_ms / k / base * 100.0, 4)
                   for k in (50, 10)}
        return {
            "metric": f"{a.model} step-level fault-domain overhead "
                      f"(batch {a.batch_size}/chip, fp32, {self.world} "
                      f"chip(s), {a.steps}-step round-robin windows: "
                      f"drift audit off/K=50/K=10 + spike-guard window "
                      f"check; one audit call priced directly)",
            "value": derived["k50"],
            "unit": "% ms/step of the K=50 drift audit, derived as "
                    "audit_call_ms / 50 / audit-off median ms/step "
                    "(acceptance: < 1%); window deltas recorded alongside "
                    "as the in-noise upper bound",
            "vs_baseline": 1.0,
            "guard_overhead": per,
            "audit_call_ms": audit_call_ms,
            "derived_audit_overhead_pct": derived,
            # A fingerprint row and the [world, L] mismatch matrix, int64.
            "audit_payload_bytes": (1 + self.world) * n_leaves * 8,
            "audit_n_leaves": n_leaves,
            "device": self.card, "power_limit_w": self.power_limit_w,
        }

    def serve_record(self) -> Dict:
        """Serving latency and throughput against offered load
        (``bench.py --serve``), around ``--fleet`` in-process engines, each
        behind a dynamic batcher (the HTTP layer is out of the loop; at N >
        1 the engines are ``LocalReplica``s behind a ``Router``, whose
        sheds are ``QueueFull``s):

        1. closed loop: ``--serve_conc`` clients submitting back to back,
           the capacity probe;
        2. open loop: fixed-rate arrivals at each ``--serve_loads`` point
           from a bounded submitter pool, recording p50/p90/p99 latency,
           achieved throughput, shed and timed-out counts.

        The knee is the last offered point served at >= 95% of the offered
        rate with nothing shed or timed out; the headline is the achieved
        rate there.  Each engine's ``warm()`` count (CUDA graphs on a card)
        is held to its bucket count."""
        a, device = self.args, self.device
        dtype = torch.bfloat16 if a.bf16 else None
        buckets = [int(b) for b in a.serve_buckets.split(",") if b]
        fleet_n = max(int(a.fleet), 1)

        def make_engine() -> ServeEngine:
            if a.snapshot_path:
                return ServeEngine.from_checkpoint(
                    a.snapshot_path, a.model, device=device,
                    buckets=buckets, compute_dtype=dtype)
            return ServeEngine(
                get_model(a.model, generator=torch.Generator().manual_seed(0)),
                device=device, buckets=buckets, compute_dtype=dtype)

        t0 = time.perf_counter()
        engines = [make_engine() for _ in range(fleet_n)]
        engine = engines[0]
        compiled = 0
        for eng in engines:
            c = eng.warm()
            if c > len(eng.buckets):
                raise RuntimeError(f"compile bound broken: {c} > "
                                   f"{len(eng.buckets)}")
            compiled += c
        warm_s = time.perf_counter() - t0
        if device.type == "cuda":
            # warm(): each bucket's eager run and its capture.
            self.eval_calls["bfloat16" if a.bf16 else "float32"] += \
                2 * compiled
        if not 1 <= a.serve_rows <= engine.max_rows:
            raise SystemExit(
                f"--serve_rows {a.serve_rows} does not fit the engine's "
                f"buckets (largest {engine.max_rows}); every request would "
                "be rejected at admission")
        batchers = [DynamicBatcher(eng, max_wait_ms=a.serve_max_wait_ms,
                                   queue_depth=a.serve_queue_depth).start()
                    for eng in engines]
        router = None
        if fleet_n > 1:
            router = Router([LocalReplica(f"r{i}", eng, b) for i, (eng, b)
                             in enumerate(zip(engines, batchers))]).start()
            submit = router.submit
        else:
            submit = batchers[0].submit
        req = np.random.default_rng(0).integers(
            0, 256, (a.serve_rows, 32, 32, 3)).astype(np.uint8)

        def pct(lat: List[float]) -> Dict:
            return {k: (round(v, 3) if v is not None else None)
                    for k, v in percentiles(lat).items()}

        def closed_loop(conc: int, secs: float) -> Dict:
            stop = time.perf_counter() + secs
            lat: List[float] = []
            timeouts = [0]
            lock = threading.Lock()

            def client():
                # A timed-out request must not end the client: a dead
                # client offers no load and the record would understate
                # capacity.
                while time.perf_counter() < stop:
                    t = time.perf_counter()
                    try:
                        submit(req, timeout=30)
                    except TimeoutError:
                        with lock:
                            timeouts[0] += 1
                        continue
                    dt = (time.perf_counter() - t) * 1e3
                    with lock:
                        lat.append(dt)

            threads = [threading.Thread(target=client) for _ in range(conc)]
            t_start = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t_start
            return {"clients": conc, "requests": len(lat),
                    "throughput_rps": round(len(lat) / wall, 2),
                    "timed_out": timeouts[0], "latency_ms": pct(lat)}

        def open_loop(rate: float, secs: float) -> Dict:
            n = max(int(rate * secs), 8)
            base = time.perf_counter() + 0.05
            arrivals = [base + i / rate for i in range(n)]
            lat: List[float] = []
            counts = {"shed": 0, "timed_out": 0}
            counter = iter(range(n))
            lock = threading.Lock()

            def client():
                while True:
                    with lock:
                        i = next(counter, None)
                    if i is None:
                        return
                    delay = arrivals[i] - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    t = time.perf_counter()
                    try:
                        submit(req, timeout=30)
                    except QueueFull:
                        with lock:
                            counts["shed"] += 1
                        continue
                    except TimeoutError:  # counted, never a dead client
                        with lock:
                            counts["timed_out"] += 1
                        continue
                    dt = (time.perf_counter() - t) * 1e3
                    with lock:
                        lat.append(dt)

            pool = [threading.Thread(target=client)
                    for _ in range(min(128, n))]
            t_start = time.perf_counter()
            for t in pool:
                t.start()
            for t in pool:
                t.join()
            wall = max(time.perf_counter() - t_start - 0.05, 1e-9)
            return {"offered_rps": round(rate, 2), "requests": n,
                    "achieved_rps": round(len(lat) / wall, 2),
                    "shed": counts["shed"],
                    "shed_rate": round(counts["shed"] / n, 4),
                    "timed_out": counts["timed_out"], "latency_ms": pct(lat)}

        try:
            closed = closed_loop(a.serve_conc, a.serve_secs)
            capacity = closed["throughput_rps"]
            if capacity <= 0:
                raise SystemExit(
                    "closed-loop capacity probe served 0 requests in "
                    f"{a.serve_secs}s (all timed out?); no load sweep to "
                    "run: raise --serve_secs or check the engine")
            if a.serve_loads == "auto":
                # Dynamic batching serves above the closed-loop probe
                # (larger formed batches), so the sweep reaches past it.
                loads = [round(capacity * f, 2)
                         for f in (0.4, 0.7, 1.0, 1.5, 2.25)]
            else:
                loads = [float(x) for x in a.serve_loads.split(",")]
            points = [open_loop(r, a.serve_secs) for r in sorted(loads)]
            stats = {"engine": engine.stats(), "batcher": batchers[0].stats(),
                     "router": router.stats() if router is not None
                     else None}
        finally:
            if router is not None:
                router.close()
            for b in batchers:
                b.drain(timeout=10.0)
        knee = None
        for pt in points:  # ascending offered load
            if pt["shed"] == 0 and pt["timed_out"] == 0 and \
                    pt["achieved_rps"] >= 0.95 * pt["offered_rps"]:
                knee = pt
        head = knee or points[-1]
        # The unit says what the number is: with no knee inside the sweep
        # the headline is the most-saturated point's throughput.
        return {
            "metric": f"{a.model} serve latency/throughput vs offered load "
                      f"(fleet of {fleet_n}, "
                      f"batch buckets {list(engine.buckets)}, "
                      f"{a.serve_rows} row(s)/request, "
                      f"{'bf16' if a.bf16 else 'fp32'}, 1 chip(s), max_wait "
                      f"{a.serve_max_wait_ms} ms)",
            "value": head["achieved_rps"],
            "unit": ("req/s at the saturation knee (last offered point "
                     "served >=95% with nothing shed)" if knee is not None
                     else "req/s at the MOST-SATURATED sweep point (no knee "
                          "inside the sweep: every offered point shed or "
                          "degraded; not comparable to knee records)"),
            "vs_baseline": 1.0,
            "serve": {
                "fleet": fleet_n,
                "closed_loop": closed,
                "open_loop": points,
                "knee_offered_rps": (knee or {}).get("offered_rps"),
                "samples_per_sec_at_knee": round(
                    head["achieved_rps"] * a.serve_rows, 2),
                "compiled_executables": compiled,
                "bucket_set_size": len(engine.buckets),
                "warm_compile_s": round(warm_s, 2),
                **stats,
            },
            "device": self.card, "power_limit_w": self.power_limit_w,
        }

    def generate_record(self) -> Dict:
        """Generative serving throughput (``bench.py --serve --generate``):
        tokens/s and TTFT against concurrent streams.  Each point runs S
        closed-loop clients for ``--serve_secs`` seconds, each looping
        whole streams (prompt, prefill, ``--gen_new_tokens`` decode steps).
        The decode program advances every live slot a step at a fixed
        ``[slots]`` shape, so the tokens/s should rise with S until the
        slots are full; the TTFT percentiles of each point price what
        sharing the decode costs the first token."""
        from .models import transformer as tfm
        from .serve import KVCacheEngine, TokenBatcher
        a, device = self.args, self.device
        dtype = torch.bfloat16 if a.bf16 else None
        prefill_buckets = [int(b) for b in
                           a.gen_prefill_buckets.split(",") if b]
        t0 = time.perf_counter()
        if a.snapshot_path:
            engine = KVCacheEngine.from_checkpoint(
                a.snapshot_path, tfm.LM_NAME, device=device,
                slots=a.gen_slots, prompt_buckets=prefill_buckets,
                compute_dtype=dtype)
        else:
            engine = KVCacheEngine(
                get_model(tfm.LM_NAME,
                          generator=torch.Generator().manual_seed(0)),
                device=device, slots=a.gen_slots,
                prompt_buckets=prefill_buckets, compute_dtype=dtype)
        compiled = engine.warm()
        if compiled > engine.compile_bound:
            raise RuntimeError(f"compile bound broken: {compiled} > "
                               f"{engine.compile_bound}")
        warm_s = time.perf_counter() - t0
        batcher = TokenBatcher(engine, max_new_tokens=a.gen_new_tokens,
                               queue_depth=a.serve_queue_depth).start()
        n_prompt = max(1, min(int(a.gen_prompt_len), engine.max_prompt))

        def pct(values: List[float]) -> Dict:
            return {k: (round(v, 3) if v is not None else None)
                    for k, v in percentiles(values).items()}

        def point(streams: int, secs: float) -> Dict:
            stop = time.perf_counter() + secs
            lock = threading.Lock()
            tokens = [0]
            ttfts: List[float] = []
            stream_lat: List[float] = []
            completed = [0]

            def client(seed: int):
                r = np.random.default_rng(seed)
                while time.perf_counter() < stop:
                    prompt = r.integers(0, tfm.VOCAB, n_prompt).tolist()
                    t = time.perf_counter()
                    try:
                        out = batcher.generate(
                            prompt, max_new_tokens=a.gen_new_tokens,
                            timeout=60)
                    except TimeoutError:
                        continue  # counted absent: a dead point shows 0
                    dt = (time.perf_counter() - t) * 1e3
                    with lock:
                        tokens[0] += len(out["tokens"])
                        ttfts.append(out["ttft_ms"])
                        stream_lat.append(dt)
                        completed[0] += 1

            threads = [threading.Thread(target=client, args=(1000 + i,))
                       for i in range(streams)]
            t_start = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t_start
            return {"streams": streams, "completed_streams": completed[0],
                    "tokens": tokens[0],
                    "tokens_per_sec": round(tokens[0] / wall, 2),
                    "ttft_ms": pct(ttfts),
                    "stream_latency_ms": pct(stream_lat)}

        streams = sorted({max(1, int(x))
                          for x in a.gen_streams.split(",") if x})
        try:
            curve = [point(n, a.serve_secs) for n in streams]
            stats = {"engine": engine.stats(), "batcher": batcher.stats()}
        finally:
            batcher.drain(timeout=10.0)
        head = curve[-1]
        return {
            "metric": f"{tfm.LM_NAME} generative decode tokens/sec vs "
                      f"concurrent streams ({engine.slots} KV slots, prompt "
                      f"{n_prompt}, {a.gen_new_tokens} new tokens/stream, "
                      f"prompt buckets {list(engine.prompt_buckets)}, "
                      f"{'bf16' if a.bf16 else 'fp32'}, 1 chip(s))",
            "value": head["tokens_per_sec"],
            "unit": f"tokens/s at {head['streams']} concurrent streams "
                    "(continuous token-level batching; higher is better)",
            "vs_baseline": 1.0,
            "generate": {
                "curve": curve,
                "slots": engine.slots,
                "compiled_executables": compiled,
                "compile_bound": engine.compile_bound,
                "warm_compile_s": round(warm_s, 2),
                "checkpoint": a.snapshot_path,
                **stats,
            },
            "device": self.card, "power_limit_w": self.power_limit_w,
        }

    def stream_attr_record(self) -> Dict:
        """The streaming-gap attribution (``bench.py --stream_attr``): the
        host stage (sequential materialise+augment), the blocking H2D copy
        (``to_device(...).wait()`` then a synchronize) and the device step
        on one device batch (``make_train_step``, one ``gather_batch``
        launch a step), each timed alone over an epoch; then the streaming
        ``Trainer`` with its ``PrefetchStats`` and a span ring sized to the
        whole run, ``--repeats`` timed epochs after 2 warm-up ones.  The
        isolated stages bound the run one could have (the pipeline-floor
        model needs each stage's uncontended cost); the spans, the
        record's ``phase_ms``, explain the run that ran.
        ``--profile_dir`` adds one untimed ``torch.profiler`` epoch."""
        a, device = self.args, self.device
        dtype = torch.bfloat16 if a.bf16 else None
        key = "bfloat16" if a.bf16 else "float32"
        model = get_model(a.model, device=device,
                          generator=torch.Generator().manual_seed(0))
        steps = a.e2e_steps
        train_ds, _ = synthetic(n_train=a.batch_size * steps, n_test=1)
        loader = TrainLoader(train_ds, a.batch_size, 1, augment=True)
        repeats = max(a.repeats, 1)

        def median_epoch_s(run_epoch) -> float:
            dts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                run_epoch()
                dts.append(time.perf_counter() - t0)
            return statistics.median(dts)

        # The host stage, sequential (the real run's host_augment spans
        # land in phase_ms instead).
        loader.set_epoch(0)
        for _ in loader:  # warm the allocator and the augment library
            pass

        def host_epoch():
            for k in range(len(loader)):
                loader.materialize(k)

        host_ms = median_epoch_s(host_epoch) / steps * 1e3

        # The H2D copy alone, blocking: the tracer's h2d span is only the
        # enqueue.
        host_batches = [loader.materialize(k) for k in range(len(loader))]
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None

        def h2d_epoch():
            for hb in host_batches:
                to_device(hb, device, stream=stream).wait()
                self.sync()

        h2d_epoch()  # the pinned pool's first allocations
        h2d_ms = median_epoch_s(h2d_epoch) / steps * 1e3
        dev_batch = to_device(host_batches[0], device, stream=stream).wait()
        del host_batches

        # The device step alone, on a copy of the model: the streaming
        # Trainer below starts from the untouched weights.
        step_model = copy.deepcopy(model)
        state = init_train_state(step_model)
        step_fn = make_train_step(step_model, SGDConfig(), SCHEDULE, False,
                                  compute_dtype=dtype)
        _, dropout = self._generators()
        for _ in range(max(a.warmup, 1)):
            loss = step_fn(state, [dev_batch], None, dropout)
        self.steps_run[key] += max(a.warmup, 1)
        float(loss)

        def step_epoch():
            for _ in range(steps):
                loss = step_fn(state, [dev_batch], None, dropout)
            self.sync()
            float(loss)
            self.steps_run[key] += steps

        step_ms = median_epoch_s(step_epoch) / steps * 1e3
        del state, step_fn, step_model, dev_batch

        pstats = PrefetchStats()
        # Warm-up, timed and profile epochs, ~6 spans a step: phase_ms
        # covers the whole timed window.
        tracer = SpanTracer(ring=max(4096, steps * (repeats + 4) * 8))
        set_tracer(tracer)
        try:
            trainer = Trainer(
                model, loader, device=device, lr_schedule=SCHEDULE,
                sgd_config=SGDConfig(), save_every=10 ** 9,
                snapshot_path=None, compute_dtype=dtype, resident=False,
                prefetch_depth=a.prefetch_depth,
                prefetch_workers=a.prefetch_workers, prefetch_stats=pstats)
            with contextlib.redirect_stdout(io.StringIO()):
                trainer.train(2)
                trainer.prefetch_stats = pstats = PrefetchStats()
                t_window = tracer.now()  # spans before this are warm-up
                dts = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    trainer.train(1)  # train() starts at epoch 0 again
                    self.sync()
                    dts.append(time.perf_counter() - t0)
                phase_ms = phase_medians(tracer.spans_since(t_window))
                if a.profile_dir:
                    self.profiled(lambda: trainer.train(1),
                                  "trace_stream_attr.json")
        finally:
            set_tracer(None)
        self.steps_run[key] += (2 + repeats + bool(a.profile_dir)) * steps
        wall_ms = statistics.median(dts) / steps * 1e3
        attr = attribute_streaming(host_ms, h2d_ms, step_ms, wall_ms)
        return {
            "metric": f"{a.model} streaming overlap attribution (batch "
                      f"{a.batch_size}/chip, "
                      f"{'bf16' if a.bf16 else 'fp32'}, 1 chip(s), "
                      f"depth {a.prefetch_depth}, workers "
                      f"{a.prefetch_workers}, {steps}-step epochs)",
            "value": attr["overlap_efficiency"],
            "unit": "pipeline overlap efficiency (slowest isolated stage / "
                    "streaming wall, per step; phase_ms = tracer spans of "
                    "the timed run)",
            "vs_baseline": 1.0,
            "attribution_ms_per_step": attr,
            "phase_ms": {k: round(v, 3) for k, v in sorted(phase_ms.items())},
            "prefetch": {"depth": a.prefetch_depth,
                         "workers": a.prefetch_workers,
                         **pstats.per_step_ms()},
            "window_epoch_s": [round(d, 3) for d in dts],
            "device": self.card, "power_limit_w": self.power_limit_w,
        }

    def pipeline_record(self) -> Dict:
        """The host input pipeline alone (``bench.py --pipeline``): epochs
        of ``TrainLoader`` materialise+augment at the training batch, no
        device in the loop; a warm epoch, then the best of ``--repeats``."""
        a = self.args
        n_chips = a.num_devices or 1
        train_ds, _ = synthetic(n_train=a.batch_size * n_chips * 16)
        loader = TrainLoader(train_ds, a.batch_size, n_chips, augment=True)
        for _ in loader:
            pass
        dt = float("inf")
        for _ in range(max(a.repeats, 1)):
            loader.set_epoch(1)
            t0 = time.perf_counter()
            n = 0
            for b in loader:
                n += len(b["label"])
            dt = min(dt, time.perf_counter() - t0)
        return {
            "metric": f"host input pipeline samples/sec (materialise+augment, "
                      f"batch {a.batch_size}, no device)",
            "value": round(n / dt, 2),
            "unit": "samples/sec",
            "vs_baseline": 1.0,
            "device": self.card, "power_limit_w": self.power_limit_w,
        }


def run_child(child: List[str], env: Dict[str, str], label: str,
              bench: Optional["_Bench"] = None) -> Dict:
    """Run a bench subprocess and return its first JSON line with a
    ``value``: the child contract of the sweep modes (``bench.py:795``).  A
    failed child, or one that printed no record, raises ``SystemExit``
    naming it; nothing falls back to a partial record.  With ``bench``, the
    child's ``--result_json`` summary (rank 0's, for a child of several
    ranks) adds its train steps, eval-form calls and launches to
    ``bench``'s, so the parent's summary accounts for its children's."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "child.json")
        if bench is not None:
            child = list(child) + ["--result_json", path]
        out = subprocess.run(child, env=env, capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-2000:])
            raise SystemExit(f"{label} failed rc={out.returncode}")
        if bench is not None:
            with open(path) as f:
                bench.add_child(json.load(f))
    for line in out.stdout.strip().splitlines():
        try:
            cand = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(cand, dict) and "value" in cand:
            return cand
    sys.stderr.write(out.stdout[-2000:])
    raise SystemExit(f"{label}: no bench-record JSON line on stdout")


BENCH = [sys.executable, "-m", "ddp_tpu_torch.bench"]


def batch_sweep_record(bench: _Bench) -> Dict:
    """The MFU-against-batch curve (``bench.py --batch_sweep``): one child a
    (batch, flavour) cell, each a fresh process; the headline is the best
    cell's MFU (its samples/s a chip where a cell has none)."""
    a = bench.args
    batches = [int(x) for x in a.batch_sweep.split(",")]
    flavors = [f.strip() for f in a.batch_sweep_flavors.split(",")
               if f.strip()]
    table: Dict[str, Dict] = {}
    for b in batches:
        table[str(b)] = {}
        for flavor in flavors:
            child = BENCH + ["--model", a.model, "--batch_size", str(b),
                             "--steps", str(a.steps),
                             "--warmup", str(a.warmup),
                             "--repeats", str(a.repeats),
                             "--no_bf16", "--primary_only",
                             "--device", a.device]
            child += ["--bf16"] if flavor.startswith("bf16") else []
            child += ["--shard_update"] if a.shard_update else []
            if a.num_devices:
                child += ["--num_devices", str(a.num_devices)]
            rec = run_child(child, dict(os.environ),
                            f"batch-sweep cell batch={b} {flavor}", bench)
            cell = {"samples_per_sec_per_chip": rec["value"],
                    "median_ms_per_step": rec["median_ms_per_step"],
                    "best_window_ms_per_step":
                        rec["best_window_ms_per_step"],
                    "window_spread_pct": rec["window_spread_pct"]}
            if rec.get("mfu") is not None:
                cell["mfu"] = rec["mfu"]
            table[str(b)][flavor] = cell
    cells = [(b, f, c) for b, fl in table.items() for f, c in fl.items()]
    has_mfu = all("mfu" in c for _, _, c in cells)
    peak = max(cells, key=lambda x: x[2].get(
        "mfu", x[2]["samples_per_sec_per_chip"]))
    return {
        "metric": f"{a.model} MFU-vs-batch sweep (per-chip batches "
                  f"{batches}, flavors {flavors}"
                  f"{', zero-sharded update' if a.shard_update else ''})",
        "value": (peak[2]["mfu"] if has_mfu
                  else peak[2]["samples_per_sec_per_chip"]),
        "unit": (f"peak mfu over sweep (at batch {peak[0]}, {peak[1]})"
                 if has_mfu else
                 f"peak samples/sec/chip over sweep (at batch {peak[0]}, "
                 f"{peak[1]}; no peak for this device kind)"),
        "vs_baseline": 1.0,
        "batch_sweep": table,
        "device": dict(bench.card, count=a.num_devices or 1),
        "power_limit_w": bench.power_limit_w,
    }


def check_card_count(n: int, device: torch.device) -> None:
    """Refuse more ranks than visible cards: NCCL runs one rank a card."""
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--num_devices {n} asks for more ranks than the "
                         f"{torch.cuda.device_count()} visible card(s); NCCL "
                         f"runs one rank a card")


def resolve_sweep_platform(args: argparse.Namespace,
                           device: torch.device) -> str:
    """The sweep's platform is the bench's device: ``cpu`` with ``--device
    cpu``, ``real`` (one rank a card) otherwise.  An explicit
    ``--sweep_platform`` that contradicts ``--device`` is refused, so a
    sweep never leaves the card for the CPU unasked."""
    platform = "cpu" if device.type == "cpu" else "real"
    if args.sweep_platform not in (None, platform):
        raise SystemExit(f"--sweep_platform {args.sweep_platform} "
                         f"contradicts --device {device.type}: the sweep's "
                         f"children run on the bench's device (cpu needs "
                         f"--device cpu)")
    return platform


def sweep_counts(args: argparse.Namespace) -> List[int]:
    return sorted(int(x) for x in args.sweep.split(","))


def sweep_record(bench: _Bench) -> Dict:
    """The scaling harness (``bench.py --sweep``): one child a device count
    n, ``--num_devices n --no_bf16 --primary_only`` on the bench's device:
    gloo ranks on the CPU (``--sweep_platform cpu``) or one rank a card
    (``real``); the headline is the per-chip efficiency of the largest n
    against the smallest."""
    a = bench.args
    counts = sweep_counts(a)
    per_n: Dict[int, float] = {}
    for n in counts:
        child = BENCH + ["--model", a.model, "--batch_size", str(a.batch_size),
                         "--steps", str(a.steps), "--warmup", str(a.warmup),
                         "--repeats", str(a.repeats), "--num_devices", str(n),
                         "--no_bf16", "--primary_only",
                         "--device", a.device]
        child += ["--bf16"] if a.bf16 else []
        # Composed strategies ride through to the children.
        child += ["--shard_update"] if a.shard_update else []
        if a.e2e or a.resident:
            child += ["--e2e", "--e2e_steps", str(a.e2e_steps)]
            child += ["--resident"] if a.resident else []
        per_n[n] = run_child(child, dict(os.environ),
                             f"sweep child n={n}", bench)["value"]
    eff = per_n[counts[-1]] / per_n[counts[0]] if per_n[counts[0]] else 0.0
    mode = ("zero-sharded update, " if a.shard_update else "") + \
           ("HBM-resident e2e, " if a.resident
            else "host-fed e2e, " if a.e2e else "")
    return {
        "metric": f"{a.model} DP scaling sweep "
                  f"({a.sweep_platform} mesh, {mode}batch "
                  f"{a.batch_size}/chip, devices {counts})",
        "value": round(eff, 4),
        "unit": f"per-chip efficiency at {counts[-1]} vs {counts[0]} devices",
        "vs_baseline": 1.0,
        "samples_per_sec_per_chip": {str(n): per_n[n] for n in counts},
        "device": dict(bench.card, count=counts[-1]),
        "power_limit_w": bench.power_limit_w,
    }


def run_chaos(args: argparse.Namespace) -> None:
    """The chaos campaign as a bench mode (``bench.py:498``): ``python -m
    ddp_tpu_torch.chaos_campaign`` in a subprocess (its drills spawn their
    own supervised children), on the bench's device; its exit code, when
    not 0, is this one's."""
    cmd = [sys.executable, "-m", "ddp_tpu_torch.chaos_campaign",
           "--out", args.chaos_out, "--device", args.device]
    if args.chaos_drills:
        cmd += ["--drills", args.chaos_drills]
    rc = subprocess.call(cmd)
    if rc != 0:
        raise SystemExit(rc)


def spawn_ranks(argv: List[str], n: int, device: torch.device,
                result_json: Optional[str]) -> Dict:
    """Run this bench as ``n`` ranks (``parallel/dist.py::launch_local``):
    rank 0 prints the record line and writes the summary, which is
    returned.  A failed rank fails the run."""
    check_card_count(n, device)
    with tempfile.TemporaryDirectory() as tmp:
        path = result_json or os.path.join(tmp, "bench.json")
        rc = dist.launch_local(BENCH + list(argv) + ["--result_json", path],
                               n)
        if rc != 0:
            raise SystemExit(f"bench rank of --num_devices {n} failed "
                             f"rc={rc}")
        with open(path) as f:
            return json.load(f)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the bench; returns ``{"records", "steps", "eval_calls",
    "launches"}`` (the first record is the one printed on stdout; ``--chaos``
    prints none and returns no records)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    check_args(args)
    device = resolve_device(args.device)
    if args.chaos:
        run_chaos(args)
        return {"records": []}
    if args.sweep:
        args.sweep_platform = resolve_sweep_platform(args, device)
        check_card_count(sweep_counts(args)[-1], device)
    n = args.num_devices or 1
    spawner = n > 1 and not (args.sweep or args.batch_sweep or args.pipeline)
    if spawner and not dist.in_rendezvous():
        return spawn_ranks(argv, n, device, args.result_json)
    rank = dist.in_rendezvous()
    if rank:
        device = dist.initialize(device)
        if dist.world_size() != n:
            raise SystemExit(f"--num_devices {n} contradicts this run's "
                             f"world of {dist.world_size()}")
    try:
        summary = _run(args, device)
    finally:
        if rank:
            dist.shutdown()
    return summary


def _run(args: argparse.Namespace, device: torch.device) -> Dict:
    set_tf32(False)
    bench = _Bench(args, device)
    launches0 = (gather_batch.launches, gather_batch.launches_bf16)
    if args.guard_overhead:
        records = [bench.guard_overhead_record()]
    elif args.inspect_overhead:
        records = [bench.inspect_overhead_record()]
    elif args.serve:
        records = [bench.generate_record() if args.generate
                   else bench.serve_record()]
    elif args.batch_sweep:
        records = [batch_sweep_record(bench)]
    elif args.sweep:
        records = [sweep_record(bench)]
    elif args.pipeline:
        records = [bench.pipeline_record()]
    elif args.stream_attr:
        records = [bench.stream_attr_record()]
    elif args.e2e:
        records = [bench.e2e_record()]
    else:
        records = bench.step_records(args.bf16, not args.primary_only,
                                     profile=bool(args.profile_dir))
        if not args.bf16 and not args.no_bf16 and device.type == "cuda":
            records += bench.step_records(True, False)
    summary = {"records": records, "steps": bench.steps_run,
               "eval_calls": bench.eval_calls,
               "launches": {
                   "gather_batch": gather_batch.launches - launches0[0]
                   + bench.child_launches["gather_batch"],
                   "gather_batch_bf16": gather_batch.launches_bf16
                   - launches0[1] + bench.child_launches["gather_batch_bf16"]}}
    if bench.rank == 0:
        print(json.dumps(records[0]), flush=True)
        for rec in records[1:]:
            print(json.dumps(rec), file=sys.stderr, flush=True)
        if args.result_json:
            with open(args.result_json, "w") as f:
                json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
