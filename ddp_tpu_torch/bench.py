"""Training throughput of the port (counterpart of ``bench.py``'s default
and ``--e2e`` modes):

    python -m ddp_tpu_torch.bench [--model vgg|deepnn|resnet18] \\
        [--batch_size 512] [--bf16 | --no_bf16] [--primary_only] \\
        [--steps 50] [--warmup 10] [--repeats 5] [--shard_update] \\
        [--device cuda|cpu] [--result_json PATH]
    python -m ddp_tpu_torch.bench --e2e [--resident] [--e2e_steps 16] \\
        [--prefetch_depth 2] [--prefetch_workers 4] [...]
    python -m ddp_tpu_torch.bench --inspect_overhead [--steps 50] [...]

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

``--result_json`` writes the records, the train steps that ran in each
dtype and the kernels' launch counts of the process.  The bench runs on
``cuda`` unless ``--device cpu`` is given; the flags of ``bench.py``'s
other modes are refused by name, each with the ROADMAP item that ports
it.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import ResidentData, TrainLoader, synthetic
from .data.device_augment import make_draws
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
from .train.epoch import make_train_epoch, make_train_step
from .train.step import init_train_state, to_device
from .train.trainer import Trainer, draw_seed, dropout_seed
from .train.zero import list_to_opt_shard

# bench.py's flags that this entry point does not take yet, with the
# ROADMAP item that ports each.
REFUSED = {
    "--sweep": "A13b", "--batch_sweep": "A13b", "--stream_attr": "A13b",
    "--pipeline": "A13b", "--calibrate_cost": "A13b", "--serve": "A13b",
    "--tp_sweep": "A10/A11", "--pp_sweep": "A10/A11",
    "--mesh_shape": "A10/A11", "--auto_plan": "A10/A11",
    "--autoplan_bench": "A10/A11", "--generate": "A12",
    "--ckpt_bench": "A7", "--chaos": "A7", "--guard_overhead": "A7",
    "--mem_ledger": "A13b",
    "--dump_hlo": "none: an eager program has no compiled program to dump",
}

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
                   help="Only 1: the sweep over devices is ROADMAP A13b")
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
                        "record's; with --e2e one epoch after the timed "
                        "ones) under torch.profiler and export its Chrome "
                        "trace into this directory")
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
    if args.dispatch == "scan":
        raise SystemExit("--dispatch scan has no eager counterpart (none: "
                         "the resident-epoch record is the nearest)")
    if args.num_devices is not None and args.num_devices > 1:
        raise SystemExit(f"--num_devices {args.num_devices}: more than one "
                         f"device is the sweep harness (ROADMAP A13b)")


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
        self.card = {"name": self.kind, "count": 1}
        self.power_limit_w = power_limit_w(device)
        self.steps_run = {"float32": 0, "bfloat16": 0}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mfu_fields(self, sps_chip: float, bf16: bool) -> Dict:
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
                      f"{'bf16' if bf16 else 'fp32'}, 1 chip(s), "
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
        ds, _ = synthetic(n_train=a.batch_size, n_test=1)
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        micros = [to_device({"image": ds.images,
                             "label": ds.labels.astype(np.int64)},
                            device, stream=stream).wait()]

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

        table, _ = synthetic(n_train=a.batch_size * a.steps, n_test=1)
        resident = ResidentData(table, device)
        loader = TrainLoader(table, a.batch_size, 1, augment=False)
        full, _ = loader.rank_index_matrix(0)
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
        n_train = a.batch_size * a.e2e_steps
        train_ds, _ = synthetic(n_train=n_train, n_test=1)
        loader = TrainLoader(train_ds, a.batch_size, 1,
                             augment=not a.resident)
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
        sps_chip = n_train * 3 / dt
        feed = ("HBM-resident data" if a.resident
                else f"host-fed, prefetch depth {a.prefetch_depth}")
        rec = {
            "metric": f"{a.model} e2e train samples/sec/chip "
                      f"(batch {a.batch_size}/chip, "
                      f"{'bf16' if a.bf16 else 'fp32'}, 1 chip(s), {feed}, "
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
        ds, _ = synthetic(n_train=a.batch_size, n_test=1)
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        micros = [to_device({"image": ds.images,
                             "label": ds.labels.astype(np.int64)},
                            device, stream=stream).wait()]
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


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the bench; returns ``{"records", "steps", "launches"}`` (the
    first record is the one printed on stdout)."""
    args = build_parser().parse_args(argv)
    check_args(args)
    device = resolve_device(args.device)
    set_tf32(False)
    bench = _Bench(args, device)
    launches0 = (gather_batch.launches, gather_batch.launches_bf16)
    if args.inspect_overhead:
        records = [bench.inspect_overhead_record()]
    elif args.e2e:
        records = [bench.e2e_record()]
    else:
        records = bench.step_records(args.bf16, not args.primary_only,
                                     profile=bool(args.profile_dir))
        if not args.bf16 and not args.no_bf16 and device.type == "cuda":
            records += bench.step_records(True, False)
    print(json.dumps(records[0]), flush=True)
    for rec in records[1:]:
        print(json.dumps(rec), file=sys.stderr, flush=True)
    summary = {"records": records, "steps": bench.steps_run,
               "launches": {
                   "gather_batch": gather_batch.launches - launches0[0],
                   "gather_batch_bf16":
                       gather_batch.launches_bf16 - launches0[1]}}
    if args.result_json:
        with open(args.result_json, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
