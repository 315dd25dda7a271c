"""Chip smoke test of the PyTorch port on one NVIDIA card:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions.
2. Builds every CUDA kernel of ``ddp_tpu_torch/csrc`` and prints the build
   seconds.
3. Kernel phase: the ``row_gather`` kernel against its plain PyTorch version
   at the main path's shapes, with exact equality (clamped out-of-range and
   negative indices, a float32 table, row sizes that are not a multiple of
   16 bytes), and its time beside the plain version's and
   ``torch.index_select``'s (the yardstick only; the port never calls it).
4. Parity phase: three resident steps of a narrow VGG on the card (kernel)
   against the same steps on the CPU (plain version), from the same weights
   and crop/flip draws, TF32 off.
5. Main path: the port's CLI in-process at full VGG-11 width,
   ``1 1 --batch_size 512 --resident --synthetic --synthetic_size 50000``
   (98 train steps, 25 eval steps), with the gather's launch count read
   around it.
6. Prints the kernels line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero; without a card it
exits 1 and prints no result.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ddp_tpu_torch import _build, cli
from ddp_tpu_torch.data import ResidentData, TrainLoader, synthetic
from ddp_tpu_torch.device import set_tf32
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.train.epoch import make_train_epoch
from ddp_tpu_torch.train.step import init_train_state

# H100 SXM memory rate (NVIDIA's data sheet), for the gather's bound.
HBM_BYTES_PER_S = 3.35e12
MAIN_ARGS = ["1", "1", "--batch_size", "512", "--resident", "--synthetic",
             "--synthetic_size", "50000"]
MAIN_TRAIN_STEPS, MAIN_EVAL_STEPS = 98, 25  # 50,000 / 512 and 12,500 / 512
# Parity of the card against the CPU, float32 with TF32 off: cuDNN and the
# CPU's convolutions sum in different orders, and three SGD steps carry
# those last-bit differences into the weights.  1e-4 is two orders above
# the ~1e-6 such rounding gives at these widths.
PARITY_TOL = 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, inputs, repeats: int = 60) -> float:
    """Median device time of ``fn(x)`` over ``repeats`` launches after a
    warm-up, each bracketed by CUDA events.  A sleep kernel queued ahead of
    each launch keeps the card busy while the host enqueues, so the events
    time the device work and not the host's launch gap."""
    for x in inputs[:5]:
        fn(x)
    pairs = []
    for i in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        fn(inputs[i % len(inputs)])
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_phase(gen: torch.Generator) -> dict:
    """row_gather against its plain version (exact), then timed."""
    table = torch.randint(0, 256, (50000, 32, 32, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    max_err = 0.0
    cases = [(table, n) for n in (512, 336)]
    for shape, dtype in (((8192, 32, 32, 3), torch.float32),
                         ((4096, 5, 7, 3), torch.uint8),      # 105-byte rows
                         ((4096, 3), torch.float32)):         # 12-byte rows
        t = torch.randn(shape, device="cuda", generator=gen).to(dtype) \
            if dtype.is_floating_point else torch.randint(
                0, 256, shape, dtype=dtype, device="cuda", generator=gen)
        cases.append((t, 512))
    for t, n in cases:
        m = t.shape[0]
        for idx_dtype in (torch.int32, torch.int64):
            idx = torch.randint(-20, m + 20, (n,), dtype=idx_dtype,
                                device="cuda", generator=gen)
            idx[:4] = torch.tensor([-1, m, -(2**31) + 1, 2**31 - 1],
                                   dtype=idx_dtype)
            got, want = gather_rows(t, idx), gather_rows_plain(t, idx)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"row_gather differs from its plain version at "
                  f"{tuple(t.shape)} {t.dtype}, N={n}, {idx_dtype}")
            max_err = max(max_err, float((got.double() - want.double())
                                         .abs().max()))
    # Timing at the main path's shape: a fresh in-range index row per
    # launch, as each step gathers other rows of the 150 MB table.
    n, d = 512, 32 * 32 * 3
    idxs = [torch.randperm(50000, device="cuda", generator=gen)[:n].int()
            for _ in range(60)]
    ms = median_ms(lambda i: gather_rows(table, i), idxs)
    plain_ms = median_ms(lambda i: gather_rows_plain(table, i), idxs)
    library_ms = median_ms(lambda i: torch.index_select(table, 0, i), idxs)
    ms_again = median_ms(lambda i: gather_rows(table, i), idxs)
    bound_ms = (2 * n * d + 4 * n) / HBM_BYTES_PER_S * 1e3
    print(f"row_gather N={n} D={d}: kernel {ms:.6f} ms (again "
          f"{ms_again:.6f}), plain {plain_ms:.6f} ms, index_select "
          f"{library_ms:.6f} ms, bound {bound_ms:.6f} ms", flush=True)
    return {"name": "row_gather", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/gather.cu",
            "replaces": "ddp_tpu/ops/gather.py:37",
            "max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def parity_phase() -> None:
    """Three resident steps (two full batches and a ragged tail) of a
    narrow VGG on the card against the CPU, same weights and draws."""
    arch = [8, "M", 16, "M", 512, "M"]
    ds, _ = synthetic(n_train=20, n_test=8, seed=1)
    loader = TrainLoader(ds, 8, seed=0)
    full, tail = loader.epoch_index_matrix()
    check(full.shape == (2, 8) and tail.shape == (4,), "parity batches")
    rng = np.random.default_rng(0)
    draws_np = [(rng.integers(0, 9, (2, n)), rng.random(n) < 0.5)
                for n in (8, 8, 4)]
    sched = lambda s: triangular_lr(s, base_lr=0.05, num_epochs=1,
                                    steps_per_epoch=3)
    cpu_model = VGG(arch, generator=torch.Generator().manual_seed(0))
    results = {}
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(cpu_model).to(device)
        res = ResidentData(ds, torch.device(device))
        state = init_train_state(model)
        run = make_train_epoch(model, SGDConfig(lr=0.05), sched,
                               device_augment=True)

        def draws(step, n, device=device):
            off, flip = draws_np[step]
            check(off.shape[1] == n, "parity draw size")
            off = torch.from_numpy(off).to(device)
            return off[0], off[1], torch.from_numpy(flip).to(device)

        losses = torch.cat([
            run(state, res.images, res.labels,
                torch.from_numpy(rows).to(device), draws)
            for rows in (full, tail[None])])
        results[device] = (losses.cpu(),
                           {k: v.cpu() for k, v in
                            model.state_dict().items()})
    (lg, sg), (lc, sc) = results["cuda"], results["cpu"]
    loss_err = float((lg - lc).abs().max())
    param_err = max(float((sg[k] - sc[k]).abs().max()) for k in sc)
    print(f"parity (narrow VGG, 3 resident steps, cuda vs cpu): max |loss "
          f"diff| {loss_err:.3e}, max |state diff| {param_err:.3e}, "
          f"tolerance {PARITY_TOL:g}", flush=True)
    check(bool(torch.isfinite(lg).all()), "parity losses not finite")
    check(loss_err <= PARITY_TOL and param_err <= PARITY_TOL,
          "card and CPU disagree beyond the tolerance")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    set_tf32(False)

    t0 = time.time()
    _build.build_all()
    print(f"build: {len(_build.sources())} kernel source(s) in "
          f"{time.time() - t0:.2f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    row_gather = kernel_phase(gen)
    parity_phase()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_rows.launches = 0
    out = cli.main(MAIN_ARGS)
    launches = gather_rows.launches
    losses = out["loss_history"]
    check(len(losses) == MAIN_TRAIN_STEPS,
          f"{len(losses)} train steps, expected {MAIN_TRAIN_STEPS}")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(math.isfinite(out["accuracy"]) and 0 <= out["accuracy"] <= 100,
          f"accuracy {out['accuracy']}")
    check(launches >= MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS,
          f"row_gather launched {launches} times on the main path, expected "
          f">= {MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS}")
    step_ms = statistics.median(out["step_ms"])
    print(f"main path ({card}): median {step_ms:.3f} ms/step, "
          f"{512 / step_ms * 1e3:.1f} samples/s, train "
          f"{out['training_seconds']:.2f} s, eval "
          f"{out['eval_seconds']:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"row_gather launches {launches}, first/last loss "
          f"{losses[0]:.4f}/{losses[-1]:.4f}, accuracy "
          f"{out['accuracy']:.2f}%", flush=True)

    row_gather.update(launches=launches, launches_per_epoch=launches)
    print(json.dumps({"kernels": [row_gather]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
