"""Where a resident training step's device time goes, at a model's full
width (VGG-11 unless ``--model`` says otherwise):

    python -m ddp_tpu_torch.profile_resident [--steps 10] [--warmup 5] \
        [--data_parallel] [--bf16] [--model vgg|deepnn|resnet18]

Runs resident train steps of the port (batch 512 from a 50,000-image
synthetic table on the card, crop/flip on), the measured window under
``torch.profiler``.  With ``--data_parallel`` the steps run as rank 0 of a
world-1 NCCL process group, as ``multigpu`` runs them on a one-card
machine: each step adds its gradient and buffer all-reduces.  With
``--bf16`` the steps compute in bfloat16, as ``--bf16`` trains.  Prints the window's wall time per step, the device's
busy and idle share (the kernels' summed time against the wall time), the
CUDA kernels launched per step, the device time by kernel group and the top
kernels, and one JSON summary line last.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

from .data import TrainLoader, synthetic
from .device import dtype_name, resolve_device, set_tf32
from .models import NAMES as MODEL_NAMES, get_model
from .optim import SGDConfig, triangular_lr
from .parallel import dist
from .train.trainer import Trainer

# Kernel name fragments -> group, first match wins.  cuDNN runs VGG's
# convolutions as implicit GEMM, Winograd, FFT (complex cf32 GEMMs between
# fft2d transforms) or plain GEMM kernels, and in bfloat16 as CUTLASS or
# cuBLAS (``nvjet``) kernels; the true matrix products (the 512x10
# classifiers, DeepNN's 2048x512 linear) are small beside them, so every
# GEMM counts as convolution.  DeepNN's dropout draws its masks with ``distribution``
# kernels.  Dtype casts (``--bf16``'s weight casts) and copies are
# PyTorch's ``direct_copy`` kernels.
GROUPS = (("nccl", "collectives (NCCL)"),
          ("gather_batch", "resident batch (port kernel)"),
          ("row_gather", "row gather (port kernel)"),
          ("conv", "convolution"), ("xmma", "convolution"),
          ("implicit", "convolution"), ("winograd", "convolution"),
          ("cudnn", "convolution"), ("fft", "convolution"),
          ("gemm", "convolution"), ("cutlass", "convolution"),
          ("nvjet", "convolution"), ("max_pool", "max pool"),
          ("direct_copy", "casts and copies"),
          ("distribution", "dropout masks (DeepNN)"),
          ("reduce", "reduction (BN stats, sums)"),
          ("index", "indexing (crop/flip, labels)"),
          ("gather", "indexing (crop/flip, labels)"),
          ("elementwise", "elementwise (BN, ReLU, SGD)"),
          ("vectorized", "elementwise (BN, ReLU, SGD)"))


def device_events(prof) -> dict:
    """``{name: (device ms, count)}`` of the device-side events of a
    ``torch.profiler`` profile: the kernels, and the copies and fills
    (named ``Memcpy ...`` and ``Memset ...``).  A scheduled profile's step
    ranges (``ProfilerStep*`` in ``key_averages``), which the device
    timeline also carries as annotations spanning the step's kernels, are
    not device work."""
    out = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.key.startswith("ProfilerStep"):
            ms, count = out.get(ev.key, (0.0, 0))
            out[ev.key] = (ms + dev / 1e3, count + ev.count)
    return out


def kernel_launches(events: dict) -> int:
    """The kernel launches among :func:`device_events`' entries."""
    return sum(n for name, (_, n) in events.items()
               if not name.startswith(("Memcpy", "Memset")))


def _group(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--data_parallel", action="store_true",
                   help="run as rank 0 of a world-1 NCCL process group")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, as the trainer's --bf16")
    p.add_argument("--model", default="vgg", choices=list(MODEL_NAMES),
                   help="the model to step (default vgg)")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    # A world-1 rendezvous of this process's own, unless it is a rank
    # already; taken out of the environment again at the end.
    own = {} if not args.data_parallel or dist.in_rendezvous() else {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(dist.free_port()),
        "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    os.environ.update(own)
    try:
        if args.data_parallel:
            device = dist.initialize(device)
        return _profile(args, device)
    finally:
        dist.shutdown()
        for k in own:
            del os.environ[k]


def _profile(args: argparse.Namespace, device: torch.device) -> dict:
    set_tf32(False)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    train_ds, _ = synthetic(n_train=50000, n_test=64)
    loader = TrainLoader(train_ds, 512, seed=0)
    model = get_model(args.model, device=device,
                      generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, loader, device=device,
                      lr_schedule=lambda s: triangular_lr(
                          s, num_epochs=1, steps_per_epoch=len(loader)),
                      sgd_config=SGDConfig(),
                      compute_dtype=compute_dtype)
    full, _ = loader.epoch_index_matrix()
    rows = torch.from_numpy(full).to(device)
    res = trainer.resident

    def run(a: int, b: int) -> None:
        trainer.train_epoch(trainer.state, res.images, res.labels, rows[a:b],
                            trainer.draws, None, trainer.dropout)

    w = args.warmup
    # The warm-up steps run in the profiler's own warm-up phase, traced and
    # dropped: a session can miss the device work at its start (ROADMAP C3),
    # and the measured window then starts after it.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run(0, w)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run(w, w + args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    launches = kernel_launches(kernels)
    # One gather_batch launch a step: fewer means the profiler missed the
    # start of the session.
    gather_launches = sum(n for name, (_, n) in kernels.items()
                          if "gather_batch_kernel" in name)
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    card = torch.cuda.get_device_name(0)
    print(f"{card}: {args.model}, {dtype_name(compute_dtype)}, "
          f"{args.steps} steps, wall "
          f"{wall_ms / args.steps:.3f} ms/step, device busy {busy_ms / args.steps:.3f} ms/step "
          f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}, "
          f"{launches / args.steps:g} CUDA kernels launched per step, "
          f"gather_batch_kernel {gather_launches} times in {args.steps} "
          f"steps")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:32s} {ms / args.steps:9.3f} ms/step "
              f"{ms / busy_ms:6.1%}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"  {ms / args.steps:9.3f} ms/step  x{n // args.steps:<4d} "
              f"{name[:100]}")
    summary = {"device": card, "model": args.model, "steps": args.steps,
               "backend": dist.backend(),
               "compute_dtype": dtype_name(compute_dtype),
               "wall_ms_per_step": wall_ms / args.steps,
               "busy_ms_per_step": busy_ms / args.steps,
               "idle_share": 1 - busy_ms / wall_ms,
               "kernels_per_step": launches / args.steps,
               "gather_batch_kernel_launches": gather_launches,
               "groups_ms_per_step": {g: ms / args.steps
                                      for g, ms in groups.items()}}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
