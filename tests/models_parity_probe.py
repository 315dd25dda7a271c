"""How far float32 runs of DeepNN and ResNet-18 lie from float64, and where
a decision can flip: the numbers behind the models' parity checks.

    python tests/models_parity_probe.py [--drills] [--margins]

``--drills``: the world-2 drill of ``chip_smoke.py``'s models phase
(sync-BN, ``--shard_update``, crop and flip, lr 0.05, start weights of
seed 0) at several seeds, ResNet-18 on 40 images of 8 a rank in groups of
2 at seeds 0-5 and on 64 images of 16 a rank at seed 3, DeepNN on one
image a rank at three (data seed, seed) pairs: the margins of
``parallel/drill.py::margins``, then on the card (where there is one) and
on the CPU, each rank against the drill's float64 epoch
(``tests/torch_float64.py::float64_drill``): the largest distance over
losses, weights, buffers and momentum, where, and the largest |value|
there; and the card from the CPU.
``--margins``: ``parallel/drill.py::margins`` of DeepNN's world-2 drill
(one image a rank, one step, seeds 0-2, data seeds 1-40), and of 2 images a
rank (data seeds 1-8): how near a ReLU input or max-pool tie comes to
flipping, and which pairs clear 1e-6.  Both by default.  Prints one line
a case.
"""
import argparse
import os
import sys
import threading

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ddp_tpu_torch.data import synthetic  # noqa: E402
from ddp_tpu_torch.device import set_tf32  # noqa: E402
from ddp_tpu_torch.models import get_model  # noqa: E402
from ddp_tpu_torch.parallel import drill  # noqa: E402
from torch_float64 import drill_distance, float64_drill  # noqa: E402

# (model, images, data seed, per-rank batch, --grad_accum, seed)
DRILLS = ([("resnet18", 40, 1, 8, 2, s) for s in range(6)]
          + [("resnet18", 64, 1, 16, 2, 3)]
          + [("deepnn", 2, d, 1, 1, s) for d, s in ((28, 0), (28, 2),
                                                     (1, 0))])


def _drill(cfg, devices, env):
    name, n_train, data, batch, accum, seed = cfg
    train, test = synthetic(n_train=n_train, n_test=24, seed=data)
    model = get_model(name, generator=torch.Generator().manual_seed(0))
    kink, gap = drill.margins(model, train, batch=batch, seed=seed, world=2,
                              accum=accum)
    ref = float64_drill(model.state_dict(), train, batch=batch, lr=0.05,
                        seed=seed, world=2, accum=accum, sync_bn=True,
                        model=name)
    runs = {}

    def one(device):
        runs[device] = drill.run(drill.spec(
            name, model.state_dict(), train, test, batch=batch, lr=0.05,
            seed=seed, augment=True, device=device, backend="gloo",
            grad_accum=accum, sync_bn=True, shard_update=True), 2,
            same_device=True, timeout=600, env=env)

    threads = [threading.Thread(target=one, args=(d,)) for d in devices]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    clears = "clear" if min(kink, gap) >= 1e-6 else "below"
    line = (f"drills: {name} {n_train} images, {batch} a rank, accum "
            f"{accum}, data seed {data}, seed {seed}: margins kink "
            f"{kink:.3e} gap {gap:.3e} ({clears} 1e-6)")
    for d in devices:
        far = max(drill_distance(r, ref) for r in runs[d])
        line += f"; {d} from float64 {far[0]:.3e} at {far[1]} " \
                f"(max |value| {far[2]:.3e})"
    if len(devices) == 2:
        apart = max(float((a["state_dict"][k] - v).abs().max())
                    for a, b in zip(runs["cuda"], runs["cpu"])
                    for k, v in b["state_dict"].items())
        line += f"; card from CPU (weights, buffers) {apart:.3e}"
    return line


def drills() -> None:
    set_tf32(False)
    devices = (["cuda"] if torch.cuda.is_available() else []) + ["cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    lines = {}

    def one(cfg):
        lines[cfg] = _drill(cfg, devices, env)

    for i in range(0, len(DRILLS), 3):
        threads = [threading.Thread(target=one, args=(c,))
                   for c in DRILLS[i:i + 3]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for c in DRILLS[i:i + 3]:
            print(lines[c], flush=True)


def margins() -> None:
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    clear = []
    for data in range(1, 41):
        train, _ = synthetic(n_train=2, n_test=24, seed=data)
        for seed in range(3):
            kink, gap = drill.margins(model, train, batch=1, seed=seed,
                                      world=2, accum=1)
            if min(kink, gap) >= 1e-6:
                clear.append((data, seed, kink, gap))
    print(f"margins: DeepNN, one image a rank: {len(clear)} of 120 (data "
          f"seed, seed) pairs clear 1e-6: {clear}", flush=True)
    best = 0.0
    for data in range(1, 9):
        train, _ = synthetic(n_train=4, n_test=24, seed=data)
        for seed in range(3):
            best = max(best, min(drill.margins(model, train, batch=1,
                                               seed=seed, world=2,
                                               accum=2)))
    print(f"margins: DeepNN, two images a rank: the best of 24 pairs "
          f"{best:.3e}", flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--drills", action="store_true")
    p.add_argument("--margins", action="store_true")
    args = p.parse_args()
    both = not (args.drills or args.margins)
    if args.drills or both:
        drills()
    if args.margins or both:
        margins()


if __name__ == "__main__":
    main()
