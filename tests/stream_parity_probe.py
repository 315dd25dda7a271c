"""Where the streamed epoch's float32 runs part from each other, and why.

    python tests/stream_parity_probe.py [--cpu] [--card_runs 4]
        [--configs world1,world1_small,drill,drill_seed4] [--lrs 0.02,0.05]

The referee is the float64 epoch of ``tests/torch_float64.py`` over the
same host batches (the loader's, host-cropped).  For each configuration and
learning rate the probe prints:

- each float32 run's largest distance from the float64 epoch in weights
  and BN buffers, in momentum and in losses: the CPU once, then (without
  ``--cpu``) the card ``--card_runs`` times at prefetch depths 2 and 0;
  for the card's world-1 runs also whether every batch its steps consumed
  equals the host's, and each run's distance from the CPU's and from the
  first card run's weights;
- the float64 trajectory's margins at each step: the smallest |BN output|
  at a ReLU (the kink) and the smallest nonzero gap between the two
  largest inputs of a 2x2 max-pool window.  A decision whose margin is
  within float32 rounding (about 1e-7 here) can go either way between two
  float32 runs, and the run that takes the other side moves one element's
  gradient whole.

Configurations: ``world1``, the narrow VGG on 600 images in batches of 64
(10 steps), one process, as ``tests/test_torch_cuda.py``'s float64-referee
case; ``world1_small``, 64 images in batches of 16 (4 steps), seed 1, as
its card-against-CPU case; ``drill``, a streamed world-2 drill of 40
images, batches of 8 a rank (3 steps), two gloo ranks (on the card, both on
it), at drill seed 0, and ``drill_seed4``, the smoke's, at seed 4.  Takes
about three minutes on the card.
"""
import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.dirname(os.path.abspath(__file__))]

from ddp_tpu_torch.data import TrainLoader, synthetic  # noqa: E402
from ddp_tpu_torch.device import set_tf32  # noqa: E402
from ddp_tpu_torch.models.vgg import VGG  # noqa: E402
from ddp_tpu_torch.optim import SGDConfig, triangular_lr  # noqa: E402
from ddp_tpu_torch.parallel import drill  # noqa: E402
from ddp_tpu_torch.train.trainer import Trainer  # noqa: E402
from torch_float64 import NARROW, float64_trajectory  # noqa: E402

# seed: the loader's, the drill's and the trainer's; model: the start
# weights' generator seed.
CONFIGS = {"world1": dict(n=600, n_test=100, batch=64, world=1, seed=0,
                          model=0),
           "world1_small": dict(n=64, n_test=100, batch=16, world=1,
                                seed=1, model=1),
           "drill": dict(n=40, n_test=24, batch=8, world=2, seed=0, model=0),
           "drill_seed4": dict(n=40, n_test=24, batch=8, world=2, seed=4,
                               model=0)}


def _data(cfg):
    train, test = synthetic(n_train=cfg["n"], n_test=cfg["n_test"], seed=1)
    per = []
    for r in range(cfg["world"]):
        loader = TrainLoader(train, cfg["batch"], cfg["world"],
                             seed=cfg["seed"], augment=True,
                             local_replicas=[r])
        loader.set_epoch(0)
        per.append(list(loader))
    return train, test, per


def _far(losses, state, momentum, ref):
    flosses, fstate, fmom = ref
    w = max(float((state[k].cpu().double() - v).abs().max())
            for k, v in fstate.items()
            if not k.endswith("num_batches_tracked"))
    m = max(float((a.cpu().double() - b).abs().max())
            for a, b in zip(momentum, fmom))
    return (f"weights {w:.3e}, momentum {m:.3e}, losses "
            f"{float(np.abs(np.asarray(losses) - flosses).max()):.3e}")


def _world1_run(device, start, train, cfg, lr, depth):
    model = VGG(NARROW)
    model.load_state_dict(start)
    model.to(device)
    loader = TrainLoader(train, cfg["batch"], seed=cfg["seed"],
                         augment=True, local_replicas=[0])
    tr = Trainer(model, loader, device=torch.device(device),
                 lr_schedule=lambda s: triangular_lr(
                     s, base_lr=lr, num_epochs=1,
                     steps_per_epoch=len(loader)),
                 sgd_config=SGDConfig(lr=lr), seed=cfg["seed"],
                 snapshot_path=None, resident=False, prefetch_depth=depth)
    seen = []
    step = tr.train_step

    def keep(state, micros, draws):
        # A copy on the compute stream: what the step reads, as it reads it.
        seen.append({k: v.clone() for k, v in micros[0].items()})
        return step(state, micros, draws)

    tr.train_step = keep
    tr.train(1)
    loader.set_epoch(0)
    bad = [k for k, (g, w) in enumerate(zip(seen, loader))
           if not all(np.array_equal(g[key].cpu().numpy(), w[key])
                      for key in ("image", "label"))]
    return tr.loss_history, model.state_dict(), tr.state.momentum, bad


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="the CPU run and the margins only")
    p.add_argument("--card_runs", type=int, default=4)
    p.add_argument("--configs", default=",".join(CONFIGS))
    p.add_argument("--lrs", default="0.02,0.05")
    args = p.parse_args()
    set_tf32(False)
    devices = ["cpu"] + ([] if args.cpu else ["cuda"] * args.card_runs)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    for name in args.configs.split(","):
        cfg = CONFIGS[name]
        train, test, per = _data(cfg)
        start = VGG(NARROW, generator=torch.Generator().manual_seed(
            cfg["model"])).state_dict()
        for lr in map(float, args.lrs.split(",")):
            flosses, fstate, fmom, margins = float64_trajectory(
                start, per, lambda s: triangular_lr(  # noqa: B023
                    s, base_lr=lr, num_epochs=1,
                    steps_per_epoch=len(per[0])))
            ref = (flosses, fstate, fmom)
            print(f"{name} lr {lr}: float64 margins by step (kink, pool "
                  f"gap): " + ", ".join(f"{k}: {a:.2e} {b:.2e}"
                                        for k, (a, b) in enumerate(margins)),
                  flush=True)
            first = cpu = None
            for i, device in enumerate(devices):
                depth = 2 if i % 2 else 0
                if cfg["world"] == 1:
                    losses, sd, mom, bad = _world1_run(device, start, train,
                                                       cfg, lr, depth)
                else:
                    g = drill.run(drill.spec(
                        NARROW, start, train, test, batch=cfg["batch"], lr=lr,
                        seed=cfg["seed"], augment=True, device=device,
                        backend="gloo", streaming=True,
                        prefetch_depth=depth), 2,
                        same_device=device == "cuda", env=env,
                        timeout=300)[0]
                    losses, sd, mom, bad = (g["losses"].numpy(),
                                            g["state_dict"], g["momentum"],
                                            None)
                line = (f"  {device} depth {depth}: from float64 "
                        f"{_far(losses, sd, mom, ref)}")
                if bad is not None:
                    line += f"; consumed batches unlike the host's {bad}"
                if cpu is not None:
                    dist = lambda o: max(  # noqa: E731
                        float((sd[k].cpu().double() - v.cpu().double())
                              .abs().max())
                        for k, v in o.items())
                    line += f"; weights from the CPU's {dist(cpu):.3e}"
                    if first is not None:
                        line += (f", from the first card run's "
                                 f"{dist(first):.3e}")
                    first = first or sd
                cpu = cpu or sd
                print(line, flush=True)


if __name__ == "__main__":
    main()
