"""One rank of ``tests/test_torch_pp.py``'s pipeline checks.

    python tests/torch_pp_worker.py SPEC OUT_DIR

runs as one rank of a gloo process group (launched by
``ddp_tpu_torch.parallel.dist.launch_local``), on the CPU with one thread,
and writes ``OUT_DIR/rank{r}.pt``: each task of the spec's ``tasks`` list by
its ``name``.  One task kind, ``pp``: DeepNN pipeline steps at ``mesh``
``(D, M, S)`` under ``schedule`` from a whole ``state_dict``, on given
stacked ``[A, global batch, ...]`` groups (each rank feeds its data
slice, images to stage 0 and labels to the others, as
``parallel/pp/schedule.py::pp_feed`` does), dropout at ``dropout`` with
``masks[step][micro][data index]`` passed in as the keep masks when given;
rank 0 returns the losses and the whole end state, gathered as a save
gathers it, and every rank its collective counts, its handoff bytes, its
stage's peak in-flight graphs and the measured bubble.
"""
import functools
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ddp_tpu_torch.models import get_model  # noqa: E402
from ddp_tpu_torch.ops import layers as tlayers  # noqa: E402
from ddp_tpu_torch.optim import SGDConfig, triangular_lr  # noqa: E402
from ddp_tpu_torch.parallel import dist  # noqa: E402
from ddp_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from ddp_tpu_torch.parallel.pp import schedule as pp  # noqa: E402
from ddp_tpu_torch.parallel.pp.partition import plan_stages  # noqa: E402
from ddp_tpu_torch.parallel.tp.plan import (plan_for_model,  # noqa: E402
                                            shard_module_, wiring)
from ddp_tpu_torch.train.step import (init_train_state,  # noqa: E402
                                      make_group_update)
from ddp_tpu_torch.train.trainer import tp_full_state  # noqa: E402

SCHED = functools.partial(triangular_lr, base_lr=0.1, num_epochs=2,
                          steps_per_epoch=4)


def run_pp(t):
    mesh = Mesh(t["mesh"], dist.rank())
    dist.init_mesh(mesh)
    dist.collective_calls.clear()
    dist.handoff_stats.clear()
    model = get_model("deepnn")
    model.load_state_dict(t["state_dict"])
    model.classifier[2].rate = t["dropout"]
    d, m, s = t["mesh"]
    j, stage = mesh.data_index, mesh.stage_index
    plan = plan_for_model("deepnn", model, model_size=m)
    tp = wiring(plan, dist.model_group())
    if tp is not None:
        shard_module_(model, plan, mesh.model_index)
    stages = plan_stages("deepnn", s, model_size=m,
                         model=get_model("deepnn", device="meta"))
    pp.stage_module_(model, stages, stage)
    state = init_train_state(model)
    step_fn = pp.PPStep(model, stages, stage,
                        make_group_update(SGDConfig(lr=0.1), SCHED),
                        device=torch.device("cpu"), tp=tp,
                        schedule=t["schedule"])
    real_keep_mask = tlayers.keep_mask
    masks = t.get("masks")
    if masks is not None:
        queue = [masks[a][k][j] for a in range(len(masks))
                 for k in range(len(masks[a]))]

        def from_queue(shape, keep, generator, device):
            mask = queue.pop(0)
            assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
            return mask.to(device)

        tlayers.keep_mask = from_queue
    gen = torch.Generator().manual_seed(0)
    losses = []
    try:
        for batch in t["batches"]:
            images, labels = batch["image"], batch["label"]
            b = images.shape[1] // d
            micros = []
            for a in range(images.shape[0]):
                micro = {"label": labels[a, j * b:(j + 1) * b]}
                if stage == 0:
                    micro["image"] = images[a, j * b:(j + 1) * b]
                micros.append(micro)
            loss = step_fn(state, micros, None, lambda step, micro=0: gen)
            if stage == s - 1:
                dist.all_reduce_sum_(loss)
            losses.append(float(dist.pipe_broadcast_(loss.clone()
                                                     .reshape(1),
                                                     s - 1)[0]))
    finally:
        tlayers.keep_mask = real_keep_mask
    counts = dict(dist.collective_calls)
    sd, mom = tp_full_state(model, state.momentum,
                            plan if tp is not None else None)
    whole = pp.gather_whole_state(sd, mom, "deepnn", stages)
    out = {"losses": losses, "collectives": counts,
           "handoff": dict(dist.handoff_stats), "stage": stage,
           "bubble": step_fn.bubble, "peak_inflight": step_fn.peak_inflight,
           "local_keys": sorted(model.state_dict()),
           "masks_left": None if masks is None else len(queue)}
    if whole is not None:
        out["state_dict"], out["momentum"] = whole
    dist.clear_mesh()
    return out


def main(spec_path, out_dir):
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    dist.initialize(torch.device("cpu"))
    try:
        out = {t["name"]: run_pp(t) for t in spec["tasks"]}
        torch.save(out, os.path.join(out_dir, f"rank{dist.rank()}.pt"))
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
