"""One rank of ``tests/test_torch_tp.py``'s tensor-parallel checks.

    python tests/torch_tp_worker.py SPEC OUT_DIR

runs as one rank of a gloo process group (launched by
``ddp_tpu_torch.parallel.dist.launch_local``), on the CPU with one thread,
and writes ``OUT_DIR/rank{r}.pt``: each task of the spec's ``tasks`` list by
its ``name``.  The tasks:

- ``wrappers``: the column/row linear and conv wrappers and the sharded
  dropout at mesh (1, M) against the unsharded ops on the same inputs, and
  the gradient of a parameter UPSTREAM of them (an all-reduce whose
  backward is another all-reduce would scale it by M);
- ``steps``: DeepNN train steps at ``mesh`` from a whole ``state_dict``
  on given global batches (dropout at ``dropout``; ``masks[step][data
  index]`` passed in as the keep masks when given), with
  ``shard_update``/``grad_accum``; the whole end state, gathered, and
  optionally the saves at ``save`` (``{format: path}``);
- ``resume``: a ``Trainer`` resumed from ``path`` at ``mesh``: its state
  right after the restore, gathered, then one more epoch's losses.
"""
import functools
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ddp_tpu_torch.data import TrainLoader  # noqa: E402
from ddp_tpu_torch.data.cifar10 import Dataset  # noqa: E402
from ddp_tpu_torch.models import get_model  # noqa: E402
from ddp_tpu_torch.ops import layers as tlayers  # noqa: E402
from ddp_tpu_torch.optim import SGDConfig, triangular_lr  # noqa: E402
from ddp_tpu_torch.parallel import dist, drill  # noqa: E402
from ddp_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from ddp_tpu_torch.parallel.tp import layers as tpl  # noqa: E402
from ddp_tpu_torch.parallel.tp.plan import (TPWiring,  # noqa: E402
                                            plan_for_model, shard_module_,
                                            wiring)
from ddp_tpu_torch.train.epoch import make_train_step  # noqa: E402
from ddp_tpu_torch.train.step import init_train_state  # noqa: E402
from ddp_tpu_torch.train.trainer import Trainer, tp_full_state  # noqa: E402
from ddp_tpu_torch.train.zero import (init_opt_shard,  # noqa: E402
                                      opt_shard_to_list)

SCHED = functools.partial(triangular_lr, base_lr=0.1, num_epochs=2,
                          steps_per_epoch=4)


def _mesh(shape):
    mesh = Mesh(shape, dist.rank())
    dist.init_mesh(mesh)
    dist.collective_calls.clear()
    return mesh


def wrappers(t):
    mesh = _mesh(t["mesh"])
    g, m, k = dist.model_group(), mesh.dims[1], mesh.model_index
    gen = torch.Generator().manual_seed(0)
    out = {}

    def full_and_tp(kind):
        if kind == "linear":
            inp = torch.randn(4, 6, generator=gen)
            u = torch.randn(6, 6, generator=gen)
            w1, b1 = torch.randn(8, 6, generator=gen), torch.randn(8,
                                                                  generator=gen)
            w2, b2 = torch.randn(5, 8, generator=gen), torch.randn(5,
                                                                  generator=gen)
            ct = torch.randn(4, 5, generator=gen)
            up = lambda a, u: a @ u  # noqa: E731
            col, row = tpl.column_linear, tpl.row_linear
            plain1 = lambda x, w, b: tlayers.linear(x, w, b)  # noqa: E731
            plain2 = plain1
        else:
            inp = torch.randn(2, 3, 6, 6, generator=gen)
            u = torch.randn(3, 3, 3, 3, generator=gen)
            w1, b1 = (torch.randn(8, 3, 3, 3, generator=gen),
                      torch.randn(8, generator=gen))
            w2, b2 = (torch.randn(4, 8, 3, 3, generator=gen),
                      torch.randn(4, generator=gen))
            ct = torch.randn(2, 4, 6, 6, generator=gen)
            up = lambda a, u: tlayers.conv2d(a, u)  # noqa: E731
            col = row = None
            plain1 = plain2 = (lambda x, w, b: tlayers.conv2d(x, w)
                               + b.view(1, -1, 1, 1))
        n1 = w1.shape[0] // m
        leaves = [t_.clone().requires_grad_() for t_ in (u, w1, b1, w2, b2)]
        fu, fw1, fb1, fw2, fb2 = leaves
        y = plain2(torch.relu(plain1(up(inp, fu), fw1, fb1)), fw2, fb2)
        (y * ct).sum().backward()
        full = [x.grad for x in leaves]
        su = u.clone().requires_grad_()
        sw1 = w1[k * n1:(k + 1) * n1].clone().requires_grad_()
        sb1 = b1[k * n1:(k + 1) * n1].clone().requires_grad_()
        sw2 = w2[:, k * n1:(k + 1) * n1].clone().requires_grad_()
        sb2 = b2.clone().requires_grad_()
        if kind == "linear":
            h = col(up(inp, su), sw1, sb1, g)
            z = row(torch.relu(h), sw2, sb2, g)
        else:
            h = tpl.column_conv2d(up(inp, su), sw1, sb1, g)
            z = tpl.row_conv2d(torch.relu(h), sw2, sb2, g)
        (z * ct).sum().backward()
        sl = slice(k * n1, (k + 1) * n1)

        def rel(a, b):  # |a - b| over the largest |b|
            return float((a - b).abs().max() / b.abs().max())

        return {"out": rel(z.detach(), y.detach()),
                "upstream": rel(su.grad, full[0]),
                "w1": rel(sw1.grad, full[1][sl]),
                "b1": rel(sb1.grad, full[2][sl]),
                "w2": rel(sw2.grad, full[3][:, sl]),
                "b2": rel(sb2.grad, full[4]),
                "upstream_scale": float(su.grad.abs().max()
                                        / full[0].abs().max())}

    for kind in ("linear", "conv"):
        out[kind] = full_and_tp(kind)
    # The sharded dropout takes this rank's block of the full-width mask.
    x = torch.randn(3, 8, generator=gen)
    seed = 11
    full = tlayers.dropout(x, 0.25, train=True,
                           generator=torch.Generator().manual_seed(seed))
    n = 8 // m
    part = tpl.sharded_dropout(x[:, k * n:(k + 1) * n], 0.25, train=True,
                               group=g,
                               generator=torch.Generator().manual_seed(seed))
    out["dropout"] = bool(torch.equal(part, full[:, k * n:(k + 1) * n]))
    out["collectives"] = dict(dist.collective_calls)
    dist.clear_mesh()
    return out


def _queue_masks(masks):
    """Serve ``masks`` (a list, in draw order) as the keep masks."""
    queue = list(masks)

    def from_queue(shape, keep, generator, device):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        return mask.to(device)

    tlayers.keep_mask = from_queue
    return queue


def steps(t):
    mesh = _mesh(t["mesh"])
    model = get_model("deepnn")
    model.load_state_dict(t["state_dict"])
    model.classifier[2].rate = t["dropout"]
    m, j = mesh.dims[1], mesh.data_index
    plan = plan_for_model("deepnn", model, model_size=m)
    tp = wiring(plan, dist.model_group())
    if t.get("force_tp"):
        # The tensor-parallel forward at a model axis of 1, over a group of
        # this one rank.
        tp = TPWiring(dist.model_group() or torch.distributed.new_group(
            [dist.rank()]))
    if tp is not None:
        shard_module_(model, plan, mesh.model_index)
    state = init_train_state(model)
    if t.get("shard_update"):
        state.momentum = init_opt_shard(list(model.parameters()))
    step_fn = make_train_step(model, SGDConfig(lr=0.1), SCHED,
                              shard_update=t.get("shard_update", False),
                              tp=tp)
    real_keep_mask = tlayers.keep_mask
    queue = None
    if t.get("masks") is not None:
        queue = _queue_masks(t["masks"][s][k][j]
                             for s in range(len(t["masks"]))
                             for k in range(len(t["masks"][s])))
    gen = torch.Generator().manual_seed(t.get("dropout_seed", 0))
    losses = []
    try:
        for batch in t["batches"]:
            images, labels = batch["image"], batch["label"]
            if images.dim() == 4:
                images, labels = images[None], labels[None]
            b = images.shape[1] // mesh.dims[0]
            micros = [{"image": images[a, j * b:(j + 1) * b],
                       "label": labels[a, j * b:(j + 1) * b]}
                      for a in range(images.shape[0])]
            loss = step_fn(state, micros, None,
                           lambda step, micro=0: gen)
            losses.append(float(dist.all_reduce_sum_(loss.clone())))
    finally:
        tlayers.keep_mask = real_keep_mask
    momentum = state.momentum
    if t.get("shard_update"):
        momentum = opt_shard_to_list(list(model.parameters()),
                                     state.momentum)
    counts = dict(dist.collective_calls)
    sd, mom = tp_full_state(model, momentum,
                            plan if tp is not None and m > 1 else None)
    for fmt, path in (t.get("save") or {}).items():
        drill._save({"save_path": path, "ckpt_format": fmt}, model,
                    momentum, plan if tp is not None and m > 1 else None,
                    state.step)
    out = {"losses": losses, "state_dict": sd, "momentum": mom,
           "collectives": counts, "masks_left": None if queue is None
           else len(queue), "local_numel": sum(
               p.numel() for p in model.parameters()),
           "momentum_numel": sum(v.numel() for v in state.momentum)}
    dist.clear_mesh()
    return out


def resume(t):
    mesh = _mesh(t["mesh"])
    model = get_model("deepnn")
    plan = plan_for_model("deepnn", model, model_size=mesh.dims[1])
    train = Dataset(t["images"].numpy(), t["labels"].numpy())
    loader = TrainLoader(train, t["batch"], mesh.dims[0], seed=0,
                         augment=False)
    trainer = Trainer(model, loader, device=torch.device("cpu"),
                      lr_schedule=SCHED, sgd_config=SGDConfig(lr=0.1),
                      snapshot_path=t["path"], resume=True, save_every=10**9,
                      tp_plan=plan, shard_update=t.get("shard_update",
                                                       False))
    momentum = trainer.state.momentum
    if t.get("shard_update"):
        momentum = opt_shard_to_list(list(model.parameters()), momentum)
    sd, mom = trainer.full_state(momentum)
    # Copies: without a model axis these are the live tensors.
    sd = {k: v.clone() for k, v in sd.items()}
    mom = {k: v.clone() for k, v in mom.items()}
    start_epoch = trainer.start_epoch
    trainer.train(start_epoch + 1)
    out = {"start_epoch": start_epoch, "state_dict": sd, "momentum": mom,
           "step": trainer.state.step, "losses": trainer.loss_history}
    dist.clear_mesh()
    return out


TASKS = {"wrappers": wrappers, "steps": steps, "resume": resume}


def main(spec_path, out_dir):
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    dist.initialize(torch.device("cpu"))
    try:
        out = {t["name"]: TASKS[t["kind"]](t) for t in spec["tasks"]}
        torch.save(out, os.path.join(out_dir, f"rank{dist.rank()}.pt"))
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
