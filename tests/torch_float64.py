"""A float64 epoch of the narrow VGG, DeepNN or ResNet-18 in plain PyTorch,
written apart from both packages: the exact epoch the float32 runs of the
JAX package and of the port (on the CPU or on the card) are held against.
Imports no JAX, so the card's tests use it too."""
from contextlib import nullcontext

import numpy as np
import torch

from ddp_tpu_torch.data.augment import _numpy_crop_flip
from ddp_tpu_torch.data.loader import TrainLoader, optimizer_groups
from ddp_tpu_torch.ops.layers import keep_mask
from ddp_tpu_torch.optim import triangular_lr
from ddp_tpu_torch.parallel.drill import Margins, draws_np, dropout_generator

NARROW = [8, "M", 16, "M", 512, "M"]


def vgg_forward64(arch):
    """The VGG of layer list ``arch`` as ``forward(q, x, bn, mask)``."""
    def forward(q, x, bn, mask=None):
        i = 0
        for a in arch:
            if a == "M":
                x = torch.nn.functional.max_pool2d(x, 2, 2)
                continue
            x = torch.relu(bn(torch.nn.functional.conv2d(
                x, q[f"backbone.conv{i}.weight"], padding=1),
                f"backbone.bn{i}"))
            i += 1
        return torch.nn.functional.linear(
            x.mean((2, 3)), q["classifier.weight"], q["classifier.bias"])
    return forward


def deepnn_forward64(q, x, bn, mask=None):
    """DeepNN (``ddp_tpu_torch/models/deepnn.py``) on the port's keys; in
    training ``mask`` is the dropout's keep mask."""
    F = torch.nn.functional
    for slot, pool in ((0, False), (2, True), (5, False), (7, True)):
        x = torch.relu(F.conv2d(x, q[f"features.{slot}.weight"],
                                q[f"features.{slot}.bias"], padding=1))
        if pool:
            x = F.max_pool2d(x, 2, 2)
    x = torch.relu(F.linear(x.flatten(1), q["classifier.0.weight"],
                            q["classifier.0.bias"]))
    if mask is not None:
        x = torch.where(mask.to(x.device), x / 0.9, x.new_zeros(()))
    return F.linear(x, q["classifier.3.weight"], q["classifier.3.bias"])


def resnet18_forward64(q, x, bn, mask=None):
    """ResNet-18 (``ddp_tpu_torch/models/resnet.py``) on torchvision's
    keys."""
    F = torch.nn.functional
    x = torch.relu(bn(F.conv2d(x, q["conv1.weight"], stride=2, padding=3),
                      "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for s in range(1, 5):
        for b in range(2):
            p, stride = f"layer{s}.{b}", 2 if s > 1 and b == 0 else 1
            y = torch.relu(bn(F.conv2d(x, q[f"{p}.conv1.weight"],
                                       stride=stride, padding=1), f"{p}.bn1"))
            y = bn(F.conv2d(y, q[f"{p}.conv2.weight"], padding=1), f"{p}.bn2")
            if f"{p}.downsample.0.weight" in q:
                x = bn(F.conv2d(x, q[f"{p}.downsample.0.weight"],
                                stride=stride), f"{p}.downsample.1")
            x = torch.relu(y + x)
    return F.linear(x.mean((2, 3)), q["fc.weight"], q["fc.bias"])


FORWARDS = {"deepnn": deepnn_forward64, "resnet18": resnet18_forward64}


def grads64(model, sd, images, labels, mask=None):
    """The float64 gradient of the mean cross entropy of uint8
    ``[B,32,32,3]`` ``images`` through :data:`FORWARDS`' ``model`` from the
    state dict ``sd`` in training mode (``mask``: DeepNN's keep mask):
    ``(loss, {parameter name: gradient})``."""
    names = [k for k in sd if "running" not in k]
    q = {k: sd[k].double().requires_grad_() for k in names}
    running = {k: v.double() for k, v in sd.items() if "running" in k}
    x = torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0
    logits = FORWARDS[model](q, x, batch_norm64(q, running), mask)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels).long())
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(
        loss, [q[k] for k in names])))


def batch_norm64(q, running, bn_momentum=0.1, eps=1e-5):
    """``bn(x, prefix)``: training-mode BatchNorm on ``x``'s batch that
    blends its statistics into ``running`` (torch's: the unbiased variance,
    its factor clamped at a count of 1 as the packages clamp it)."""
    ch = lambda t: t[None, :, None, None]

    def bn(x, prefix):
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        for key, v in (("running_mean", mean),
                       ("running_var", var * n / max(n - 1, 1))):
            k = f"{prefix}.{key}"
            running[k] = ((1 - bn_momentum) * running[k]
                          + bn_momentum * v.detach())
        return (x - ch(mean)) / ch(torch.sqrt(var + eps)) \
            * ch(q[f"{prefix}.weight"]) + ch(q[f"{prefix}.bias"])
    return bn


def float64_epoch(sd, train, groups, lr_at, *, world, sync_bn,
                  momentum=0.9, wd=5e-4, eps=1e-5, bn_momentum=0.1,
                  state=None, step0=0, arch=NARROW, model=None,
                  masks=None, margins=None, device="cpu"):
    """The epoch in float64 plain PyTorch, written apart from both
    packages: for each optimizer step, the sum over its micro-batches and
    ranks of the gradients of each rank's share of the global-mean loss,
    over the micro-batch count; BatchNorm on each rank's batch with its
    running buffers chained through the micro-batches and averaged over the
    ranks, or with ``sync_bn`` on the whole global batch; SGD with momentum
    and weight decay.  ``groups`` is the global ``[A, world * b]`` index
    rows of each step.  ``state``, the ``(weights, momentum)`` dicts of an
    earlier call, continues that run (they are updated in place), with the
    learning rate of step ``step0 + s``.  The model is ``model`` (a name of
    :data:`FORWARDS`) or else the VGG of layer list ``arch``
    (``ddp_tpu_torch/models/vgg.py``: convolutions with BN+ReLU, ``"M"``
    max pools, global average pool, linear); ``masks(step, k, r)`` gives
    DeepNN's dropout keep mask of micro-batch k of rank r.  When
    ``margins`` is a list, each step appends the ``(kink, gap)`` of its
    forwards (``ddp_tpu_torch.parallel.drill.Margins``).  ``device`` runs
    the float64 arithmetic there (the card's float64 units take a
    full-width epoch in a fraction of a second); the results come back on
    the CPU.  Returns (losses, state dict, momentum list in parameter
    order)."""
    forward = FORWARDS[model] if model else vgg_forward64(arch)
    names = [k for k in sd if not k.endswith(("running_mean", "running_var"))]
    if state is None:
        p = {k: v.detach().to(device, torch.float64, copy=True)
             for k, v in sd.items()}
        buf = {k: torch.zeros_like(p[k]) for k in names}
    else:
        p, buf = state
    images = torch.from_numpy(train.images).to(device)
    labels = torch.from_numpy(train.labels).long().to(device)
    losses = []
    for step, group in enumerate(groups):
        b = len(group[0]) // world
        parts = [slice(0, world * b)] if sync_bn else \
            [slice(r * b, (r + 1) * b) for r in range(world)]
        running = [{k: v.clone() for k, v in p.items() if "running" in k}
                   for _ in parts]
        grads = {k: torch.zeros_like(p[k]) for k in names}
        total = 0.0
        seen = Margins()
        for m, row in enumerate(group):
            for j, part in enumerate(parts):
                idx = torch.from_numpy(np.asarray(row[part])).long().to(
                    device)
                x = images[idx].permute(0, 3, 1, 2).double() / 255.0
                q = {k: p[k].clone().requires_grad_() for k in names}
                mask = None if masks is None else \
                    masks(step0 + step, m, j)
                with seen if margins is not None else nullcontext():
                    logits = forward(q, x, batch_norm64(
                        q, running[j], bn_momentum, eps), mask)
                loss = torch.nn.functional.cross_entropy(
                    logits, labels[idx], reduction="sum") / (b * world)
                for k, g in zip(names, torch.autograd.grad(
                        loss, [q[k] for k in names])):
                    grads[k] += g / len(group)
                total += float(loss.detach()) / len(group)
        if margins is not None:
            margins.append((seen.kink, seen.gap))
        for k in running[0]:
            p[k] = sum(r[k] for r in running) / len(running)
        lr_t = float(lr_at(step0 + step))
        for k in names:
            buf[k] = momentum * buf[k] + grads[k] + wd * p[k]
            p[k] = p[k] - lr_t * buf[k]
        losses.append(total)
    if device != "cpu":
        return (np.array(losses), {k: v.cpu() for k, v in p.items()},
                [buf[k].cpu() for k in names])
    return np.array(losses), p, [buf[k] for k in names]


def float64_drill(sd, train, *, batch, lr, seed, world, accum, sync_bn,
                  model=None, arch=NARROW, margins=None, device="cpu"):
    """The float64 epoch of a resident drill
    (``ddp_tpu_torch/parallel/drill.py`` with ``augment=True``) from the
    state dict ``sd``: each rank's rows of each micro-batch (its
    ``TrainLoader`` columns in ``optimizer_groups``) cropped and flipped
    with the drill's draws, DeepNN's keep masks from the drill's dropout
    generators, the drill's learning-rate schedule.  Returns
    :func:`float64_epoch`'s result; ``margins`` and ``device`` as
    there."""
    loader = TrainLoader(train, batch, world, seed=seed)
    loader.set_epoch(0)
    images, labels, groups, masks, at, step = [], [], [], {}, 0, 0
    for calls in zip(*(optimizer_groups(*loader.rank_index_matrix(r), accum)
                       for r in range(world))):
        for g in range(calls[0].shape[0]):
            rows = []
            for k in range(calls[0].shape[1]):
                row = []
                for r, c in enumerate(calls):
                    idx = c[g, k]
                    images.append(_numpy_crop_flip(
                        train.images[idx],
                        *draws_np(seed, r, step, len(idx), k)))
                    labels.append(train.labels[idx])
                    row.append(np.arange(at, at + len(idx)))
                    at += len(idx)
                    masks[step, k, r] = keep_mask(
                        (len(idx), 512), 0.9,
                        dropout_generator(seed, r, step, k), "cpu")
                rows.append(np.concatenate(row))
            groups.append(np.stack(rows))
            step += 1

    class _Data:  # the fields float64_epoch reads
        pass

    data = _Data()
    data.images, data.labels = np.concatenate(images), np.concatenate(labels)
    steps = loader.optimizer_steps_per_epoch(accum)
    return float64_epoch(
        sd, data, groups, lambda s: triangular_lr(
            s, base_lr=lr, num_epochs=1, steps_per_epoch=steps),
        world=world, sync_bn=sync_bn, model=model, arch=arch,
        masks=lambda s, k, j: torch.cat([masks[s, k, r] for r in (
            range(world) if sync_bn else [j])]),
        margins=margins, device=device)


def drill_distance(got, ref):
    """The largest distance of a drill rank's result (a dict of
    ``ddp_tpu_torch.parallel.drill.run``) from :func:`float64_drill`'s
    ``(losses, state, momentum)`` over losses, weights, buffers and
    momentum: ``(distance, where, the largest |value| there)``."""
    losses, state, mom = ref
    pairs = [("losses", got["losses"], torch.from_numpy(losses))]
    pairs += [(k, got["state_dict"][k], v) for k, v in state.items()]
    pairs += [(f"momentum {k}", a, b) for k, (a, b) in enumerate(
        zip(got["momentum"], mom))]
    return max((float((a.double() - b).abs().max()), key,
                float(b.abs().max())) for key, a, b in pairs)


def margins(p, images, arch=NARROW):
    """``(kink, gap)`` of one rank's uint8 ``[B,32,32,3]`` batch through
    the float64 weights ``p`` in training mode: the smallest |BN output| at
    a ReLU, and the smallest nonzero gap between the two largest inputs of
    a 2x2 max-pool window.  A decision whose margin is within float32
    rounding can go either way between two float32 runs."""
    ch = lambda t: t[None, :, None, None]
    x = torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0
    kink, gap, i = float("inf"), float("inf"), 0
    for a in arch:
        if a == "M":
            n, c, h, w = x.shape
            top = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(
                0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4).sort(
                -1, descending=True).values
            d = top[..., 0] - top[..., 1]
            if bool((d > 0).any()):
                gap = min(gap, float(d[d > 0].min()))
            x = torch.nn.functional.max_pool2d(x, 2, 2)
            continue
        x = torch.nn.functional.conv2d(x, p[f"backbone.conv{i}.weight"],
                                       padding=1)
        mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
        x = (x - ch(mean)) / ch(torch.sqrt(var + 1e-5)) \
            * ch(p[f"backbone.bn{i}.weight"]) + ch(p[f"backbone.bn{i}.bias"])
        kink = min(kink, float(x.abs().min()))
        x = torch.relu(x)
        i += 1
    return kink, gap


def float64_trajectory(sd, per, lr_at, arch=NARROW):
    """The float64 epoch over streamed host batches, one optimizer step a
    batch: ``per[r][k]`` is rank r's batch k (``{"image", "label"}``, as
    ``TrainLoader(local_replicas=[r])`` yields it); BatchNorm per rank.
    Returns (losses, state dict, momentum list, ``[(kink, gap)]`` of each
    step at the weights that step sees, over the ranks)."""
    world, steps = len(per), len(per[0])
    images, labels, groups, at = [], [], [], 0
    for k in range(steps):
        for r in range(world):
            images.append(per[r][k]["image"])
            labels.append(per[r][k]["label"])
        m = world * len(per[0][k]["label"])
        groups.append(np.arange(at, at + m)[None])
        at += m

    class _Data:  # the fields float64_epoch reads
        pass

    data = _Data()
    data.images, data.labels = np.concatenate(images), np.concatenate(labels)
    names = [k for k in sd if not k.endswith(("running_mean", "running_var"))]
    p = {k: v.detach().double().clone() for k, v in sd.items()}
    buf = {k: torch.zeros_like(p[k]) for k in names}
    losses, steps_margins, mom = [], [], []
    for k, group in enumerate(groups):
        ms = [margins(p, per[r][k]["image"], arch) for r in range(world)]
        steps_margins.append((min(m[0] for m in ms), min(m[1] for m in ms)))
        got, _, mom = float64_epoch(sd, data, [group], lr_at, world=world,
                                    sync_bn=False, state=(p, buf), step0=k,
                                    arch=arch)
        losses += list(got)
    return np.array(losses), p, mom, steps_margins
