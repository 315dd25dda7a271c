"""A float64 epoch of the narrow VGG in plain PyTorch, written apart from
both packages: the exact epoch the float32 runs of the JAX package and of
the port (on the CPU or on the card) are held against.  Imports no JAX, so
the card's tests use it too."""
import numpy as np
import torch

NARROW = [8, "M", 16, "M", 512, "M"]


def float64_epoch(sd, train, groups, lr_at, *, world, sync_bn,
                  momentum=0.9, wd=5e-4, eps=1e-5, bn_momentum=0.1,
                  state=None, step0=0, arch=NARROW):
    """The epoch in float64 plain PyTorch, written apart from both
    packages: for each optimizer step, the sum over its micro-batches and
    ranks of the gradients of each rank's share of the global-mean loss,
    over the micro-batch count; BatchNorm on each rank's batch with its
    running buffers chained through the micro-batches and averaged over the
    ranks, or with ``sync_bn`` on the whole global batch; SGD with momentum
    and weight decay.  ``groups`` is the global ``[A, world * b]`` index
    rows of each step.  ``state``, the ``(weights, momentum)`` dicts of an
    earlier call, continues that run (they are updated in place), with the
    learning rate of step ``step0 + s``.  ``arch`` is the VGG's layer list
    (``ddp_tpu_torch/models/vgg.py``: convolutions with BN+ReLU, ``"M"``
    max pools, global average pool, linear).  Returns (losses, state dict,
    momentum list in parameter order)."""
    names = [k for k in sd if not k.endswith(("running_mean", "running_var"))]
    if state is None:
        p = {k: v.detach().double().clone() for k, v in sd.items()}
        buf = {k: torch.zeros_like(p[k]) for k in names}
    else:
        p, buf = state
    images = torch.from_numpy(train.images)
    labels = torch.from_numpy(train.labels).long()
    ch = lambda t: t[None, :, None, None]
    losses = []
    for step, group in enumerate(groups):
        b = len(group[0]) // world
        parts = [slice(0, world * b)] if sync_bn else \
            [slice(r * b, (r + 1) * b) for r in range(world)]
        running = [{k: v.clone() for k, v in p.items() if "running" in k}
                   for _ in parts]
        grads = {k: torch.zeros_like(p[k]) for k in names}
        total = 0.0
        for row in group:
            for j, part in enumerate(parts):
                idx = torch.from_numpy(np.asarray(row[part])).long()
                x = images[idx].permute(0, 3, 1, 2).double() / 255.0
                q = {k: p[k].clone().requires_grad_() for k in names}
                i = 0
                for a in arch:
                    if a == "M":
                        x = torch.nn.functional.max_pool2d(x, 2, 2)
                        continue
                    x = torch.nn.functional.conv2d(
                        x, q[f"backbone.conv{i}.weight"], padding=1)
                    mean = x.mean((0, 2, 3))
                    var = x.var((0, 2, 3), unbiased=False)
                    n = x.shape[0] * x.shape[2] * x.shape[3]
                    for key, v in (("running_mean", mean),
                                   ("running_var", var * n / (n - 1))):
                        k = f"backbone.bn{i}.{key}"
                        running[j][k] = ((1 - bn_momentum) * running[j][k]
                                         + bn_momentum * v.detach())
                    x = torch.relu((x - ch(mean)) / ch(torch.sqrt(var + eps))
                                   * ch(q[f"backbone.bn{i}.weight"])
                                   + ch(q[f"backbone.bn{i}.bias"]))
                    i += 1
                logits = torch.nn.functional.linear(
                    x.mean((2, 3)), q["classifier.weight"],
                    q["classifier.bias"])
                loss = torch.nn.functional.cross_entropy(
                    logits, labels[idx], reduction="sum") / (b * world)
                for k, g in zip(names, torch.autograd.grad(
                        loss, [q[k] for k in names])):
                    grads[k] += g / len(group)
                total += float(loss.detach()) / len(group)
        for k in running[0]:
            p[k] = sum(r[k] for r in running) / len(running)
        lr_t = float(lr_at(step0 + step))
        for k in names:
            buf[k] = momentum * buf[k] + grads[k] + wd * p[k]
            p[k] = p[k] - lr_t * buf[k]
        losses.append(total)
    return np.array(losses), p, [buf[k] for k in names]


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
