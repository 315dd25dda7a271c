"""Convert between ``ddp_tpu``'s parameter trees, the port's ``state_dict``
and the reference's torch ``state_dict`` files, for VGG-11, DeepNN and
ResNet-18 (counterpart of ``ddp_tpu/utils/torch_interop.py``, without its
JAX import).

``ddp_tpu`` keeps ``(params, batch_stats)`` as nested dicts of arrays, conv
kernels HWIO and linear weights ``[in, out]``; here they are numpy arrays
(pass ``np.asarray`` of JAX arrays).  The port's ``state_dict`` holds conv
kernels OIHW and linear weights ``[out, in]`` under the reference's names:
``backbone.conv0.weight`` ... ``classifier.bias`` for VGG, the reference's
Sequential slots (``features.{0,2,5,7}``, ``classifier.{0,3}``) for DeepNN,
torchvision's names for ResNet-18.  Each model's :data:`_RULES` pair every
port key with its tree path; DeepNN's first linear also permutes its input
axis between the port's channel-major flatten and the JAX package's NHWC
one (``ddp_tpu/utils/torch_interop.py:108-111,137-139``).

Any tree shaped like ``params`` maps by the same rules: the SGD momentum is
one, which ``ddp_tpu`` keeps as a tree mirroring ``params`` and the port as
a list in ``model.parameters()`` order (:func:`momentum_tree_from_list`,
:func:`momentum_list_from_tree`).

The reference's own files (``--init_from_torch`` / ``--export_torch``) are
the port's ``state_dict`` plus BatchNorm's ``num_batches_tracked`` counters
(:func:`from_reference`, :func:`to_reference`).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .models import get_model


class Rule(NamedTuple):
    """A port key template, its tree (``params`` or ``batch_stats``), the
    tree path template (``/`` between levels) and the layout change
    (``conv``, ``linear``, ``flat_linear`` or None)."""
    port: str
    section: str
    path: str
    layout: Optional[str] = None


def _bn(port: str, params: str, stats: str) -> List[Rule]:
    return [Rule(f"{port}.weight", "params", f"{params}/scale"),
            Rule(f"{port}.bias", "params", f"{params}/bias"),
            Rule(f"{port}.running_mean", "batch_stats", f"{stats}/mean"),
            Rule(f"{port}.running_var", "batch_stats", f"{stats}/var")]


_DEEPNN_SLOTS = (0, 2, 5, 7)
_RESNET_BLOCK = "layer{s}.{b}"
_RESNET_TREE = "layer{s}.block{b}"
_RULES: Dict[str, List[Rule]] = {
    "vgg": [Rule("backbone.conv{i}.weight", "params",
                 "backbone/conv{i}/kernel", "conv"),
            *_bn("backbone.bn{i}", "backbone/bn{i}", "bn{i}"),
            Rule("classifier.weight", "params", "classifier/weight",
                 "linear"),
            Rule("classifier.bias", "params", "classifier/bias")],
    "deepnn": [r for i, slot in enumerate(_DEEPNN_SLOTS) for r in (
        Rule(f"features.{slot}.weight", "params",
             f"features/conv{i}/kernel", "conv"),
        Rule(f"features.{slot}.bias", "params", f"features/conv{i}/bias"))
    ] + [Rule("classifier.0.weight", "params", "classifier/linear0/weight",
              "flat_linear"),
         Rule("classifier.0.bias", "params", "classifier/linear0/bias"),
         Rule("classifier.3.weight", "params", "classifier/linear1/weight",
              "linear"),
         Rule("classifier.3.bias", "params", "classifier/linear1/bias")],
    "resnet18": [
        Rule("conv1.weight", "params", "conv1/kernel", "conv"),
        *_bn("bn1", "bn1", "bn1"),
        *[r for n in (1, 2) for r in (
            Rule(f"{_RESNET_BLOCK}.conv{n}.weight", "params",
                 f"{_RESNET_TREE}/conv{n}/kernel", "conv"),
            *_bn(f"{_RESNET_BLOCK}.bn{n}", f"{_RESNET_TREE}/bn{n}",
                 f"{_RESNET_TREE}/bn{n}"))],
        Rule(f"{_RESNET_BLOCK}.downsample.0.weight", "params",
             f"{_RESNET_TREE}/downsample/conv/kernel", "conv"),
        *_bn(f"{_RESNET_BLOCK}.downsample.1",
             f"{_RESNET_TREE}/downsample/bn",
             f"{_RESNET_TREE}/downsample_bn"),
        Rule("fc.weight", "params", "fc/weight", "linear"),
        Rule("fc.bias", "params", "fc/bias")],
}
# DeepNN's last feature map, [C, H, W], whose flatten linear0 reads.
_FLAT_CHW = (32, 8, 8)


def _pattern(template: str) -> "re.Pattern":
    return re.compile("".join(
        f"(?P<{part[1:-1]}>\\d+)" if part.startswith("{") else re.escape(part)
        for part in re.split(r"(\{\w+\})", template)) + "$")


_PATTERNS = {name: [(_pattern(r.port), _pattern(r.path), r) for r in rules]
             for name, rules in _RULES.items()}


def _rules(name: str):
    if name not in _PATTERNS:
        raise ValueError(f"unknown model {name!r}; the port maps "
                         f"{', '.join(_PATTERNS)}")
    return _PATTERNS[name]


def model_of_tree(params: Dict[str, Any]) -> Optional[str]:
    """Which model a ``params`` tree belongs to, from its top-level keys
    (None when it is none of the three)."""
    for name, top in (("vgg", "backbone"), ("deepnn", "features"),
                      ("resnet18", "fc")):
        if top in params:
            return name
    return None


def _t(a) -> torch.Tensor:
    # A copy: the caller's arrays must not alias the model's tensors.
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _a(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.array(t, copy=True)


def _to_tree(a: np.ndarray, layout: Optional[str]) -> np.ndarray:
    """A port tensor's values in ``ddp_tpu``'s layout."""
    if layout == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))  # OIHW->HWIO
    if layout == "linear":
        return np.ascontiguousarray(a.T)
    if layout == "flat_linear":  # [out, (c,h,w)] -> [(h,w,c), out]
        out = a.shape[0]
        return np.ascontiguousarray(a.reshape(out, *_FLAT_CHW).transpose(
            0, 2, 3, 1).reshape(out, -1).T)
    return a


def _from_tree(a: np.ndarray, layout: Optional[str]) -> np.ndarray:
    """The inverse of :func:`_to_tree`."""
    if layout == "conv":
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if layout == "linear":
        return a.T
    if layout == "flat_linear":  # [(h,w,c), out] -> [out, (c,h,w)]
        c, h, w = _FLAT_CHW
        out = a.shape[1]
        return a.T.reshape(out, h, w, c).transpose(0, 3, 1, 2).reshape(
            out, -1)
    return a


def _leaves(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def jax_from_state_dict(name: str, sd: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Model ``name``'s port ``state_dict`` (or any subset of its keys, such
    as its parameters) -> ``ddp_tpu``'s ``(params, batch_stats)`` as nested
    dicts of numpy arrays.  A key no rule of the model matches raises
    ValueError."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    rules = _rules(name)
    for key, value in sd.items():
        for port, _, rule in rules:
            m = port.match(key)
            if m:
                break
        else:
            raise ValueError(f"{key!r} is not a {name} state_dict key")
        node = trees[rule.section]
        *parents, leaf = rule.path.format(**m.groupdict()).split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_tree(_a(value), rule.layout)
    return trees["params"], trees["batch_stats"]


def state_dict_from_jax(name: str, params: Dict[str, Any],
                        batch_stats: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """``ddp_tpu``'s ``(params, batch_stats)`` of model ``name`` -> the
    port's ``state_dict`` (CPU tensors; ``load_state_dict`` moves them), in
    the model's own order whatever order the tree's dicts hold (JAX sorts
    their keys; a narrower VGG's keys are a subset of VGG-11's).  A tree
    path no rule of the model matches raises ValueError."""
    out = {}
    rules = _rules(name)
    for section, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _leaves(tree):
            for _, tree_path, rule in rules:
                m = tree_path.match(path) if rule.section == section \
                    else None
                if m:
                    break
            else:
                raise ValueError(f"{section}/{path} is not a {name} tree "
                                 f"path")
            out[rule.port.format(**m.groupdict())] = _t(
                _from_tree(np.asarray(value), rule.layout))
    ordered = {k: out[k] for k in get_model(name, device="meta").state_dict()
               if k in out}
    ordered.update(out)
    return ordered


def param_tree_paths(model: nn.Module) -> List[str]:
    """Each parameter's ``params`` tree path in ``ddp_tpu``'s tree (``/``
    between levels, e.g. ``backbone/conv0/kernel``), in
    ``model.parameters()`` order."""
    rules = _rules(model.name)
    out = []
    for key, _ in model.named_parameters():
        for port, _, rule in rules:
            m = port.match(key)
            if m:
                out.append(rule.path.format(**m.groupdict()))
                break
        else:
            raise ValueError(f"{key!r} is not a {model.name} parameter")
    return out


def momentum_tree_from_list(model: nn.Module,
                            momentum: List[torch.Tensor]) -> Dict[str, Any]:
    """The port's momentum list (parallel to ``model.parameters()``) ->
    ``ddp_tpu``'s momentum tree (mirrors ``params``)."""
    names = [n for n, _ in model.named_parameters()]
    return jax_from_state_dict(model.name, dict(zip(names, momentum)))[0]


def momentum_list_from_tree(model: nn.Module, tree: Dict[str, Any]
                            ) -> List[torch.Tensor]:
    """``ddp_tpu``'s momentum tree -> the port's list in
    ``model.parameters()`` order (CPU tensors)."""
    named = state_dict_from_jax(model.name, tree, {})
    return [named[n] for n, _ in model.named_parameters()]


_TRACKED = ".num_batches_tracked"


def _deepnn_by_order(sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A DeepNN ``state_dict`` under any Sequential numbering -> the port's
    slots, by tensor rank and registration order as
    ``ddp_tpu/utils/torch_interop.py::deepnn_from_torch_state_dict``
    maps it: 4-D tensors are the convs' kernels, 1-D ones under
    ``features`` their biases, 2-D ones the linears' weights, 1-D ones
    under ``classifier`` their biases."""
    groups: Dict[str, List[torch.Tensor]] = {"cw": [], "cb": [], "lw": [],
                                             "lb": []}
    for k, v in sd.items():
        kind = {4: "cw", 2: "lw"}.get(v.dim()) or (
            "cb" if "features" in k else "lb" if "classifier" in k else None)
        if kind is not None:
            groups[kind].append(v)
    if [len(g) for g in groups.values()] != [4, 4, 2, 2]:
        raise ValueError(
            f"a DeepNN state_dict holds 4 conv kernels and biases and 2 "
            f"linear weights and biases, not "
            f"{[len(g) for g in groups.values()]}")
    out = {}
    for i, slot in enumerate(_DEEPNN_SLOTS):
        out[f"features.{slot}.weight"] = groups["cw"][i]
        out[f"features.{slot}.bias"] = groups["cb"][i]
    for i, slot in enumerate((0, 3)):
        out[f"classifier.{slot}.weight"] = groups["lw"][i]
        out[f"classifier.{slot}.bias"] = groups["lb"][i]
    return out


def from_reference(name: str, sd: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A reference torch ``state_dict`` of model ``name`` (the reference's
    ``checkpoint.pt``; torchvision's ``resnet18`` for ResNet-18) -> the
    port's ``state_dict`` (float32 CPU copies), for ``--init_from_torch``.
    ``num_batches_tracked`` counters are dropped; DeepNN's tensors are
    taken by rank and order, so any Sequential numbering loads."""
    _rules(name)
    sd = {k: v for k, v in sd.items() if not k.endswith(_TRACKED)}
    if name == "deepnn":
        sd = _deepnn_by_order(sd)
    return {k: v.detach().cpu().to(torch.float32).clone()
            for k, v in sd.items()}


def to_reference(name: str, sd: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of model ``name`` -> the reference's file
    (``torch.save(model.module.state_dict())``, multigpu.py:110-112), for
    ``--export_torch``: the same keys and layouts, CPU copies, and a zero
    ``num_batches_tracked`` beside every BatchNorm's running mean, as
    ``ddp_tpu/cli.py:500-505`` writes them, so torch's BatchNorm2d (and
    torchvision's ``resnet18``) load it strictly."""
    _rules(name)
    out = {k: v.detach().cpu().clone() for k, v in sd.items()}
    for k in list(out):
        if k.endswith(".running_mean"):
            out[k[:-len(".running_mean")] + _TRACKED] = torch.zeros(
                (), dtype=torch.long)
    return out
