"""Convert between ``ddp_tpu``'s parameter trees, the port's ``state_dict``
and the reference's torch ``state_dict`` files, for VGG-11, DeepNN and
ResNet-18 (counterpart of ``ddp_tpu/utils/torch_interop.py``, without its
JAX import), and between the trees and the port's ``state_dict`` of the
transformer encoder and ``tinylm`` (``embed/...``, ``blocks/blockN/...``,
``head/...``; a LayerNorm's ``scale`` is the port's ``weight``).

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

Under tensor parallelism (``parallel/tp/plan.py``) a rank holds one model
slice of each sharded leaf: :func:`shard_state` cuts a whole ``state_dict``
(or a momentum dict keyed alike) to model index k's slice by the plan's
specs, which name the split dimension of the port's tensors;
:func:`gather_state` joins the M slices again; :func:`rank_state_from_jax`
takes a JAX tree straight to one rank's slice, under a stage plan
(``parallel/pp/``) its stage's part of it (:func:`stage_state`).  :func:`tree_dim` maps a
dimension of a port tensor to the same dimension of the JAX package's
layout, where the JAX package's specs and shard files name it.
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


def _ln(port: str, path: str) -> List[Rule]:
    return [Rule(f"{port}.weight", "params", f"{path}/scale"),
            Rule(f"{port}.bias", "params", f"{path}/bias")]


def _lin(port: str, path: str) -> List[Rule]:
    return [Rule(f"{port}.weight", "params", f"{path}/weight", "linear"),
            Rule(f"{port}.bias", "params", f"{path}/bias")]


# The two transformer models' shared block stack and head.
_TFM_STACK = [
    *_ln("blocks.{i}.ln1", "blocks/block{i}/ln1"),
    *_lin("blocks.{i}.attn.qkv", "blocks/block{i}/attn/qkv"),
    *_lin("blocks.{i}.attn.out", "blocks/block{i}/attn/out"),
    *_ln("blocks.{i}.ln2", "blocks/block{i}/ln2"),
    *_lin("blocks.{i}.mlp.fc1", "blocks/block{i}/mlp/fc1"),
    *_lin("blocks.{i}.mlp.fc2", "blocks/block{i}/mlp/fc2"),
    *_ln("head.ln", "head/ln"),
    *_lin("head.linear", "head/linear")]
_RULES["transformer"] = [*_lin("embed.patch", "embed/patch"),
                         Rule("embed.pos", "params", "embed/pos"),
                         *_TFM_STACK]
_RULES["tinylm"] = [Rule("embed.tok", "params", "embed/tok"),
                    Rule("embed.pos", "params", "embed/pos"), *_TFM_STACK]
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
    (None when it is none of the five): the two transformer models share
    ``embed``, whose ``tok`` table is the LM's."""
    if "embed" in params:
        return "tinylm" if "tok" in params["embed"] else "transformer"
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


# A port tensor's dimension -> the same dimension in ddp_tpu's layout.
_TREE_DIMS = {"conv": (3, 2, 0, 1),            # OIHW -> HWIO
              "linear": (1, 0), "flat_linear": (1, 0)}


def tree_dim(layout: Optional[str], dim: int) -> int:
    """Where dimension ``dim`` of a port tensor of ``layout`` lies in
    ``ddp_tpu``'s layout of it (a flat linear's input axis is permuted
    within itself, so its dimensions map as a linear's)."""
    return _TREE_DIMS[layout][dim] if layout in _TREE_DIMS else dim


def rule_of(name: str, port_key: str) -> Tuple[str, Rule]:
    """Model ``name``'s tree path of the port key ``port_key`` and its
    rule; ValueError for a key no rule matches."""
    for port, _, rule in _rules(name):
        m = port.match(port_key)
        if m:
            return rule.path.format(**m.groupdict()), rule
    raise ValueError(f"{port_key!r} is not a {name} state_dict key")


def split_dim(spec) -> Optional[int]:
    """The dimension a spec (a tuple with an axis name on the split
    dimension, None elsewhere) splits, or None for a replicated leaf."""
    dims = [d for d, e in enumerate(spec) if e is not None]
    return dims[0] if dims else None


def shard_state(plan, state_dict: Dict[str, torch.Tensor],
                model_index: int) -> Dict[str, torch.Tensor]:
    """Model index ``model_index``'s slice of the whole ``state_dict`` (or a
    momentum dict keyed by parameter name) under ``plan``: each leaf the
    plan shards is cut to its ``model_index``-th of ``plan.model_size``
    blocks along its spec's dimension, the rest is kept whole.  Copies."""
    out = {}
    for key, v in state_dict.items():
        path, _ = rule_of(plan.model_name, key)
        dim = split_dim(plan.param_specs.get(path, ()))
        if dim is not None:
            n = v.shape[dim] // plan.model_size
            v = v.narrow(dim, model_index * n, n)
        out[key] = v.detach().clone()
    return out


def gather_state(plan, slices: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state`: model indices 0..M-1's slices
    (``slices[k]``) joined into the whole ``state_dict``; a leaf the plan
    replicates is taken from slice 0."""
    out = {}
    for key, v in slices[0].items():
        path, _ = rule_of(plan.model_name, key)
        dim = split_dim(plan.param_specs.get(path, ()))
        out[key] = v.clone() if dim is None else \
            torch.cat([s[key] for s in slices], dim=dim)
    return out


def stage_state(pp_plan, state_dict: Dict[str, torch.Tensor],
                stage: int) -> Dict[str, torch.Tensor]:
    """The keys of ``state_dict`` (or of a momentum dict keyed alike) that
    stage ``stage`` of ``pp_plan`` owns: block ``"a/b"`` owns the tree
    paths under ``a/b`` (``parallel/pp/partition.py``)."""
    from .parallel.pp.partition import stage_of_path
    return {k: v for k, v in state_dict.items()
            if stage_of_path(pp_plan, rule_of(pp_plan.model_name, k)[0])
            == stage}


def rank_state_from_jax(plan, params: Dict[str, Any],
                        batch_stats: Dict[str, Any], model_index: int,
                        pp_plan=None, stage: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """``ddp_tpu``'s ``(params, batch_stats)`` (numpy trees) -> the port
    ``state_dict`` slice of model index ``model_index`` under ``plan``, and
    of stage ``stage`` under ``pp_plan``: the start a test hands to a port
    rank where ``ddp_tpu`` takes the whole tree on its mesh."""
    sd = shard_state(plan, state_dict_from_jax(plan.model_name, params,
                                               batch_stats), model_index)
    return sd if pp_plan is None else stage_state(pp_plan, sd, stage)


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
# The models the reference's own torch files exist for.
_REFERENCE_MODELS = ("vgg", "deepnn", "resnet18")


def _reference_rules(name: str) -> None:
    if name not in _REFERENCE_MODELS:
        raise ValueError(f"{name!r} has no reference torch file; the "
                         f"reference's models are "
                         f"{', '.join(_REFERENCE_MODELS)}")


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
    _reference_rules(name)
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
    _reference_rules(name)
    out = {k: v.detach().cpu().clone() for k, v in sd.items()}
    for k in list(out):
        if k.endswith(".running_mean"):
            out[k[:-len(".running_mean")] + _TRACKED] = torch.zeros(
                (), dtype=torch.long)
    return out
