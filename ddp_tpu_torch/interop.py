"""Convert between ``ddp_tpu``'s VGG parameters and the port's
``state_dict`` (counterpart of ``ddp_tpu/utils/torch_interop.py``'s VGG
half, without its JAX import).

``ddp_tpu`` keeps ``(params, batch_stats)`` as nested dicts:
``params["backbone"]["conv{i}"]["kernel"]`` (HWIO),
``params["backbone"]["bn{i}"]["scale" | "bias"]``,
``params["classifier"]["weight"]`` (``[in, out]``) and ``["bias"]``, and
``batch_stats["bn{i}"]["mean" | "var"]``.  Here they are numpy arrays (pass
``np.asarray`` of JAX arrays); the port's keys are the reference
checkpoint's (``backbone.conv0.weight`` in OIHW, ``classifier.weight`` in
``[out, in]``, ...).

Any tree shaped like ``params`` maps by the same rule
(:func:`params_tree_from_named`, :func:`named_from_params_tree`): the SGD
momentum is one, which ``ddp_tpu`` keeps as a tree mirroring ``params`` and
the port as a list in ``model.parameters()`` order
(:func:`momentum_tree_from_list`, :func:`momentum_list_from_tree`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def _t(a) -> torch.Tensor:
    # A copy: the caller's arrays must not alias the model's tensors.
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def named_from_params_tree(params: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """A ``params``-shaped tree -> the port's parameter names (CPU tensors
    in the port's layouts)."""
    named: Dict[str, torch.Tensor] = {}
    backbone = params["backbone"]
    i = 0
    while f"conv{i}" in backbone:
        named[f"backbone.conv{i}.weight"] = _t(
            np.asarray(backbone[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1))
        named[f"backbone.bn{i}.weight"] = _t(backbone[f"bn{i}"]["scale"])
        named[f"backbone.bn{i}.bias"] = _t(backbone[f"bn{i}"]["bias"])
        i += 1
    named["classifier.weight"] = _t(
        np.asarray(params["classifier"]["weight"]).T)
    named["classifier.bias"] = _t(params["classifier"]["bias"])
    return named


def params_tree_from_named(named: Dict[str, torch.Tensor]
                           ) -> Dict[str, Any]:
    """The port's parameter names (a ``state_dict`` will do) -> a
    ``params``-shaped tree of numpy arrays in ``ddp_tpu``'s layouts."""
    backbone: Dict[str, Any] = {}
    i = 0
    while f"backbone.conv{i}.weight" in named:
        backbone[f"conv{i}"] = {
            "kernel": _a(named[f"backbone.conv{i}.weight"]).transpose(
                2, 3, 1, 0)}
        backbone[f"bn{i}"] = {"scale": _a(named[f"backbone.bn{i}.weight"]),
                              "bias": _a(named[f"backbone.bn{i}.bias"])}
        i += 1
    return {"backbone": backbone,
            "classifier": {"weight": _a(named["classifier.weight"]).T.copy(),
                           "bias": _a(named["classifier.bias"])}}


def vgg_state_dict_from_jax(params: Dict[str, Any],
                            batch_stats: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """``ddp_tpu`` VGG ``(params, batch_stats)`` -> the port's
    ``state_dict`` (CPU tensors; ``load_state_dict`` moves them)."""
    sd = named_from_params_tree(params)
    for name, stats in batch_stats.items():
        sd[f"backbone.{name}.running_mean"] = _t(stats["mean"])
        sd[f"backbone.{name}.running_var"] = _t(stats["var"])
    return sd


def vgg_jax_from_state_dict(sd: Dict[str, torch.Tensor]
                            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's VGG ``state_dict`` -> ``ddp_tpu``'s ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""
    stats: Dict[str, Any] = {}
    i = 0
    while f"backbone.bn{i}.running_mean" in sd:
        stats[f"bn{i}"] = {"mean": _a(sd[f"backbone.bn{i}.running_mean"]),
                           "var": _a(sd[f"backbone.bn{i}.running_var"])}
        i += 1
    return params_tree_from_named(sd), stats


def momentum_tree_from_list(model: nn.Module,
                            momentum: List[torch.Tensor]) -> Dict[str, Any]:
    """The port's momentum list (parallel to ``model.parameters()``) ->
    ``ddp_tpu``'s momentum tree (mirrors ``params``)."""
    names = [n for n, _ in model.named_parameters()]
    return params_tree_from_named(dict(zip(names, momentum)))


def momentum_list_from_tree(model: nn.Module, tree: Dict[str, Any]
                            ) -> List[torch.Tensor]:
    """``ddp_tpu``'s momentum tree -> the port's list in
    ``model.parameters()`` order (CPU tensors)."""
    named = named_from_params_tree(tree)
    return [named[n] for n, _ in model.named_parameters()]
