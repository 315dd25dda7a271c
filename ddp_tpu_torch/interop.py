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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    # A copy: the caller's arrays must not alias the model's tensors.
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def vgg_state_dict_from_jax(params: Dict[str, Any],
                            batch_stats: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """``ddp_tpu`` VGG ``(params, batch_stats)`` -> the port's
    ``state_dict`` (CPU tensors; ``load_state_dict`` moves them)."""
    sd: Dict[str, torch.Tensor] = {}
    backbone = params["backbone"]
    i = 0
    while f"conv{i}" in backbone:
        sd[f"backbone.conv{i}.weight"] = _t(
            np.asarray(backbone[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"backbone.bn{i}.weight"] = _t(backbone[f"bn{i}"]["scale"])
        sd[f"backbone.bn{i}.bias"] = _t(backbone[f"bn{i}"]["bias"])
        sd[f"backbone.bn{i}.running_mean"] = _t(batch_stats[f"bn{i}"]["mean"])
        sd[f"backbone.bn{i}.running_var"] = _t(batch_stats[f"bn{i}"]["var"])
        i += 1
    sd["classifier.weight"] = _t(np.asarray(params["classifier"]["weight"]).T)
    sd["classifier.bias"] = _t(params["classifier"]["bias"])
    return sd


def vgg_jax_from_state_dict(sd: Dict[str, torch.Tensor]
                            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's VGG ``state_dict`` -> ``ddp_tpu``'s ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""

    def a(key: str) -> np.ndarray:
        return sd[key].detach().cpu().numpy().copy()

    backbone: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    i = 0
    while f"backbone.conv{i}.weight" in sd:
        backbone[f"conv{i}"] = {
            "kernel": a(f"backbone.conv{i}.weight").transpose(2, 3, 1, 0)}
        backbone[f"bn{i}"] = {"scale": a(f"backbone.bn{i}.weight"),
                              "bias": a(f"backbone.bn{i}.bias")}
        stats[f"bn{i}"] = {"mean": a(f"backbone.bn{i}.running_mean"),
                           "var": a(f"backbone.bn{i}.running_var")}
        i += 1
    params = {"backbone": backbone,
              "classifier": {"weight": a("classifier.weight").T.copy(),
                             "bias": a("classifier.bias")}}
    return params, stats
