"""Model registry (counterpart of ``ddp_tpu/models/__init__.py``).  This
slice of the port has VGG only."""
from __future__ import annotations

from torch import nn


def get_model(name: str, **kwargs) -> nn.Module:
    """A freshly initialised model; ``kwargs`` go to its constructor
    (``device``, ``generator``, and ``arch`` for VGG)."""
    if name == "vgg":
        from .vgg import VGG
        return VGG(**kwargs)
    raise ValueError(f"unknown model {name!r}; this port has: vgg")
