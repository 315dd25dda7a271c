"""Model registry (counterpart of ``ddp_tpu/models/__init__.py``): VGG-11,
DeepNN and ResNet-18.  Every model's forward is ``forward(x, sync_bn=False,
compute_dtype=None, generator=None)``; ``generator`` feeds DeepNN's dropout
in training and is ignored by the others.  The transformer models belong to
a later slice."""
from __future__ import annotations

from torch import nn

NAMES = ("vgg", "deepnn", "resnet18")


def get_model(name: str, **kwargs) -> nn.Module:
    """A freshly initialised model; ``kwargs`` go to its constructor
    (``device``, ``generator``, and ``arch`` for VGG)."""
    if name == "vgg":
        from .vgg import VGG
        return VGG(**kwargs)
    if name == "deepnn":
        from .deepnn import DeepNN
        return DeepNN(**kwargs)
    if name == "resnet18":
        from .resnet import ResNet18
        return ResNet18(**kwargs)
    raise ValueError(f"unknown model {name!r}; this port has: "
                     f"{', '.join(NAMES)}")
