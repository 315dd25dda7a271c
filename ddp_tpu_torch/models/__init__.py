"""Model registry (counterpart of ``ddp_tpu/models/__init__.py``): VGG-11,
DeepNN, ResNet-18, the CIFAR transformer encoder and the byte LM
``tinylm``.  Every model's forward is ``forward(x, sync_bn=False,
compute_dtype=None, generator=None)``; ``generator`` feeds DeepNN's dropout
in training and is ignored by the others.  ``tinylm``'s ``x`` is a batch of
token ids (``models/transformer.py``).

``NAMES`` are the models the classifier trainer and the bench take (the
JAX CLI's choices); ``ALL_NAMES`` adds the transformer pair, which the
serving, planning and LM entry points take."""
from __future__ import annotations

from torch import nn

NAMES = ("vgg", "deepnn", "resnet18")
ALL_NAMES = NAMES + ("transformer", "tinylm")


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
    if name == "transformer":
        from .transformer import Transformer
        return Transformer(**kwargs)
    if name == "tinylm":
        from .transformer import TinyLM
        return TinyLM(**kwargs)
    raise ValueError(f"unknown model {name!r}; this port has: "
                     f"{', '.join(ALL_NAMES)}")
