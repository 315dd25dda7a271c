"""Optimizer and learning-rate schedule of the port."""
from .schedule import triangular_lr
from .sgd import SGDConfig

__all__ = ["SGDConfig", "triangular_lr"]
