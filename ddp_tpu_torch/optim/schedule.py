"""Triangular LR schedule (counterpart of ``ddp_tpu/optim/schedule.py``).

``lr(step) = base_lr * interp(step / steps_per_epoch,
                              [0, 0.3 * num_epochs, num_epochs], [0, 1, 0])``

advanced per batch; the first update (step 0) runs at lr 0, as torch's
LambdaLR gives it.  ``step`` is the host's step count, so the rate is a
Python float and reading it costs no device sync.
"""
from __future__ import annotations


def triangular_lr(step: int, *, base_lr: float = 0.4, num_epochs: int = 20,
                  steps_per_epoch: int = 98, peak_frac: float = 0.3) -> float:
    """Effective LR at global batch index ``step``."""
    e = step / steps_per_epoch
    peak = num_epochs * peak_frac
    warm = e / peak
    decay = (num_epochs - e) / (num_epochs - peak)
    return base_lr * min(max(min(warm, decay), 0.0), 1.0)
