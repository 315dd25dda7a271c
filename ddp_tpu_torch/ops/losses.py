"""Losses (counterpart of ``ddp_tpu/ops/losses.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy_per_example(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy in float32, as
    ``F.cross_entropy(..., reduction='none')``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return logz - picked


def cross_entropy_sum_count(logits: torch.Tensor, labels: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE over valid examples, valid count).  The train step takes
    the mean as sum/count, so a padded batch with a mask gives the same
    loss as the unpadded one."""
    ce = cross_entropy_per_example(logits, labels)
    if mask is None:
        # torch.full, not torch.tensor: a fill kernel, no host-to-device
        # copy that would wait for the stream.
        return ce.sum(), torch.full((), float(ce.shape[0]), device=ce.device)
    maskf = mask.float()
    return (ce * maskf).sum(), maskf.sum()
