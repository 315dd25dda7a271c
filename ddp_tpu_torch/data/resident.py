"""Device-resident dataset: the whole set lives in the card's memory
(counterpart of ``ddp_tpu/data/resident.py``).

The uint8 images (~150 MB for CIFAR-10's 50,000 training images) are copied
to the device once; each step gathers its batch by index there
(:func:`~ddp_tpu_torch.ops.gather.gather_batch`), so an epoch moves only
its int32 index matrix from the host.  In a data-parallel run every rank
holds the whole set on its own device and gathers its own columns, so the
budget is checked per device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cifar10 import Dataset

# Share of the card's free memory the dataset may take; the rest stays for
# weights, momentum, activations and the allocator's working set.
MEMORY_BUDGET_FRACTION = 0.8


def _device_bytes_free(device: torch.device) -> Optional[int]:
    """Free bytes on ``device``, or None for the CPU (tests monkeypatch this
    seam)."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return free


class ResidentData:
    """``dataset.images`` as a uint8 ``[N,32,32,3]`` tensor and its labels as
    int64 ``[N]`` on ``device``.

    Raises :class:`ValueError` before any copy when the dataset would not fit
    the budget; the ToTensor scaling (u8/255) happens as each step gathers
    its batch, so the card holds the set at a quarter of its float32 size."""

    def __init__(self, dataset: Dataset, device: torch.device):
        images = np.ascontiguousarray(dataset.images)
        labels = np.ascontiguousarray(dataset.labels, dtype=np.int64)
        free = _device_bytes_free(device)
        needed = images.nbytes + labels.nbytes
        if free is not None and needed > MEMORY_BUDGET_FRACTION * free:
            raise ValueError(
                f"resident mode keeps the whole dataset in device memory, "
                f"but this dataset is {needed / 2**20:,.0f} MiB and the "
                f"budget is {MEMORY_BUDGET_FRACTION * free / 2**20:,.0f} MiB "
                f"({MEMORY_BUDGET_FRACTION:.0%} of the "
                f"{free / 2**20:,.0f} MiB free on {device}).  Shrink the "
                f"dataset.")
        self.images = torch.from_numpy(images).to(device)
        self.labels = torch.from_numpy(labels).to(device)
