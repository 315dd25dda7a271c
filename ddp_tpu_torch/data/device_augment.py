"""On-device RandomCrop(32, pad 4) + HFlip for the resident path
(counterpart of ``ddp_tpu/data/device_augment.py``).

The crop and flip are direct indexing with a zero fill (torchvision's
RandomCrop fill=0); the JAX package writes them as one-hot matrix products
because gathers are slow on the TPU.  The draws are arguments: the trainer
makes them from a device :class:`torch.Generator` (:func:`make_draws`), and
the tests pass the JAX package's, so the two packages augment alike.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.gather import gather_rows

PAD = 4
SIZE = 32

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def make_draws(generator: torch.Generator, n: int,
               device: torch.device) -> Draws:
    """``(ys, xs, flip)``: crop offsets uniform over [0, 2*PAD] and flips
    with probability 0.5, for ``n`` images."""
    ys, xs = torch.randint(0, 2 * PAD + 1, (2, n), generator=generator,
                           device=device)
    flip = torch.rand(n, generator=generator, device=device) < 0.5
    return ys, xs, flip


def crop_flip(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
              flip: torch.Tensor) -> torch.Tensor:
    """``[N,32,32,C]`` (any dtype) -> the same shape and dtype: image i is
    padded by PAD zeros, cropped at row ``ys[i]``, column ``xs[i]``, then
    mirrored left-right where ``flip[i]``."""
    n = imgs.shape[0]
    row = torch.arange(SIZE, device=imgs.device)
    y_src = ys[:, None] + row[None, :] - PAD                       # [N, 32]
    x_cols = torch.where(flip[:, None], SIZE - 1 - row[None, :], row[None, :])
    x_src = xs[:, None] + x_cols - PAD                             # [N, 32]
    inside = (((y_src >= 0) & (y_src < SIZE))[:, :, None]
              & ((x_src >= 0) & (x_src < SIZE))[:, None, :])       # [N,32,32]
    out = imgs[torch.arange(n, device=imgs.device)[:, None, None],
               y_src.clamp(0, SIZE - 1)[:, :, None],
               x_src.clamp(0, SIZE - 1)[:, None, :]]
    return out * inside[..., None].to(imgs.dtype)


def gather_crop_flip(table: torch.Tensor, idx_row: torch.Tensor,
                     draws: Draws) -> torch.Tensor:
    """Batch gather from the resident ``table`` (the row-gather kernel on
    the card), then :func:`crop_flip` with ``draws``: the uint8 composition
    that ``ops/gather.py::gather_batch`` fuses with u8/255 and the labels."""
    return crop_flip(gather_rows(table, idx_row), *draws)
