"""Host-side CIFAR train-time augmentation for the streaming path
(counterpart of ``ddp_tpu/data/augment.py``, draw for draw).

The reference's transforms (singlegpu.py:154-160) are RandomCrop(32,
padding=4) + RandomHorizontalFlip + ToTensor.  Here a whole batch is cropped
and flipped at once on the host: the C++ library (``data/native.py``) where
it built, else one vectorised numpy gather.  ToTensor's u8/255 happens on
the card, in the ``gather_batch`` kernel, so a batch crosses the bus as
uint8.
"""
from __future__ import annotations

import numpy as np

from . import native

PAD = 4
SIZE = 32


def random_crop_flip(batch: np.ndarray, rng: np.random.Generator
                     ) -> np.ndarray:
    """[N,32,32,3] uint8 -> augmented [N,32,32,3] uint8.

    Zero padding and uniform offsets as torchvision's RandomCrop (fill=0);
    flip probability 0.5.  The draws are ``rng.integers`` for the rows, then
    for the columns, then ``rng.random`` for the flips, the JAX package's
    order, so the same ``rng`` gives the same bytes in both packages."""
    n = batch.shape[0]
    ys = rng.integers(0, 2 * PAD + 1, n)
    xs = rng.integers(0, 2 * PAD + 1, n)
    flip = rng.random(n) < 0.5
    out = native.crop_flip(batch, ys, xs, flip)
    if out is not None:
        return out
    return _numpy_crop_flip(batch, ys, xs, flip)


def _numpy_crop_flip(batch: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                     flip: np.ndarray) -> np.ndarray:
    """The numpy version (one batched gather): the fallback, and the C++
    library's reference in the tests."""
    n = batch.shape[0]
    padded = np.pad(batch, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)))
    row = np.arange(SIZE)
    out = padded[np.arange(n)[:, None, None],
                 (ys[:, None] + row)[:, :, None],
                 (xs[:, None] + row)[:, None, :], :]
    out[flip] = out[flip, :, ::-1]
    return out

