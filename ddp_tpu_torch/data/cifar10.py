"""CIFAR-10 datasets (counterpart of ``ddp_tpu/data/cifar10.py``).

:func:`load` reads the python-pickle batches (``cifar-10-batches-py/
data_batch_{1..5}`` and ``test_batch``) that torchvision's download leaves;
the port downloads nothing.  :func:`synthetic` is a copy of the JAX
package's, draw for draw, so both packages make identical datasets from one
seed.
"""
from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Tuple

import numpy as np

DEFAULT_ROOT = "data/cifar10"
_BATCH_DIR = "cifar-10-batches-py"
NUM_CLASSES = 10


class Dataset(NamedTuple):
    images: np.ndarray  # uint8 [N,32,32,3] (NHWC)
    labels: np.ndarray  # int32 [N]

    def __len__(self) -> int:
        return len(self.images)


def _load_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    # The pickles are the dataset's own files, read from the local root the
    # user names; nothing here is fetched.
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d.get(b"labels", d.get(b"fine_labels")), np.int32)
    return np.ascontiguousarray(imgs), labels


def load(root: str = DEFAULT_ROOT) -> Tuple[Dataset, Dataset]:
    """(train 50k, test 10k) from the standard pickle layout under ``root``."""
    base = os.path.join(root, _BATCH_DIR)
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"CIFAR-10 not found under {base!r}.  Place the extracted "
            f"'cifar-10-batches-py' directory there (torchvision's download "
            f"layout), or run with --synthetic.")
    parts = [_load_batch(os.path.join(base, f"data_batch_{i}"))
             for i in range(1, 6)]
    train = Dataset(np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
    test = Dataset(*_load_batch(os.path.join(base, "test_batch")))
    return train, test


def synthetic(n_train: int = 2048, n_test: int = 512, seed: int = 0,
              label_noise: float = 0.0) -> Tuple[Dataset, Dataset]:
    """Deterministic fake CIFAR with a learnable signal: the label is
    encoded in each image's mean brightness.  ``label_noise`` relabels that
    fraction of examples from an independent stream, so images and clean
    labels are the same at every noise level."""
    rng = np.random.default_rng(seed)
    noise_rng = np.random.default_rng([seed, 0x5EED_10])

    def make(n: int) -> Dataset:
        labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
        base = rng.integers(0, 64, (n, 32, 32, 3))
        imgs = np.clip(base + (labels * 18)[:, None, None, None],
                       0, 255).astype(np.uint8)
        if label_noise > 0.0:
            flip = noise_rng.random(n) < label_noise
            labels = np.where(
                flip,
                noise_rng.integers(0, NUM_CLASSES, n).astype(np.int32),
                labels)
        return Dataset(imgs, labels)

    return make(n_train), make(n_test)
