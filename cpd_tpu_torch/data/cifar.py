"""CIFAR-10 dataset + batch pipeline, host-side numpy, NHWC (port of
`cpd_tpu/data/cifar.py`, bitwise: the same numpy operations in the same
order).

Loading is array-at-once: the whole 50k x 32 x 32 x 3 uint8 cube lives in
host RAM, augmentation is vectorized (augment.py), and a batch goes to
the device as one NHWC array (the train step makes it NCHW there).

If no CIFAR-10 copy exists on disk, a deterministic synthetic stand-in
with class-dependent structure is generated; the real pickle folder is
picked up when present.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Iterator, Optional, Tuple

import numpy as np

from .augment import (Crop, Cutout, FlipLR, TransformPipeline, normalise,
                      pad_reflect)

__all__ = ["load_cifar10", "CIFAR10Pipeline", "synthetic_cifar10"]

_CIFAR_DIRS = ("cifar-10-batches-py",)
# searched when no root is given: the checkout's own data/ folder
_DEFAULT_ROOTS = ("./data",)


def _load_pickle_batches(folder: str) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
    xs, ys = [], []
    for i in range(1, 6):
        with open(os.path.join(folder, f"data_batch_{i}"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(d[b"labels"])
    train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    train_y = np.concatenate(ys).astype(np.int32)
    with open(os.path.join(folder, "test_batch"), "rb") as f:
        d = pickle.load(f, encoding="bytes")
    test_x = np.asarray(d[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    test_y = np.asarray(d[b"labels"], np.int32)
    return train_x.astype(np.uint8), train_y, test_x.astype(np.uint8), test_y


def synthetic_cifar10(n_train: int = 50000, n_test: int = 10000,
                      seed: int = 0):
    """Deterministic synthetic CIFAR-shaped data whose pixel statistics
    depend on the label, so short training runs show real learning signal
    (loss decreases, APS-vs-no-APS ordering is observable)."""
    rng = np.random.RandomState(seed)

    def make(n):
        y = rng.randint(0, 10, size=n).astype(np.int32)
        x = rng.randint(0, 256, size=(n, 32, 32, 3)).astype(np.float32)
        # class-dependent low-frequency pattern: mean shift + per-class
        # spatial gradient, strong enough to be learnable.
        yy, xx = np.mgrid[0:32, 0:32] / 31.0
        for c in range(10):
            m = y == c
            pattern = (np.cos(2 * np.pi * (c + 1) * yy / 10.0)
                       + np.sin(2 * np.pi * (c + 1) * xx / 10.0))
            x[m] = 0.5 * x[m] + 0.5 * (128 + 64 * pattern)[None, :, :, None] \
                + 8.0 * c
        return np.clip(x, 0, 255).astype(np.uint8), y

    train_x, train_y = make(n_train)
    test_x, test_y = make(n_test)
    return train_x, train_y, test_x, test_y


def load_cifar10(root: Optional[str] = None, allow_synthetic: bool = True):
    """Return (train_x u8 NHWC, train_y, test_x, test_y); real data if found
    under `root` (or common roots), else synthetic (see module docstring).

    An EXPLICIT `root` is strict: if no CIFAR-10 tree is found there, this
    raises instead of silently training on synthetic data (a typo'd
    --data-root must not fabricate a run that looks real).  The synthetic
    fallback applies only to the no-root default search."""
    if root:
        allow_synthetic = False
    roots = [root] if root else list(_DEFAULT_ROOTS)
    for r in roots:
        if not r:
            continue
        for d in _CIFAR_DIRS:
            folder = os.path.join(r, d)
            if os.path.isfile(os.path.join(folder, "data_batch_1")):
                return _load_pickle_batches(folder)
        tgz = os.path.join(r or ".", "cifar-10-python.tar.gz")
        if os.path.isfile(tgz):
            with tarfile.open(tgz) as tf:
                tf.extractall(r)
            folder = os.path.join(r, _CIFAR_DIRS[0])
            if os.path.isfile(os.path.join(folder, "data_batch_1")):
                return _load_pickle_batches(folder)
    if not allow_synthetic:
        raise FileNotFoundError(f"CIFAR-10 not found under {roots}")
    return synthetic_cifar10()


class CIFAR10Pipeline:
    """Epoch iterator producing augmented, normalised NHWC fp32 batches.

    Augmentation recipe = the DavidNet one (pad 4 reflect -> random 32x32
    crop -> flip -> cutout 8x8, dawn.py:66) with per-epoch pre-sampled
    choices; `augment=False` gives the eval pipeline (normalise only)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, augment: bool = True, cutout: int = 8,
                 drop_last: bool = True):
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = batch_size
        self.augment = augment
        self.drop_last = drop_last
        base = normalise(images.astype(np.float32))
        self._choice_seed: Optional[int] = None
        if augment:
            self.data = pad_reflect(base, 4)
            transforms = [Crop(32, 32), FlipLR()]
            if cutout:
                transforms.append(Cutout(cutout, cutout))
            self.pipeline = TransformPipeline(transforms, self.data.shape)
        else:
            self.data = base
            self.pipeline = None

    def batch(self, indices: np.ndarray, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """One batch for explicit `indices` (iteration-based samplers).
        Choices are re-drawn only when `seed` changes, matching the
        reference's once-per-epoch set_random_choices (utils.py:138-145)."""
        indices = np.asarray(indices)
        if self.pipeline is not None:
            if self._choice_seed != seed:
                self.pipeline.resample(seed)
                self._choice_seed = seed
            x = self.pipeline.apply(self.data, indices)
        else:
            x = self.data[indices]
        return x, self.labels[indices]

    def __len__(self) -> int:
        n = len(self.labels)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, indices: np.ndarray, seed: int = 0,
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) batches for a precomputed index order (from a
        sampler in data/samplers.py)."""
        if self.pipeline is not None:
            self.pipeline.resample(seed)
            self._choice_seed = seed   # keep batch()'s cache coherent
        bs = self.batch_size
        limit = len(indices) - (len(indices) % bs if self.drop_last else 0)
        for lo in range(0, limit, bs):
            idx = np.asarray(indices[lo:lo + bs])
            if self.pipeline is not None:
                x = self.pipeline.apply(self.data, idx)
            else:
                x = self.data[idx]
            yield x, self.labels[idx]
