"""Batched, pre-sampled-choice augmentation, NHWC numpy (port of
`cpd_tpu/data/augment.py`, bitwise: the same numpy operations in the
same order, so one seed gives the same choices and the same pixels).

`normalise` (mean/std in 0-255 units), reflect `pad_reflect`, and the
`Crop` / `FlipLR` / `Cutout` transforms, whose random choices are drawn
once per epoch for the whole dataset (`TransformPipeline.resample`).
`TransformPipeline.apply` runs the canonical chains, ``[Crop, FlipLR]``
and ``[Crop, FlipLR, Cutout]`` on float32 data, as one threaded C++ pass
(`native.fused_augment_np`, bitwise this numpy chain: pure copies and
zeros) wherever the port's native library builds, as the JAX package
does; other chains, and hosts without a C++ compiler, take the numpy
path.  ``fused_calls`` counts the batches the native pass made.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["CIFAR10_MEAN", "CIFAR10_STD", "normalise", "pad_reflect",
           "Crop", "FlipLR", "Cutout", "TransformPipeline"]

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2471, 0.2435, 0.2616)


def normalise(x: np.ndarray, mean=CIFAR10_MEAN, std=CIFAR10_STD) -> np.ndarray:
    """(x - 255*mean) / (255*std) on uint8-scale NHWC input."""
    x = np.asarray(x, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (x - mean * 255.0) / (255.0 * std)


def pad_reflect(x: np.ndarray, border: int = 4) -> np.ndarray:
    """Reflect-pad H and W of an NHWC batch."""
    return np.pad(x, [(0, 0), (border, border), (border, border), (0, 0)],
                  mode="reflect")


class Crop:
    """Random crop to (h, w); choices are (x0, y0) per sample."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def sample_choices(self, rng: np.random.RandomState, n: int, shape):
        H, W = shape[0], shape[1]
        return {"x0": rng.choice(W + 1 - self.w, size=n),
                "y0": rng.choice(H + 1 - self.h, size=n)}

    def output_shape(self, shape):
        return (self.h, self.w, shape[2])

    def __call__(self, x: np.ndarray, choices) -> np.ndarray:
        n = x.shape[0]
        out = np.empty((n, self.h, self.w, x.shape[3]), x.dtype)
        x0, y0 = choices["x0"], choices["y0"]
        for start_x in np.unique(x0):        # few distinct offsets -> few slices
            for start_y in np.unique(y0[x0 == start_x]):
                m = (x0 == start_x) & (y0 == start_y)
                out[m] = x[m, start_y:start_y + self.h,
                           start_x:start_x + self.w, :]
        return out


class FlipLR:
    """Random horizontal flip; the choice is a bool per sample."""

    def sample_choices(self, rng: np.random.RandomState, n: int, shape):
        return {"choice": rng.choice([True, False], size=n)}

    def output_shape(self, shape):
        return shape

    def __call__(self, x: np.ndarray, choices) -> np.ndarray:
        flip = choices["choice"]
        out = x.copy()
        out[flip] = out[flip, :, ::-1, :]
        return out


class Cutout:
    """Zero out a random (h, w) patch per sample."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def sample_choices(self, rng: np.random.RandomState, n: int, shape):
        H, W = shape[0], shape[1]
        return {"x0": rng.choice(W + 1 - self.w, size=n),
                "y0": rng.choice(H + 1 - self.h, size=n)}

    def output_shape(self, shape):
        return shape

    def __call__(self, x: np.ndarray, choices) -> np.ndarray:
        out = x.copy()
        for i in range(x.shape[0]):
            y0, x0 = choices["y0"][i], choices["x0"][i]
            out[i, y0:y0 + self.h, x0:x0 + self.w, :] = 0.0
        return out


class TransformPipeline:
    """Epoch-level pre-sampled augmentation over a full NHWC dataset.

    `resample(seed)` draws all per-sample choices for the epoch;
    `apply(x, indices)` augments the selected samples with their
    pre-drawn choices."""

    def __init__(self, transforms: Sequence, dataset_shape):
        self.transforms = list(transforms)
        self.dataset_shape = tuple(dataset_shape)  # (N, H, W, C)
        self.choices: Optional[list] = None
        self.fused_calls = 0   # batches made by the native fused pass

    def resample(self, seed: int):
        rng = np.random.RandomState(seed)
        n = self.dataset_shape[0]
        shape = self.dataset_shape[1:]
        self.choices = []
        for t in self.transforms:
            self.choices.append(t.sample_choices(rng, n, shape))
            shape = t.output_shape(shape)

    def apply(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        if self.choices is None:
            raise RuntimeError("call resample(seed) before apply()")
        fused = self._apply_fused(x, indices)
        if fused is not None:
            self.fused_calls += 1
            return fused
        out = x[indices]
        for t, ch in zip(self.transforms, self.choices):
            out = t(out, {k: v[indices] for k, v in ch.items()})
        return out

    def _apply_fused(self, x: np.ndarray, indices: np.ndarray
                     ) -> Optional[np.ndarray]:
        """The native Crop -> FlipLR [-> Cutout] pass for the canonical
        chains on float32 data; None for any other chain or where the
        native library is unavailable."""
        kinds = [type(t).__name__ for t in self.transforms]
        if (kinds not in (["Crop", "FlipLR"], ["Crop", "FlipLR", "Cutout"])
                or x.dtype != np.float32):
            return None
        from .. import native
        if not native.available():
            return None
        crop = self.transforms[0]
        crop_ch, flip_ch = self.choices[0], self.choices[1]
        cut = {}
        if len(self.transforms) == 3:
            cut = dict(cut_y=self.choices[2]["y0"],
                       cut_x=self.choices[2]["x0"],
                       cut_h=self.transforms[2].h, cut_w=self.transforms[2].w)
        return native.fused_augment_np(
            x, np.asarray(indices), crop_ch["y0"], crop_ch["x0"], crop.h,
            crop.w, flip_ch["choice"].astype(np.uint8), **cut)
