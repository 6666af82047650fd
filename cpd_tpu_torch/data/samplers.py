"""Deterministic, iteration-based, resumable samplers (port of
`cpd_tpu/data/samplers.py`: the iteration samplers, bitwise).

`DistributedGivenIterationSampler` is the reference recipe
(train_util.py:159-222): seed-0 RandomState, dataset indices capped at
all_size BEFORE tiling, tiled to all_size, ONE whole-schedule shuffle, a
contiguous per-rank slice; resume by skipping ``last_iter`` batches.
`GivenIterationSampler` is its single-rank form.  Numpy index
generators; the trainer feeds the indices to its array-backed dataset.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

__all__ = ["GivenIterationSampler", "DistributedGivenIterationSampler"]


def _gen_new_list(dataset_len: int, total_size: int, world_size: int,
                  rank: int, seed: int) -> np.ndarray:
    """Bit-exact transcription of the reference schedule recipe
    (train_util.py:196-215): cap-at-all_size, tile, one shuffle, contiguous
    rank slice."""
    all_size = total_size * world_size
    indices = np.arange(dataset_len)
    indices = indices[:all_size]                    # the :204 cap quirk
    num_repeat = (all_size - 1) // indices.shape[0] + 1
    indices = np.tile(indices, num_repeat)
    indices = indices[:all_size]
    rng = np.random.RandomState(seed)               # == np.random.seed(0)
    rng.shuffle(indices)                            # ONE global shuffle :208
    beg = total_size * rank
    return indices[beg:beg + total_size]


class GivenIterationSampler:
    """Fixed-length schedule of total_iter*batch_size indices, seed-shuffled
    (train_util.py:110-156).  Iterating yields single indices; `last_iter`
    skips the first `last_iter + 1` batches on resume."""

    def __init__(self, dataset_len: int, total_iter: int, batch_size: int,
                 seed: int = 0, last_iter: int = -1):
        self.dataset_len = dataset_len
        self.total_iter = total_iter
        self.batch_size = batch_size
        self.seed = seed
        self.last_iter = last_iter
        self.indices = self._gen_indices()

    def _gen_indices(self) -> np.ndarray:
        return _gen_new_list(self.dataset_len,
                             self.total_iter * self.batch_size,
                             world_size=1, rank=0, seed=self.seed)

    def __iter__(self) -> Iterator[int]:
        start = (self.last_iter + 1) * self.batch_size
        return iter(self.indices[start:])

    def __len__(self) -> int:
        return self.total_iter * self.batch_size

    def batches(self) -> Iterator[np.ndarray]:
        start = self.last_iter + 1
        for it in range(start, self.total_iter):
            lo = it * self.batch_size
            yield self.indices[lo:lo + self.batch_size]


class DistributedGivenIterationSampler(GivenIterationSampler):
    """Per-rank slice of the global schedule (train_util.py:159-222).

    The reference builds world*total*batch indices by seed-0 shuffling and
    tiling, then takes the rank-th contiguous block (`beg = total_size//world
    * rank`, train_util.py:212-215) — contiguous block, NOT strided."""

    def __init__(self, dataset_len: int, total_iter: int, batch_size: int,
                 world_size: int = 1, rank: int = 0, seed: int = 0,
                 last_iter: int = -1):
        self.world_size = world_size
        self.rank = rank
        super().__init__(dataset_len, total_iter, batch_size, seed, last_iter)

    def _gen_indices(self) -> np.ndarray:
        return _gen_new_list(self.dataset_len,
                             self.total_iter * self.batch_size,
                             world_size=self.world_size, rank=self.rank,
                             seed=self.seed)
