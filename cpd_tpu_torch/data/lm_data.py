"""Synthetic token streams for LM training (port of
`cpd_tpu/data/lm_data.py`, bitwise: the same numpy `RandomState` draws
and the same Markov chain).

Sequences follow a deterministic order-1 Markov chain with
class-structured transitions, so short training runs show a clearly
decreasing loss.  The transition table is built in place (one V x V
float64 array: 8 GB at V = 32000, where the JAX version's temporaries
take three times that); its values are the JAX version's bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["SyntheticText"]


class SyntheticText:
    """n sequences of length seq_len + 1; batch() returns (tokens, targets)
    as the usual next-token split."""

    def __init__(self, n: int = 4096, seq_len: int = 128,
                 vocab_size: int = 256, seed: int = 0):
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self._seed = seed
        self.labels = np.zeros(n, np.int32)   # dataset contract
        self._n = n
        # banded transition matrix: from token t, mass concentrated on
        # {t-1, t+1, t+7 mod V} — learnable, low-entropy
        rng = np.random.RandomState(seed)
        cum = rng.rand(vocab_size, vocab_size)
        cum *= 0.05
        idx = np.arange(vocab_size)
        cum[idx, (idx + 1) % vocab_size] += 2.0
        cum[idx, (idx - 1) % vocab_size] += 1.0
        cum[idx, (idx + 7) % vocab_size] += 1.0
        cum /= cum.sum(1, keepdims=True)
        for lo in range(0, vocab_size, 1024):      # row blocks, in place
            rows = cum[lo:lo + 1024]
            rows[...] = np.cumsum(rows, axis=1)
        self._cum = cum

    def __len__(self) -> int:
        return self._n

    def batch(self, indices: Sequence[int], seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
        indices = np.asarray(indices)
        out = np.empty((len(indices), self.seq_len + 1), np.int32)
        for i, idx in enumerate(indices):
            rng = np.random.RandomState((self._seed * 1_000_003 + int(idx))
                                        % (2 ** 31))
            tok = rng.randint(0, self.vocab_size)
            for t in range(self.seq_len + 1):
                out[i, t] = tok
                tok = int(np.searchsorted(self._cum[tok], rng.rand()))
        return out[:, :-1], out[:, 1:]
