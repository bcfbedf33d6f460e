"""IMDB sentiment reader API (reference: python/paddle/dataset/imdb.py) with
synthetic data (zero-egress): positive reviews draw tokens from the upper
vocab half, negative from the lower, so the task is learnable."""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "word_dict"]

_VOCAB = 5148  # reference imdb vocab size after cutoff


def word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _gen(n, seed, max_len=100):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(10, max_len))
            half = _VOCAB // 2
            lo, hi = (half, _VOCAB) if label else (1, half)
            words = rng.randint(lo, hi, length).astype("int64")
            yield list(words), label

    return reader


def train(word_idx=None, n=4096, seed=0):
    return _gen(n, seed)


def test(word_idx=None, n=1024, seed=1):
    return _gen(n, seed)
