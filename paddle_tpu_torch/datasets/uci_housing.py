"""UCI housing reader API (reference: python/paddle/dataset/uci_housing.py),
synthetic linear data (13 features -> price)."""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]

_W = None


def _w():
    global _W
    if _W is None:
        _W = np.random.RandomState(123).randn(13).astype("float32")
    return _W


def _gen(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        w = _w()
        for _ in range(n):
            x = rng.randn(13).astype("float32")
            y = float(x @ w + 0.05 * rng.randn())
            yield x, np.array([y], dtype="float32")

    return reader


def train(n=404, seed=0):
    return _gen(n, seed)


def test(n=102, seed=1):
    return _gen(n, seed)
