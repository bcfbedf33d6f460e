"""MNIST reader API (reference: python/paddle/dataset/mnist.py) with
synthetic separable digits (class k lights a band at column 2k)."""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]


def _gen(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            y = int(rng.randint(0, 10))
            img = 0.1 * rng.randn(784).astype("float32")
            img2 = img.reshape(28, 28)
            img2[:, y * 2 : y * 2 + 3] += 1.0
            yield img2.reshape(784), y

    return reader


def train(n=8192, seed=0):
    return _gen(n, seed)


def test(n=2048, seed=1):
    return _gen(n, seed)
