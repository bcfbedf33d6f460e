"""CIFAR reader API (reference: python/paddle/dataset/cifar.py), synthetic."""

from __future__ import annotations

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]


def _gen(n, classes, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            y = int(rng.randint(0, classes))
            img = 0.1 * rng.randn(3, 32, 32).astype("float32")
            img[y % 3, :, (y * 3) % 30 : (y * 3) % 30 + 3] += 1.0
            yield img.reshape(-1), y

    return reader


def train10(n=8192, seed=0):
    return _gen(n, 10, seed)


def test10(n=2048, seed=1):
    return _gen(n, 10, seed)


def train100(n=8192, seed=0):
    return _gen(n, 100, seed)


def test100(n=2048, seed=1):
    return _gen(n, 100, seed)
