"""Parameter initializers. Each appends an op to the startup program that
fills the parameter, exactly as `paddle_tpu/initializer.py` does; the
startup program then runs those ops on the executor's device with an
explicit `torch.Generator` (ops/tensor_ops.py). The values differ from the
JAX package's (threefry vs Philox), which is why the tests carry weights
across by name instead of re-initialising."""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "Initializer",
    "Constant",
    "ConstantInitializer",
    "Uniform",
    "UniformInitializer",
    "Normal",
    "NormalInitializer",
    "TruncatedNormal",
    "TruncatedNormalInitializer",
    "Xavier",
    "XavierInitializer",
    "NumpyArrayInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant",
            {},
            {"Out": [var.name]},
            {"shape": list(var.shape), "value": float(self.value), "dtype": var.dtype},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random",
            {},
            {"Out": [var.name]},
            {
                "shape": list(var.shape),
                "min": self.low,
                "max": self.high,
                "seed": self.seed,
                "dtype": var.dtype,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random",
            {},
            {"Out": [var.name]},
            {
                "shape": list(var.shape),
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
                "dtype": var.dtype,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random",
            {},
            {"Out": [var.name]},
            {
                "shape": list(var.shape),
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
                "dtype": var.dtype,
            },
        )


class XavierInitializer(Initializer):
    """Glorot: uniform (default) or normal, from the fans of the shape."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """Fills the parameter with a given array through one `assign_value`
    op: float values (float, bfloat16 vars) as `fp32_values`, others as
    `int32_values`, as `paddle_tpu/initializer.py:176-197` emits it."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        values = self.value.astype(
            "float32" if var.dtype.startswith("float") or var.dtype == "bfloat16"
            else var.dtype
        )
        key = "fp32_values" if values.dtype == np.float32 else "int32_values"
        return block.append_op(
            "assign_value",
            {},
            {"Out": [var.name]},
            {
                "shape": list(var.shape),
                "dtype": var.dtype,
                key: values.flatten().tolist(),
            },
        )


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
