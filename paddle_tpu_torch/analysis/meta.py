"""VarMeta: the static (shape, dtype) abstraction the analysis layer
computes per variable (the port's copy of `paddle_tpu/analysis/meta.py`).

Dtypes live in *lowered* space: the dtype a value has when the port's
walk runs it (ops/registry.py TORCH_DTYPE: IR "float64" runs as float32,
and "int64" stays int64, where the JAX package runs it as int32).

Shapes are tuples of ints, or None when unknown (a feed whose concrete
shape the caller did not supply, or anything downstream of an op with no
shape function). Helpers short-circuit None so shape functions stay
one-liners.
"""

from __future__ import annotations

import math
from typing import NamedTuple

__all__ = [
    "VarMeta",
    "InferError",
    "Unknown",
    "lowered_dtype",
    "itemsize",
    "promote",
    "is_float",
    "broadcast_shapes",
    "ew_broadcast",
    "conv_out_dim",
    "pool_out_dim",
    "prod",
]

# mirrors ops/registry.py _TORCH_DTYPES
_LOWERED = {
    "float32": "float32",
    "float64": "float32",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "bool": "bool",
}

_ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1, "uint8": 1,
             "int16": 2, "int32": 4, "int64": 8, "bool": 1}

_FLOATS = ("float16", "bfloat16", "float32")


class InferError(ValueError):
    """A shape function hit a real structural problem (incompatible
    broadcast, bad axis, malformed attrs). The engine records these as
    error entries and poisons the op's outputs."""


class Unknown(Exception):
    """A shape function could not proceed because an INPUT meta is
    unknown: not an error, just no information. The engine poisons the
    outputs silently."""


class VarMeta(NamedTuple):
    shape: tuple | None  # concrete dims, or None = unknown
    dtype: str | None  # lowered dtype name, or None = unknown

    def with_shape(self, shape):
        return VarMeta(tuple(shape) if shape is not None else None, self.dtype)

    def with_dtype(self, dtype):
        return VarMeta(self.shape, lowered_dtype(dtype) if dtype else None)


def lowered_dtype(dtype) -> str:
    """IR dtype label -> the lowered on-device dtype name."""
    from ..framework import convert_dtype

    name = dtype if isinstance(dtype, str) and dtype in _LOWERED else convert_dtype(dtype)
    try:
        return _LOWERED[name]
    except KeyError:
        raise InferError(f"no lowered dtype for {dtype!r}")


def itemsize(dtype) -> int:
    """Bytes per element of a lowered dtype name."""
    return _ITEMSIZE[dtype]


def is_float(dtype) -> bool:
    return dtype in _FLOATS


def promote(*dtypes) -> str | None:
    """torch's dtype promotion over lowered dtype names (None poisons to
    None), as the lowerings promote."""
    import torch

    out = None
    for d in dtypes:
        if d is None:
            return None
        if out is None or out == d:
            out = d
            continue
        out = str(torch.promote_types(getattr(torch, out), getattr(torch, d))).replace(
            "torch.", "")
    return out


def broadcast_shapes(*shapes) -> tuple | None:
    """Numpy-rule broadcast; None in, None out."""
    out: list = []
    for s in shapes:
        if s is None:
            return None
        s = tuple(s)
        if len(s) > len(out):
            out = [1] * (len(s) - len(out)) + out
        pad = [1] * (len(out) - len(s)) + list(s)
        for i, (a, b) in enumerate(zip(out, pad)):
            if a == 1:
                out[i] = b
            elif b != 1 and a != b:
                raise InferError(f"cannot broadcast shapes {shapes}")
    return tuple(out)


def ew_broadcast(x_shape, y_shape, axis) -> tuple | None:
    """Fluid elementwise broadcast: Y aligns against X starting at
    `axis`, then numpy broadcast."""
    if x_shape is None or y_shape is None:
        return None
    if len(x_shape) == len(y_shape):
        return broadcast_shapes(x_shape, y_shape)
    if axis is None or axis == -1:
        axis = len(x_shape) - len(y_shape)
    aligned = [1] * len(x_shape)
    for i, s in enumerate(y_shape):
        aligned[axis + i] = s
    return broadcast_shapes(x_shape, tuple(aligned))


def conv_out_dim(size, k_eff, pad, stride) -> int:
    """One spatial dim of a conv/window output. `pad` is (lo, hi) pairs,
    "SAME" or "VALID"."""
    if pad == "SAME":
        return -(-size // stride)
    if pad == "VALID":
        return (size - k_eff) // stride + 1
    lo, hi = pad
    return (size + lo + hi - k_eff) // stride + 1


def pool_out_dim(size, k, pad, stride, ceil_mode=False) -> int:
    """pool2d windowed dim: ceil_mode widens the high pad by stride - 1."""
    if isinstance(pad, str):
        return conv_out_dim(size, k, pad, stride)
    lo, hi = pad
    if ceil_mode:
        hi += stride - 1
    return (size + lo + hi - k) // stride + 1


def prod(seq) -> int:
    return math.prod(seq) if seq else 1
