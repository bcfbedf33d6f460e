"""Dygraph — imperative mode (paddle_tpu/dygraph/; reference
paddle/fluid/imperative/ + python/paddle/fluid/dygraph/). Ops run eagerly
on torch tensors and a define-by-run tape supplies `loss.backward()`
(autograd.py, over torch autograd). `fluid.dygraph.guard(place)` flips the
mode and names the device: `CUDAPlace(0)` unless the caller passes
another place (`fluid.CPUPlace()` for the CPU); with no card and no place
it raises. The JIT bridge (jit.py) runs a dygraph train step as one CUDA
graph replay."""

from __future__ import annotations

import contextlib

from .autograd import Tracer, VarBase, _host_to_tensor, no_grad, record
from .checkpoint import (load_dygraph, load_persistables,
                         save_dygraph, save_persistables)
from .learning_rate_scheduler import (  # noqa: F401
    CosineDecay,
    ExponentialDecay,
    InverseTimeDecay,
    LearningRateDecay,
    NaturalExpDecay,
    NoamDecay,
    PiecewiseDecay,
    PolynomialDecay,
)
from .jit import TracedLayer, to_compiled
from .layers import Layer
from .nn import (
    FC,
    BatchNorm,
    BilinearTensorProduct,
    Conv2D,
    Conv2DTranspose,
    Conv3D,
    Conv3DTranspose,
    Dropout,
    Embedding,
    GRUUnit,
    LayerNorm,
    Linear,
    Pool2D,
    PRelu,
    GroupNorm,
    RowConv,
    SequenceConv,
    SpectralNorm,
    TreeConv,
)
from .nn import NCE  # noqa: F401
from .parallel import DataParallel, ParallelEnv, prepare_context

__all__ = [
    "guard", "enabled", "to_variable", "no_grad", "Tracer", "VarBase",
    "TracedLayer", "to_compiled", "jit",
    "Layer", "Linear", "FC", "Conv2D", "Pool2D", "BatchNorm", "Embedding",
    "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
    "BilinearTensorProduct", "SequenceConv", "RowConv", "GroupNorm",
    "SpectralNorm", "TreeConv", "NCE",
    "LayerNorm", "Dropout", "GRUUnit", "PRelu", "save_dygraph", "load_dygraph",
    "save_persistables", "load_persistables",
    "LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
    "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
    "CosineDecay", "NoamDecay",
    "DataParallel",
    "ParallelEnv", "prepare_context",
]

_tracer: Tracer | None = None
_place = None  # the active guard's place


def enabled() -> bool:
    return _tracer is not None


# the executor/layers graph path checks this to reject mixed-mode use
def _current_tracer():
    return _tracer


def _current_place():
    return _place


@contextlib.contextmanager
def guard(place=None):
    """Enter imperative mode on `place` (reference: dygraph/base.py guard):
    CUDAPlace(0) by default, which raises without a card."""
    from ..place import CUDAPlace

    global _tracer, _place
    place = place if place is not None else CUDAPlace(0)
    place.torch_device()  # no card for a CUDAPlace: raise here
    old = _tracer, _place
    _tracer, _place = Tracer(), place
    try:
        yield
    finally:
        _tracer, _place = old


def to_variable(value, name=None, zero_copy=None):
    """numpy array / tensor -> VarBase on the guard's device (reference:
    dygraph/base.py to_variable)."""
    if isinstance(value, VarBase):
        return value
    from .autograd import current_device

    if hasattr(value, "detach"):
        value = value.detach().to(current_device())
    else:
        value = _host_to_tensor(value)
    return VarBase(value, stop_gradient=True, name=name)
