"""Tensor creation layers of the training slice. Each emits the same op
types, slots and attrs as its `paddle_tpu/layers/tensor.py` counterpart."""

from __future__ import annotations

import numpy as np

from ..framework import Variable, default_startup_program
from ..layer_helper import LayerHelper

__all__ = [
    "create_global_var",
    "sums",
    "assign",
    "fill_constant",
    "fill_constant_batch_size_like",
]


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False,
                      name=None):
    """A global var filled with `value` by the startup program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(shape=shape, dtype=dtype,
                                        persistable=persistable, name=name)
    sb = default_startup_program().global_block()
    sb.create_var(name=var.name, shape=tuple(shape), dtype=dtype, persistable=persistable)
    sb.append_op("fill_constant", {}, {"Out": [var.name]},
                 {"shape": list(shape), "value": float(value), "dtype": dtype})
    default_startup_program().bump_version()
    return var


def sums(input, out=None):
    helper = LayerHelper("sum")
    xs = input if isinstance(input, (list, tuple)) else [input]
    if out is None:
        out = helper.create_variable_for_type_inference(xs[0].dtype, xs[0].shape)
    helper.append_op(type="sum", inputs={"X": xs}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """A Variable through an `assign` op; an array (numpy or nested lists)
    through an `assign_value` op that holds its values."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype, input.shape)
        helper.append_op(type="assign", inputs={"X": [input]}, outputs={"Out": [output]})
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(str(arr.dtype), arr.shape)
    key = "fp32_values" if arr.dtype == np.float32 else "int32_values"
    helper.append_op(
        type="assign_value",
        inputs={},
        outputs={"Out": [output]},
        attrs={"shape": list(arr.shape), "dtype": str(arr.dtype),
               key: arr.flatten().tolist()},
    )
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op(type="fill_constant", inputs={}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype, "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value),
               "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx},
    )
    out.stop_gradient = True
    return out
