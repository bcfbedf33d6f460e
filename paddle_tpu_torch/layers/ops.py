"""Unary layers over ported lowerings (paddle_tpu/layers/ops.py:13-62):
each emits one op of its own name with X in and Out out."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["sigmoid", "tanh", "sqrt", "square", "sign"]


def _make(op_type):
    def f(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]})
        return out

    f.__name__ = op_type
    f.__doc__ = f"the {op_type} op of ops/math_ops.py, elementwise"
    return f


sigmoid = _make("sigmoid")
tanh = _make("tanh")
sqrt = _make("sqrt")
square = _make("square")
sign = _make("sign")
