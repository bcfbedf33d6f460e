"""Python operator overloads on Variable, as `paddle_tpu/layers/
math_op_patch.py` installs them. Ported so far are the two that the BERT
pretraining head writes (`mask_pos + row_id * seq_len`): `x + y` and
`x * y` with a Variable, or with a Python int on an integer Variable (an
elementwise op with a filled constant). Other operands raise TypeError;
the JAX package turns a float scalar into a `scale` op, which no ported
model uses yet."""

from __future__ import annotations

from ..framework import FLOAT_DTYPES, Variable, convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["monkey_patch_variable"]


def _const_like(x, value):
    helper = LayerHelper("fill_constant")
    out = helper.create_variable_for_type_inference(x.dtype, (1,))
    helper.append_op(type="fill_constant", inputs={}, outputs={"Out": [out]},
                     attrs={"shape": [1], "dtype": str(x.dtype), "value": float(value)})
    return out


def _elementwise(op_type, x, y):
    helper = LayerHelper(op_type)
    shape = x.shape if len(x.shape or ()) >= len(y.shape or ()) else y.shape
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs={"axis": -1})
    return out


def _binary(op_type):
    def impl(self, other):
        if isinstance(other, Variable):
            return _elementwise(op_type, self, other)
        if (isinstance(other, int) and not isinstance(other, bool)
                and convert_dtype(self.dtype) not in FLOAT_DTYPES):
            return _elementwise(op_type, self, _const_like(self, other))
        return NotImplemented

    return impl


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__mul__ = _binary("elementwise_mul")
