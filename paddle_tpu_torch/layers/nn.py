"""The neural-net layers the BERT slices build with. Each emits the same
op types, slots and attrs as its `paddle_tpu/layers/nn.py` counterpart,
so the two packages build identical Programs."""

from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..initializer import Constant, Xavier
from ..layer_helper import LayerHelper

__all__ = [
    "fc",
    "embedding",
    "layer_norm",
    "elementwise_add",
    "scale",
    "fused_multihead_attention",
    "reshape",
    "dropout",
    "softmax_with_cross_entropy",
    "matmul",
    "gather",
    "cumsum",
    "reduce_sum",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
]


def _elementwise_out_shape(xs, ys):
    if xs is None or ys is None:
        return xs or ys
    return xs if len(xs) >= len(ys) else ys


def _single_out(helper, op_type, inputs, attrs=None, dtype=None, shape=None):
    first = None
    for vs in inputs.values():
        first = next((v for v in vs if isinstance(v, Variable)), None)
        if first is not None:
            break
    dtype = dtype or (first.dtype if first else "float32")
    out = helper.create_variable_for_type_inference(dtype, shape)
    helper.append_op(
        type=op_type, inputs=inputs, outputs={"Out": [out]}, attrs=attrs or {}
    )
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None, act=None, name=None):
    """mul + bias + activation over one input (the JAX layer's list of
    inputs needs the `sum` op, not ported yet)."""
    helper = LayerHelper("fc", name=name, act=act)
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_dim, size], dtype=input.dtype)
    out_shape = tuple(input.shape[:num_flatten_dims]) + (size,)
    tmp = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(
        type="mul",
        inputs={"X": [input], "Y": [w]},
        outputs={"Out": [tmp]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    pre_act = helper.append_bias_op(tmp, bias_attr, size, num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    """lookup_table over a [vocab, width] parameter."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(
        param_attr, list(size), dtype=dtype, default_initializer=Xavier()
    )
    in_shape = tuple(input.shape)
    out_shape = (
        in_shape[:-1] if in_shape and in_shape[-1] == 1 else in_shape
    ) + (size[1],)
    out = helper.create_variable_for_type_inference(dtype, out_shape)
    if padding_idx is None:
        padding_idx = -1
    elif padding_idx < 0:
        padding_idx = size[0] + padding_idx
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={
            "padding_idx": padding_idx,
            "is_sparse": is_sparse,
            "is_distributed": is_distributed,
        },
    )
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", name=name, act=act)
    norm_dim = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, [norm_dim], dtype="float32", default_initializer=Constant(1.0)
        )]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, [norm_dim], dtype="float32", is_bias=True
        )]
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference(
        "float32", input.shape[:begin_norm_axis]
    )
    var = helper.create_variable_for_type_inference(
        "float32", input.shape[:begin_norm_axis]
    )
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def _ew_layer(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = _single_out(
            helper, op_type, {"X": [x], "Y": [y]}, {"axis": axis},
            shape=_elementwise_out_shape(x.shape, y.shape),
        )
        return helper.append_activation(out, act)

    f.__name__ = op_type
    return f


elementwise_add = _ew_layer("elementwise_add")
elementwise_sub = _ew_layer("elementwise_sub")
elementwise_mul = _ew_layer("elementwise_mul")
elementwise_div = _ew_layer("elementwise_div")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = _single_out(
        helper,
        "scale",
        {"X": [x]},
        {"scale": scale, "bias": bias, "bias_after_scale": bias_after_scale},
        shape=x.shape,
    )
    return helper.append_activation(out, act)


def fused_multihead_attention(q, k, v, key_bias=None, causal=False, attn_dropout=0.0,
                              sm_scale=None, is_test=False, layout="bhsd", name=None):
    """Fused attention over q/k/v. layout="bhsd": [b, nh, s, dh];
    layout="bshd": [b, s, nh, dh]. `key_bias` is an additive [b, sk] bias.
    On the card it runs the hand-written kernels of ops/kernels/."""
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"layout must be 'bhsd' or 'bshd', got {layout!r}")
    helper = LayerHelper("fused_multihead_attention", name=name)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if key_bias is not None:
        inputs["KeyBias"] = [key_bias]
    return _single_out(
        helper,
        "fused_multihead_attention",
        inputs,
        {
            "causal": causal,
            "attn_dropout": float(attn_dropout),
            "sm_scale": float(sm_scale or 0.0),
            "is_test": is_test,
            "layout": layout,
        },
        dtype=q.dtype,
        shape=list(q.shape),
    )


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape2", name=name, act=act)
    out_shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    # resolve -1 at build time when the input shape is fully static
    if -1 in out_shape and x.shape and all(
        d is not None and d > 0 for d in x.shape
    ):
        known = int(np.prod([s for s in out_shape if s != -1]))
        total = int(np.prod(x.shape))
        if known > 0 and total % known == 0:
            out_shape[out_shape.index(-1)] = total // known
    out = helper.create_variable_for_type_inference(x.dtype, tuple(out_shape))
    xshape = helper.create_variable_for_type_inference(
        x.dtype, (0,) + tuple(x.shape or ()), stop_gradient=True
    )
    helper.append_op(
        type="reshape2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out, act)



def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    mask = helper.create_variable_for_type_inference("uint8", x.shape, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype, logits.shape)
    loss = helper.create_variable_for_type_inference(
        logits.dtype, tuple(logits.shape[:-1]) + (1,))
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs, ys = list(x.shape), list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    return _single_out(
        helper, "matmul", {"X": [x], "Y": [y]},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": alpha},
        shape=tuple(xs[:-1]) + (ys[-1],),
    )


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    return _single_out(helper, "gather", {"X": [input], "Index": [index]},
                       shape=(index.shape[0],) + tuple(input.shape[1:]))


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    return _single_out(helper, "cumsum", {"X": [x]},
                       {"axis": axis, "exclusive": exclusive, "reverse": reverse},
                       shape=x.shape)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    reduce_all = dim is None
    dims = [0] if dim is None else (dim if isinstance(dim, (list, tuple)) else [dim])
    if input.shape is None or reduce_all:
        # a full reduce gives [1] (fluid convention), or all ones with keep_dim
        shape = ((1,) * len(input.shape) or (1,)) if keep_dim and input.shape is not None \
            else (1,)
    else:
        axes = {d % len(input.shape) for d in dims}
        shape = tuple((1 if i in axes else s) for i, s in enumerate(input.shape)
                      if keep_dim or i not in axes) or (1,)
    return _single_out(helper, "reduce_sum", {"X": [input]},
                       {"dim": dims, "keep_dim": keep_dim, "reduce_all": reduce_all},
                       shape=shape)
