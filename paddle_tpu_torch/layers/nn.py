"""The neural-net layers the BERT and ResNet slices build with. Each emits
the same op types, slots and attrs as its `paddle_tpu/layers/nn.py`
counterpart, so the two packages build identical Programs."""

from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..initializer import Constant, Normal, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc",
    "moe",
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
    "reduce_mean",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "transpose",
    "split",
    "slice",
    "clip",
    "clip_by_norm",
    "square_error_cost",
    "conv2d",
    "conv2d_transpose",
    "conv3d",
    "pool2d",
    "adaptive_pool2d",
    "batch_norm",
    "softmax",
    "cross_entropy",
    "mean",
    "topk",
    "accuracy",
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
    """mul + bias + activation; over a list of inputs, one mul per input
    (each with its own param_attr when a list is given), summed before the
    bias."""
    helper = LayerHelper("fc", name=name, act=act)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = ParamAttr._to_attr(param_attr)
    if not isinstance(param_attrs, list):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for x, pattr in zip(inputs, param_attrs):
        in_dim = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(pattr, [in_dim, size], dtype=x.dtype)
        out_shape = tuple(x.shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(x.dtype, out_shape)
        helper.append_op(
            type="mul",
            inputs={"X": [x], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_results[0].dtype, mul_results[0].shape)
        helper.append_op(type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, bias_attr, size, num_flatten_dims)
    return helper.append_activation(pre_act)


def moe(input, num_experts, d_ff, capacity_factor=1.25, k=2, param_attr=None, name=None,
        ep_axis="ep"):
    """Mixture-of-experts FFN layer (GShard top-k dense dispatch; the JAX
    package's layers.moe). The expert parameters are annotated to shard
    their leading (expert) dim over the `ep_axis` mesh axis (`model`); on
    a mesh whose model axis is larger than 1 the layout plan's expert rule
    runs each rank's experts (parallel/tensor_parallel.py). Returns (out,
    aux_loss): add `aux_loss` (shape [1], the load-balance loss) to the
    training objective."""
    import copy

    from ..parallel import P, shard_parameter

    helper = LayerHelper("moe", name=name)
    d = int(input.shape[-1])

    def pattr(suffix):
        # one param_attr names FIVE parameters: suffix each so a named
        # ParamAttr does not alias them onto one variable
        a = ParamAttr._to_attr(param_attr)
        if a and a.name:
            a = copy.copy(a)
            a.name = f"{a.name}.{suffix}"
        return a

    gate = helper.create_parameter(pattr("gate"), [d, num_experts], dtype=input.dtype)
    w1 = helper.create_parameter(pattr("w1"), [num_experts, d, d_ff], dtype=input.dtype)
    b1 = helper.create_parameter(pattr("b1"), [num_experts, d_ff], dtype=input.dtype,
                                 is_bias=True)
    w2 = helper.create_parameter(pattr("w2"), [num_experts, d_ff, d], dtype=input.dtype)
    b2 = helper.create_parameter(pattr("b2"), [num_experts, d], dtype=input.dtype,
                                 is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    aux = helper.create_variable_for_type_inference(input.dtype, (1,))
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [input], "Gate": [gate.name], "W1": [w1.name], "B1": [b1.name],
                "W2": [w2.name], "B2": [b2.name]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"capacity_factor": float(capacity_factor), "k": int(k)},
    )
    prog = helper.main_program
    for p_ in (w1, b1, w2, b2):
        shard_parameter(prog, p_.name, P(ep_axis))
    return out, aux


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
elementwise_max = _ew_layer("elementwise_max")


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


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    shape = tuple(x.shape[p] for p in perm) if x.shape else None
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    xshape = helper.create_variable_for_type_inference(
        x.dtype, (0,) + tuple(x.shape or ()), stop_gradient=True
    )
    helper.append_op(
        type="transpose2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axis": list(perm)},
    )
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """`num_or_sections` equal parts, or parts of the listed sizes, along
    `dim` -> the list of parts."""
    helper = LayerHelper("split", name=name)
    d = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        sections = []
        sizes = [input.shape[d] // num_or_sections] * num_or_sections
    else:
        sections = sizes = list(num_or_sections)
    outs = []
    for size in sizes:
        shape = list(input.shape)
        shape[d] = size
        outs.append(helper.create_variable_for_type_inference(input.dtype, tuple(shape)))
    helper.append_op(
        type="split",
        inputs={"X": [input]},
        outputs={"Out": outs},
        attrs={"axis": d, "num": 0 if sections else len(sizes), "sections": sections},
    )
    return outs


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    shape = list(input.shape)
    for a, s, e in zip(axes, starts, ends):
        dim = shape[a]
        if dim not in (-1, None):
            s_ = s + dim if s < 0 else min(s, dim)
            e_ = e + dim if e < 0 else min(e, dim)
            shape[a] = max(e_ - s_, 0)
    return _single_out(
        helper, "slice", {"Input": [input]},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends),
         "decrease_axis": []},
        shape=tuple(shape),
    )


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    return _single_out(helper, "clip", {"X": [x]}, {"min": min, "max": max},
                       shape=x.shape)


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    return _single_out(helper, "clip_by_norm", {"X": [x]}, {"max_norm": max_norm},
                       shape=x.shape)


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


def _reduce_layer(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
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
        return _single_out(helper, op_type, {"X": [input]},
                           {"dim": dims, "keep_dim": keep_dim, "reduce_all": reduce_all},
                           shape=shape)

    f.__name__ = op_type
    return f


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")


# ---------------------------------------------------------------------------
# the conv stack and the classifier head (ResNet)
# ---------------------------------------------------------------------------


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _conv_out_dim(in_dim, k, pad, stride, dilation=1):
    if in_dim in (-1, None):
        return -1
    eff = dilation * (k - 1) + 1
    return (in_dim + 2 * pad - eff) // stride + 1


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None,
           data_format="NCHW"):
    """conv2d over NCHW input, OIHW filter initialized Normal(0,
    sqrt(2 / fan_in)), then the optional bias and activation."""
    helper = LayerHelper("conv2d", name=name, act=act)
    ksize = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    groups = groups or 1
    c_in = input.shape[1]
    fan_in = (c_in // groups) * ksize[0] * ksize[1]
    w = helper.create_parameter(param_attr, [num_filters, c_in // groups] + ksize,
                                dtype=input.dtype,
                                default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5))
    out_shape = (
        input.shape[0],
        num_filters,
        _conv_out_dim(input.shape[2], ksize[0], padding[0], stride[0], dilation[0]),
        _conv_out_dim(input.shape[3], ksize[1], padding[1], stride[1], dilation[1]),
    )
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups},
    )
    pre_act = helper.append_bias_op(out, bias_attr, num_filters, 1)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None, padding=0,
                     stride=1, dilation=1, groups=1, param_attr=None, bias_attr=None,
                     act=None, name=None):
    """conv2d_transpose over NCHW input with a [in_c, num_filters / groups,
    kh, kw] filter (paddle_tpu/layers/nn.py:420-471): `filter_size` is
    required and `output_size` is taken but not read, as there."""
    helper = LayerHelper("conv2d_transpose", name=name, act=act)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    groups = groups or 1
    if filter_size is None:
        raise ValueError("filter_size required")
    ksize = _pair(filter_size)
    w = helper.create_parameter(param_attr, [input.shape[1], num_filters // groups] + ksize,
                                dtype=input.dtype)

    def _o(i, k, p, s, d):
        if i in (-1, None):
            return -1
        return (i - 1) * s - 2 * p + d * (k - 1) + 1

    out_shape = (input.shape[0], num_filters,
                 _o(input.shape[2], ksize[0], padding[0], stride[0], dilation[0]),
                 _o(input.shape[3], ksize[1], padding[1], stride[1], dilation[1]))
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups},
    )
    pre_act = helper.append_bias_op(out, bias_attr, num_filters, 1)
    return helper.append_activation(pre_act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None):
    """conv3d over NCDHW input, OIDHW filter initialized Normal(0,
    sqrt(2 / fan_in)) (paddle_tpu/layers/nn.py:2639-2673)."""
    helper = LayerHelper("conv3d", name=name, act=act)

    def _triple(v):
        return [v] * 3 if isinstance(v, int) else list(v)

    ks, st, pd, dl = (_triple(v) for v in (filter_size, stride, padding, dilation))
    groups = groups or 1
    c_in = input.shape[1]
    fan_in = (c_in // groups) * ks[0] * ks[1] * ks[2]
    w = helper.create_parameter(param_attr, [num_filters, c_in // groups] + ks,
                                dtype=input.dtype,
                                default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5))
    out_shape = tuple([input.shape[0], num_filters] + [
        _conv_out_dim(input.shape[2 + i], ks[i], pd[i], st[i], dl[i]) for i in range(3)])
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(
        type="conv3d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": st, "paddings": pd, "dilations": dl, "groups": groups},
    )
    pre_act = helper.append_bias_op(out, bias_attr, num_filters, 1)
    return helper.append_activation(pre_act)


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False, name=None):
    """pool2d with adaptive=True: the output's H, W are `pool_size`
    whatever the input's (paddle_tpu/layers/api_tail.py:65-87)."""
    if require_index:
        raise NotImplementedError("require_index=True (argmax outputs) is not supported")
    if pool_type not in ("max", "avg"):
        raise ValueError(f"pool_type must be 'max' or 'avg', got {pool_type}")
    ksize = [pool_size] * 2 if isinstance(pool_size, int) else list(pool_size)
    helper = LayerHelper("adaptive_pool2d", name=name)
    return _single_out(helper, "pool2d", {"X": [input]},
                       {"pooling_type": pool_type, "ksize": ksize, "adaptive": True,
                        "global_pooling": False},
                       shape=tuple(input.shape[:2]) + tuple(ksize))


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, exclusive=True,
           name=None):
    helper = LayerHelper("pool2d", name=name)
    ksize = _pair(pool_size)
    stride = _pair(pool_stride)
    padding = _pair(pool_padding)
    if global_pooling:
        out_shape = (input.shape[0], input.shape[1], 1, 1)
    else:
        def _o(i, k, p, s):
            if i in (-1, None):
                return -1
            if ceil_mode:
                return (i - k + 2 * p + s - 1) // s + 1
            return (i - k + 2 * p) // s + 1

        out_shape = (input.shape[0], input.shape[1],
                     _o(input.shape[2], ksize[0], padding[0], stride[0]),
                     _o(input.shape[3], ksize[1], padding[1], stride[1]))
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": ksize, "strides": stride,
               "paddings": padding, "global_pooling": global_pooling,
               "ceil_mode": ceil_mode, "exclusive": exclusive},
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW", name=None,
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """batch_norm with float32 scale (1) and bias (0) parameters and the
    running mean (0) and variance (1) as persistable global vars, which
    the op updates in training mode."""
    helper = LayerHelper("batch_norm", name=name, act=act)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], dtype="float32",
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], dtype="float32", is_bias=True)
    mean = helper.create_or_get_global_variable(
        moving_mean_name or helper.prefix + ".mean", [c], "float32",
        initializer=Constant(0.0))
    variance = helper.create_or_get_global_variable(
        moving_variance_name or helper.prefix + ".var", [c], "float32",
        initializer=Constant(1.0))
    saved_mean = helper.create_variable_for_type_inference("float32", (c,))
    saved_var = helper.create_variable_for_type_inference("float32", (c,))
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias], "Mean": [mean],
                "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout, "use_global_stats": use_global_stats},
    )
    return helper.append_activation(out)


def softmax(input, axis=-1, name=None, use_cudnn=False):
    helper = LayerHelper("softmax", name=name)
    return _single_out(helper, "softmax", {"X": [input]}, {"axis": axis},
                       shape=input.shape)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """Cross entropy of probabilities `input` against `label`."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(
        input.dtype, tuple(input.shape[:-1]) + (1,))
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    return _single_out(helper, "square_error_cost", {"X": [input], "Y": [label]},
                       shape=input.shape)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    return _single_out(helper, "mean", {"X": [x]}, shape=(1,))


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = tuple(input.shape[:-1]) + (k,)
    values = helper.create_variable_for_type_inference(input.dtype, shape)
    indices = helper.create_variable_for_type_inference("int64", shape,
                                                        stop_gradient=True)
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [values], "Indices": [indices]},
        attrs={"k": k},
    )
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the top k of `input`."""
    helper = LayerHelper("accuracy")
    _, indices = topk(input, k)
    out = helper.create_variable_for_type_inference("float32", (1,), stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Indices": [indices], "Label": [label]},
        outputs={"Accuracy": [out]},
        attrs={},
    )
    return out
