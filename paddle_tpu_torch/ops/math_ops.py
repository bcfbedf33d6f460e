"""Elementwise, activation, matmul, reduction, norm and scan op lowerings:
elementwise_add / sub / mul / div / max (fluid axis broadcast) with the
linear grad op of add and sub, scale, mul, matmul, gelu, relu, tanh, sqrt,
sign, clip, sum, reduce_sum, mean, squared_l2_norm, clip_by_norm, top_k
and cumsum. The large `mul` / `matmul` products stay
`torch.matmul`, as the JAX package leaves them to XLA; under bf16 AMP they
take their inputs in bf16 (`ctx.amp_cast`, math_ops.py:315-363 there)."""

from __future__ import annotations

import numpy as np
import torch

from .registry import register_op


def _broadcast_y(x, y, axis):
    """Y broadcast against X starting at `axis` (fluid convention)."""
    if x.dim() == y.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return y.reshape(shape)


def _ew(fn):
    def lower(ctx, op):
        x = ctx.in_(op, "X")
        y = ctx.in_(op, "Y")
        # Out takes X's dtype (elementwise_op.h convention)
        if x.dtype != y.dtype and x.is_floating_point() and y.is_floating_point():
            y = y.to(x.dtype)
        out = fn(x, _broadcast_y(x, y, op.attr("axis", -1)))
        scale = op.attr("Scale_out", 1.0)
        if scale != 1.0:
            out = out * scale
        ctx.out(op, "Out", out)

    return lower


def _ew_linear_grad_maker(op_type):
    """elementwise_add / _sub get their own grad op, as in the JAX package
    (math_ops.py:67-93): the bias-grad reduce over Y's broadcast dims."""

    def maker(op, grad_out_names, block, helpers):
        if grad_out_names.get("Out", [None])[0] is None:
            return None
        return [{
            "type": op_type + "_grad",
            "inputs": {
                "X": op.input("X"),
                "Y": op.input("Y"),
                "GRAD_Out": [grad_out_names["Out"][0]],
            },
            "outputs": {
                "IGRAD_X": [helpers.grad_name(op.input("X")[0])],
                "IGRAD_Y": [helpers.grad_name(op.input("Y")[0])],
            },
            "attrs": {
                "axis": op.attr("axis", -1),
                "Scale_out": op.attr("Scale_out", 1.0),
            },
        }]

    return maker


def _reduce_to_y(d, x, y, axis):
    """The full-shape cotangent `d` summed down to y's shape under the
    broadcast convention, accumulated in float32 (the caller casts)."""
    if tuple(y.shape) == tuple(d.shape):
        return d
    yb_shape = _broadcast_y(x, y, axis).shape
    red = tuple(i for i, yb in enumerate(yb_shape) if yb == 1 and d.shape[i] != 1)
    out = d.float().sum(dim=red, keepdim=True) if red else d.float()
    return out.reshape(y.shape)


def _sum_to_x(d, x):
    """The cotangent summed down to x's shape where x broadcast against y
    (a [b, 1, 1, t] padding bias plus a [1, 1, t, t] causal one). The JAX
    lowering passes d through unreduced there (paddle_tpu/ops/math_ops.py
    :131), which only its dead-op pass keeps from failing: no such grad is
    live in its Programs."""
    if tuple(d.shape) == tuple(x.shape):
        return d
    lead = d.dim() - x.dim()
    red = tuple(range(lead)) + tuple(lead + i for i, n in enumerate(x.shape)
                                     if n == 1 and d.shape[lead + i] != 1)
    return d.float().sum(dim=red, keepdim=True).reshape(x.shape)


def _ew_add_sub_grad(sign):
    def lower(ctx, op):
        d = ctx.in_(op, "GRAD_Out")
        x = ctx.in_(op, "X")
        y = ctx.in_(op, "Y")
        scale = op.attr("Scale_out", 1.0)
        if scale != 1.0:
            d = d * scale
        ctx.out(op, "IGRAD_X", _sum_to_x(d, x).to(x.dtype))
        dy = _reduce_to_y(d, x, y, op.attr("axis", -1))
        ctx.out(op, "IGRAD_Y", (dy if sign > 0 else -dy).to(y.dtype))

    return lower


register_op("elementwise_add_grad", differentiable=False)(_ew_add_sub_grad(1))
register_op("elementwise_sub_grad", differentiable=False)(_ew_add_sub_grad(-1))
for _name, _fn in {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
}.items():
    if _name in ("elementwise_add", "elementwise_sub"):
        register_op(_name, grad=_ew_linear_grad_maker(_name))(_ew(_fn))
    else:
        register_op(_name)(_ew(_fn))


@register_op("scale")
def _scale(ctx, op):
    x = ctx.in_(op, "X")
    scale = op.attr("scale", 1.0)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.out(op, "Out", out)


def _product(x, y):
    """torch.matmul; an fp16 product on the CPU is taken in fp32 and rounded
    once, as the card's cuBLAS (fp32 accumulation) and XLA's CPU backend
    take it: torch's own fp16 CPU GEMM is a slow loop on CPUs without native
    fp16, such as an H100 host's."""
    if x.dtype == torch.float16 and x.device.type == "cpu":
        return torch.matmul(x.float(), y.float()).to(torch.float16)
    return torch.matmul(x, y)


@register_op("mul")
def _mul(ctx, op):
    """Flattening matmul: X flattened to 2-D at x_num_col_dims, Y at
    y_num_col_dims; output unflattened."""
    x, y = ctx.amp_cast(op, ctx.in_(op, "X"), ctx.in_(op, "Y"))
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    x_lead = tuple(x.shape[:xn])
    x2 = x.reshape(int(np.prod(x_lead or (1,))), -1)
    y2 = y.reshape(int(np.prod(y.shape[:yn])), -1)
    out = _product(x2, y2)
    ctx.out(op, "Out", out.reshape(x_lead + tuple(y.shape[yn:])))


@register_op("matmul")
def _matmul(ctx, op):
    """Fluid matmul: transpose flags, alpha and batch broadcasting."""
    x, y = ctx.amp_cast(op, ctx.in_(op, "X"), ctx.in_(op, "Y"))
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if op.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = _product(x, y)
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.out(op, "Out", out)


@register_op("gelu")
def _gelu(ctx, op):
    x = ctx.in_(op, "X")
    approximate = "tanh" if op.attr("approximate", False) else "none"
    ctx.out(op, "Out", torch.nn.functional.gelu(x, approximate=approximate))


def _unary(name, fn, **reg_kwargs):
    register_op(name, **reg_kwargs)(lambda ctx, op: ctx.out(op, "Out", fn(ctx.in_(op, "X"))))


_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("sqrt", torch.sqrt)
_unary("square", torch.square)
_unary("sign", torch.sign, differentiable=False)


@register_op("clip")
def _clip(ctx, op):
    ctx.out(op, "Out", torch.clamp(ctx.in_(op, "X"), op.attr("min"), op.attr("max")))


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, op):
    """sum(x^2) as a [1] tensor; the JAX package registers it twice with
    this one function (math_ops.py:443, loss_ops.py:127 there)."""
    ctx.out(op, "Out", torch.sum(torch.square(ctx.in_(op, "X"))).reshape(1))


@register_op("clip_by_norm")
def _clip_by_norm(ctx, op):
    """x * (max_norm / ||x||) where ||x|| > max_norm, else x: a zero
    norm keeps x (math_ops.py:598-603 there)."""
    x = ctx.in_(op, "X")
    max_norm = op.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    ctx.out(op, "Out", torch.where(norm > max_norm, x * (max_norm / norm), x))


@register_op("mean")
def _mean(ctx, op):
    """Fluid `mean` reduces to a [1] tensor."""
    ctx.out(op, "Out", ctx.in_(op, "X").mean().reshape(1))


@register_op("top_k", no_grad_inputs=("Indices",))
def _top_k(ctx, op):
    """The k largest along the last axis, ties to the lower index as
    `lax.top_k` breaks them (a stable descending sort); Indices int32, as
    the JAX package gives them."""
    x = ctx.in_(op, "X")
    k = op.attr("k", 1)
    if op.input("K"):
        k = int(ctx.in_(op, "K").reshape(-1)[0])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    ctx.out(op, "Out", vals[..., :k])
    ctx.out(op, "Indices", idx[..., :k].to(torch.int32))


@register_op("sum")
def _sum(ctx, op):
    """Multi-input accumulate: the @PARTIAL grads of one variable."""
    xs = ctx.ins(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.out(op, "Out", out)


def _reduce(name, fn):
    """reduce_sum / reduce_mean over `dim`, or over everything into [1]
    (fluid's shape; all ones under keep_dim)."""

    @register_op(name)
    def lower(ctx, op):
        x = ctx.in_(op, "X")
        dims = op.attr("dim", [0])
        keep = op.attr("keep_dim", False)
        if op.attr("reduce_all", False) or dims is None:
            out = fn(x)
            out = out.reshape((1,) * x.dim() if keep else (1,))  # fluid: [1]
        else:
            dims = dims if isinstance(dims, (list, tuple)) else [dims]
            out = fn(x, dim=tuple(d % x.dim() for d in dims), keepdim=keep)
        ctx.out(op, "Out", out)


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)


@register_op("cumsum")
def _cumsum(ctx, op):
    x = ctx.in_(op, "X")
    axis = op.attr("axis", -1)
    if op.attr("flatten", False):
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    reverse = op.attr("reverse", False)
    src = x.flip(axis) if reverse else x
    out = src.cumsum(axis)
    if op.attr("exclusive", False):
        # one step along the scan direction, a zero at its start
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    ctx.out(op, "Out", out.flip(axis) if reverse else out)
