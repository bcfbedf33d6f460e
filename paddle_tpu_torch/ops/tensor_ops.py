"""Shape, creation and indexing op lowerings: reshape2, transpose,
transpose2, split, slice, fill_constant, fill_constant_batch_size_like,
assign, assign_value, gather and the random
initializers of the startup program. Random ops draw from an
explicit torch.Generator on the context's device: their values differ
from the JAX package's threefry streams, so parity tests carry weights
across by name (io.set_persistables_from_numpy)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .registry import TORCH_DTYPE, register_op


def _infer_reshape(x, shape):
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    return tuple(shape)


@register_op("reshape2")
def _reshape2(ctx, op):
    x = ctx.in_(op, "X")
    ctx.out(op, "Out", x.reshape(_infer_reshape(x, op.attr("shape"))))
    # XShape only carries the input shape for the grad op
    ctx.out(op, "XShape", x.new_empty((0,) + tuple(x.shape)))


@register_op("transpose")
def _transpose(ctx, op):
    ctx.out(op, "Out", ctx.in_(op, "X").permute(*op.attr("axis")))


@register_op("transpose2")
def _transpose2(ctx, op):
    x = ctx.in_(op, "X")
    ctx.out(op, "Out", x.permute(*op.attr("axis")))
    ctx.out(op, "XShape", x.new_empty((0,) + tuple(x.shape)))


@register_op("split")
def _split(ctx, op):
    """`sections` sizes along `axis`, or `num` equal parts; the grad of
    the parts is their cotangents concatenated back (autograd's)."""
    x = ctx.in_(op, "X")
    axis = op.attr("axis", 0)
    sections = op.attr("sections", [])
    size = list(sections) if sections else x.shape[axis] // op.attr("num", 0)
    for i, part in enumerate(torch.split(x, size, dim=axis)):
        ctx.out(op, "Out", part, idx=i)


@register_op("slice")
def _slice(ctx, op):
    """Starts and ends per axis, negative ones from the end, clamped to
    the dim; `decrease_axis` drops those axes. The grad is the cotangent
    zero-padded back to the input's shape (autograd's)."""
    x = ctx.in_(op, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(op.attr("axes"), op.attr("starts"), op.attr("ends")):
        dim = x.shape[a]
        s = s + dim if s < 0 else min(s, dim)
        e = e + dim if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    decrease = op.attr("decrease_axis", [])
    if decrease:
        out = out.reshape([d for i, d in enumerate(out.shape) if i not in decrease])
    ctx.out(op, "Out", out)


@register_op("fill_constant", differentiable=False)
def _fill_constant(ctx, op):
    """`str_value`, when set, takes the place of `value`
    (tensor_ops.py:376-383 there)."""
    value = op.attr("value", 0.0)
    if op.attr("str_value", ""):
        value = float(op.attr("str_value"))
    dtype = TORCH_DTYPE(op.attr("dtype", "float32"))
    ctx.out(op, "Out", torch.full(tuple(op.attr("shape", [1])), value, dtype=dtype,
                                  device=ctx.device))


@register_op("fill_constant_batch_size_like", differentiable=False)
def _fill_constant_bsl(ctx, op):
    ref = ctx.in_(op, "Input")
    shape = list(op.attr("shape"))
    shape[op.attr("output_dim_idx", 0)] = ref.shape[op.attr("input_dim_idx", 0)]
    ctx.out(op, "Out", torch.full(tuple(shape), op.attr("value", 0.0),
                                  dtype=TORCH_DTYPE(op.attr("dtype", "float32")),
                                  device=ctx.device))


@register_op("assign")
def _assign(ctx, op):
    """An alias of X, not a copy: no lowering on the port's paths writes a
    tensor in place, so the two names may share one."""
    ctx.out(op, "Out", ctx.in_(op, "X"))


@register_op("assign_value", differentiable=False)
def _assign_value(ctx, op):
    """The attr's values (`fp32_values`, `int32_values` or `values`) as a
    tensor of `dtype` and `shape` (tensor_ops.py:415-420 there). Values
    all equal (the constants passes/const_fold.py folds) are a fill on the
    device, as fill_constant is: a copy from the host would wait for the
    device's queue, in mid-step."""
    values = op.attr("fp32_values") or op.attr("int32_values") or op.attr("values")
    dtype = TORCH_DTYPE(op.attr("dtype", "float32"))
    shape = tuple(op.attr("shape"))
    if values and all(v == values[0] for v in values):
        ctx.out(op, "Out", torch.full(shape, values[0], dtype=dtype, device=ctx.device))
        return
    out = torch.as_tensor(np.array(values), device=ctx.device)
    ctx.out(op, "Out", out.to(dtype).reshape(shape))


@register_op("gather", no_grad_inputs=("Index",))
def _gather(ctx, op):
    x = ctx.in_(op, "X")
    index = ctx.in_(op, "Index").long()
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.squeeze(1)
    ctx.out(op, "Out", torch.index_select(x, op.attr("overwrite_axis", 0), index))


def _op_generator(ctx, op):
    """The op's own seed when it has one, else the run's generator. A
    static step (Executor.run_repeated) has no generator: its replays
    could not redraw from one, so such an op raises there."""
    if ctx.seed_slots is not None:
        raise RuntimeError(
            f"op {op.type!r} draws from a torch.Generator, which a static step "
            "(Executor.run_repeated) cannot redraw at each replay: run this Program "
            "with Executor.run")
    seed = op.attr("seed", 0)
    if seed:
        return torch.Generator(device=ctx.device).manual_seed(int(seed))
    if ctx.generator is None:
        raise RuntimeError("op requires randomness but no generator was "
                           "passed — executor bug")
    return ctx.generator


def _empty_f32(ctx, op):
    return torch.empty(tuple(op.attr("shape")), dtype=torch.float32,
                       device=ctx.device)


@register_op("uniform_random", differentiable=False)
def _uniform_random(ctx, op):
    out = _empty_f32(ctx, op).uniform_(
        op.attr("min", -1.0), op.attr("max", 1.0),
        generator=_op_generator(ctx, op))
    ctx.out(op, "Out", out.to(TORCH_DTYPE(op.attr("dtype", "float32"))))


@register_op("gaussian_random", differentiable=False)
def _gaussian_random(ctx, op):
    out = _empty_f32(ctx, op).normal_(
        op.attr("mean", 0.0), op.attr("std", 1.0),
        generator=_op_generator(ctx, op))
    ctx.out(op, "Out", out.to(TORCH_DTYPE(op.attr("dtype", "float32"))))


@register_op("truncated_gaussian_random", differentiable=False)
def _truncated_gaussian_random(ctx, op):
    """mean + std * N(0, 1) truncated to [-2, 2], by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = _empty_f32(ctx, op).uniform_(2 * lo - 1, 2 * hi - 1,
                                     generator=_op_generator(ctx, op))
    x = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    out = x.mul_(op.attr("std", 1.0)).add_(op.attr("mean", 0.0))
    ctx.out(op, "Out", out.to(TORCH_DTYPE(op.attr("dtype", "float32"))))
