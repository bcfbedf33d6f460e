"""Shape, creation and indexing op lowerings: reshape2, fill_constant,
fill_constant_batch_size_like, assign, gather and the random
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


@register_op("fill_constant", differentiable=False)
def _fill_constant(ctx, op):
    dtype = TORCH_DTYPE(op.attr("dtype", "float32"))
    ctx.out(op, "Out", torch.full(tuple(op.attr("shape", [1])),
                                  op.attr("value", 0.0), dtype=dtype,
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


@register_op("gather", no_grad_inputs=("Index",))
def _gather(ctx, op):
    x = ctx.in_(op, "X")
    index = ctx.in_(op, "Index").long()
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.squeeze(1)
    ctx.out(op, "Out", torch.index_select(x, op.attr("overwrite_axis", 0), index))


def _op_generator(ctx, op):
    """The op's own seed when it has one, else the run's generator."""
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
