"""Optimizer op lowerings: sgd, momentum and adam
(paddle_tpu/ops/optimizer_ops.py).

Each writes new tensors for its param and accumulators, out of place, as
the JAX package's functional updates do; the executor stores them back
into the scope under the same names. Moments are float32 and the beta
powers are [1] state tensors (Beta1Pow / Beta2Pow)."""

from __future__ import annotations

import torch

from .registry import register_op


def _lr(ctx, op):
    return ctx.in_(op, "LearningRate").reshape(())


@register_op("sgd", differentiable=False)
def _sgd(ctx, op):
    p = ctx.in_(op, "Param")
    g = ctx.in_(op, "Grad")
    ctx.out(op, "ParamOut", (p - _lr(ctx, op) * g.to(p.dtype)).to(p.dtype))


@register_op("momentum", differentiable=False)
def _momentum(ctx, op):
    """v = mu * v + g (g in fp32); p -= lr * v, or with Nesterov
    p -= (g + mu * v) * lr (optimizer_ops.py:30-44 there)."""
    p = ctx.in_(op, "Param")
    g = ctx.in_(op, "Grad").float()
    v = ctx.in_(op, "Velocity")
    lr = _lr(ctx, op)
    mu = op.attr("mu")
    v_new = mu * v + g
    if op.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.out(op, "ParamOut", p_new.to(p.dtype))
    ctx.out(op, "VelocityOut", v_new)


@register_op("adam", differentiable=False)
def _adam(ctx, op):
    p = ctx.in_(op, "Param")
    g = ctx.in_(op, "Grad").float()
    m1 = ctx.in_(op, "Moment1")
    m2 = ctx.in_(op, "Moment2")
    b1p = ctx.in_(op, "Beta1Pow")
    b2p = ctx.in_(op, "Beta2Pow")
    lr = _lr(ctx, op)
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_new = p.float() - lr_t * m1n / (torch.sqrt(m2n) + eps)
    ctx.out(op, "ParamOut", p_new.to(p.dtype))
    ctx.out(op, "Moment1Out", m1n)
    ctx.out(op, "Moment2Out", m2n)
    ctx.out(op, "Beta1PowOut", b1p * beta1)
    ctx.out(op, "Beta2PowOut", b2p * beta2)
