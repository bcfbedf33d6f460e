"""Optimizer op lowerings: sgd, momentum, adam, adamw and lamb, and the
loss-scaling ops check_finite_and_unscale and update_loss_scaling
(paddle_tpu/ops/optimizer_ops.py).

Each writes new tensors for its param and accumulators, out of place, as
the JAX package's functional updates do; the executor stores them back
into the scope under the same names. Moments are float32 and the beta
powers are [1] state tensors (Beta1Pow / Beta2Pow). The loss-scaling ops
keep the scale, the step counters and FoundInfinite on the device: no
lowering here reads a value back to the host."""

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


def _adam_moments(ctx, op):
    """Adam's moments and the bias-corrected step size of one op ->
    (p, m1n, m2n, lr_t, lr)."""
    p = ctx.in_(op, "Param")
    g = ctx.in_(op, "Grad").float()
    m1 = ctx.in_(op, "Moment1")
    m2 = ctx.in_(op, "Moment2")
    b1p = ctx.in_(op, "Beta1Pow")
    b2p = ctx.in_(op, "Beta2Pow")
    lr = _lr(ctx, op)
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    return p, m1n, m2n, lr_t, lr


def _adam_outputs(ctx, op, p, p_new, m1n, m2n):
    ctx.out(op, "ParamOut", p_new.to(p.dtype))
    ctx.out(op, "Moment1Out", m1n)
    ctx.out(op, "Moment2Out", m2n)
    ctx.out(op, "Beta1PowOut", ctx.in_(op, "Beta1Pow") * op.attr("beta1", 0.9))
    ctx.out(op, "Beta2PowOut", ctx.in_(op, "Beta2Pow") * op.attr("beta2", 0.999))


@register_op("adam", differentiable=False)
def _adam(ctx, op):
    p, m1n, m2n, lr_t, _ = _adam_moments(ctx, op)
    eps = op.attr("epsilon", 1e-8)
    p_new = p.float() - lr_t * m1n / (torch.sqrt(m2n) + eps)
    _adam_outputs(ctx, op, p, p_new, m1n, m2n)


@register_op("adamw", differentiable=False)
def _adamw(ctx, op):
    """Adam with decoupled weight decay: p * (1 - lr * coeff) before the
    Adam step (optimizer_ops.py:93-115 there)."""
    p, m1n, m2n, lr_t, lr = _adam_moments(ctx, op)
    eps = op.attr("epsilon", 1e-8)
    decayed = p.float() * (1.0 - lr * op.attr("coeff", 0.01))
    p_new = decayed - lr_t * m1n / (torch.sqrt(m2n) + eps)
    _adam_outputs(ctx, op, p, p_new, m1n, m2n)


@register_op("lamb", differentiable=False)
def _lamb(ctx, op):
    """Layer-wise adaptive Adam (optimizer_ops.py:223-252 there): the
    update m1^ / (sqrt(m2^) + eps) + weight_decay * p, scaled by the trust
    ratio ||p|| / ||update||, which is 1 where either norm is 0."""
    p = ctx.in_(op, "Param")
    g = ctx.in_(op, "Grad").float()
    b1p = ctx.in_(op, "Beta1Pow")
    b2p = ctx.in_(op, "Beta2Pow")
    lr = _lr(ctx, op)
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-6)
    pf = p.float()
    m1n = beta1 * ctx.in_(op, "Moment1") + (1 - beta1) * g
    m2n = beta2 * ctx.in_(op, "Moment2") + (1 - beta2) * torch.square(g)
    m1h = m1n / (1 - b1p.reshape(()))
    m2h = m2n / (1 - b2p.reshape(()))
    update = m1h / (torch.sqrt(m2h) + eps) + op.attr("weight_decay", 0.01) * pf
    p_norm = torch.sqrt(torch.sum(torch.square(pf)))
    u_norm = torch.sqrt(torch.sum(torch.square(update)))
    ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                        torch.ones((), dtype=p_norm.dtype, device=p_norm.device))
    _adam_outputs(ctx, op, p, pf - lr * ratio * update, m1n, m2n)


@register_op("check_finite_and_unscale", differentiable=False)
def _check_finite_and_unscale(ctx, op):
    """Every grad times 1 / Scale, or zeros when any grad holds a nan or
    an inf, with FoundInfinite [1] bool (optimizer_ops.py:437-456 there).
    Zeros by selection, not by a product with 0: inf * 0 is nan."""
    scale = ctx.in_(op, "Scale").reshape(()).float()
    grads = ctx.ins(op, "X")
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    inv = 1.0 / scale
    zero = torch.zeros((), dtype=torch.float32, device=scale.device)
    for i, g in enumerate(grads):
        ctx.out(op, "Out", torch.where(finite, g.float() * inv, zero).to(g.dtype), idx=i)
    ctx.out(op, "FoundInfinite", torch.logical_not(finite).reshape(1))


@register_op("update_loss_scaling", differentiable=False,
             stateful_outputs=("LossScalingOut", "OutGoodSteps", "OutBadSteps"))
def _update_loss_scaling(ctx, op):
    """Grow the scale by incr_ratio after incr_every_n_steps finite steps
    in a row (only while the grown scale is finite), shrink it by
    decr_ratio, to no less than 1, after decr_every_n_nan_or_inf overflow
    steps in a row; a closed window resets its counter. The windows
    compare the counters before this step's increment: the reference's
    less_than(n, count + 1) (optimizer_ops.py:459-490 there)."""
    finite = torch.logical_not(ctx.in_(op, "FoundInfinite").reshape(()).bool())
    scale = ctx.in_(op, "PrevLossScaling").reshape(()).float()
    good = ctx.in_(op, "InGoodSteps").reshape(()).int()
    bad = ctx.in_(op, "InBadSteps").reshape(()).int()
    zero = torch.zeros((), dtype=torch.int32, device=good.device)
    good2 = torch.where(finite, good + 1, zero)
    bad2 = torch.where(finite, zero, bad + 1)
    incr_window = finite & (good2 > op.attr("incr_every_n_steps", 1000))
    decr_window = ~finite & (bad2 > op.attr("decr_every_n_nan_or_inf", 2))
    grown = scale * op.attr("incr_ratio", 2.0)
    shrunk = torch.clamp(scale * op.attr("decr_ratio", 0.8), min=1.0)
    new_scale = torch.where(incr_window & torch.isfinite(grown), grown,
                            torch.where(decr_window, shrunk, scale))
    ctx.out(op, "LossScalingOut", new_scale.reshape(1))
    ctx.out(op, "OutGoodSteps", torch.where(incr_window, zero, good2).reshape(1))
    ctx.out(op, "OutBadSteps", torch.where(decr_window, zero, bad2).reshape(1))
