"""Optimizer op lowerings: sgd, momentum, adam, adamw and lamb, their
multi-tensor forms fused_sgd / fused_momentum / fused_adam / fused_adamw /
fused_lamb (emitted by passes/fuse_optimizer.py), and the loss-scaling ops
check_finite_and_unscale and update_loss_scaling
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
    # a parameter sharded over a model group sums its squares over the group
    name = op.input("Param")[0]
    p_norm = torch.sqrt(ctx.model_sum(name, torch.sum(torch.square(pf))))
    u_norm = torch.sqrt(ctx.model_sum(name, torch.sum(torch.square(update))))
    ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                        torch.ones((), dtype=p_norm.dtype, device=p_norm.device))
    _adam_outputs(ctx, op, p, pf - lr * ratio * update, m1n, m2n)


# ---------------------------------------------------------------------------
# fused multi-tensor updates (passes/fuse_optimizer.py; reference
# fuse_all_optimizer_ops + multi_tensor_apply)
#
# One IR op updates a whole group of parameters in a few torch._foreach_*
# calls, where the per-op lowerings above cost ~20 torch calls each from
# Python. The JAX package's fused lowering is a per-tensor loop
# (optimizer_ops.py:255-345 there), free under XLA's trace; here the host
# issues every call, so the loop would save nothing.
#
# Each tensor goes through the same sequence of operations as the per-op
# lowering above (scalars multiply on the same side, sums associate the
# same way, torch.square is x * x), so a fused step matches an unfused one
# bit for bit; fused_lamb's norms are torch._foreach_norm, which may sum
# in another order than torch.sum.
#
# Traps:
#   * Each parameter has its own Beta1Pow / Beta2Pow [1] tensors. Their
#     step sizes are computed for the whole group at once (torch.stack,
#     then unbind into 0-dim tensors); no .item(), which would sync the
#     host with the card once a parameter.
#   * A list of 0-dim tensors times a list of tensors takes foreach's
#     per-tensor path (one C++ loop, no Python); every other call here is
#     one multi-tensor launch per dtype on the card.
#   * The port's `assign` is an alias (tensor_ops.py), so a grad, param or
#     moment tensor may be bound under other names too: every call on
#     them is out of place. The in-place forms (`_foreach_*_`) run only on
#     tensors this lowering has just made.
# ---------------------------------------------------------------------------


def _as_dtype(ts, dtype):
    """`ts` in `dtype`, the list itself when every tensor already is."""
    if all(t.dtype == dtype for t in ts):
        return ts
    return [t.to(dtype) for t in ts]


def _write(ctx, op, slot, values):
    for i, v in enumerate(values):
        ctx.out(op, slot, v, idx=i)


def _write_params(ctx, op, params, new):
    """ParamOut in each param's own dtype (a group shares one)."""
    _write(ctx, op, "ParamOut", _as_dtype(new, params[0].dtype))


def _fused_moments(ctx, op, g):
    """m1n = beta1 * m1 + (1 - beta1) * g and m2n = beta2 * m2 +
    (1 - beta2) * g * g for the group, as _adam_moments computes them."""
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    m1n = torch._foreach_mul(ctx.ins(op, "Moment1"), beta1)
    torch._foreach_add_(m1n, torch._foreach_mul(g, 1 - beta1))
    m2n = torch._foreach_mul(ctx.ins(op, "Moment2"), beta2)
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_add_(m2n, sq)
    return m1n, m2n


def _beta_pows(ctx, op):
    """The group's Beta1Pow / Beta2Pow as two [n] tensors."""
    b1 = torch.stack(ctx.ins(op, "Beta1Pow")).reshape(-1)
    b2 = torch.stack(ctx.ins(op, "Beta2Pow")).reshape(-1)
    return b1, b2


def _write_beta_pows(ctx, op, b1, b2):
    """Beta1PowOut = b1p * beta1, Beta2PowOut = b2p * beta2, each [1]."""
    _write(ctx, op, "Beta1PowOut", (b1 * op.attr("beta1", 0.9)).reshape(-1, 1).unbind(0))
    _write(ctx, op, "Beta2PowOut", (b2 * op.attr("beta2", 0.999)).reshape(-1, 1).unbind(0))


@register_op("fused_sgd", differentiable=False)
def _fused_sgd(ctx, op):
    params = ctx.ins(op, "Param")
    g = _as_dtype(ctx.ins(op, "Grad"), params[0].dtype)
    step = torch._foreach_mul(g, _lr(ctx, op))
    _write_params(ctx, op, params, torch._foreach_sub(params, step))


@register_op("fused_momentum", differentiable=False)
def _fused_momentum(ctx, op):
    params = ctx.ins(op, "Param")
    g = _as_dtype(ctx.ins(op, "Grad"), torch.float32)
    lr = _lr(ctx, op)
    mu = op.attr("mu")
    v_new = torch._foreach_mul(ctx.ins(op, "Velocity"), mu)
    torch._foreach_add_(v_new, g)
    if op.attr("use_nesterov", False):
        step = torch._foreach_add(g, torch._foreach_mul(v_new, mu))
        torch._foreach_mul_(step, lr)
    else:
        step = torch._foreach_mul(v_new, lr)
    _write_params(ctx, op, params, torch._foreach_sub(params, step))
    _write(ctx, op, "VelocityOut", v_new)


def _fused_adam_family(ctx, op, decay_coeff=None):
    """adam, or adamw with p * (1 - lr * coeff) before the step."""
    params = ctx.ins(op, "Param")
    g = _as_dtype(ctx.ins(op, "Grad"), torch.float32)
    lr = _lr(ctx, op)
    m1n, m2n = _fused_moments(ctx, op, g)
    b1, b2 = _beta_pows(ctx, op)
    lr_t = (lr * torch.sqrt(1 - b2) / (1 - b1)).unbind(0)
    step = torch._foreach_mul(m1n, lr_t)
    den = torch._foreach_sqrt(m2n)
    torch._foreach_add_(den, op.attr("epsilon", 1e-8))
    torch._foreach_div_(step, den)
    pf = _as_dtype(params, torch.float32)
    if decay_coeff is not None:
        pf = torch._foreach_mul(pf, 1.0 - lr * decay_coeff)
    _write_params(ctx, op, params, torch._foreach_sub(pf, step))
    _write(ctx, op, "Moment1Out", m1n)
    _write(ctx, op, "Moment2Out", m2n)
    _write_beta_pows(ctx, op, b1, b2)


@register_op("fused_adam", differentiable=False)
def _fused_adam(ctx, op):
    _fused_adam_family(ctx, op)


@register_op("fused_adamw", differentiable=False)
def _fused_adamw(ctx, op):
    _fused_adam_family(ctx, op, decay_coeff=op.attr("coeff", 0.01))


def _group_norms(ctx, op, tensors):
    """Each tensor's 2-norm (torch._foreach_norm); a parameter sharded over
    a model group gets the norm of the whole parameter, its squares summed
    over the group."""
    norms = torch._foreach_norm(tensors)
    if not ctx.model_dims:
        return norms
    return [torch.sqrt(ctx.model_sum(n, torch.sum(torch.square(t))))
            if n in ctx.model_dims else x
            for n, t, x in zip(op.input("Param"), tensors, norms)]


@register_op("fused_lamb", differentiable=False)
def _fused_lamb(ctx, op):
    """The trust ratio stays per tensor (layer-wise adaptation): the
    group's norms come from torch._foreach_norm, stacked into one [n]
    tensor for the ratio."""
    params = ctx.ins(op, "Param")
    g = _as_dtype(ctx.ins(op, "Grad"), torch.float32)
    pf = _as_dtype(params, torch.float32)
    lr = _lr(ctx, op)
    m1n, m2n = _fused_moments(ctx, op, g)
    b1, b2 = _beta_pows(ctx, op)
    m1h = torch._foreach_div(m1n, (1 - b1).unbind(0))
    m2h = torch._foreach_div(m2n, (1 - b2).unbind(0))
    den = torch._foreach_sqrt(m2h)
    torch._foreach_add_(den, op.attr("epsilon", 1e-6))
    update = torch._foreach_div(m1h, den)
    torch._foreach_add_(update, torch._foreach_mul(pf, op.attr("weight_decay", 0.01)))
    p_norm = torch.stack(_group_norms(ctx, op, pf))
    u_norm = torch.stack(_group_norms(ctx, op, update))
    ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                        torch.ones((), dtype=p_norm.dtype, device=p_norm.device))
    step = torch._foreach_mul(update, (lr * ratio).unbind(0))
    _write_params(ctx, op, params, torch._foreach_sub(pf, step))
    _write(ctx, op, "Moment1Out", m1n)
    _write(ctx, op, "Moment2Out", m2n)
    _write_beta_pows(ctx, op, b1, b2)


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
