"""layer_norm (forward and grad), dropout (forward and grad),
softmax_with_cross_entropy (forward and grad) and lookup_table lowerings.

The LayerNorm forward stays plain torch, as the JAX package keeps its
forward out of Pallas; its grad op launches the LayerNorm backward kernel
(ops/kernels/layer_norm.py) on the card. Dropout masks are the JAX
package's murmur counter hash over the threefry key of the op's output
name (nn_ops.py:699-741 there), so both packages drop the same elements.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.flash_attention import mul32, murmur_mix
from .kernels.layer_norm import ln_bwd
from .registry import register_op


def _layer_norm_grad_maker(op, grad_out_names, block, helpers):
    """layer_norm_grad from X and the saved Mean / Variance, as the JAX
    package emits it (nn_ops.py:487-519)."""
    if grad_out_names.get("Y", [None])[0] is None:
        return None  # only Mean/Variance differentiated: __auto_grad__
    if (grad_out_names.get("Mean", [None])[0] is not None
            or grad_out_names.get("Variance", [None])[0] is not None):
        return None  # cotangents into the stats outputs: __auto_grad__
    inputs = {
        "X": op.input("X"),
        "Mean": [op.output("Mean")[0]],
        "Variance": [op.output("Variance")[0]],
        "GRAD_Y": [grad_out_names["Y"][0]],
    }
    outputs = {"IGRAD_X": [helpers.grad_name(op.input("X")[0])]}
    if op.input("Scale"):
        inputs["Scale"] = op.input("Scale")
        outputs["IGRAD_Scale"] = [helpers.grad_name(op.input("Scale")[0])]
    if op.input("Bias"):
        outputs["IGRAD_Bias"] = [helpers.grad_name(op.input("Bias")[0])]
    return [{
        "type": "layer_norm_grad",
        "inputs": inputs,
        "outputs": outputs,
        "attrs": {
            "epsilon": op.attr("epsilon", 1e-5),
            "begin_norm_axis": op.attr("begin_norm_axis", 1),
        },
    }]


@register_op("layer_norm", grad=_layer_norm_grad_maker)
def _layer_norm(ctx, op):
    x = ctx.in_(op, "X")
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    n = int(np.prod(lead or (1,)))
    scale = ctx.in_(op, "Scale")
    bias = ctx.in_(op, "Bias")
    x2 = x.reshape(n, -1).float()
    mean = x2.mean(dim=1, keepdim=True)
    var = x2.var(dim=1, unbiased=False, keepdim=True)
    y = (x2 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    ctx.out(op, "Y", y.reshape(x.shape).to(x.dtype))
    ctx.out(op, "Mean", mean.reshape(lead))
    ctx.out(op, "Variance", var.reshape(lead))


@register_op("layer_norm_grad", differentiable=False)
def _layer_norm_grad(ctx, op):
    """dX, dScale, dBias from X and the saved per-row stats. Every shape
    goes through ln_bwd (the kernel on the card): the JAX package's
    ln_bwd_viable gate is a TPU VMEM limit, and its plain branch computes
    the same fp32 function. One difference waits for AMP: with bf16 X the
    JAX plain branch rounds dy and the normalized value to bf16 before the
    dScale sum (nn_ops.py:598-605), which the kernel does not."""
    x = ctx.in_(op, "X")
    dy = ctx.in_(op, "GRAD_Y")
    mean = ctx.in_(op, "Mean")
    var = ctx.in_(op, "Variance")
    scale = ctx.in_(op, "Scale")
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    n = int(np.prod(x.shape[:begin] or (1,)))
    k = int(np.prod(x.shape[begin:]))
    rstd = torch.rsqrt(var.reshape(-1).float() + eps)
    sc = (scale.reshape(-1).float() if scale is not None
          else torch.ones((k,), dtype=torch.float32, device=x.device))
    dx, dscale, dbias = ln_bwd(x.reshape(n, k).contiguous(),
                               dy.to(x.dtype).reshape(n, k).contiguous(),
                               mean.reshape(-1).float().contiguous(), rstd.contiguous(),
                               sc.contiguous())
    ctx.out(op, "IGRAD_X", dx.reshape(x.shape))
    if scale is not None and op.output("IGRAD_Scale"):
        ctx.out(op, "IGRAD_Scale", dscale)
    if op.output("IGRAD_Bias"):
        ctx.out(op, "IGRAD_Bias", dbias)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _dropout_grad_maker(op, grad_out_names, block, helpers):
    """dropout_grad regenerates the mask from the key of the forward's Out
    name instead of reading the saved Mask (nn_ops.py:672-696)."""
    if grad_out_names.get("Out", [None])[0] is None:
        return None
    return [{
        "type": "dropout_grad",
        "inputs": {"GRAD_Out": [grad_out_names["Out"][0]]},
        "outputs": {"IGRAD_X": [helpers.grad_name(op.input("X")[0])]},
        "attrs": {
            "dropout_prob": op.attr("dropout_prob", 0.5),
            "dropout_implementation": op.attr("dropout_implementation",
                                              "downgrade_in_infer"),
            "rng_name": op.output("Out")[0],
        },
    }]


def _drop_threshold(p):
    """uint32 threshold of the hash mask (2^-32 granularity)."""
    return min(int(round(p * 2.0**32)), 2**32 - 1)


def _quantized_keep_prob(p):
    """The keep probability the hash mask really has; the forward and the
    grad scale by the same value."""
    return 1.0 - _drop_threshold(p) / 2.0**32


def dropout_keep_mask(key, p, shape, device):
    """(keep bool tensor of `shape`, effective keep prob): one murmur-mixed
    word per element from its flat index and the seed word of the threefry
    `key`, kept when the word is >= round(p * 2^32) (nn_ops.py:720-741)."""
    k0, k1 = key
    seed = int(murmur_mix(torch.tensor(((k0 * 0x9E3779B1) & 0xFFFFFFFF) ^ k1,
                                       dtype=torch.int64)))
    n = int(np.prod(shape)) if len(shape) else 1
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    words = murmur_mix(mul32(i, 0x9E3779B1) ^ seed)
    return words >= _drop_threshold(p), _quantized_keep_prob(p)


@register_op("dropout", grad=_dropout_grad_maker)
def _dropout(ctx, op):
    x = ctx.in_(op, "X")
    p = op.attr("dropout_prob", 0.5)
    is_test = op.attr("is_test", False) or ctx.is_test
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    if is_test or p == 0.0:
        # upscale_in_train -> identity; downgrade_in_infer -> x * (1 - p)
        out = x if impl == "upscale_in_train" or p == 0.0 else x * (1.0 - p)
        ctx.out(op, "Out", out)
        ctx.out(op, "Mask", torch.ones_like(x, dtype=torch.uint8))
        return
    keep, keep_prob = dropout_keep_mask(ctx.rng_for(op.output("Out")[0]), p,
                                        tuple(x.shape), x.device)
    kept = x * (1.0 / keep_prob) if impl == "upscale_in_train" else x
    ctx.out(op, "Out", torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                                           device=x.device)))
    ctx.out(op, "Mask", keep.to(torch.uint8))


@register_op("dropout_grad", differentiable=False, name_attrs=("rng_name",))
def _dropout_grad(ctx, op):
    dy = ctx.in_(op, "GRAD_Out")
    p = op.attr("dropout_prob", 0.5)
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    rng_name = op.attr("rng_name")
    if rng_name is None:
        raise NotImplementedError(
            "dropout_grad without an rng_name attr (a program serialized "
            "before mask regeneration) reads the saved Mask: not ported")
    keep, keep_prob = dropout_keep_mask(ctx.rng_for(rng_name), p, tuple(dy.shape),
                                        dy.device)
    scaled = dy * (1.0 / keep_prob) if impl == "upscale_in_train" else dy
    ctx.out(op, "IGRAD_X", torch.where(keep, scaled, torch.zeros(
        (), dtype=dy.dtype, device=dy.device)))


# ---------------------------------------------------------------------------
# softmax_with_cross_entropy
# ---------------------------------------------------------------------------


def _swce_grad_maker(op, grad_out_names, block, helpers):
    """The classic xent grad from the logits (nn_ops.py:894-930)."""
    if grad_out_names.get("Loss", [None])[0] is None:
        return None
    if grad_out_names.get("Softmax", [None])[0] is not None:
        return None  # cotangent into the Softmax output: __auto_grad__
    return [{
        "type": "softmax_with_cross_entropy_grad",
        "inputs": {
            "Logits": op.input("Logits"),
            "Label": op.input("Label"),
            "GRAD_Loss": [grad_out_names["Loss"][0]],
        },
        "outputs": {"IGRAD_Logits": [helpers.grad_name(op.input("Logits")[0])]},
        "attrs": {
            "soft_label": op.attr("soft_label", False),
            "ignore_index": op.attr("ignore_index", -100),
            "axis": op.attr("axis", -1),
        },
    }]


def _hard_label_index(label, ndim, axis):
    lbl = label.long()
    return lbl.squeeze(axis) if lbl.dim() == ndim else lbl


@register_op("softmax_with_cross_entropy_grad", no_grad_inputs=("Label",))
def _softmax_with_cross_entropy_grad(ctx, op):
    """dLogits = (softmax(logits) - onehot(label)) * dLoss."""
    logits = ctx.in_(op, "Logits")
    axis = op.attr("axis", -1) % logits.dim()
    p = torch.softmax(logits.float(), dim=axis).to(logits.dtype)
    label = ctx.in_(op, "Label")
    dl = ctx.in_(op, "GRAD_Loss").to(p.dtype)
    ignore_index = op.attr("ignore_index", -100)
    if op.attr("soft_label", False):
        lf = label.to(p.dtype)
        dx = (p * lf.sum(dim=axis, keepdim=True) - lf) * dl
    else:
        idx = _hard_label_index(label, p.dim(), axis)
        onehot = torch.nn.functional.one_hot(idx, p.shape[axis]).to(p.dtype)
        dx = (p - onehot.movedim(-1, axis)) * dl
        if ignore_index >= 0:
            dx = torch.where((idx != ignore_index).unsqueeze(axis), dx,
                             torch.zeros((), dtype=p.dtype, device=p.device))
    ctx.out(op, "IGRAD_Logits", dx)


@register_op("softmax_with_cross_entropy", no_grad_inputs=("Label",),
             grad=_swce_grad_maker)
def _softmax_with_cross_entropy(ctx, op):
    """Softmax and the per-row Loss (hard or soft labels)."""
    logits = ctx.in_(op, "Logits")
    label = ctx.in_(op, "Label")
    axis = op.attr("axis", -1) % logits.dim()
    logp = torch.log_softmax(logits.float(), dim=axis)
    if op.attr("soft_label", False):
        loss = -(label.float() * logp).sum(dim=axis, keepdim=True)
    else:
        idx = _hard_label_index(label, logits.dim(), axis)
        loss = -torch.gather(logp, axis, idx.unsqueeze(axis))
        ignore_index = op.attr("ignore_index", -100)
        if ignore_index >= 0:
            loss = torch.where((idx != ignore_index).unsqueeze(axis), loss,
                               torch.zeros((), dtype=loss.dtype, device=loss.device))
    ctx.out(op, "Softmax", torch.exp(logp).to(logits.dtype))
    ctx.out(op, "Loss", loss.to(logits.dtype))


@register_op("lookup_table", no_grad_inputs=("Ids",))
def _lookup_table(ctx, op):
    w = ctx.in_(op, "W")
    idx = ctx.in_(op, "Ids").long()
    padding_idx = op.attr("padding_idx", -1)
    if idx.dim() >= 2 and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    out = torch.nn.functional.embedding(idx.clamp(min=0), w)
    if padding_idx is not None and padding_idx != -1:
        out = out.masked_fill((idx == padding_idx).unsqueeze(-1), 0.0)
    ctx.out(op, "Out", out)
