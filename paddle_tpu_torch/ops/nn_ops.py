"""conv2d, conv2d_transpose, conv3d, pool2d, batch_norm (forward and
grad), group_norm, layer_norm (forward and grad), dropout (forward and grad), softmax
(forward and grad), softmax_with_cross_entropy (forward and grad),
cross_entropy, square_error_cost and lookup_table lowerings.

Convolutions go to `F.conv2d`, `F.conv_transpose2d` and `F.conv3d`
(cuDNN on the card), as the JAX package leaves them to
`lax.conv_general_dilated` outside any Pallas kernel. The
batch-norm forward and grad are the JAX package's own formulas, not
`F.batch_norm`: shifted one-pass statistics, the biased batch variance in
the running variance, and 1/sqrt(var + eps) in SavedVariance.

The LayerNorm forward stays plain torch, as the JAX package keeps its
forward out of Pallas; its grad op launches the LayerNorm backward kernel
(ops/kernels/layer_norm.py) on the card. Dropout masks are the JAX
package's murmur counter hash over the threefry key of the op's output
name (nn_ops.py:699-741 there), so both packages drop the same elements.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels.flash_attention import mul32, murmur_mix
from .kernels.layer_norm import ln_bwd
from .registry import register_op


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


def _conv_padding(padding, ndim):
    """Fluid paddings -> "SAME" / "VALID" or [(lo, hi)] per spatial dim
    (nn_ops.py:27-36 there)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        padding = [padding] * ndim
    if len(padding) == ndim:
        return [(p, p) for p in padding]
    if len(padding) == 2 * ndim:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(ndim)]
    raise ValueError(f"bad conv padding: {padding}")


def _explicit_pads(pad, spatial, ksize, strides, dilations):
    """[(lo, hi)] per spatial dim; "SAME" pads as XLA does (the output is
    ceil(in / stride), the odd pixel of the total goes to the end)."""
    if pad == "VALID":
        return [(0, 0)] * len(spatial)
    if pad == "SAME":
        pads = []
        for n, k, s, d in zip(spatial, ksize, strides, dilations):
            eff = (k - 1) * d + 1
            total = max((-(-n // s) - 1) * s + eff - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    return pad


@register_op("conv2d")
def _conv2d(ctx, op):
    """Input NCHW, or NHWC with data_format "NHWC" (channels_last on the
    card); Filter OIHW in both.
    The optional Bias [O] and fused_act "relu" are what fuse_conv_bn
    emits. The JAX package rewrites the 7x7/s2 stem on few channels into a
    4x4/s1 conv over space-to-depth input (`_s2d_stem_conv`, a TPU lane
    occupancy trick with the same math); here every conv is one
    F.conv2d, so sums run in another order than there."""
    x = ctx.in_(op, "Input")
    w = ctx.in_(op, "Filter")
    bias = ctx.in_(op, "Bias")
    x, w = ctx.amp_cast(op, x, w)
    strides = list(op.attr("strides", [1, 1]))
    dilations = list(op.attr("dilations", [1, 1]))
    groups = op.attr("groups", 1) or 1
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    # NHWC (passes/layout_opt.py) is channels_last memory: the NCHW view of
    # a contiguous NHWC tensor, so cuDNN runs its NHWC kernels and writes a
    # channels_last output. An input that arrives as a strided view (the
    # boundary transpose of an NCHW tensor) is made channels_last here.
    xc = (x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
          if nhwc else x)
    pads = _explicit_pads(_conv_padding(op.attr("paddings", [0, 0]), 2),
                          xc.shape[2:], w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        xc = F.pad(xc, [pads[1][0], pads[1][1], pads[0][0], pads[0][1]])
        padding = [0, 0]
    out = F.conv2d(xc, w, None, strides, padding, dilations, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    act = op.attr("fused_act", "") or ""
    if act:
        if act != "relu":
            raise ValueError(f"conv2d fused_act supports 'relu', got {act!r}")
        out = torch.relu(out)
    ctx.out(op, "Output", out.permute(0, 2, 3, 1) if nhwc else out)


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, op):
    _conv2d(ctx, op)


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, op):
    """NCHW input, fluid filter [in_c, out_c / groups, kh, kw] (torch's
    conv_transpose2d layout); out = (i - 1) * stride - pad_lo - pad_hi +
    (k - 1) * dilation + 1 per dim, any groups (nn_ops.py:130-200 there).
    Unequal pads crop the unpadded output. String paddings raise: the
    layers never emit them."""
    x = ctx.in_(op, "Input")
    w = ctx.in_(op, "Filter")
    strides = list(op.attr("strides", [1, 1]))
    dilations = list(op.attr("dilations", [1, 1]))
    groups = op.attr("groups", 1) or 1
    pads = _conv_padding(op.attr("paddings", [0, 0]), 2)
    if isinstance(pads, str):
        raise NotImplementedError(
            "conv2d_transpose with SAME / VALID string paddings — pass explicit pads")
    if all(lo == hi for lo, hi in pads):
        out = F.conv_transpose2d(x, w, None, strides, [lo for lo, _ in pads], 0,
                                 groups, dilations)
    else:
        out = F.conv_transpose2d(x, w, None, strides, 0, 0, groups, dilations)
        out = out[:, :, pads[0][0]:out.shape[2] - pads[0][1],
                  pads[1][0]:out.shape[3] - pads[1][1]]
    ctx.out(op, "Output", out)


@register_op("conv3d")
def _conv3d(ctx, op):
    """NCDHW input, OIDHW filter (nn_ops.py:203-215 there)."""
    x = ctx.in_(op, "Input")
    w = ctx.in_(op, "Filter")
    strides = list(op.attr("strides", [1, 1, 1]))
    dilations = list(op.attr("dilations", [1, 1, 1]))
    pads = _explicit_pads(_conv_padding(op.attr("paddings", [0, 0, 0]), 3),
                          x.shape[2:], w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = [0, 0, 0]
    ctx.out(op, "Output", F.conv3d(x, w, None, strides, padding, dilations,
                                   op.attr("groups", 1) or 1))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


@register_op("pool2d")
def _pool2d(ctx, op):
    """Max or avg pooling (nn_ops.py:238-329 there), NCHW or NHWC: global
    pooling, explicit or SAME / VALID paddings, `exclusive` avg (divide by
    the window's in-bounds count wherever there is padding) and
    `ceil_mode`, which pads the end of each dim by stride - 1 as the JAX
    lowering does; and adaptive pooling to an output of `ksize`
    (`_adaptive_pool`)."""
    x = ctx.in_(op, "X")
    ptype = op.attr("pooling_type", "max")
    ksize = list(op.attr("ksize", [2, 2]))
    strides = list(op.attr("strides", ksize))
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    global_pool = op.attr("global_pooling", False)
    adaptive = op.attr("adaptive", False)
    if adaptive and not global_pool and ksize != [1, 1]:
        ctx.out(op, "Out", _adaptive_pool(x, ptype, ksize, nhwc))
        return
    if global_pool or adaptive:
        dims = (1, 2) if nhwc else (2, 3)
        out = (x.amax(dim=dims, keepdim=True) if ptype == "max"
               else x.mean(dim=dims, keepdim=True))
        ctx.out(op, "Out", out)
        return
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    pad = _conv_padding(op.attr("paddings", [0, 0]), 2)
    pads = _explicit_pads(pad, xc.shape[2:], ksize, strides, [1, 1])
    if not isinstance(pad, str) and op.attr("ceil_mode", False):
        pads = [(lo, hi + s - 1) for (lo, hi), s in zip(pads, strides)]
    flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
    padded = isinstance(pad, str) or any(p != (0, 0) for p in pads)
    if ptype == "max":
        xp = F.pad(xc, flat, value=float("-inf")) if padded else xc
        out = F.max_pool2d(xp, ksize, strides)
    else:
        xp = F.pad(xc, flat) if padded else xc
        summed = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
        if op.attr("exclusive", True) and padded:
            ones = F.pad(torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                                    device=xc.device), flat)
            out = summed / F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        else:
            out = summed / float(np.prod(ksize))
    ctx.out(op, "Out", out.permute(0, 2, 3, 1) if nhwc else out)


def _adaptive_mask(size, out_size, device):
    """[out_size, size] float32 bin membership: bin i covers
    [floor(i * size / out), ceil((i + 1) * size / out)), the reference's
    adaptive windows (nn_ops.py:224-235 there)."""
    idx = np.arange(size)
    starts = np.floor(np.arange(out_size) * size / out_size)
    ends = np.ceil((np.arange(out_size) + 1) * size / out_size)
    m = (idx[None, :] >= starts[:, None]) & (idx[None, :] < ends[:, None])
    return torch.from_numpy(m.astype(np.float32)).to(device)


def _adaptive_pool(x, ptype, ksize, nhwc):
    """NCHW adaptive pooling to [oh, ow] = ksize, as the JAX lowering does
    it (nn_ops.py:275-301 there): an even split reshapes and reduces; an
    uneven avg sums each bin through the membership masks in float32 and
    divides by the bin's count; an uneven max raises, as there."""
    if nhwc:
        # layout_opt converts no adaptive pool but the [1, 1] one
        raise ValueError("pool2d: adaptive pooling has no NHWC lowering — layout_opt "
                         "should not have converted this op")
    n, c, h, w = x.shape
    oh, ow = ksize
    if h % oh == 0 and w % ow == 0:
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        return xr.amax(dim=(3, 5)) if ptype == "max" else xr.mean(dim=(3, 5))
    if ptype == "max":
        raise ValueError(f"adaptive max pool needs output sizes dividing the input "
                         f"({oh}x{ow} vs {h}x{w}); use avg, or an even split")
    row_m = _adaptive_mask(h, oh, x.device)
    col_m = _adaptive_mask(w, ow, x.device)
    sums = torch.einsum("ih,jw,nchw->ncij", row_m, col_m, x.float())
    cnt = torch.einsum("ih,jw->ij", row_m, col_m)
    return (sums / cnt).to(x.dtype)


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------


def _batch_norm_grad_maker(op, grad_out_names, block, helpers):
    """batch_norm_grad from X and the saved batch stats (nn_ops.py:337-372
    there); eval-mode grads and cotangents into the stats outputs take
    __auto_grad__."""
    if grad_out_names.get("Y", [None])[0] is None:
        return None
    for stats_slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if grad_out_names.get(stats_slot, [None])[0] is not None:
            return None
    if op.attr("is_test", False) or op.attr("use_global_stats", False):
        return None
    return [{
        "type": "batch_norm_grad",
        "inputs": {
            "X": op.input("X"),
            "Scale": op.input("Scale"),
            "SavedMean": [op.output("SavedMean")[0]],
            "SavedVariance": [op.output("SavedVariance")[0]],
            "GRAD_Y": [grad_out_names["Y"][0]],
        },
        "outputs": {
            "IGRAD_X": [helpers.grad_name(op.input("X")[0])],
            "IGRAD_Scale": [helpers.grad_name(op.input("Scale")[0])],
            "IGRAD_Bias": [helpers.grad_name(op.input("Bias")[0])],
        },
        "attrs": {
            "epsilon": op.attr("epsilon", 1e-5),
            "data_layout": op.attr("data_layout", "NCHW"),
        },
    }]


def _bn_channel_axis(x, layout):
    """The channel axis: 1 in NCHW, the last dim otherwise."""
    return 1 if layout == "NCHW" and x.dim() > 1 else x.dim() - 1


def _bn_bshape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def _batch_sums(ctx, m, *sums):
    """Per-channel `sums` summed over the mesh's batch group (one
    all-reduce; differentiable, for a recompute step's autograd), and the
    element count `m` of a channel over the whole batch."""
    import torch.distributed.nn.functional as dist_fn

    n = [t.numel() for t in sums]
    total = dist_fn.all_reduce(torch.cat([t.reshape(-1) for t in sums]),
                               group=ctx.batch_group)
    return (*(t.view_as(s) for t, s in zip(total.split(n), sums)), m * ctx.batch_ranks)


@register_op("batch_norm_grad", differentiable=False)
def _batch_norm_grad(ctx, op):
    """dx = (gamma * inv / M) * (M * dy - sum(dy) - xhat * dgamma), with
    dgamma = inv * (sum(dy * x) - mean * sum(dy)) and inv the saved
    1/sqrt(var + eps) (nn_ops.py:375-412 there); stats in fp32, dX in X's
    dtype."""
    x = ctx.in_(op, "X")
    scale = ctx.in_(op, "Scale")
    mean = ctx.in_(op, "SavedMean")
    inv = ctx.in_(op, "SavedVariance")
    dy = ctx.in_(op, "GRAD_Y")
    axis = _bn_channel_axis(x, op.attr("data_layout", "NCHW"))
    axes = tuple(i for i in range(x.dim()) if i != axis)
    bshape = _bn_bshape(x, axis)
    m = x.numel() // x.shape[axis]
    xf, dyf = x.float(), dy.float()
    dbeta = dyf.sum(dim=axes)
    dyx = (dyf * xf).sum(dim=axes)
    dgamma = inv * (dyx - mean * dbeta)
    # dX from the sums over the mesh's whole batch; dScale / dBias stay
    # this rank's shares, which the mesh step averages with the other grads
    g_dbeta, g_dgamma = dbeta, dgamma
    if ctx.batch_ranks > 1:
        g_dbeta, g_dyx, m = _batch_sums(ctx, m, dbeta, dyx)
        g_dgamma = inv * (g_dyx - mean * g_dbeta)
    xhat = (xf - mean.reshape(bshape)) * inv.reshape(bshape)
    dx = (scale * inv / m).reshape(bshape) * (
        m * dyf - g_dbeta.reshape(bshape) - xhat * g_dgamma.reshape(bshape))
    ctx.out(op, "IGRAD_X", dx.to(x.dtype))
    if op.output("IGRAD_Scale"):
        ctx.out(op, "IGRAD_Scale", dgamma)
    if op.output("IGRAD_Bias"):
        ctx.out(op, "IGRAD_Bias", dbeta)


@register_op("batch_norm",
             stateful_outputs=("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
             no_grad_inputs=("Mean", "Variance"), grad=_batch_norm_grad_maker)
def _batch_norm(ctx, op):
    """Training mode: batch stats in one pass, shifted by the running mean
    (E[(x - rm)^2] - (E[x] - rm)^2, nn_ops.py:449-475 there), running
    stats updated with momentum from the biased batch variance, and
    SavedVariance = 1/sqrt(var + eps). is_test or use_global_stats
    normalises with the running stats and writes no state. Stats in fp32,
    Y in X's dtype."""
    x = ctx.in_(op, "X")
    scale = ctx.in_(op, "Scale")
    bias = ctx.in_(op, "Bias")
    mean = ctx.in_(op, "Mean")
    var = ctx.in_(op, "Variance")
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    is_test = op.attr("is_test", False) or ctx.is_test
    axis = _bn_channel_axis(x, op.attr("data_layout", "NCHW"))
    axes = tuple(i for i in range(x.dim()) if i != axis)
    bshape = _bn_bshape(x, axis)
    xf = x.float()
    if op.attr("use_global_stats", False) or is_test:
        use_mean, use_var = mean, var
    else:
        m = x.numel() // x.shape[axis]
        rm = mean.float().detach()
        d = xf - rm.reshape(bshape)
        s1 = d.sum(dim=axes)
        s2 = torch.square(d).sum(dim=axes)
        if ctx.batch_ranks > 1:
            s1, s2, m = _batch_sums(ctx, m, s1, s2)
        s1 = s1 / m
        s2 = s2 / m
        use_mean = rm + s1
        use_var = torch.clamp(s2 - torch.square(s1), min=0.0)
        ctx.out(op, "MeanOut", momentum * mean + (1 - momentum) * use_mean)
        ctx.out(op, "VarianceOut", momentum * var + (1 - momentum) * use_var)
        ctx.out(op, "SavedMean", use_mean)
        ctx.out(op, "SavedVariance", 1.0 / torch.sqrt(use_var + eps))
    inv = torch.rsqrt(use_var.reshape(bshape) + eps)
    y = (xf - use_mean.reshape(bshape)) * inv * scale.reshape(bshape) + bias.reshape(bshape)
    ctx.out(op, "Y", y.to(x.dtype))


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------


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


@register_op("group_norm")
def _group_norm(ctx, op):
    """Normalise each group of channels of an NCHW (or N C ...) input by its
    mean and biased variance (nn_ops.py:618-638 there); Mean and Variance
    are [N, groups]."""
    x = ctx.in_(op, "X")
    groups = op.attr("groups", 32)
    eps = op.attr("epsilon", 1e-5)
    n, c = x.shape[:2]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    var, mean = torch.var_mean(xg, axes, correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    scale, bias = ctx.in_(op, "Scale"), ctx.in_(op, "Bias")
    bshape = (1, c) + (1,) * (x.ndim - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    ctx.out(op, "Y", y)
    ctx.out(op, "Mean", mean.reshape(n, groups))
    ctx.out(op, "Variance", var.reshape(n, groups))


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
    the same fp32 function; with bf16 X both round dy and the normalized
    value to bf16 before the dScale sum, as the JAX plain branch does
    (nn_ops.py:598-605 there)."""
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


def dropout_keep_mask(seed, p, shape, device, global_shape=None, starts=None):
    """(keep bool tensor of `shape`, effective keep prob): one murmur-mixed
    word per element from its flat index in the global tensor and the seed
    word (`LoweringContext.dropout_seed`: an int, or an int64 device scalar
    in [0, 2^32) in a static step), kept when the word is >= round(p *
    2^32) (nn_ops.py:720-741). `global_shape` / `starts`: the tensor the
    whole mesh computes and where this chunk starts in it, per dim
    (`LoweringContext.global_place`); by default the chunk is the whole
    tensor. On a mesh, rank r's rows of a batch-split tensor start at r
    times its rows, so its indices are the old `offset` one, r times its
    element count, on."""
    shape = tuple(int(s) for s in shape)
    if global_shape is None:
        global_shape, starts = shape, (0,) * len(shape)
    n = int(np.prod(shape)) if shape else 1
    if tuple(global_shape[1:]) == shape[1:] and not any(starts[1:]):
        # rows of the global tensor: one contiguous run of flat indices
        first = int(starts[0]) * (n // shape[0]) if shape and shape[0] else 0
        i = torch.arange(first, first + n, dtype=torch.int64, device=device).reshape(shape)
    else:
        i = torch.zeros(shape, dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(shape))):
            view = [1] * len(shape)
            view[d] = shape[d]
            ar = torch.arange(starts[d], starts[d] + shape[d], dtype=torch.int64, device=device)
            i = i + (ar * stride).reshape(view)
            stride *= int(global_shape[d])
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
    keep, keep_prob = dropout_keep_mask(ctx.dropout_seed(op.output("Out")[0]), p,
                                        tuple(x.shape), x.device,
                                        *ctx.global_place(op.input("X")[0], x.shape))
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
    if rng_name is not None:
        # regenerate the forward's mask bit for bit from the shared rng
        keep, keep_prob = dropout_keep_mask(ctx.dropout_seed(rng_name), p, tuple(dy.shape),
                                            dy.device, *ctx.global_place(rng_name, dy.shape))
    else:
        # a program serialized before mask regeneration: the saved Mask
        mask = ctx.in_(op, "Mask")
        if mask is None:
            raise ValueError("dropout_grad needs either an 'rng_name' attr or a saved "
                             "'Mask' input; this op has neither")
        keep, keep_prob = mask.bool(), _quantized_keep_prob(p)
    scaled = dy * (1.0 / keep_prob) if impl == "upscale_in_train" else dy
    ctx.out(op, "IGRAD_X", torch.where(keep, scaled, torch.zeros(
        (), dtype=dy.dtype, device=dy.device)))


# ---------------------------------------------------------------------------
# softmax, cross_entropy and softmax_with_cross_entropy
# ---------------------------------------------------------------------------


def _softmax_grad_maker(op, grad_out_names, block, helpers):
    """softmax_grad from the op's own output (nn_ops.py:799-818 there)."""
    if grad_out_names.get("Out", [None])[0] is None:
        return None
    return [{
        "type": "softmax_grad",
        "inputs": {"Out": [op.output("Out")[0]], "GRAD_Out": [grad_out_names["Out"][0]]},
        "outputs": {"IGRAD_X": [helpers.grad_name(op.input("X")[0])]},
        "attrs": {"axis": op.attr("axis", -1)},
    }]


@register_op("softmax_grad")
def _softmax_grad(ctx, op):
    """dX = (dY - sum(dY * Y, axis)) * Y in fp32, in Y's dtype."""
    yf = ctx.in_(op, "Out").float()
    dyf = ctx.in_(op, "GRAD_Out").float()
    axis = op.attr("axis", -1)
    dx = (dyf - (dyf * yf).sum(dim=axis, keepdim=True)) * yf
    ctx.out(op, "IGRAD_X", dx.to(ctx.in_(op, "Out").dtype))


@register_op("softmax", grad=_softmax_grad_maker)
def _softmax(ctx, op):
    """fp32 inside, also under bf16 AMP; Out in X's dtype."""
    x = ctx.in_(op, "X")
    ctx.out(op, "Out", torch.softmax(x.float(), dim=op.attr("axis", -1)).to(x.dtype))


@register_op("cross_entropy", no_grad_inputs=("Label",))
def _cross_entropy(ctx, op):
    """-log(p[label] + 1e-12) from probabilities X (hard labels, with
    ignore_index), or -sum(label * log(p + 1e-12)) (soft labels)."""
    x = ctx.in_(op, "X")
    label = ctx.in_(op, "Label")
    eps = 1e-12
    if op.attr("soft_label", False):
        loss = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        idx = _hard_label_index(label, x.dim(), -1)
        loss = -torch.log(torch.gather(x, -1, idx.unsqueeze(-1)) + eps)
        ignore_index = op.attr("ignore_index", -100)
        if ignore_index >= 0:
            loss = torch.where((idx != ignore_index).unsqueeze(-1), loss,
                               torch.zeros((), dtype=loss.dtype, device=loss.device))
    ctx.out(op, "Y", loss)


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


@register_op("square_error_cost")
def _square_error_cost(ctx, op):
    ctx.out(op, "Out", torch.square(ctx.in_(op, "X") - ctx.in_(op, "Y")))


@register_op("lookup_table", no_grad_inputs=("Ids",))
def _lookup_table(ctx, op):
    w = ctx.in_(op, "W")
    idx = ctx.in_(op, "Ids").long()
    padding_idx = op.attr("padding_idx", -1)
    if idx.dim() >= 2 and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    out = torch.nn.functional.embedding(idx.clamp(min=0), w)
    # AMP: the gathered rows are cast, not the table (nn_ops.py:1096 there)
    (out,) = ctx.amp_cast(op, out)
    if padding_idx is not None and padding_idx != -1:
        out = out.masked_fill((idx == padding_idx).unsqueeze(-1), 0.0)
    ctx.out(op, "Out", out)
