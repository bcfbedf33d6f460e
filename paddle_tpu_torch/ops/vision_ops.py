"""row_conv, bilinear_tensor_product, conv3d_transpose and spectral_norm
lowerings (paddle_tpu/ops/vision_ops.py:107-135, 358-372, 623-634,
685-710), the graph-mode ops the dygraph classes RowConv,
BilinearTensorProduct, Conv3DTranspose and SpectralNorm run eagerly.
Their grads come from torch autograd through the lowering (the generic
`__auto_grad__`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


@register_op("row_conv")
def _row_conv(ctx, op):
    """Lookahead row convolution (row_conv_op.cc): out[t, d] =
    sum_j filter[j, d] * x[t + j, d], zero past the end; dense [B, T, D]."""
    x = ctx.in_(op, "X")
    f = ctx.in_(op, "Filter")  # [k, D]
    out = torch.zeros_like(x)
    for j in range(f.shape[0]):
        out = out + F.pad(x[..., j:, :], (0, 0, 0, j)) * f[j]
    ctx.out(op, "Out", out)


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, op):
    """out[:, k] = x W_k y^T + b_k (bilinear_tensor_product_op.h)."""
    x = ctx.in_(op, "X")  # [N, dx]
    y = ctx.in_(op, "Y")  # [N, dy]
    w = ctx.in_(op, "Weight")  # [K, dx, dy]
    bias = ctx.in_(op, "Bias")
    out = torch.einsum("ni,kij,nj->nk", x, w, y)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    ctx.out(op, "Out", out)


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, op):
    """Transposed 3D conv over NCDHW, fluid filter [in_c, out_c, kd, kh,
    kw] (torch's conv_transpose3d layout); groups > 1 raises, as in the
    JAX package."""
    x = ctx.in_(op, "Input")
    w = ctx.in_(op, "Filter")
    if (op.attr("groups", 1) or 1) != 1:
        raise NotImplementedError("conv3d_transpose with groups > 1 is not supported yet")
    ctx.out(op, "Output", F.conv_transpose3d(
        x, w, None, list(op.attr("strides", [1, 1, 1])), list(op.attr("paddings", [0, 0, 0])),
        0, 1, list(op.attr("dilations", [1, 1, 1]))))


@register_op("spectral_norm", no_grad_inputs=("U", "V"))
def _spectral_norm(ctx, op):
    """Weight / sigma, sigma from power iteration on the [h, w] matricised
    weight (spectral_norm_op.h) from the warm-start U / V; the iterated
    u / v are constants of the gradient."""
    w = ctx.in_(op, "Weight")
    u = ctx.in_(op, "U").reshape(-1)
    v = ctx.in_(op, "V").reshape(-1)
    dim = int(op.attr("dim", 0))
    eps = float(op.attr("eps", 1e-12))
    perm = [dim] + [i for i in range(w.ndim) if i != dim]
    wm = w.permute(perm).reshape(w.shape[dim], -1)  # [h, wd]
    with torch.no_grad():
        wm_c = wm.detach()
        for _ in range(max(int(op.attr("power_iters", 1)), 0)):
            v = wm_c.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wm_c @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u.detach() @ (wm @ v.detach())
    ctx.out(op, "Out", (w / sigma).to(w.dtype))
