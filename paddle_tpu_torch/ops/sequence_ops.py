"""The sequence_conv lowering (paddle_tpu/ops/sequence_ops.py:92-116),
dense: [b, t, d] with an optional [b, t] Mask in place of a LoD. The
dygraph SequenceConv runs it eagerly."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("sequence_conv", no_grad_inputs=("Mask",))
def _sequence_conv(ctx, op):
    """A 1-D context window over time (sequence_conv_op.cc) as im2col and
    one matmul; masked positions read as zeros, and a window never reads
    past either end."""
    x = ctx.in_(op, "X")  # [b, t, d]
    w = ctx.in_(op, "Filter")  # [ctx_len * d, out]
    ctx_len = op.attr("contextLength", 3)
    ctx_start = op.attr("contextStart", -(ctx_len // 2))
    mask = ctx.in_(op, "Mask")
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    b, t, d = x.shape
    pos = torch.arange(t, device=x.device)[None, :, None]
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(x, -off, dims=1)
        keep = pos >= -off if off < 0 else pos < t - off
        cols.append(torch.where(keep, shifted, torch.zeros((), dtype=x.dtype,
                                                           device=x.device)))
    im2col = torch.cat(cols, -1)  # [b, t, ctx_len * d]
    ctx.out(op, "Out", (im2col.reshape(b * t, ctx_len * d) @ w).reshape(b, t, -1))
