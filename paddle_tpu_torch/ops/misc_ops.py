"""Metric op lowerings: accuracy (paddle_tpu/ops/misc_ops.py:12-21)."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("accuracy", differentiable=False)
def _accuracy(ctx, op):
    """The share of rows whose label is among their top-k Indices [N, k]:
    Accuracy [1] float32, Correct and Total [1] int32."""
    indices = ctx.in_(op, "Indices")
    lbl = ctx.in_(op, "Label").to(torch.int32)
    if lbl.dim() == 2:
        lbl = lbl.squeeze(-1)
    hit = (indices.to(torch.int32) == lbl[:, None]).any(dim=1)
    ctx.out(op, "Accuracy", hit.float().mean().reshape(1))
    ctx.out(op, "Correct", hit.to(torch.int32).sum().to(torch.int32).reshape(1))
    # a fill on the device: a tensor copied from the host would wait for
    # the device to finish the step so far
    ctx.out(op, "Total", torch.full((1,), lbl.shape[0], dtype=torch.int32, device=lbl.device))
