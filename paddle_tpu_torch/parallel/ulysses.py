"""Ulysses sequence parallelism: the all-to-all alternative to ring
attention (the port's copy of `paddle_tpu/parallel/ulysses.py`).

Each rank of a `model` group of size n holds its chunk of the sequence,
[b, s/n, h, d] ("bshd") or [b, h, s/n, d] ("bhsd"). An all-to-all
re-shards it to the whole sequence for h/n of the heads, attention runs
there through the port's normal dispatch (the short kernels #1 / #7, or
#2 / #6 in bhsd, where s <= 512; the flash kernels #3-#5 otherwise), and
a second all-to-all returns the sequence chunk. The kernels take
`heads_global = h` and `head0 = rank * h / n`, so attention dropout
hashes global heads and draws the mask of one whole launch. The key bias
[b, s/n] is all-gathered along the sequence. Where the JAX package flips
two sharding constraints and GSPMD emits the all-to-alls, the port calls
`all_to_all_single` over the group (gloo takes CUDA tensors there); each
all-to-all is a `torch.autograd.Function` whose backward is the opposite
all-to-all. Requires num_heads % n == 0.
"""

from __future__ import annotations

import torch

__all__ = ["ulysses_attention", "SeqToHeads", "HeadsToSeq"]


def _seq_head_dims(layout):
    if layout == "bshd":
        return 1, 2
    if layout == "bhsd":
        return 2, 1
    raise ValueError(f"layout must be 'bhsd' or 'bshd', got {layout!r}")


def _all_to_all(x, split_dim, cat_dim, group):
    """Split `x` into n parts along `split_dim`, send part j to rank j, and
    concatenate what rank j sent along `cat_dim` in rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    parts = x.chunk(n, dim=split_dim)
    send = torch.stack(parts, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)


class SeqToHeads(torch.autograd.Function):
    """[.., s/n, .., h, ..] sequence chunk -> [.., s, .., h/n, ..] heads
    chunk; backward: the opposite all-to-all."""

    @staticmethod
    def forward(ctx, x, seq_dim, head_dim, group):
        ctx.args = (seq_dim, head_dim, group)
        return _all_to_all(x, head_dim, seq_dim, group)

    @staticmethod
    def backward(ctx, g):
        seq_dim, head_dim, group = ctx.args
        return _all_to_all(g, seq_dim, head_dim, group), None, None, None


class HeadsToSeq(torch.autograd.Function):
    """The inverse re-shard: heads chunk -> sequence chunk."""

    @staticmethod
    def forward(ctx, x, seq_dim, head_dim, group):
        ctx.args = (seq_dim, head_dim, group)
        return _all_to_all(x, seq_dim, head_dim, group)

    @staticmethod
    def backward(ctx, g):
        seq_dim, head_dim, group = ctx.args
        return _all_to_all(g, head_dim, seq_dim, group), None, None, None


def ulysses_attention(q, k, v, group=None, bias=None, causal=False, sm_scale=None,
                      dropout=0.0, seed=0, layout="bshd"):
    """Attention on this rank's sequence chunk of `group` (None: one rank,
    plain attention): q / k / v [b, s/n, h, d] ("bshd") or [b, h, s/n, d]
    ("bhsd"), an optional additive key bias [b, s/n] float32. `seed`: the
    attention dropout seed of the whole launch (an int, or a 0-dim int32
    device tensor). Returns the output chunk in q's layout and dtype.
    Raises ValueError when the group's size does not divide the heads."""
    from ..ops.fused_ops import FlashAttention, ShortAttention
    from ..ops.kernels.mha_short import short_attention_viable

    seq_dim, head_dim = _seq_head_dims(layout)
    h = q.shape[head_dim]
    n, rank = 1, 0
    if group is not None:
        import torch.distributed as dist

        n, rank = dist.get_world_size(group), dist.get_rank(group)
    if h % n:
        raise ValueError(f"ulysses needs num_heads ({h}) divisible by the model axis ({n})")
    if bias is not None:
        bias = bias.detach().to(torch.float32).contiguous()
    if n > 1:
        q, k, v = (SeqToHeads.apply(t, seq_dim, head_dim, group) for t in (q, k, v))
        if bias is not None:
            from .tensor_parallel import _gather

            bias = _gather(bias, 1, group, n)
    fn = (ShortAttention if short_attention_viable(q.shape[seq_dim], k.shape[seq_dim])
          else FlashAttention)
    out = fn.apply(q, k, v, bias, bool(causal), sm_scale, float(dropout), seed, layout, h,
                   rank * (h // n))
    if n > 1:
        out = HeadsToSeq.apply(out, seq_dim, head_dim, group)
    return out
