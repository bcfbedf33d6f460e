"""The `fused_multihead_attention` lowering, forward and training.

Where the JAX op chooses among the Pallas short kernel, the Pallas flash
kernel and plain XLA by TPU-measured cutovers, this lowering has two
paths and no third: the short kernels whenever sq, sk <= 512 (BERT's
shapes), the flash kernels otherwise. Each path is a
`torch.autograd.Function` over its kernel pair: the forward launches the
forward kernel and saves (q, k, v, bias, out, lse); the backward computes
delta = rowsum(dO * O) in plain torch and launches the backward kernel.
Each wrapper runs its plain version for a CPU tensor and launches the
CUDA kernel for a CUDA tensor. Attention dropout draws its int32 seed
from the threefry key of the op's output name, as the JAX op does
(mha_short.py:567-570, flash_attention.py:634-636), so both packages
drop the same pairs. In a static step (Executor.run_repeated) the seed
is a device word of the step's seed table (`LoweringContext.
attention_seed`), which the kernels read through a pointer, so each
replay of the captured step draws its own mask. On a mesh the kernels
hash global (batch, head) indices, (b * H + h) * 0xC2B2AE35 + seed in
uint32, H the global head count: rank r of the batch group holds rows of
the global batch, so the seed shifts by r * (local batch * H) *
0xC2B2AE35; a rank of a model group holds heads [h0, h0 + local heads)
of H (`LoweringContext.head_shard`), which the kernels take as
`heads_global` / `head0`, since the offset of a local (batch, head)
index from its global one depends on the batch row.
"""

from __future__ import annotations

import torch

from .kernels.flash_attention import attention_delta, flash_attention, flash_attention_bwd
from .kernels.mha_short import short_attention, short_attention_bwd, short_attention_viable
from .registry import register_op


def _kernel_pair_fn(fwd, bwd, name):
    """A torch.autograd.Function whose forward is `fwd` and whose backward
    is `bwd`; it returns no grad for the bias or the seed."""

    class _Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias, causal, sm_scale, dropout, seed, layout,
                    heads_global=None, head0=0):
            out, lse = fwd(q, k, v, bias=bias, causal=causal, sm_scale=sm_scale,
                           dropout=dropout, seed=seed, layout=layout,
                           heads_global=heads_global, head0=head0)
            ctx.save_for_backward(q, k, v, bias, out, lse)
            ctx.args = (causal, sm_scale, dropout, seed, layout, heads_global, head0)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, bias, out, lse = ctx.saved_tensors
            causal, sm_scale, dropout, seed, layout, heads_global, head0 = ctx.args
            delta = attention_delta(out, dout, layout)
            dq, dk, dv = bwd(q, k, v, bias, dout, lse, delta, causal=causal,
                             sm_scale=sm_scale, dropout=dropout, seed=seed,
                             layout=layout, heads_global=heads_global, head0=head0)
            return dq, dk, dv, None, None, None, None, None, None, None, None

    _Attention.__name__ = _Attention.__qualname__ = name
    return _Attention


ShortAttention = _kernel_pair_fn(short_attention, short_attention_bwd, "ShortAttention")
FlashAttention = _kernel_pair_fn(flash_attention, flash_attention_bwd, "FlashAttention")


@register_op("fused_multihead_attention", no_grad_inputs=("KeyBias",))
def _fused_mha(ctx, op):
    """Q/K/V: [b, nh, s, dh] (layout "bhsd") or [b, s, nh, dh] ("bshd");
    optional KeyBias: [b, sk] additive. Out matches the input layout."""
    q, k, v = ctx.amp_cast(op, ctx.in_(op, "Q"), ctx.in_(op, "K"), ctx.in_(op, "V"))
    bias = ctx.in_(op, "KeyBias")
    causal = bool(op.attr("causal", False))
    dropout = float(op.attr("attn_dropout", 0.0))
    if op.attr("is_test", False) or ctx.is_test:
        dropout = 0.0
    sm_scale = op.attr("sm_scale", 0.0) or None
    layout = op.attr("layout", "bhsd") or "bhsd"
    seed = 0
    head_dim = 2 if layout == "bshd" else 1
    heads, head0 = ctx.head_shard(op.input("Q")[0], q.shape[head_dim], head_dim)
    if dropout > 0.0:
        seed = ctx.attention_seed(op.output("Out")[0],
                                  ctx.batch_rank * q.shape[0] * heads * 0xC2B2AE35)
    if bias is not None:
        bias = bias.detach().to(torch.float32).contiguous()
    seq_axis = 1 if layout == "bshd" else 2
    fn = (ShortAttention if short_attention_viable(q.shape[seq_axis], k.shape[seq_axis])
          else FlashAttention)
    ctx.out(op, "Out", fn.apply(q, k, v, bias, causal, sm_scale, dropout, seed, layout,
                                heads, head0))
