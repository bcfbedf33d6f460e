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

Sequence parallelism (after the JAX op, fused_ops.py:253-363 there): on a
mesh whose `model` axis is larger than 1, `sequence_parallel_mode` picks
the formulation from PADDLE_TPU_SP_MODE = ring | ulysses | off; unset, the
ring once the sequence is at least RING_MIN_SEQ and divides by the axis.
The layout plan (parallel/tensor_parallel.py) then shards the sequence
over `model`, and this lowering, given q / k / v sharded on the sequence
dim, runs the ring across the model group (ops/ring_attention.py,
counter `attn_dispatch_ring`) or Ulysses (parallel/ulysses.py,
`attn_dispatch_ulysses`). Within a ring launch the (batch * head) index
is launch-local, as in the JAX package; the seed carries the batch rank's
shift as above.
"""

from __future__ import annotations

import os

import torch

from .. import profiler

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

# the JAX package's rule for which formulation runs (its dispatch table's
# ring_min_seq): the sequence length from which the ring is the default on a
# model axis larger than 1. It is not a speed measured on this card.
RING_MIN_SEQ = 4096


def sequence_parallel_mode(seq_q, seq_k, model_n, env=None):
    """The sequence-parallel formulation of an attention of sequence
    lengths (seq_q, seq_k) on a model axis of `model_n` ranks: "ring",
    "ulysses" or None (none: the axis stays tensor / expert parallelism).
    PADDLE_TPU_SP_MODE (read from `env`, default os.environ) = ring |
    ulysses selects one, off (or empty) none; unset, the ring when
    model_n > 1 and seq_q >= RING_MIN_SEQ and both lengths divide by
    model_n. Raises ValueError for another value, and for an explicit mode
    whose sequence the axis does not divide."""
    raw = (os.environ if env is None else env).get("PADDLE_TPU_SP_MODE")
    mode = (raw or "").strip().lower()
    if mode in ("off", "none", "0"):
        mode = ""
    if mode and mode not in ("ring", "ulysses"):
        raise ValueError(f"PADDLE_TPU_SP_MODE={mode!r}: expected 'ring', 'ulysses' or 'off'")
    if model_n <= 1:
        return None
    divisible = seq_q % model_n == 0 and seq_k % model_n == 0
    if raw is None:
        return "ring" if seq_q >= RING_MIN_SEQ and divisible else None
    if mode and not divisible:
        raise ValueError(
            f"sequence length {seq_q}/{seq_k} not divisible by the model axis ({model_n}) "
            f"- pad the sequence or resize the mesh for PADDLE_TPU_SP_MODE={mode}")
    return mode or None


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
    if ctx.sequence_parallel and ctx.model_dims.get(op.input("Q")[0]) == seq_axis:
        ctx.out(op, "Out", _sequence_parallel(ctx, q, k, v, bias, causal, sm_scale, dropout,
                                              seed, layout))
        return
    fn = (ShortAttention if short_attention_viable(q.shape[seq_axis], k.shape[seq_axis])
          else FlashAttention)
    ctx.out(op, "Out", fn.apply(q, k, v, bias, causal, sm_scale, dropout, seed, layout,
                                heads, head0))


def _sequence_parallel(ctx, q, k, v, bias, causal, sm_scale, dropout, seed, layout):
    """Attention on this rank's sequence chunk of the model group: the ring
    or Ulysses (`ctx.sequence_parallel`)."""
    if ctx.sequence_parallel == "ulysses":
        from ..parallel.ulysses import ulysses_attention

        profiler.bump_counter("attn_dispatch_ulysses")
        return ulysses_attention(q, k, v, ctx.model_group, bias=bias, causal=causal,
                                 sm_scale=sm_scale, dropout=dropout, seed=seed, layout=layout)
    from .ring_attention import ring_attention

    profiler.bump_counter("attn_dispatch_ring")
    return ring_attention(q, k, v, bias=bias, causal=causal, sm_scale=sm_scale,
                          dropout=dropout, seed=seed, layout=layout, group=ctx.model_group)
