"""Short-sequence attention (sq, sk <= 512): the wrappers of the
whole-row forward kernel (csrc/mha_short_fwd.cu) and of the two-pass
backward kernel (csrc/mha_short_bwd.cu), and their plain PyTorch versions.

Counterpart of `paddle_tpu/ops/pallas/mha_short.py`. Each kernel covers
both of the JAX package's entry points through strides:
`short_attention_bshd` ([b, s, h, d]) is layout="bshd" and
`short_attention` ([b, h, s, d]) is layout="bhsd". Its function differs
from the flash kernel's in two places, both kept: the row max is clamped
at NEG_INF / 8, so a row whose keys are all masked gives 0, and dropout
scales kept values by p * (1 / (1 - rate)).
"""

from __future__ import annotations

from .flash_attention import (
    attention_bwd_plain,
    attention_plain,
    launch_attention,
    launch_attention_bwd,
)

__all__ = [
    "MAX_SHORT_SEQ",
    "short_attention_viable",
    "short_attention_plain",
    "short_attention",
    "short_attention_bwd_plain",
    "short_attention_bwd",
]

# the [64, sk] float32 score rows of one block must fit shared memory
MAX_SHORT_SEQ = 512


def short_attention_viable(sq, sk):
    return sq <= MAX_SHORT_SEQ and sk <= MAX_SHORT_SEQ


def short_attention_plain(q, k, v, bias=None, causal=False, sm_scale=None,
                          dropout=0.0, seed=0, layout="bhsd"):
    """Plain version of csrc/mha_short_fwd.cu -> (out, lse [b, h, sq])."""
    return attention_plain(q, k, v, bias, causal, sm_scale, dropout, seed,
                           layout, clamp_max=True)


def short_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    dropout=0.0, seed=0, layout="bhsd"):
    """Short-sequence attention forward -> (out, lse). A CPU tensor runs
    the plain version; a CUDA tensor launches csrc/mha_short_fwd.cu."""
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, bias, causal, sm_scale, dropout,
                                     seed, layout)
    sq, sk = (q.shape[1], k.shape[1]) if layout == "bshd" else (q.shape[2], k.shape[2])
    if not short_attention_viable(sq, sk):
        raise ValueError(f"short attention takes sq, sk <= {MAX_SHORT_SEQ}, "
                         f"got {sq}, {sk}: use flash_attention")
    return launch_attention("mha_short_fwd", q, k, v, bias, causal, sm_scale,
                            dropout, seed, layout)


def short_attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal=False,
                              sm_scale=None, dropout=0.0, seed=0, layout="bhsd"):
    """Plain version of csrc/mha_short_bwd.cu (_bwd_math,
    mha_short.py:149-177) -> (dq, dk, dv)."""
    return attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                               dropout, seed, layout, div=False)


def short_attention_bwd(q, k, v, bias, dout, lse, delta, causal=False, sm_scale=None,
                        dropout=0.0, seed=0, layout="bhsd"):
    """Short-sequence attention backward from the forward's lse and
    delta = rowsum(dO * O) -> (dq, dk, dv). A CPU tensor runs the plain
    version; a CUDA tensor launches csrc/mha_short_bwd.cu."""
    if q.device.type == "cpu":
        return short_attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal,
                                         sm_scale, dropout, seed, layout)
    sq, sk = (q.shape[1], k.shape[1]) if layout == "bshd" else (q.shape[2], k.shape[2])
    if not short_attention_viable(sq, sk):
        raise ValueError(f"short attention takes sq, sk <= {MAX_SHORT_SEQ}, "
                         f"got {sq}, {sk}: use flash_attention_bwd")
    return launch_attention_bwd("mha_short_bwd", q, k, v, bias, dout, lse, delta, causal,
                                sm_scale, dropout, seed, layout)
