"""Short-sequence attention (sq, sk <= 512): the wrappers of the
whole-row forward kernel (csrc/mha_short_fwd.cu) and of the tensor-core
backward kernel (csrc/mha_short_bwd.cu), their plain PyTorch versions,
and a mirror of the backward's block math.

Counterpart of `paddle_tpu/ops/pallas/mha_short.py`. Each kernel covers
both of the JAX package's entry points through strides:
`short_attention_bshd` ([b, s, h, d]) is layout="bshd" and
`short_attention` ([b, h, s, d]) is layout="bhsd". Its function differs
from the flash kernel's in two places, both kept: the row max is clamped
at NEG_INF / 8, so a row whose keys are all masked gives 0, and dropout
scales kept values by p * (1 / (1 - rate)).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import LAUNCHES
from ._build import load
from .flash_attention import (
    NEG_INF,
    _check_bwd_inputs,
    _dims,
    _drop_scale,
    _dropout_thresh,
    _mma,
    attention_bwd_plain,
    attention_plain,
    dropout_keep_mask,
    launch_attention,
)

__all__ = [
    "MAX_SHORT_SEQ",
    "short_attention_viable",
    "short_attention_plain",
    "short_attention",
    "short_attention_bwd_plain",
    "short_attention_bwd_mirror",
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


def short_attention_bwd_mirror(q, k, v, bias, dout, lse, delta, causal=False,
                               sm_scale=None, dropout=0.0, seed=0, layout="bhsd"):
    """The block math of csrc/mha_short_bwd.cu on the CPU -> (dq, dk, dv):
    every product as the tensor cores make it (`_mma`), p, the keep mask
    and dS in float32 once per pair, p_drop rounded to dO's dtype, dS to
    q's (the scratch), and dQ from that scratch."""
    b, h, sq, sk, d = _dims(q, k, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout == "bshd":
        q, k, v, dout = (t.permute(0, 2, 1, 3) for t in (q, k, v, dout))
    s = _mma(q, k.transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        live = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~live, NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    dp = _mma(dout, v.transpose(-1, -2))
    p_drop = p
    if dropout > 0.0:
        keep = dropout_keep_mask(seed, b, h, sq, sk, dropout, s.device)
        inv = torch.tensor(1.0 / (1.0 - dropout), dtype=torch.float32)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    pd = p_drop.to(dout.dtype)
    ds = (p * (dp - delta.float()[..., None]) * sm_scale).to(q.dtype)
    dv = _mma(pd.transpose(-1, -2), dout)
    dk = _mma(ds.transpose(-1, -2), q)
    dq = _mma(ds, k)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if layout == "bshd":
        grads = tuple(g.permute(0, 2, 1, 3) for g in grads)
    return tuple(g.contiguous() for g in grads)


@functools.cache
def _bwd_fn():
    """The C entry point mha_short_bwd, typed for ctypes."""
    fn = load("mha_short_bwd").mha_short_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_void_p])
    return fn


def short_attention_bwd(q, k, v, bias, dout, lse, delta, causal=False, sm_scale=None,
                        dropout=0.0, seed=0, layout="bhsd"):
    """Short-sequence attention backward from the forward's lse and
    delta = rowsum(dO * O) -> (dq, dk, dv). A CPU tensor runs the plain
    version. A CUDA tensor launches csrc/mha_short_bwd.cu (its two
    launches share a dS scratch [b, h, sq, sk rounded up to 8] of q's
    dtype) on the current stream; it raises on what the kernel does not
    take and on a failed launch."""
    if q.device.type == "cpu":
        return short_attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal,
                                         sm_scale, dropout, seed, layout)
    name = "mha_short_bwd"
    sq, sk = (q.shape[1], k.shape[1]) if layout == "bshd" else (q.shape[2], k.shape[2])
    if not short_attention_viable(sq, sk):
        raise ValueError(f"short attention takes sq, sk <= {MAX_SHORT_SEQ}, "
                         f"got {sq}, {sk}: use flash_attention_bwd")
    (b, h, sq, sk, d), dout, (dq, dk, dv), strides = _check_bwd_inputs(
        name, q, k, v, bias, dout, lse, delta, dropout, layout)
    scratch = torch.empty((b, h, sq, (sk + 7) // 8 * 8), dtype=q.dtype, device=q.device)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        rc = _bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), int(q.dtype == torch.bfloat16), b, h, sq,
            sk, d, strides, float(sm_scale), int(bool(causal)), int(dropout > 0.0),
            float(_drop_scale(name, dropout)),
            _dropout_thresh(dropout) if dropout > 0.0 else 0, int(seed) & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1
    return dq, dk, dv
