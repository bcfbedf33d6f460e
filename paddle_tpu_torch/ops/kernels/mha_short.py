"""Short-sequence attention (sq, sk <= 512): the wrappers of the
tensor-core forward and backward kernels (csrc/mha_short_fwd.cu,
csrc/mha_short_bwd.cu), their plain PyTorch versions, and mirrors of
their block math.

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

from . import CAUSAL_LAUNCHES, LAUNCHES, dtype_code
from ._build import load
from .flash_attention import (
    NEG_INF,
    NEG_INF_F32,
    _check_bwd_inputs,
    _dims,
    _drop_scale,
    _dropout_thresh,
    _mma,
    attention_bwd_plain,
    attention_plain,
    dropout_keep_mask,
    head_args,
    launch_attention,
    seed_args,
)

__all__ = [
    "MAX_SHORT_SEQ",
    "short_attention_viable",
    "short_attention_plain",
    "short_attention",
    "short_attention_fwd_mirror",
    "short_attention_bwd_plain",
    "short_attention_bwd_mirror",
    "short_attention_bwd",
]

# the JAX package's short kernels take sq, sk <= 512; longer sequences go
# to the flash kernels
MAX_SHORT_SEQ = 512
# csrc/mha_short_fwd.cu: keys of a warp's tile, and the key groups of a
# block (ShortFwdTile::NKW there): key tile i goes to group i % groups
SHORT_FWD_TILE = 64
SHORT_FWD_KEY_GROUPS = 2
# the kernel's base-2 constants, as float32 computes them
# (attn_common.cuh FLASH_LOG2E, FLASH_LN2, FLASH_NEG_INF2)
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
_LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)
_NEG_INF2 = torch.tensor(NEG_INF, dtype=torch.float32) * _LOG2E


def short_attention_viable(sq, sk):
    return sq <= MAX_SHORT_SEQ and sk <= MAX_SHORT_SEQ


def short_attention_plain(q, k, v, bias=None, causal=False, sm_scale=None,
                          dropout=0.0, seed=0, layout="bhsd", heads_global=None, head0=0):
    """Plain version of csrc/mha_short_fwd.cu -> (out, lse [b, h, sq])."""
    return attention_plain(q, k, v, bias, causal, sm_scale, dropout, seed,
                           layout, clamp_max=True, heads_global=heads_global, head0=head0)


def short_attention_fwd_mirror(q, k, v, bias=None, causal=False, sm_scale=None,
                               dropout=0.0, seed=0, layout="bhsd", heads_global=None, head0=0):
    """The block math of csrc/mha_short_fwd.cu on the CPU -> (out, lse).
    Each key group walks its 64-key tiles (tile i in group i % groups) in
    order with an online softmax in base 2 and float32, its running max
    starting at the clamp NEG_INF log2(e) / 8; p rounded to v's dtype
    before P V; every product as the tensor cores make it (`_mma`). Then
    the groups' (m, l, acc) merge in order, and a row with l == 0 gets lse
    NEG_INF / 8. The kernel skips tiles past the causal diagonal; those add
    p = 0 and keep the running max, so walking them here changes nothing."""
    b, h, sq, sk, d = _dims(q, k, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout == "bshd":
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    scale2 = torch.tensor(sm_scale, dtype=torch.float32) * _LOG2E
    keep = dropout_keep_mask(seed, b, h, sq, sk, dropout, q.device, heads_global,
                             head0) if dropout > 0.0 else None
    mul = torch.tensor(1.0 / (1.0 - dropout), dtype=torch.float32)
    groups, T = SHORT_FWD_KEY_GROUPS, SHORT_FWD_TILE
    parts = []
    for kw in range(groups):
        m = torch.full((b, h, sq, 1), float(_NEG_INF2 / 8), dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, sq, d, dtype=torch.float32)
        for k0 in range(kw * T, sk, groups * T):
            k1 = min(k0 + T, sk)
            s = _mma(q, k[:, :, k0:k1].transpose(-1, -2)) * scale2
            if bias is not None:
                s = s + bias.float()[:, None, None, k0:k1] * _LOG2E
            if causal:
                live = torch.arange(sq)[:, None] + (sk - sq) >= torch.arange(k0, k1)[None, :]
                s = s.masked_fill(~live, float(_NEG_INF2))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            if keep is not None:
                p = torch.where(keep[:, :, :, k0:k1], p * mul, 0.0)
            acc = alpha * acc + _mma(p.to(v.dtype), v[:, :, k0:k1])
            m = m_new
        parts.append((m, l, acc))
    m, l, acc = parts[0]
    for m_w, l_w, acc_w in parts[1:]:
        m_new = torch.maximum(m, m_w)
        a0, a1 = torch.exp2(m - m_new), torch.exp2(m_w - m_new)
        l, acc, m = a0 * l + a1 * l_w, a0 * acc + a1 * acc_w, m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF_F32 / 8, m * _LN2 + torch.log(l_safe)).squeeze(-1)
    if layout == "bshd":
        out = out.permute(0, 2, 1, 3)
    return out.contiguous(), lse


def short_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    dropout=0.0, seed=0, layout="bhsd", heads_global=None, head0=0):
    """Short-sequence attention forward -> (out, lse). A CPU tensor runs
    the plain version. A CUDA tensor launches csrc/mha_short_fwd.cu (the
    tensor cores: 3xTF32 for fp32, bf16 and fp16 with fp32 sums) on the current
    stream; it raises on what the kernel does not take (sq or sk > 512
    among it) and on a failed launch."""
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, bias, causal, sm_scale, dropout,
                                     seed, layout, heads_global, head0)
    sq, sk = (q.shape[1], k.shape[1]) if layout == "bshd" else (q.shape[2], k.shape[2])
    if not short_attention_viable(sq, sk):
        raise ValueError(f"short attention takes sq, sk <= {MAX_SHORT_SEQ}, "
                         f"got {sq}, {sk}: use flash_attention")
    return launch_attention("mha_short_fwd", q, k, v, bias, causal, sm_scale,
                            dropout, seed, layout, heads_global, head0)


def short_attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal=False,
                              sm_scale=None, dropout=0.0, seed=0, layout="bhsd",
                              heads_global=None, head0=0):
    """Plain version of csrc/mha_short_bwd.cu (_bwd_math,
    mha_short.py:149-177) -> (dq, dk, dv)."""
    return attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                               dropout, seed, layout, div=False, heads_global=heads_global,
                               head0=head0)


def short_attention_bwd_mirror(q, k, v, bias, dout, lse, delta, causal=False,
                               sm_scale=None, dropout=0.0, seed=0, layout="bhsd",
                               heads_global=None, head0=0):
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
        keep = dropout_keep_mask(seed, b, h, sq, sk, dropout, s.device, heads_global, head0)
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
                      ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
                      ctypes.c_void_p])
    return fn


def short_attention_bwd(q, k, v, bias, dout, lse, delta, causal=False, sm_scale=None,
                        dropout=0.0, seed=0, layout="bhsd", heads_global=None, head0=0):
    """Short-sequence attention backward from the forward's lse and
    delta = rowsum(dO * O) -> (dq, dk, dv). A CPU tensor runs the plain
    version. A CUDA tensor launches csrc/mha_short_bwd.cu (its two
    launches share a dS scratch [b, h, sq, sk rounded up to 8] of q's
    dtype) on the current stream; it raises on what the kernel does not
    take and on a failed launch."""
    if q.device.type == "cpu":
        return short_attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal,
                                         sm_scale, dropout, seed, layout, heads_global, head0)
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
            dv.data_ptr(), scratch.data_ptr(), dtype_code(q.dtype), b, h, sq,
            sk, d, strides, float(sm_scale), int(bool(causal)), int(dropout > 0.0),
            float(_drop_scale(name, dropout)),
            _dropout_thresh(dropout) if dropout > 0.0 else 0,
            *head_args(name, h, heads_global, head0), *seed_args(name, seed, q),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1
    CAUSAL_LAUNCHES[name] += bool(causal)
    return dq, dk, dv
