"""Attention over any sequence length: the wrappers of the blocked
online-softmax CUDA kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu), their
plain PyTorch versions, mirrors of their block math, and the launch
plumbing and tensor-core emulation the short and flash kernels share.

Counterpart of `paddle_tpu/ops/pallas/flash_attention.py`. Semantics: q
[b, h, sq, d] (layout "bhsd") or [b, sq, h, d] ("bshd"), k / v likewise
with sk, an optional additive [b, sk] float32 key bias, a bottom-right
aligned causal mask (offset sk - sq), and dropout from the murmur hash of
the global (batch*head, query, key) coordinates and an int32 seed — the
same mask, bit for bit, as the Pallas kernels draw. The seed is an int,
passed by value, or a 0-dim int32 tensor on the card, whose word the
kernels read through a pointer (the Pallas kernels' `seed_ref`). Every
function takes `heads_global` / `head0`: its h heads are heads [head0,
head0 + h) of `heads_global` (a tensor-parallel rank's chunk), and the
hash takes the global (batch, head) index b * heads_global + head0 + h;
by default (None, 0) the heads are all of them, and the mask is the
whole launch's. Every forward
returns (out, lse): out in q's layout and dtype, lse [b, h, sq] float32.
Every backward takes the forward's lse and delta = rowsum(dO * O)
[b, h, sq] float32 and returns (dq, dk, dv) in the layout and dtypes of
q, k, v.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import CAUSAL_LAUNCHES, LAUNCHES, dtype_code
from ._build import load

NEG_INF = -1e30
# NEG_INF as float32 holds it: the lse of a row with no live key
NEG_INF_F32 = float(torch.tensor(NEG_INF, dtype=torch.float32))
MAX_HEAD_DIM = 128

__all__ = [
    "NEG_INF",
    "mul32",
    "murmur_mix",
    "seed_word",
    "dropout_keep_mask",
    "seed_args",
    "head_args",
    "attention_plain",
    "flash_attention_plain",
    "flash_attention_fwd_mirror",
    "flash_attention",
    "attention_bwd_plain",
    "flash_attention_bwd_plain",
    "flash_attention_bwd_mirror",
    "flash_attention_bwd",
    "attention_delta",
    "tf32_round",
]

_M32 = 0xFFFFFFFF


def mul32(x, c):
    """(x * c) mod 2**32 for int64 tensors x < 2**32, without overflowing
    int64: split x into 16-bit halves."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def murmur_mix(x):
    """The murmur3 finalizer on uint32 values held in an int64 tensor."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seed_word(seed):
    """An attention dropout seed as the hash takes it: an int's low 32 bits,
    or a 0-dim int32 device tensor's word (a seed slot, read on the device)
    as an int64 tensor in [0, 2**32)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _M32
    return int(seed) & _M32


def dropout_keep_mask(seed, b, h, sq, sk, rate, device, heads_global=None, head0=0):
    """[b, h, sq, sk] keep mask: the hash of flash_attention._dropout_keep /
    mha_short._keep3 (and csrc/attn_common.cuh) in int64 arithmetic. `seed`:
    an int or a 0-dim int32 tensor on `device` (`seed_word`). The h heads
    are heads [head0, head0 + h) of `heads_global` (default: all h)."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    hg = h if heads_global is None else int(heads_global)
    bh = (ar(b) * hg + int(head0)).view(b, 1, 1, 1) + ar(h).view(1, h, 1, 1)
    qi = ar(sq).view(1, 1, sq, 1)
    ki = ar(sk).view(1, 1, 1, sk)
    x = (mul32(qi, 0x9E3779B1) ^ mul32(ki, 0x85EBCA6B)
         ^ ((seed_word(seed) + mul32(bh, 0xC2B2AE35)) & _M32))
    return murmur_mix(x) >= _dropout_thresh(rate)


def _dropout_thresh(rate):
    return min(int(rate * 2**32), 2**32 - 1)


def _dims(q, k, layout):
    if layout == "bshd":
        b, sq, h, d = q.shape
        sk = k.shape[1]
    elif layout == "bhsd":
        b, h, sq, d = q.shape
        sk = k.shape[2]
    else:
        raise ValueError(f"layout must be 'bhsd' or 'bshd', got {layout!r}")
    return b, h, sq, sk, d


def attention_plain(q, k, v, bias=None, causal=False, sm_scale=None, dropout=0.0,
                    seed=0, layout="bhsd", clamp_max=False, heads_global=None, head0=0):
    """The plain PyTorch forward both kernels are held against. The math runs
    in float64, so the reference's own rounding stays far below the fp32
    tolerances whatever algorithm the backend's matmul picks (fp32 matmuls
    on this path were seen to drift by 4e-5 now and then on an AMX CPU);
    p is rounded to v's dtype before P.V, as the kernels do. `clamp_max`
    selects the short kernel's row max clamp at NEG_INF / 8 (a fully masked
    row gives 0) and its dropout scaling p * (1/(1-rate)); without it this
    is the flash kernel's function (p / (1-rate), unclamped max)."""
    b, h, sq, sk, d = _dims(q, k, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout == "bshd":
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.double()[:, None, None, :]
    if causal:
        live = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~live, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if clamp_max:
        m = m.clamp(min=NEG_INF / 8)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout > 0.0:
        keep = dropout_keep_mask(seed, b, h, sq, sk, dropout, s.device, heads_global, head0)
        kept = p * (1.0 / (1.0 - dropout)) if clamp_max else p / (1.0 - dropout)
        p = torch.where(keep, kept, torch.zeros((), device=p.device))
    acc = torch.matmul(p.to(v.dtype).double(), v.double())
    l_safe = torch.where(l == 0.0, torch.ones((), device=l.device), l)
    out = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).squeeze(-1).float()
    if layout == "bshd":
        out = out.permute(0, 2, 1, 3)
    return out.contiguous(), lse


def attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal=False, sm_scale=None,
                        dropout=0.0, seed=0, layout="bhsd", div=True, heads_global=None,
                        head0=0):
    """The plain PyTorch backward both backward kernels are held against,
    in float64 inside: p = exp(s - lse), dp = dO V^T, dropout on both with
    the forward's mask, dV = (p_drop as dO's dtype)^T dO,
    dS = (p (dp - delta) scale as q's dtype), dQ = dS K, dK = dS^T Q.
    `div` selects the flash kernel's p / (1 - rate); without it kept
    values are scaled by p * (1 / (1 - rate)), the short kernel's. Masked
    scores take NEG_INF as float32 holds it, as the kernels' float32 scores
    do: a row with no live key (causal sq > sk) has lse = that value from
    the flash forward, so its p = exp(0) = 1 on every key, as in the
    Pallas kernels (in float64 NEG_INF - lse would be 1.5e22)."""
    b, h, sq, sk, d = _dims(q, k, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout == "bshd":
        q, k, v, dout = (t.permute(0, 2, 1, 3) for t in (q, k, v, dout))
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.double()[:, None, None, :]
    if causal:
        live = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~live, NEG_INF_F32)
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.matmul(dout.double(), v.double().transpose(-1, -2))
    p_drop = p
    if dropout > 0.0:
        keep = dropout_keep_mask(seed, b, h, sq, sk, dropout, s.device, heads_global, head0)
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        scaled = (lambda x: x / (1.0 - dropout)) if div else (
            lambda x: x * (1.0 / (1.0 - dropout)))
        p_drop = torch.where(keep, scaled(p), zero)
        dp = torch.where(keep, scaled(dp), zero)
    dv = torch.matmul(p_drop.to(dout.dtype).double().transpose(-1, -2), dout.double())
    ds = (p * (dp - delta.double()[..., None]) * sm_scale).to(q.dtype).double()
    dq = torch.matmul(ds, k.double())
    dk = torch.matmul(ds.transpose(-1, -2), q.double())
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if layout == "bshd":
        grads = tuple(g.permute(0, 2, 1, 3) for g in grads)
    return tuple(g.contiguous() for g in grads)


def attention_delta(out, dout, layout):
    """delta = rowsum(dO * O) as [b, h, sq] float32, computed outside the
    kernels as the JAX package computes it (mha_short.py:505-507)."""
    delta = (out.float() * dout.float()).sum(-1)
    return (delta.transpose(1, 2) if layout == "bshd" else delta).contiguous()


def flash_attention_plain(q, k, v, bias=None, causal=False, sm_scale=None,
                          dropout=0.0, seed=0, layout="bhsd", heads_global=None, head0=0):
    """Plain version of csrc/flash_fwd.cu (the JAX package's
    _attention_unfused semantics, plus lse)."""
    return attention_plain(q, k, v, bias, causal, sm_scale, dropout, seed,
                           layout, clamp_max=False, heads_global=heads_global, head0=head0)


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as `cvt.rna.tf32.f32` rounds: round the low 13 bits of the
    magnitude."""
    bits = x.float().contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((bits & -2**31) | mag).view(torch.float32)


def _mma(a, b):
    """a @ b as the kernels' tensor cores make it, in float32. float32
    inputs: 3xTF32 (a = hi + lo, hi*hi + hi*lo + lo*hi); bf16 and fp16
    inputs: exact products. The TF32 products are exact in float64, where they are
    summed, and the sum rounds once to float32 (the card's fp32
    accumulation rounds at each step, a difference far below the
    tolerances)."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return torch.matmul(a.double(), b.double()).float()
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (torch.matmul(ah.double(), bh.double()) + torch.matmul(ah.double(), bl.double())
            + torch.matmul(al.double(), bh.double())).float()


# the query rows and keys of one tile of csrc/flash_fwd.cu
FLASH_TILE = 64


def flash_attention_fwd_mirror(q, k, v, bias=None, causal=False, sm_scale=None,
                               dropout=0.0, seed=0, layout="bhsd", heads_global=None, head0=0):
    """The block math of csrc/flash_fwd.cu on the CPU -> (out, lse): 64-row
    query tiles, each walking its 64-key tiles in order and skipping those
    past the causal diagonal, except in a query tile that holds a row with
    no live key (sq > sk), which walks every tile as the plain version's
    function needs; m, l, alpha and acc in float32; every product as the
    tensor cores make it (`_mma`), p rounded to v's dtype before P V."""
    b, h, sq, sk, d = _dims(q, k, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout == "bshd":
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    offset, T = sk - sq, FLASH_TILE
    keep = dropout_keep_mask(seed, b, h, sq, sk, dropout, q.device, heads_global,
                             head0) if dropout > 0.0 else None
    out = torch.empty(b, h, sq, d, dtype=q.dtype)
    lse = torch.empty(b, h, sq, dtype=torch.float32)
    for q0 in range(0, sq, T):
        q1 = min(q0 + T, sq)
        rows = torch.arange(q0, q1)
        # the last live key of the tile's last row; a row with none: every tile
        k_end = min(sk, q1 + offset) if causal and q0 + offset >= 0 else sk
        m = torch.full((b, h, q1 - q0, 1), NEG_INF, dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, q1 - q0, d, dtype=torch.float32)
        for k0 in range(0, k_end, T):
            k1 = min(k0 + T, sk)
            s = _mma(q[:, :, q0:q1], k[:, :, k0:k1].transpose(-1, -2)) * sm_scale
            if bias is not None:
                s = s + bias.float()[:, None, None, k0:k1]
            if causal:
                live = rows[:, None] + offset >= torch.arange(k0, k1)[None, :]
                s = s.masked_fill(~live, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            if keep is not None:
                div = torch.tensor(1.0 - dropout, dtype=torch.float32)
                p = torch.where(keep[:, :, q0:q1, k0:k1], p / div, 0.0)
            acc = alpha * acc + _mma(p.to(v.dtype), v[:, :, k0:k1])
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[:, :, q0:q1] = (acc / l_safe).to(q.dtype)
        lse[:, :, q0:q1] = (m + torch.log(l_safe)).squeeze(-1)
    if layout == "bshd":
        out = out.permute(0, 2, 1, 3)
    return out.contiguous(), lse


def flash_attention_bwd_mirror(q, k, v, bias, dout, lse, delta, causal=False,
                               sm_scale=None, dropout=0.0, seed=0, layout="bhsd",
                               heads_global=None, head0=0):
    """The block math of csrc/flash_bwd.cu on the CPU -> (dq, dk, dv).
    Launch 1: 32-key tiles, each walking its query tiles (64 rows, 32 at
    d > 64) in order, from the first that sees any of its keys, and every
    tile that holds a row with no live key (causal sq > sk). Launch 2:
    32-row query tiles, each walking its 64-key tiles in order up to the
    last key its last row sees (all of them in a tile with a row with no
    live key). Per tile pair p, the keep mask and dS in float32, p_drop
    rounded to dO's dtype and dS to q's, every product as the tensor cores
    make it (`_mma`), each sum in float32 over the tiles in order."""
    b, h, sq, sk, d = _dims(q, k, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout == "bshd":
        q, k, v, dout = (t.permute(0, 2, 1, 3) for t in (q, k, v, dout))
    offset, T, T2 = sk - sq, FLASH_TILE, FLASH_TILE // 2
    keep = dropout_keep_mask(seed, b, h, sq, sk, dropout, q.device, heads_global,
                             head0) if dropout > 0.0 else None
    lse, delta = lse.float()[..., None], delta.float()[..., None]

    def tile(q0, q1, k0, k1):
        """(p_drop as dO's dtype, dS as q's dtype) of one tile pair."""
        s = _mma(q[:, :, q0:q1], k[:, :, k0:k1].transpose(-1, -2)) * sm_scale
        if bias is not None:
            s = s + bias.float()[:, None, None, k0:k1]
        if causal:
            live = torch.arange(q0, q1)[:, None] + offset >= torch.arange(k0, k1)[None, :]
            s = s.masked_fill(~live, NEG_INF)
        p = torch.exp(s - lse[:, :, q0:q1])
        dp = _mma(dout[:, :, q0:q1], v[:, :, k0:k1].transpose(-1, -2))
        pd = p
        if keep is not None:
            kept = keep[:, :, q0:q1, k0:k1]
            div = torch.tensor(1.0 - dropout, dtype=torch.float32)
            pd = torch.where(kept, p / div, 0.0)
            dp = torch.where(kept, dp / div, 0.0)
        return pd.to(dout.dtype), (p * (dp - delta[:, :, q0:q1]) * sm_scale).to(q.dtype)

    # launch 1: dK and dV over the query tiles of each key tile
    tq = T if d <= 64 else T2
    nqt = -(-sq // tq)
    dead = min(nqt, -(offset // tq)) if causal and offset < 0 else 0
    dk = torch.zeros(b, h, sk, d, dtype=torch.float32)
    dv = torch.zeros(b, h, sk, d, dtype=torch.float32)
    for k0 in range(0, sk, T2):
        k1 = min(k0 + T2, sk)
        first = max(0, k0 - offset) // tq if causal else 0
        for i in [i for i in range(nqt) if i < dead or i >= first]:
            q0, q1 = i * tq, min(i * tq + tq, sq)
            pd, ds = tile(q0, q1, k0, k1)
            dv[:, :, k0:k1] += _mma(pd.transpose(-1, -2), dout[:, :, q0:q1])
            dk[:, :, k0:k1] += _mma(ds.transpose(-1, -2), q[:, :, q0:q1])
    # launch 2: dQ over the key tiles of each query tile
    dq = torch.zeros(b, h, sq, d, dtype=torch.float32)
    for q0 in range(0, sq, T2):
        q1 = min(q0 + T2, sq)
        k_end = min(sk, q1 + offset) if causal and q0 + offset >= 0 else sk
        for k0 in range(0, k_end, T):
            k1 = min(k0 + T, sk)
            dq[:, :, q0:q1] += _mma(tile(q0, q1, k0, k1)[1], k[:, :, k0:k1])
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if layout == "bshd":
        grads = tuple(g.permute(0, 2, 1, 3) for g in grads)
    return tuple(g.contiguous() for g in grads)


def _bsh_strides(t, layout):
    st = t.stride()
    return (st[0], st[1], st[2]) if layout == "bshd" else (st[0], st[2], st[1])


@functools.cache
def _kernel_fn(name):
    """The C entry point `name` of library `name`, typed for ctypes."""
    fn = getattr(load(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
                      ctypes.c_void_p])
    return fn


def _check_inputs(name, q, k, v, bias, dropout, layout, more=()):
    """Raise on what the CUDA kernel `name` does not take (`more`: further
    tensors that must share q's device) -> (b, h, sq, sk, d)."""
    b, h, sq, sk, d = _dims(q, k, layout)
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *more))):
        raise ValueError(f"{name}: every tensor must be a CUDA tensor on one device")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: q, k, v must share dtype float32, bfloat16 or float16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    kshape = (b, sk, h, d) if layout == "bshd" else (b, h, sk, d)
    if q.dim() != 4 or tuple(k.shape) != kshape or tuple(v.shape) != kshape:
        raise ValueError(f"{name}: k and v must be {kshape} for q {tuple(q.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM} is not supported")
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"{name}: dropout rate {dropout} is not in [0, 1)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim of q, k, v must be contiguous")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (b, sk)
                             or not bias.is_contiguous() or bias.device != q.device):
        raise ValueError(f"{name}: bias must be a contiguous float32 [{b}, {sk}] "
                         "tensor on q's device")
    return b, h, sq, sk, d


def _drop_scale(name, dropout):
    """Kept values: the short kernels multiply by 1/(1-p) and the flash
    kernels divide by 1-p, each as its Pallas counterpart does."""
    return 1.0 / (1.0 - dropout) if name.startswith("mha_short") else 1.0 - dropout


def head_args(name, h, heads_global, head0):
    """The C entry points' (heads_global, head0) of a launch over h heads:
    (h, 0) by default; raises unless the h heads lie inside
    heads_global."""
    hg = h if heads_global is None else int(heads_global)
    if not (head0 >= 0 and hg >= h and head0 + h <= hg):
        raise ValueError(f"{name}: heads [{head0}, {head0 + h}) are not inside "
                         f"{hg} global heads")
    return hg, int(head0)


def seed_args(name, seed, q):
    """The C entry points' (seed_val, seed_ptr) of a dropout seed: an int by
    value; a 0-dim int32 tensor on q's device (a seed slot of a static step,
    whose word a CUDA graph replay rewrites) by pointer, read by the
    kernel."""
    if not isinstance(seed, torch.Tensor):
        return int(seed) & _M32, None
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != q.device:
        raise ValueError(f"{name}: a seed tensor must be one int32 word on q's device, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return 0, seed.data_ptr()


def launch_attention(name, q, k, v, bias, causal, sm_scale, dropout, seed, layout,
                     heads_global=None, head0=0):
    """Check the inputs, allocate out / lse and launch the CUDA kernel
    `name` (mha_short_fwd or flash_fwd) on the current stream. Raises on
    what the kernel does not take and on a failed launch."""
    b, h, sq, sk, d = _check_inputs(name, q, k, v, bias, dropout, layout)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *_bsh_strides(q, layout), *_bsh_strides(k, layout),
        *_bsh_strides(v, layout), *_bsh_strides(out, layout))
    fn = _kernel_fn(name)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(),
                out.data_ptr(), lse.data_ptr(), dtype_code(q.dtype),
                b, h, sq, sk, d, strides, float(sm_scale), int(bool(causal)),
                int(dropout > 0.0), float(_drop_scale(name, dropout)),
                _dropout_thresh(dropout) if dropout > 0.0 else 0,
                *head_args(name, h, heads_global, head0), *seed_args(name, seed, q),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1
    CAUSAL_LAUNCHES[name] += bool(causal)
    return out, lse


@functools.cache
def _bwd_kernel_fn():
    """The C entry point flash_bwd, typed for ctypes."""
    fn = load("flash_bwd").flash_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
                      ctypes.c_void_p])
    return fn


def _check_bwd_inputs(name, q, k, v, bias, dout, lse, delta, dropout, layout):
    """The input checks and output allocation both backward wrappers share:
    raise on what the CUDA kernel `name` does not take -> ((b, h, sq, sk,
    d), dout with a contiguous head dim, (dq, dk, dv) allocated, their 21
    (b, s, h) element strides with those of q, k, v, dout as a ctypes
    array)."""
    b, h, sq, sk, d = _check_inputs(name, q, k, v, bias, dropout, layout,
                                    more=(dout, lse, delta))
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError(f"{name}: dout must be {q.dtype} {tuple(q.shape)}")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous float32 [{b}, {h}, {sq}]")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=q.device) for t in (q, k, v))
    strides = (ctypes.c_longlong * 21)(*(
        x for t in (q, k, v, dout, *grads) for x in _bsh_strides(t, layout)))
    return (b, h, sq, sk, d), dout, grads, strides


def launch_attention_bwd(q, k, v, bias, dout, lse, delta, causal, sm_scale, dropout,
                         seed, layout, heads_global=None, head0=0):
    """Check the inputs, allocate dq / dk / dv and launch csrc/flash_bwd.cu
    (a dK / dV launch and a dQ launch) on the current stream. Raises on
    what it does not take and on a failed launch."""
    name = "flash_bwd"
    (b, h, sq, sk, d), dout, (dq, dk, dv), strides = _check_bwd_inputs(
        name, q, k, v, bias, dout, lse, delta, dropout, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        rc = _bwd_kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dtype_code(q.dtype), b, h, sq, sk, d, strides,
            float(sm_scale), int(bool(causal)), int(dropout > 0.0),
            float(_drop_scale(name, dropout)),
            _dropout_thresh(dropout) if dropout > 0.0 else 0,
            *head_args(name, h, heads_global, head0), *seed_args(name, seed, q),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1
    CAUSAL_LAUNCHES[name] += bool(causal)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal=False,
                              sm_scale=None, dropout=0.0, seed=0, layout="bhsd",
                              heads_global=None, head0=0):
    """Plain version of csrc/flash_bwd.cu."""
    return attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                               dropout, seed, layout, div=True, heads_global=heads_global,
                               head0=head0)


def flash_attention_bwd(q, k, v, bias, dout, lse, delta, causal=False, sm_scale=None,
                        dropout=0.0, seed=0, layout="bhsd", heads_global=None, head0=0):
    """Attention backward, any sequence length -> (dq, dk, dv). A CPU
    tensor runs the plain version; a CUDA tensor launches
    csrc/flash_bwd.cu."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, dout, lse, delta, causal,
                                         sm_scale, dropout, seed, layout, heads_global,
                                         head0)
    return launch_attention_bwd(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                                dropout, seed, layout, heads_global, head0)


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None, dropout=0.0,
                    seed=0, layout="bhsd", heads_global=None, head0=0):
    """Attention forward, any sequence length -> (out, lse). A CPU tensor
    runs the plain version; a CUDA tensor launches csrc/flash_fwd.cu."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, causal, sm_scale, dropout,
                                     seed, layout, heads_global, head0)
    return launch_attention("flash_fwd", q, k, v, bias, causal, sm_scale,
                            dropout, seed, layout, heads_global, head0)
