"""Ring attention: exact attention over a sequence split into n contiguous
chunks, merged one (query chunk i, key chunk j) pair at a time in ring
order j = i, i-1, ..., i-n+1 (mod n), so the [s, s] score matrix never
exists. The counterpart of `paddle_tpu/ops/pallas/ring_attention.py`,
one `torch.autograd.Function` in two forms:

- global: q, k, v hold the whole sequence on one device. Each pair runs
  the flash kernels on chunk views of q, k, v (the kernels take strides,
  so no chunk is copied): #3 (`flash_attention`, csrc/flash_fwd.cu) in
  the forward, #4/#5 (`flash_attention_bwd`, csrc/flash_bwd.cu) in the
  backward. A CPU tensor runs the same loop over their plain versions.
- across ranks: q, k, v are this rank's chunk of a `model` group of size
  n (`group`). Each step sends the K/V/bias chunk to the next rank and
  receives the previous rank's, posted before the pair's launch so the
  hop overlaps it; in the backward the dK/dV accumulators travel with
  their chunk and land home on the last hop. The merge order and the pair
  seeds are the global form's, so the ranks' results are the global
  form's bit for bit.

The pairs merge with the online-softmax `_combine` in float32, in the
JAX package's order. A causal pair that lies wholly in the future
(j > i) is skipped, in both passes; the diagonal pair is causal, the
others fully visible. Attention dropout folds the pair into the seed,
seed + (i * n + j) * 2654435769 mod 2**32 (`mix_seed`, the JAX
`_mix_seed` in int32), and the kernels hash chunk-local (batch * head,
query, key) coordinates. The backward computes delta = rowsum(dO * O)
once from the global output and launches each pair under the global
lse. The bias grad is zero, as in the JAX package.

`ring_attention_plain` / `ring_attention_bwd_plain` are the pair loop over
the plain chunk math in float64 (the JAX `_chunk_fwd_jnp` /
`_chunk_bwd_jnp` mirror): the reference the tests and `chip_smoke.py`
hold the kernels' ring against. Nothing on the main path uses them.

Under gloo (the CPU, or ranks sharing one card) a hop of CUDA tensors is
staged through pinned host memory: gloo's send and receive take host
tensors (`_Hop`). Under NCCL it is plain send / receive.
"""

from __future__ import annotations

import math

import torch

from .kernels.flash_attention import (
    NEG_INF_F32,
    attention_delta,
    dropout_keep_mask,
    flash_attention,
    flash_attention_bwd,
)

__all__ = [
    "RING_SEED_STEP",
    "mix_seed",
    "ring_attention",
    "ring_attention_fwd",
    "ring_attention_bwd",
    "ring_attention_plain",
    "ring_attention_bwd_plain",
    "RingAttention",
]

_M32 = 0xFFFFFFFF
# 2654435769, the golden-ratio word; -1640531527 as the JAX package's int32
RING_SEED_STEP = 0x9E3779B9


def mix_seed(seed, i, j, n):
    """The dropout seed of pair (query chunk i, key chunk j) of an n-chunk
    ring: seed + (i * n + j) * 2654435769 mod 2**32."""
    return (int(seed) + (i * n + j) * RING_SEED_STEP) & _M32


def _seq_dim(layout):
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"layout must be 'bhsd' or 'bshd', got {layout!r}")
    return 2 if layout == "bhsd" else 1


def _chunk(x, i, n, dim):
    """Chunk i of n along `dim`: a view."""
    c = x.shape[dim] // n
    return x.narrow(dim, i * c, c)


def _bias_chunk(bias, j, n):
    return None if bias is None else _chunk(bias, j, n, 1).contiguous()


def _row(w, layout):
    """[b, h, c] row weights broadcast against [b, h, c, d] (bhsd) or
    [b, c, h, d] (bshd)."""
    return w[..., None] if layout == "bhsd" else w.transpose(1, 2)[..., None]


def _combine(o, lse, o_t, lse_t, layout="bhsd"):
    """Online-softmax merge of two normalized partials (float32). NEG_INF is
    a finite sentinel, so exp() underflows to 0.0 without NaNs for a row
    with no live key."""
    lse_new = torch.logaddexp(lse, lse_t)
    w = torch.exp(lse - lse_new)
    w_t = torch.exp(lse_t - lse_new)
    return o * _row(w, layout) + o_t * _row(w_t, layout), lse_new


def _check(q, k, n, layout):
    sd = _seq_dim(layout)
    n = int(n)
    if n < 1 or q.shape[sd] % n or k.shape[sd] % n:
        raise ValueError(f"sequence length {q.shape[sd]}/{k.shape[sd]} not divisible by "
                         f"axis_size={n}")
    if q.shape[sd] != k.shape[sd]:
        raise ValueError(f"ring attention needs sq == sk, got {q.shape[sd]} and {k.shape[sd]}")
    return sd, n


def _lse_shape(q, n, layout):
    """[b, h, s / n] of q [b, h, s, d] ("bhsd") or [b, s, h, d] ("bshd")."""
    sd = _seq_dim(layout)
    return (q.shape[0], q.shape[3 - sd], q.shape[sd] // n)


def _skipped(causal, i, j):
    return causal and j > i


# -- the hop ------------------------------------------------------------------------


def _group_info(group):
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group), dist.get_backend(group)


class _Hop:
    """One ring hop: `tensors` sent to the next rank of `group`, as many
    received from the previous one. Posted at construction; `wait()`
    returns the received tensors. Under gloo a CUDA tensor is staged
    through pinned host memory (gloo's send and receive take host tensors);
    under NCCL the tensors go as they are."""

    def __init__(self, tensors, group, tag):
        import torch.distributed as dist

        rank, n, backend = _group_info(group)
        nxt = dist.get_global_rank(group, (rank + 1) % n)
        prv = dist.get_global_rank(group, (rank - 1) % n)
        self.tensors = [t for t in tensors if t is not None]
        self.none = [t is None for t in tensors]
        self.stage = backend == "gloo" and any(t.is_cuda for t in self.tensors)
        send = [t.contiguous() for t in self.tensors]
        if self.stage:
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in send]
            for h, t in zip(host, send):
                h.copy_(t)
            send = host
        self.recv = [torch.empty_like(t) for t in send]
        self.reqs = []
        for s_, (t, r) in enumerate(zip(send, self.recv)):
            self.reqs.append(dist.isend(t, nxt, group=group, tag=tag * 16 + s_))
            self.reqs.append(dist.irecv(r, prv, group=group, tag=tag * 16 + s_))
        self._send = send  # alive until the sends complete

    def wait(self):
        for r in self.reqs:
            r.wait()
        got = iter([r.to(t.device, non_blocking=False) if self.stage else r
                    for r, t in zip(self.recv, self.tensors)])
        return [None if none else next(got) for none in self.none]


# -- the two passes -----------------------------------------------------------------


def ring_attention_fwd(q, k, v, bias=None, causal=False, sm_scale=None, dropout=0.0, seed=0,
                       n=1, layout="bhsd", group=None):
    """The ring's forward -> (out in q's layout and dtype, lse [b, h, s]
    float32). Global form (`group` None): q, k, v hold the whole sequence,
    split into n chunks. Across ranks: q, k, v (and bias [b, s/n]) are this
    rank's chunk of `group`, whose size is n."""
    if group is not None:
        return _ring_fwd_ranks(q, k, v, bias, causal, sm_scale, dropout, seed, layout, group)
    sd, n = _check(q, k, n, layout)
    # one accumulator a query chunk, each as a rank of the ring holds it,
    # so that the merge runs the ranks' element-wise ops on the same shapes
    o = [torch.zeros(_chunk(q, 0, n, sd).shape, dtype=torch.float32, device=q.device)
         for _ in range(n)]
    lse = [torch.full(_lse_shape(q, n, layout), NEG_INF_F32, dtype=torch.float32,
                      device=q.device) for _ in range(n)]
    for t in range(n):
        for i in range(n):
            j = (i - t) % n
            if _skipped(causal, i, j):
                continue
            o_t, lse_t = flash_attention(
                _chunk(q, i, n, sd), _chunk(k, j, n, sd), _chunk(v, j, n, sd),
                bias=_bias_chunk(bias, j, n), causal=causal and t == 0, sm_scale=sm_scale,
                dropout=dropout, seed=mix_seed(seed, i, j, n), layout=layout)
            o[i], lse[i] = _combine(o[i], lse[i], o_t.float(), lse_t, layout)
    return torch.cat(o, dim=sd).to(q.dtype), torch.cat(lse, dim=2)


def _ring_fwd_ranks(q, k, v, bias, causal, sm_scale, dropout, seed, layout, group):
    i, n, _ = _group_info(group)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(_lse_shape(q, 1, layout), NEG_INF_F32, dtype=torch.float32,
                     device=q.device)
    kv = [k, v, bias]
    for t in range(n):
        j = (i - t) % n
        hop = _Hop(kv, group, t) if t < n - 1 else None
        if not _skipped(causal, i, j):
            o_t, lse_t = flash_attention(
                q, kv[0], kv[1], bias=kv[2], causal=causal and t == 0, sm_scale=sm_scale,
                dropout=dropout, seed=mix_seed(seed, i, j, n), layout=layout)
            o, lse = _combine(o, lse, o_t.float(), lse_t, layout)
        if hop is not None:
            kv = hop.wait()
    return o.to(q.dtype), lse


def ring_attention_bwd(q, k, v, bias, dout, out, lse, causal=False, sm_scale=None,
                       dropout=0.0, seed=0, n=1, layout="bhsd", group=None):
    """The ring's backward -> (dq, dk, dv) in the dtypes of q, k, v: a second
    ring over the same pairs under the global lse and delta = rowsum(dO *
    O); dq accumulates at its query chunk, dk / dv at their key chunk, in
    float32."""
    delta = attention_delta(out, dout, layout)
    if group is not None:
        return _ring_bwd_ranks(q, k, v, bias, dout, lse, delta, causal, sm_scale, dropout,
                               seed, layout, group)
    sd, n = _check(q, k, n, layout)
    dq, dk, dv = ([torch.zeros(_chunk(t, 0, n, sd).shape, dtype=torch.float32,
                               device=t.device) for _ in range(n)] for t in (q, k, v))
    for t in range(n):
        for i in range(n):
            j = (i - t) % n
            if _skipped(causal, i, j):
                continue
            g = flash_attention_bwd(
                _chunk(q, i, n, sd), _chunk(k, j, n, sd), _chunk(v, j, n, sd),
                _bias_chunk(bias, j, n), _chunk(dout, i, n, sd),
                _chunk(lse, i, n, 2).contiguous(), _chunk(delta, i, n, 2).contiguous(),
                causal=causal and t == 0, sm_scale=sm_scale, dropout=dropout,
                seed=mix_seed(seed, i, j, n), layout=layout)
            dq[i].add_(g[0].float())
            dk[j].add_(g[1].float())
            dv[j].add_(g[2].float())
    return tuple(torch.cat(acc, dim=sd).to(x.dtype) for acc, x in ((dq, q), (dk, k), (dv, v)))


def _ring_bwd_ranks(q, k, v, bias, dout, lse, delta, causal, sm_scale, dropout, seed,
                    layout, group):
    i, n, _ = _group_info(group)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in (k, v)]
    kv = [k, v, bias]
    for t in range(n):
        j = (i - t) % n
        hop = _Hop(kv, group, 2 * t) if t < n - 1 else None
        if not _skipped(causal, i, j):
            g = flash_attention_bwd(
                q, kv[0], kv[1], kv[2], dout, lse, delta, causal=causal and t == 0,
                sm_scale=sm_scale, dropout=dropout, seed=mix_seed(seed, i, j, n),
                layout=layout)
            dq.add_(g[0].float())
            acc[0].add_(g[1].float())
            acc[1].add_(g[2].float())
        # the accumulators travel with their chunk; the last hop lands them home
        acc = _Hop(acc, group, 2 * t + 1).wait()
        if hop is not None:
            kv = hop.wait()
    return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Ring attention as one autograd node: the forward saves q, k, v, bias,
    out and the global lse; the backward runs the second ring. No grad
    for the bias or the seed."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, dropout, seed, n, layout, group):
        out, lse = ring_attention_fwd(q, k, v, bias, causal, sm_scale, dropout, seed, n,
                                      layout, group)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, sm_scale, dropout, seed, n, layout, group)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, sm_scale, dropout, seed, n, layout, group = ctx.args
        dq, dk, dv = ring_attention_bwd(q, k, v, bias, dout, out, lse, causal, sm_scale,
                                        dropout, seed, n, layout, group)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def ring_attention(q, k, v, axis_name="model", axis_size=None, bias=None, causal=False,
                   sm_scale=None, dropout=0.0, seed=0, layout="bhsd", group=None):
    """Exact attention over q / k / v [b, h, s, d] ("bhsd") or [b, s, h, d]
    ("bshd") blocked into `axis_size` sequence chunks, with an optional
    additive key bias [b, s] float32. `axis_size` defaults to the current
    mesh's `axis_name` size (1 without a mesh), as in the JAX package.
    With `group`, q / k / v / bias are this rank's chunk of the group's
    sequence and the ring runs across its ranks (`axis_size` is the
    group's size). `seed`: the attention dropout seed, an int. Returns the
    output in q's layout and dtype."""
    if group is not None:
        import torch.distributed as dist

        n = dist.get_world_size(group)
    else:
        n = axis_size
        if n is None:
            from ..parallel.mesh import canonical_axis, current_mesh

            mesh = current_mesh()
            n = mesh.shape.get(canonical_axis(axis_name), 1) if mesh is not None else 1
        _check(q, k, n, layout)
    if bias is not None:
        bias = bias.detach().to(torch.float32).contiguous()
    return RingAttention.apply(q, k, v, bias, bool(causal), sm_scale, float(dropout), seed,
                               int(n), layout, group)


# -- the plain version --------------------------------------------------------------


def _pair64(q, k, v, bias, diag, sm_scale, dropout, seed, b, h):
    """One pair's scores and probabilities in float64, bhsd -> (s, keep or
    None)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.double()[:, None, None, :]
    if diag:
        c = s.shape[-1]
        live = torch.ones(c, c, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~live, NEG_INF_F32)
    keep = (dropout_keep_mask(seed, b, h, s.shape[-2], s.shape[-1], dropout, s.device)
            if dropout > 0.0 else None)
    return s, keep


def _plain_inputs(q, k, v, layout, n, extra=()):
    sd, n = _check(q, k, n, layout)
    ts = [t.double() for t in (q, k, v, *extra)]
    if layout == "bshd":
        ts = [t.permute(0, 2, 1, 3) for t in ts]
    b, h, s, d = ts[0].shape
    return ts, n, b, h, s, d


def ring_attention_plain(q, k, v, bias=None, causal=False, sm_scale=None, dropout=0.0,
                         seed=0, n=1, layout="bhsd"):
    """The plain version of the ring's forward: the same pairs, order, skips
    and pair seeds over the plain chunk math, all in float64 -> (out in q's
    layout and dtype, lse [b, h, s] float32)."""
    (q64, k64, v64), n, b, h, s, d = _plain_inputs(q, k, v, layout, n)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    c = s // n
    o = torch.zeros(b, h, s, d, dtype=torch.float64, device=q.device)
    lse = torch.full((b, h, s), NEG_INF_F32, dtype=torch.float64, device=q.device)
    for t in range(n):
        for i in range(n):
            j = (i - t) % n
            if _skipped(causal, i, j):
                continue
            qs, ks = slice(i * c, i * c + c), slice(j * c, j * c + c)
            sc, keep = _pair64(q64[:, :, qs], k64[:, :, ks], v64[:, :, ks],
                               None if bias is None else bias[:, ks], causal and t == 0,
                               sm_scale, dropout, mix_seed(seed, i, j, n), b, h)
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            l = p.sum(-1, keepdim=True)
            l_safe = torch.where(l == 0.0, torch.ones((), dtype=l.dtype, device=l.device), l)
            if keep is not None:
                p = torch.where(keep, p / (1.0 - dropout), torch.zeros((), dtype=p.dtype,
                                                                        device=p.device))
            o_t = torch.matmul(p, v64[:, :, ks]) / l_safe
            lse_t = (m + torch.log(l_safe))[..., 0]
            lse_new = torch.logaddexp(lse[:, :, qs], lse_t)
            o[:, :, qs] = (o[:, :, qs] * torch.exp(lse[:, :, qs] - lse_new)[..., None]
                           + o_t * torch.exp(lse_t - lse_new)[..., None])
            lse[:, :, qs] = lse_new
    out = o.to(q.dtype)
    if layout == "bshd":
        out = out.permute(0, 2, 1, 3)
    return out.contiguous(), lse.float()


def ring_attention_bwd_plain(q, k, v, bias, dout, out, lse, causal=False, sm_scale=None,
                             dropout=0.0, seed=0, n=1, layout="bhsd"):
    """The plain version of the ring's backward, in float64 -> (dq, dk, dv)
    in the dtypes and layout of q, k, v: per pair p = exp(s - lse),
    dp = dO V^T (dropout on both), dV += p_drop^T dO, dS = p (dp - delta)
    scale, dQ += dS K, dK += dS^T Q."""
    (q64, k64, v64, do64, o64), n, b, h, s, d = _plain_inputs(q, k, v, layout, n,
                                                              (dout, out))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    c = s // n
    delta = (o64 * do64).sum(-1)
    lse64 = lse.double()
    dq, dk, dv = (torch.zeros(b, h, s, d, dtype=torch.float64, device=q.device)
                  for _ in range(3))
    zero = torch.zeros((), dtype=torch.float64, device=q.device)
    for t in range(n):
        for i in range(n):
            j = (i - t) % n
            if _skipped(causal, i, j):
                continue
            qs, ks = slice(i * c, i * c + c), slice(j * c, j * c + c)
            sc, keep = _pair64(q64[:, :, qs], k64[:, :, ks], v64[:, :, ks],
                               None if bias is None else bias[:, ks], causal and t == 0,
                               sm_scale, dropout, mix_seed(seed, i, j, n), b, h)
            p = torch.exp(sc - lse64[:, :, qs, None])
            dp = torch.matmul(do64[:, :, qs], v64[:, :, ks].transpose(-1, -2))
            p_drop = p
            if keep is not None:
                p_drop = torch.where(keep, p / (1.0 - dropout), zero)
                dp = torch.where(keep, dp / (1.0 - dropout), zero)
            dv[:, :, ks] += torch.matmul(p_drop.transpose(-1, -2), do64[:, :, qs])
            ds = p * (dp - delta[:, :, qs, None]) * sm_scale
            dq[:, :, qs] += torch.matmul(ds, k64[:, :, ks])
            dk[:, :, ks] += torch.matmul(ds.transpose(-1, -2), q64[:, :, qs])
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if layout == "bshd":
        grads = tuple(g.permute(0, 2, 1, 3) for g in grads)
    return tuple(g.contiguous() for g in grads)
