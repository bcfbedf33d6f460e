"""Dropout on a shard of a tensor-parallel rank: the attention kernels
#1-#7 and their plain versions over a chunk of the heads
(`heads_global` / `head0`: the hash of global (batch, head) indices), and
the dropout op's mask at a chunk's place in the global tensor
(`nn_ops.dropout_keep_mask(..., global_shape, starts)`).

On the CPU (the plain versions): a launch over heads [h0, h0 + h) of H
equals the whole launch's slice bit for bit, forward (out, lse) and
backward (dQ, dK, dV with the sliced dO), short and flash, in both
layouts; the masks likewise; and with one contiguous row shard the
dropout mask is the one the batch offset drew before. On the card
(`-m gpu`, skipped without one): each of #1-#7 with head0 = 0 and
heads_global = its heads is bit-equal to the launch without them, and a
half-head launch equals the whole launch's slice bit for bit and its plain
version at the kernel tolerances.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import mha_short as ms

FWD = {"short": (ms.short_attention, ms.short_attention_plain),
       "flash": (fa.flash_attention, fa.flash_attention_plain)}
BWD = {"short": (ms.short_attention_bwd, ms.short_attention_bwd_plain),
       "flash": (fa.flash_attention_bwd, fa.flash_attention_bwd_plain)}


def _inputs(b, h, sq, sk, d, layout, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    qs = (b, sq, h, d) if layout == "bshd" else (b, h, sq, d)
    ks = (b, sk, h, d) if layout == "bshd" else (b, h, sk, d)
    q, k, v = (torch.randn(s, generator=gen, device=device).to(dtype) for s in (qs, ks, ks))
    bias = torch.where(torch.rand(b, sk, generator=gen, device=device) > 0.2, 0.0, -1e4)
    dout = (0.25 * torch.randn(qs, generator=gen, device=device)).to(dtype)
    return q, k, v, bias.float().contiguous(), dout


def _heads(t, layout, h0, h1):
    return (t[:, :, h0:h1] if layout == "bshd" else t[:, h0:h1]).contiguous()


def test_attention_mask_of_a_head_chunk_is_the_whole_mask_slice():
    full = fa.dropout_keep_mask(1234, 3, 8, 5, 7, 0.3, "cpu")
    half = fa.dropout_keep_mask(1234, 3, 4, 5, 7, 0.3, "cpu", heads_global=8, head0=4)
    assert torch.equal(half, full[:, 4:])
    # the defaults are the whole launch: head0 0 and heads_global its heads
    assert torch.equal(fa.dropout_keep_mask(1234, 3, 8, 5, 7, 0.3, "cpu", 8, 0), full)
    # a batch shard's rows are the global mask's rows under the seed shift
    rows = fa.dropout_keep_mask((1234 + 2 * 8 * 0xC2B2AE35) & 0xFFFFFFFF, 1, 8, 5, 7, 0.3,
                                "cpu")
    assert torch.equal(rows, full[2:3])


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("kind", ["short", "flash"])
def test_plain_half_head_launch_is_the_whole_launch_slice(kind, layout):
    b, H, sq, sk, d = 2, 6, 24, 20, 16
    q, k, v, bias, dout = _inputs(b, H, sq, sk, d, layout)
    kw = dict(causal=kind == "flash", dropout=0.2, seed=777, layout=layout)
    fwd, bwd = FWD[kind][1], BWD[kind][1]
    out, lse = fwd(q, k, v, bias, **kw)
    delta = fa.attention_delta(out, dout, layout)
    grads = bwd(q, k, v, bias, dout, lse, delta, **kw)
    h0 = 3
    part = [_heads(t, layout, h0, H) for t in (q, k, v, dout)]
    o2, l2 = fwd(*part[:3], bias, heads_global=H, head0=h0, **kw)
    assert torch.equal(o2, _heads(out, layout, h0, H))
    assert torch.equal(l2, lse[:, h0:])
    d2 = delta[:, h0:].contiguous()
    g2 = bwd(*part[:3], bias, part[3], l2, d2, heads_global=H, head0=h0, **kw)
    for a, full in zip(g2, grads):
        assert torch.equal(a, _heads(full, layout, h0, H))
    # without the global heads the chunk draws another mask
    o3, _ = fwd(*part[:3], bias, **kw)
    assert not torch.equal(o3, o2)


def test_head_args_refuse_heads_outside_the_global_ones():
    assert fa.head_args("k", 6, None, 0) == (6, 0)
    assert fa.head_args("k", 6, 12, 6) == (12, 6)
    for hg, h0 in ((12, 7), (5, 0), (12, -1)):
        with pytest.raises(ValueError, match="global heads"):
            fa.head_args("k", 6, hg, h0)


def test_dropout_mask_at_a_chunk_is_the_global_mask_slice():
    seed, p = 0x5EED, 0.4
    full, kp = nn_ops.dropout_keep_mask(seed, p, (4, 6, 10), "cpu")
    chunk, kp2 = nn_ops.dropout_keep_mask(seed, p, (2, 6, 5), "cpu", global_shape=(4, 6, 10),
                                          starts=(2, 0, 5))
    assert kp == kp2 and torch.equal(chunk, full[2:4, :, 5:10])
    # one contiguous row shard: the mask the batch offset drew, flat indices
    # from r times the shard's element count
    rows, _ = nn_ops.dropout_keep_mask(seed, p, (2, 6, 10), "cpu", global_shape=(4, 6, 10),
                                       starts=(2, 0, 0))
    i = torch.arange(2 * 60, 4 * 60, dtype=torch.int64).reshape(2, 6, 10)
    old = fa.murmur_mix(fa.mul32(i, 0x9E3779B1) ^ seed) >= nn_ops._drop_threshold(p)
    assert torch.equal(rows, old) and torch.equal(rows, full[2:4])


def test_lowering_context_places_a_chunk():
    from paddle_tpu_torch.ops.registry import LoweringContext

    ctx = LoweringContext()
    assert ctx.global_place("x", (4, 6)) == ((4, 6), (0, 0))
    assert ctx.head_shard("q", 6, 2) == (6, 0)
    ctx.batch_rank, ctx.batch_ranks = 1, 2
    ctx.model_rank, ctx.model_ranks, ctx.model_dims = 1, 2, {"x": 1, "q": 2}
    assert ctx.global_place("x", (4, 6)) == ((8, 12), (4, 6))
    assert ctx.global_place("y", (4, 6)) == ((8, 6), (4, 0))
    assert ctx.head_shard("q", 6, 2) == (12, 6)
    assert ctx.head_shard("q", 6, 1) == (6, 0)


# -- on the card ---------------------------------------------------------------------

# kernel, the TPU kernels, layout, b H sq sk d, causal, dtype
CARD_CASES = [
    ("short", "#1", "bshd", (2, 12, 128, 128, 64), False, torch.float32),
    ("short", "#2", "bhsd", (2, 12, 128, 128, 64), False, torch.bfloat16),
    ("flash", "#3 #4 #5", "bhsd", (1, 4, 600, 600, 64), True, torch.float32),
    ("short", "#6", "bhsd", (2, 12, 100, 77, 64), True, torch.bfloat16),
    ("short", "#7", "bshd", (2, 12, 128, 128, 64), False, torch.float32),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_head_shard.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[1].replace(" ", ""))
def test_kernels_over_a_head_chunk_on_the_card(case, cuda_device):
    kind, _, layout, (b, H, sq, sk, d), causal, dtype = case
    q, k, v, bias, dout = _inputs(b, H, sq, sk, d, layout, dtype, cuda_device)
    kw = dict(causal=causal, dropout=0.1, seed=4321, layout=layout)
    (fwd, fwd_plain), (bwd, bwd_plain) = FWD[kind], BWD[kind]
    out, lse = fwd(q, k, v, bias, **kw)
    delta = fa.attention_delta(out, dout, layout)
    grads = bwd(q, k, v, bias, dout, lse, delta, **kw)
    # head0 0 and heads_global = the launch's heads: the launch without them
    o1, l1 = fwd(q, k, v, bias, heads_global=H, head0=0, **kw)
    g1 = bwd(q, k, v, bias, dout, lse, delta, heads_global=H, head0=0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o1, out) and torch.equal(l1, lse)
    assert all(torch.equal(a, c) for a, c in zip(g1, grads))
    # the second half of the heads: the whole launch's slice, bit for bit
    h0 = H // 2
    part = [_heads(t, layout, h0, H) for t in (q, k, v, dout)]
    o2, l2 = fwd(*part[:3], bias, heads_global=H, head0=h0, **kw)
    d2 = delta[:, h0:].contiguous()
    g2 = bwd(*part[:3], bias, part[3], l2, d2, heads_global=H, head0=h0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o2, _heads(out, layout, h0, H)) and torch.equal(l2, lse[:, h0:])
    for a, full in zip(g2, grads):
        assert torch.equal(a, _heads(full, layout, h0, H))
    # and its plain version at the kernels' gate (max abs err fp32 1e-4,
    # bf16 2e-2, as chip_smoke.py's phase 3)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ref = fwd_plain(*part[:3], bias, heads_global=H, head0=h0, **kw)
    refg = bwd_plain(*part[:3], bias, part[3], l2, d2, heads_global=H, head0=h0, **kw)
    for got, want in zip((o2,) + tuple(g2), (ref[0],) + tuple(refg)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, err
    assert np.isfinite(float(o2.float().abs().max()))
