"""The port's backward kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those
are held against the Pallas kernels run in interpret mode:
- the attention backward (plain `short_attention_bwd` /
  `flash_attention_bwd` after the plain forward) against `jax.vjp` of
  `short_attention_bshd`, `short_attention` and `flash_attention`, whose
  custom vjps run the Pallas backward kernels; with dropout both sides
  use the same threefry key, the port drawing its int32 seed through
  `ops/prng.randint` as the JAX entry points do;
- the LayerNorm backward (`ln_bwd_plain`) against the Pallas `ln_bwd`.

The `gpu`-marked tests hold each CUDA kernel against its plain version
on the card and skip without one.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 (summation order only); bf16
atol 2e-2 (about one bf16 ulp of these gradients, which stay below 2 in
magnitude: dO is scaled to keep them there).

The card has no JAX, so this file imports the JAX package inside the CPU
tests only; on the card run
`python -m pytest -m gpu --noconftest tests/test_torch_training_kernels.py`."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF,
    attention_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from paddle_tpu_torch.ops.kernels.layer_norm import ln_bwd, ln_bwd_plain
from paddle_tpu_torch.ops.kernels.mha_short import (
    short_attention,
    short_attention_bwd,
    short_attention_bwd_plain,
    short_attention_plain,
)
from test_torch_kernels import _tol

KEY_SEED = 7  # jax.random.key(KEY_SEED) on the JAX side

# (kernel, layout, b, h, sq, sk, d, bias, causal, dtype, dropout)
CASES = [
    ("short", "bshd", 2, 4, 128, 128, 64, True, False, "float32", 0.0),
    ("short", "bhsd", 2, 3, 64, 64, 64, False, False, "float32", 0.0),
    # sq > sk causal: the first 23 query rows see no key
    ("short", "bshd", 2, 3, 100, 77, 32, False, True, "float32", 0.0),
    ("short", "bhsd", 1, 2, 64, 77, 64, True, True, "float32", 0.0),
    ("short", "bshd", 2, 4, 128, 128, 64, True, False, "float32", 0.2),
    ("short", "bhsd", 1, 2, 70, 77, 32, True, True, "float32", 0.2),
    ("short", "bshd", 2, 2, 128, 128, 64, True, False, "bfloat16", 0.0),
    ("short", "bshd", 2, 2, 100, 128, 64, False, True, "bfloat16", 0.2),
    ("flash", "bhsd", 1, 2, 160, 160, 64, True, False, "float32", 0.0),
    # flash causal keeps sq <= sk, so every row has a live key
    ("flash", "bshd", 2, 2, 64, 77, 64, False, True, "float32", 0.0),
    ("flash", "bhsd", 1, 3, 77, 77, 32, False, False, "float32", 0.0),
    ("flash", "bhsd", 2, 2, 128, 128, 64, True, False, "float32", 0.2),
    ("flash", "bshd", 1, 2, 100, 150, 64, True, True, "bfloat16", 0.0),
    ("flash", "bshd", 1, 2, 64, 77, 32, True, True, "bfloat16", 0.2),
    # fp16: BERT's shape, causal sq > sk with dropout, flash causal + bias
    ("short", "bshd", 2, 2, 128, 128, 64, True, False, "float16", 0.1),
    ("short", "bhsd", 1, 2, 100, 77, 32, False, True, "float16", 0.0),
    ("flash", "bshd", 1, 2, 64, 77, 32, True, True, "float16", 0.2),
]

# on the card only (the Pallas kernels in interpret mode would take
# minutes at these sizes): the short backward's edges, d 128 at s 512 in
# fp32 (its shared-memory edge), d 16 and d 32, bf16 with dropout in
# bhsd, and d 77 / bf16 d 20, whose rows take the scalar copy
CUDA_CASES = [
    ("short", "bshd", 1, 2, 512, 512, 128, True, False, "float32", 0.1),
    ("short", "bhsd", 2, 2, 96, 80, 16, True, True, "float32", 0.0),
    ("short", "bshd", 2, 3, 130, 70, 32, False, True, "float32", 0.1),
    ("short", "bhsd", 2, 2, 128, 128, 64, True, False, "bfloat16", 0.1),
    ("short", "bhsd", 1, 2, 33, 45, 77, True, False, "float32", 0.0),
    ("short", "bshd", 1, 2, 64, 50, 20, False, False, "bfloat16", 0.0),
]


def _case_id(c):
    return "-".join(str(x) for x in c)


def _inputs(layout, b, h, sq, sk, d, use_bias, seed=0):
    """numpy float32 q, k, v, dO (scaled by 0.5) in `layout` and a [b, sk]
    key bias (0 keep, -1e4 drop) with key 0 always live."""
    rs = np.random.RandomState(seed)
    qshape = (b, sq, h, d) if layout == "bshd" else (b, h, sq, d)
    kshape = (b, sk, h, d) if layout == "bshd" else (b, h, sk, d)
    q = rs.randn(*qshape).astype(np.float32)
    k = rs.randn(*kshape).astype(np.float32)
    v = rs.randn(*kshape).astype(np.float32)
    do = (0.5 * rs.randn(*qshape)).astype(np.float32)
    bias = None
    if use_bias:
        bias = np.where(rs.rand(b, sk) > 0.25, 0.0, -1e4).astype(np.float32)
        bias[:, 0] = 0.0
    return q, k, v, do, bias


def _bhsd(x, layout):
    return np.swapaxes(x, 1, 2) if layout == "bshd" else x


def _jax_grads(kernel, q, k, v, do, bias, causal, scale, dropout, layout, dtype):
    """dq, dk, dv (float32 numpy, in `layout`) from jax.vjp of the JAX
    package's public entry point, whose custom vjp runs the Pallas
    backward kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import flash_attention as j_flash
    from paddle_tpu.ops.pallas.mha_short import short_attention as j_short
    from paddle_tpu.ops.pallas.mha_short import short_attention_bshd as j_short_bshd

    jdt = jnp.dtype(dtype)
    jbias = None if bias is None else jnp.asarray(bias)
    key = jax.random.key(KEY_SEED)
    if kernel == "short":
        fn = j_short_bshd if layout == "bshd" else j_short
        args = [jnp.asarray(t, jdt) for t in (q, k, v)]
        cot = jnp.asarray(do, jdt)
    else:  # flash_attention takes bhsd
        fn = j_flash
        args = [jnp.asarray(_bhsd(t, layout), jdt) for t in (q, k, v)]
        cot = jnp.asarray(_bhsd(do, layout), jdt)

    def f(qj, kj, vj):
        return fn(qj, kj, vj, bias=jbias, causal=causal, sm_scale=scale,
                  dropout=dropout, rng_key=key)

    _, pullback = jax.vjp(f, *args)
    grads = [np.asarray(g.astype(jnp.float32)) for g in pullback(cot)]
    return [g if kernel == "short" else _bhsd(g, layout) for g in grads]


def _torch(arrays, dtype, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrays]


def _port_grads(kernel, q, k, v, do, bias, causal, scale, dropout, layout, dtype,
                device="cpu"):
    """The port's forward then backward wrappers -> (dq, dk, dv)."""
    tdt = getattr(torch, dtype)
    qt, kt, vt, dot = _torch((q, k, v, do), tdt, device)
    bt = None if bias is None else torch.from_numpy(bias).to(device)
    seed = prng.randint(prng.key(KEY_SEED), 1, 0, 2**31 - 1)[0] if dropout > 0 else 0
    kw = dict(causal=causal, sm_scale=scale, dropout=dropout, seed=seed, layout=layout)
    fwd, bwd = ((short_attention, short_attention_bwd) if kernel == "short"
                else (flash_attention, flash_attention_bwd))
    out, lse = fwd(qt, kt, vt, bias=bt, **kw)
    return bwd(qt, kt, vt, bt, dot, lse, attention_delta(out, dot, layout), **kw)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_backward_matches_pallas_kernels(case, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    kernel, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, do, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    scale = 1.0 / np.sqrt(d)
    ref = _jax_grads(kernel, q, k, v, do, bias, causal, scale, dropout, layout, dtype)
    launches = dict(LAUNCHES)
    got = _port_grads(kernel, q, k, v, do, bias, causal, scale, dropout, layout, dtype)
    assert LAUNCHES == launches  # a CPU tensor never launches a kernel
    for g, r, t in zip(got, ref, (q, k, v)):
        assert g.dtype == getattr(torch, dtype) and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(), r, **_tol(dtype, r))


def test_short_backward_fully_masked_row_gives_zero(monkeypatch):
    """A batch row whose keys are all masked gives p == 0 through the
    forward's clamped lse, so all its grads are exactly 0, as in Pallas."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q, k, v, do, bias = _inputs("bshd", 2, 2, 40, 40, 32, True)
    bias[1, :] = NEG_INF
    scale = 1.0 / np.sqrt(32)
    ref = _jax_grads("short", q, k, v, do, bias, False, scale, 0.0, "bshd", "float32")
    got = _port_grads("short", q, k, v, do, bias, False, scale, 0.0, "bshd", "float32")
    for g, r in zip(got, ref):
        assert torch.count_nonzero(g[1]) == 0 and np.count_nonzero(r[1]) == 0
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-5)


def _overflow_inputs(layout="bshd"):
    """fp16 inputs whose dS overflows fp16: q at 3 randn makes p peaky,
    v and dO at 1000 randn (a loss-scaled cotangent) make dp ~ 1e7, so
    p (dp - delta) scale passes 65504 on many pairs."""
    q, k, v, do, _ = _inputs(layout, 1, 2, 64, 64, 64, False, seed=5)
    return 3 * q, k, 1000 * v, 2000 * do


def _overflow_tol(ref, other):
    """dV (other None): one fp16 ulp; dQ / dK: one fp16 ulp of the largest
    finite dS (2^15 <= |dS| <= 65504: 32) times the largest |operand|."""
    if other is None:
        return _tol("float16", ref)
    return dict(atol=32.0 * float(np.abs(np.asarray(other, np.float32)).max()), rtol=0)


def test_fp16_ds_overflow_gives_inf_as_pallas(monkeypatch):
    """dS rounds to fp16 before dQ and dK in both packages: where it passes
    65504 it is inf, so dQ and dK carry inf (and nan where an inf meets a
    zero or an inf of the other sign) in the same places as the Pallas
    backward's; dV, which dS does not reach, stays finite. The plain
    version matches the non-finite pattern exactly; dV within one fp16
    ulp; the finite values of dQ and dK within one fp16 ulp of the largest
    finite dS (32, below 65504) times the largest |K| or |Q| they multiply:
    a dS that rounds the other way (p in float64 here, in fp32 there)
    moves a sum of dS K by that much."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q, k, v, do = _overflow_inputs()
    scale = 1.0 / np.sqrt(64)
    ref = _jax_grads("short", q, k, v, do, None, False, scale, 0.0, "bshd", "float16")
    got = _port_grads("short", q, k, v, do, None, False, scale, 0.0, "bshd", "float16")
    assert not np.isfinite(ref[0]).all() and not np.isfinite(ref[1]).all()
    assert np.isfinite(ref[2]).all()
    for g, r, other in zip(got, ref, (k, q, None)):
        g = g.float().numpy()
        assert (np.isnan(g) == np.isnan(r)).all() and (np.isposinf(g) == np.isposinf(r)).all()
        np.testing.assert_allclose(g, r, **_overflow_tol(r, other))


# (n, k, dtype): BERT's encoder rows and mlm.ln's b * max_preds rows,
# and a ragged n past the Pallas block
LN_CASES = [
    (1024, 768, "float32"),
    (160, 768, "float32"),
    (1100, 128, "float32"),
    (64, 64, "float32"),
    (512, 768, "bfloat16"),
    (512, 768, "float16"),
]


def _ln_inputs(n, k, seed=11):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, k) * 2 + 0.5).astype(np.float32)
    dy = rs.randn(n, k).astype(np.float32)
    scale = (rs.rand(k) + 0.5).astype(np.float32)
    mean = x.mean(axis=1)
    rstd = (1.0 / np.sqrt(x.var(axis=1) + 1e-5)).astype(np.float32)
    return x, dy, mean.astype(np.float32), rstd, scale


@pytest.mark.parametrize("case", LN_CASES, ids=_case_id)
def test_ln_bwd_plain_matches_pallas_kernel(case, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.layer_norm import ln_bwd as j_ln_bwd

    n, k, dtype = case
    x, dy, mean, rstd, scale = _ln_inputs(n, k)
    jdt = jnp.dtype(dtype)
    ref = [np.asarray(t.astype(jnp.float32)) for t in j_ln_bwd(
        jnp.asarray(x, jdt), jnp.asarray(dy, jdt), jnp.asarray(mean), jnp.asarray(rstd),
        jnp.asarray(scale))]
    if dtype == "bfloat16":
        # dscale follows the JAX package's layer_norm_grad for bf16 X
        # (nn_ops.py:598-605), which rounds dy and the normalized value to
        # bf16 before their products; the Pallas body keeps them in fp32
        def bf(a):
            return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

        nrm = (bf(x) - mean[:, None]) * rstd[:, None]
        ref[1] = (bf(dy) * bf(nrm)).sum(axis=0, dtype=np.float32)
    tdt = getattr(torch, dtype)
    launches = dict(LAUNCHES)
    got = ln_bwd(*_torch((x, dy), tdt), *_torch((mean, rstd, scale), torch.float32))
    assert LAUNCHES == launches
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    # dscale / dbias sum n rows: fp32 summation order over up to 1100 terms
    tols = (_tol(dtype, ref[0]), dict(atol=1e-4, rtol=1e-5), dict(atol=1e-4, rtol=1e-5))
    if dtype == "bfloat16":  # the sums of bf16-rounded inputs, in fp32 on both sides
        tols = (_tol(dtype), dict(atol=2e-3, rtol=1e-5), dict(atol=2e-3, rtol=1e-5))
    for g, r, tol in zip(got, ref, tols):
        np.testing.assert_allclose(g.float().numpy(), r, **tol)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_training_kernels.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + CUDA_CASES, ids=_case_id)
def test_cuda_backward_matches_plain(case, cuda_device):
    kernel, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, do, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    tdt = getattr(torch, dtype)
    qt, kt, vt, dot = _torch((q, k, v, do), tdt, cuda_device)
    bt = None if bias is None else torch.from_numpy(bias).to(cuda_device)
    kw = dict(causal=causal, dropout=dropout, seed=1234, layout=layout)
    fwd_plain, bwd, bwd_plain, name = (
        (short_attention_plain, short_attention_bwd, short_attention_bwd_plain,
         "mha_short_bwd") if kernel == "short" else
        (flash_attention_plain, flash_attention_bwd, flash_attention_bwd_plain,
         "flash_bwd"))
    out, lse = fwd_plain(qt, kt, vt, bias=bt, **kw)
    delta = attention_delta(out, dot, layout)
    before = LAUNCHES[name]
    got = bwd(qt, kt, vt, bt, dot, lse, delta, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    ref = bwd_plain(qt, kt, vt, bt, dot, lse, delta, **kw)
    for g, r in zip(got, ref):
        r = r.float().cpu().numpy()
        np.testing.assert_allclose(g.float().cpu().numpy(), r, **_tol(dtype, r))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["short", "flash"])
def test_cuda_fp16_ds_overflow_gives_inf_as_plain(kernel, cuda_device):
    """On the card the fp16 kernels round an overflowing dS to inf, as the
    plain version (and the Pallas kernels) do: the same non-finite
    pattern in dQ and dK, finite dV, the finite values within the gates of
    test_fp16_ds_overflow_gives_inf_as_pallas; nothing is clamped."""
    q, k, v, do = _overflow_inputs()
    qt, kt, vt, dot = _torch((q, k, v, do), torch.float16, cuda_device)
    fwd_plain, bwd, bwd_plain = (
        (short_attention_plain, short_attention_bwd, short_attention_bwd_plain)
        if kernel == "short" else
        (flash_attention_plain, flash_attention_bwd, flash_attention_bwd_plain))
    kw = dict(layout="bshd")
    out, lse = fwd_plain(qt, kt, vt, **kw)
    args = (qt, kt, vt, None, dot, lse, attention_delta(out, dot, "bshd"))
    got, ref = bwd(*args, **kw), bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ref[0]).all()) and bool(torch.isfinite(ref[2]).all())
    for g, r, other in zip(got, ref, (k, q, None)):
        g, r = g.float().cpu().numpy(), r.float().cpu().numpy()
        assert (np.isnan(g) == np.isnan(r)).all() and (np.isposinf(g) == np.isposinf(r)).all()
        np.testing.assert_allclose(g, r, **_overflow_tol(r, other))


@pytest.mark.gpu
@pytest.mark.parametrize("case", LN_CASES, ids=_case_id)
def test_cuda_ln_bwd_matches_plain(case, cuda_device):
    n, k, dtype = case
    x, dy, mean, rstd, scale = _ln_inputs(n, k)
    tdt = getattr(torch, dtype)
    args = (*_torch((x, dy), tdt, cuda_device),
            *_torch((mean, rstd, scale), torch.float32, cuda_device))
    before = LAUNCHES["layer_norm_bwd"]
    got = ln_bwd(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_norm_bwd"] == before + 1
    ref = ln_bwd_plain(*args)
    tols = (_tol(dtype, ref[0].float().cpu().numpy()), dict(atol=1e-4, rtol=1e-5),
            dict(atol=1e-4, rtol=1e-5))
    for g, r, tol in zip(got, ref, tols):
        np.testing.assert_allclose(g.float().cpu().numpy(), r.float().cpu().numpy(), **tol)


@pytest.mark.gpu
def test_cuda_backward_kernels_are_deterministic(cuda_device):
    """No atomics: two launches on the same inputs agree bitwise, with
    dropout, in fp32 and bf16."""
    q, k, v, do, bias = _inputs("bshd", 2, 4, 128, 128, 64, True)
    bt = torch.from_numpy(bias).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        qt, kt, vt, dot = _torch((q, k, v, do), dtype, cuda_device)
        kw = dict(dropout=0.1, seed=99, layout="bshd")
        out, lse = short_attention(qt, kt, vt, bias=bt, **kw)
        delta = attention_delta(out, dot, "bshd")
        a = short_attention_bwd(qt, kt, vt, bt, dot, lse, delta, **kw)
        b = short_attention_bwd(qt, kt, vt, bt, dot, lse, delta, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    x, dy, mean, rstd, scale = _ln_inputs(1024, 768)
    args = (*_torch((x, dy, mean, rstd, scale), torch.float32, cuda_device),)
    assert all(torch.equal(x, y) for x, y in zip(ln_bwd(*args), ln_bwd(*args)))
