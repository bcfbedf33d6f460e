"""The block math of the tensor-core flash attention backward
(csrc/flash_bwd.cu), mirrored on the CPU by `flash_attention_bwd_mirror`,
against the plain version (float64 inside) and against `jax.vjp` through
the Pallas backward kernels in interpret mode.

The mirror walks the kernel's two launches: 32-key tiles over their query
tiles (64 rows, 32 at d > 64) and 32-row query tiles over their 64-key
tiles, each in order, skipping the same causal tiles except those that
hold a row with no live key (causal sq > sk: p = exp(NEG_INF - NEG_INF) = 1
on every key there, as in the Pallas kernels). Every product is made as
the tensor cores make it: fp32 as 3xTF32 (x = hi + lo, hi = tf32(x),
lo = tf32(x - hi); hi*hi + hi*lo + lo*hi), bf16 exactly; p_drop is rounded
to dO's dtype and dS to q's; every sum is float32 over the tiles in order.

Tolerances, each with its reason:
- fp32 mirror against the plain version: within half of the `gpu` tests'
  tolerance (atol 1e-5 + rtol 1e-5 |ref|), so the card's own summation
  order keeps the other half; measured at most 0.43 of it (d 128, causal
  sq > sk, dropout), 0.03 at s 2048.
- fp32 against the Pallas kernels: atol 1e-5 + rtol 1e-5, the training
  kernels' tests' tolerance (summation order only).
- fp32 kernel against the plain version on the card: atol 1e-5 times the
  grad's largest magnitude (at least 1) + rtol 1e-5. The summation-order
  error scales with the terms summed, and the rows with no live key sum
  p = 1 over every key, so their grads reach ~12 and an element near 0
  among them is off by up to 2e-5 (measured at d 128), 1.6e-6 of the
  row's scale; elsewhere the grads stay below 1, where this is 1e-5.
- bf16: atol 2e-2 + rtol 2^-7, one bf16 ulp: p_drop and dS round to
  bf16 on both sides and a rounding flip moves a product by one ulp. dO
  is scaled by 0.5, so most grads stay below 2, where one ulp is under
  2e-2; the rows with no live key sum p = 1 over every key and reach 4-8,
  where it is 3.1e-2 (measured).
- Single-pass TF32 against the card's 1e-4 gate: at s 512 and 2048 (d 64,
  causal, bias) it misses the gate by 10.3x and 19.4x, where 3xTF32 stays
  170-210x inside it, which is why the kernel splits.

The `gpu`-marked tests hold the CUDA kernel against the plain version on
the card (the same shapes, fp32 and bf16, strided views, two launches
bit for bit); the card has no JAX, so run
`python -m pytest -m gpu --noconftest tests/test_torch_flash_bwd_tc.py`
there."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels.flash_attention import (
    attention_delta,
    flash_attention_bwd,
    flash_attention_bwd_mirror,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from test_torch_flash_fwd_tc import EDGE_CASES, _edge_id, steady_torch_cpu  # noqa: F401
from test_torch_kernels import CASES as FWD_CASES
from test_torch_kernels import fp16_ulp
from test_torch_short_bwd_tc import _single_pass_tf32
from test_torch_training_kernels import CASES as BWD_CASES
from test_torch_training_kernels import KEY_SEED, _inputs, _jax_grads

# (layout, b, h, sq, sk, d, bias, causal, dtype, dropout): the flash cases
# of the forward and backward kernel tests (every row has a live key),
# then the long-sequence step's attention at b 1, h 2
PALLAS_CASES = [c[1:] for c in BWD_CASES if c[0] == "flash"]
MIRROR_CASES = [c[1:] for c in FWD_CASES if c[0] == "flash"]
MIRROR_CASES += [c for c in PALLAS_CASES if c not in MIRROR_CASES] + [
    ("bhsd", 1, 2, 2048, 2048, 64, True, True, "float32", 0.0),
]
GPU_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 on the card: summation order only
BF16_TOL = dict(atol=2e-2, rtol=2.0**-7)  # one bf16 ulp
FP32_GATE = 1e-4  # chip_smoke.py's fp32 gate


def _args(case, device="cpu"):
    """The plain forward on `case`'s inputs -> (backward args, kwargs): q,
    k, v, bias, dO, lse, delta, with the JAX entry points' int32 seed."""
    layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, do, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    tdt = getattr(torch, dtype)
    qt, kt, vt, dot = (torch.from_numpy(a).to(device, tdt) for a in (q, k, v, do))
    bt = None if bias is None else torch.from_numpy(bias).to(device)
    seed = prng.randint(prng.key(KEY_SEED), 1, 0, 2**31 - 1)[0] if dropout > 0 else 0
    kw = dict(causal=causal, sm_scale=1.0 / np.sqrt(d), dropout=dropout, seed=seed,
              layout=layout)
    out, lse = flash_attention_plain(qt, kt, vt, bias=bt, **kw)
    return (qt, kt, vt, bt, dot, lse, attention_delta(out, dot, layout)), kw


def _tol(dtype, ref=None):
    """fp32: summation order; bf16 one bf16 ulp; fp16 one fp16 ulp of
    `ref`'s largest magnitude."""
    if dtype == "float16":
        return dict(atol=fp16_ulp(ref), rtol=0)
    return GPU_TOL if dtype == "float32" else BF16_TOL


def _assert_close_on_card(got, ref, dtype):
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    tol = dict(BF16_TOL) if dtype == "bfloat16" else _tol(dtype, ref)
    if dtype == "float32":
        tol = dict(atol=1e-5 * max(1.0, float(np.abs(ref).max())), rtol=1e-5)
    np.testing.assert_allclose(got, ref, **tol)


def _gpu_margin(got, ref):
    """The largest |got - ref| as a share of atol 1e-5 + rtol 1e-5 |ref|."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max())


def _check_against_plain(case):
    args, kw = _args(case)
    mirror = flash_attention_bwd_mirror(*args, **kw)
    plain = flash_attention_bwd_plain(*args, **kw)
    dtype = case[8]
    for m, p, t in zip(mirror, plain, args[:3]):
        assert m.dtype == t.dtype and m.shape == t.shape
        assert bool(torch.isfinite(p.float()).all())
        if dtype == "float32":
            assert _gpu_margin(m, p) <= 0.5
        else:
            p = p.float().numpy()
            np.testing.assert_allclose(m.float().numpy(), p, **_tol(dtype, p))
    return mirror


@pytest.mark.parametrize("case", MIRROR_CASES, ids=_edge_id)
def test_mirror_matches_plain(case):
    _check_against_plain(case)


@pytest.mark.parametrize("case", PALLAS_CASES, ids=_edge_id)
def test_mirror_matches_pallas_kernels(case, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    args, kw = _args(case)
    q, k, v, do, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    ref = _jax_grads("flash", q, k, v, do, bias, causal, kw["sm_scale"], dropout, layout,
                     dtype)
    for m, r in zip(flash_attention_bwd_mirror(*args, **kw), ref):
        np.testing.assert_allclose(m.float().numpy(), r, **_tol(dtype, r))


@pytest.mark.parametrize("case", EDGE_CASES, ids=_edge_id)
def test_mirror_edges_match_plain(case):
    """Causal sq > sk: the rows with no live key have p = 1 on every key,
    so their dQ is not 0, and every key tile's dK and dV take them in,
    though the other query tiles skip the tiles past their diagonal."""
    dq, _, _ = _check_against_plain(case)
    layout, _, _, sq, sk, _, _, causal, _, _ = case
    if causal and sq > sk:
        dead = dq[:, : sq - sk] if layout == "bshd" else dq[:, :, : sq - sk]
        assert float(dead.float().abs().sum()) > 0


@pytest.mark.parametrize("s", [512, 2048])
def test_single_pass_tf32_misses_the_fp32_gate(s, monkeypatch):
    """At s 512 and 2048 (d 64, causal, bias) one TF32 pass misses the
    card's 1e-4 gate on dQ, dK or dV by more than 8x (10.3x, 19.4x);
    3xTF32 stays 100x inside it (210x, 168x)."""
    args, kw = _args(("bhsd", 1, 2, s, s, 64, True, True, "float32", 0.0))
    plain = flash_attention_bwd_plain(*args, **kw)

    def err():
        return max(float((m - p).abs().max())
                   for m, p in zip(flash_attention_bwd_mirror(*args, **kw), plain))

    err3 = err()
    monkeypatch.setattr(fa, "_mma", _single_pass_tf32)
    err1 = err()
    assert 100 * err3 <= FP32_GATE < err1 / 8, (err3, err1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_flash_bwd_tc.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    return torch.device("cuda")


def _with_dtype(case, dtype):
    return case[:8] + (dtype, case[9])


CUDA_CASES = list(dict.fromkeys(
    [_with_dtype(c, dt) for c in MIRROR_CASES for dt in ("float32", "bfloat16", "float16")]
    + EDGE_CASES))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CUDA_CASES, ids=_edge_id)
def test_cuda_flash_bwd_matches_plain(case, cuda_device):
    args, kw = _args(case, cuda_device)
    before = LAUNCHES["flash_bwd"]
    got = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_bwd"] == before + 1
    for g, r in zip(got, flash_attention_bwd_plain(*args, **kw)):
        _assert_close_on_card(g, r, case[8])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_flash_bwd_strided_views(dtype, cuda_device):
    """q, k, v and dO as views into wider bshd tensors (rows not 16-byte
    aligned): the kernel's scalar copies."""
    args, kw = _args(("bshd", 2, 3, 150, 190, 64, True, True, dtype, 0.2), cuda_device)
    wide = [torch.cat([t, torch.zeros(t.shape[:-1] + (3,), dtype=t.dtype,
                                      device=cuda_device)], -1) for t in args[:3] + args[4:5]]
    q, k, v, do = (t[..., :64] for t in wide)
    views = (q, k, v, args[3], do, args[5], args[6])
    for g, r in zip(flash_attention_bwd(*views, **kw), flash_attention_bwd_plain(*views, **kw)):
        _assert_close_on_card(g, r, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_flash_bwd_is_deterministic(dtype, cuda_device):
    """No atomics: two launches on the same inputs agree bit for bit."""
    args, kw = _args(("bhsd", 2, 4, 700, 900, 64, True, True, dtype, 0.2), cuda_device)
    a = flash_attention_bwd(*args, **kw)
    b = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
