"""The block math of the tensor-core flash attention forward
(csrc/flash_fwd.cu), mirrored on the CPU by `flash_attention_fwd_mirror`,
against the plain version (float64 inside) and against the Pallas
`_fwd_pallas` in interpret mode.

The mirror walks 64-row query tiles over 64-key tiles in order, skips the
key tiles past the causal diagonal (except in a query tile that holds a
row with no live key, which walks every tile), keeps m, l, alpha and acc
in float32 and makes every product as the tensor cores do: fp32 as 3xTF32
(x = hi + lo, hi = tf32(x), lo = tf32(x - hi); hi*hi + hi*lo + lo*hi),
bf16 exactly, p rounded to v's dtype before P V. In fp32 it stays within
0.007-0.033 of the `gpu` tests' tolerance (atol 1e-5 + rtol 1e-5) of the
plain version on every fp32 case here; single-pass TF32 misses the 1e-4
gate of the card's checks by 9.1x at s 512 and 9.5x at s 2048 (d 64,
causal, bias), which is why the kernel splits.

The `gpu`-marked tests hold the CUDA kernel against the plain version on
the card; the card has no JAX, so run
`python -m pytest -m gpu --noconftest tests/test_torch_flash_fwd_tc.py`
there."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_fwd_mirror,
    flash_attention_plain,
)
from test_torch_kernels import (CASES, SEED, _case_id, _inputs, _jax_flash, _tol,
                                _torch_inputs, fp16_ulp)
from test_torch_short_bwd_tc import _single_pass_tf32

# the flash cases of the kernel tests (every row has a live key), and the
# long-sequence path's attention at b 1, h 2
FLASH_CASES = [c for c in CASES if c[0] == "flash"] + [
    ("flash", "bhsd", 1, 2, 2048, 2048, 64, True, True, "float32", 0.0),
]
# (layout, b, h, sq, sk, d, bias, causal): causal sq > sk (rows with no live
# key, a query tile straddling the edge), sq = 1, sk not a multiple of 64,
# d in {16, 36, 40, 128} (36 in bf16: rows not 16-byte aligned, the
# kernel's scalar copies)
EDGE_SHAPES = [
    ("bshd", 2, 3, 100, 77, 40, False, True),
    ("bhsd", 2, 2, 130, 64, 16, True, True),
    ("bshd", 2, 2, 300, 250, 128, True, True),
    ("bhsd", 1, 2, 1, 200, 128, True, True),
    ("bshd", 1, 3, 1, 77, 16, False, False),
    ("bshd", 1, 3, 257, 700, 36, True, True),
    ("bhsd", 1, 2, 513, 1000, 64, True, True),
]
EDGE_CASES = [(*s, dtype, dropout) for s in EDGE_SHAPES
              for dtype in ("float32", "bfloat16") for dropout in (0.0, 0.2)] + [
    (*s, "float16", 0.2) for s in EDGE_SHAPES[:2]]
GPU_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 on the card: summation order only
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _atol(dtype, ref):
    """ATOL[dtype]; fp16: one fp16 ulp of the largest magnitude of an fp16
    output, the fp32 gate for a float32 one (lse)."""
    if dtype != "float16":
        return ATOL[dtype]
    return ATOL["float32"] if ref.dtype == torch.float32 else fp16_ulp(ref.float().numpy())


def _edge_id(c):
    return "-".join(str(x) for x in c)


@pytest.fixture(autouse=True)
def steady_torch_cpu():
    """The CPU math of each test with one intra-op thread and IEEE
    denormals, whatever the tests before it in the process left set: the
    mirrors' float32 results then do not hang on the thread split of
    torch's kernels, and their thousands of small ops run 70x faster under
    the suite's parallel workers (0.46 s against 36 s for the backward
    mirror at s 1024 on an 8-core Xeon beside six busy workers)."""
    threads = torch.get_num_threads()
    torch.set_flush_denormal(False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(fn, q, k, v, bias, causal, dtype, dropout, layout, device="cpu"):
    return fn(*_torch_inputs(q, k, v, bias, dtype, device), causal=causal,
              sm_scale=1.0 / np.sqrt(q.shape[-1]), dropout=dropout, seed=SEED,
              layout=layout)


def _gpu_margin(got, ref):
    """The largest |got - ref| as a share of atol 1e-5 + rtol 1e-5 |ref|."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max())


@pytest.mark.parametrize("case", FLASH_CASES, ids=_case_id)
def test_mirror_matches_plain(case):
    _, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    args = (q, k, v, bias, causal, dtype, dropout, layout)
    out, lse = _run(flash_attention_fwd_mirror, *args)
    ref_out, ref_lse = _run(flash_attention_plain, *args)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), ref_out.float().numpy(),
                               atol=_atol(dtype, ref_out), rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=_atol(dtype, ref_lse), rtol=0)
    if dtype == "float32":  # 3xTF32 keeps well inside the card's fp32 tolerance
        assert _gpu_margin(out, ref_out) <= 0.1 and _gpu_margin(lse, ref_lse) <= 0.1


@pytest.mark.parametrize("case", FLASH_CASES[:-1], ids=_case_id)
def test_mirror_matches_pallas_kernel(case, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    _, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    ref_out, ref_lse = _jax_flash(q, k, v, bias, causal, 1.0 / np.sqrt(d), dropout, layout,
                                  dtype)
    out, lse = _run(flash_attention_fwd_mirror, q, k, v, bias, causal, dtype, dropout, layout)
    tol = GPU_TOL if dtype == "float32" else dict(atol=2e-2, rtol=0)
    if dtype == "float16":
        tol = dict(atol=fp16_ulp(ref_out), rtol=0)
    np.testing.assert_allclose(out.float().numpy(), ref_out, **tol)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **(GPU_TOL if dtype == "float16" else tol))


@pytest.mark.parametrize("s", [512, 2048])
def test_single_pass_tf32_misses_the_fp32_gate(s, monkeypatch):
    """At s >= 512 (d 64, causal, bias) one TF32 pass misses the 1e-4 gate
    by more than 8x (9.1x, 9.5x); 3xTF32 stays 100x inside it."""
    q, k, v, bias = _inputs("bhsd", 1, 2, s, s, 64, True)
    args = (q, k, v, bias, True, "float32", 0.0, "bhsd")
    ref_out, _ = _run(flash_attention_plain, *args)
    err3 = float((_run(flash_attention_fwd_mirror, *args)[0] - ref_out).abs().max())
    monkeypatch.setattr(fa, "_mma", _single_pass_tf32)
    err1 = float((_run(flash_attention_fwd_mirror, *args)[0] - ref_out).abs().max())
    assert 100 * err3 <= ATOL["float32"] < err1 / 8, (err3, err1)


@pytest.mark.parametrize("case", EDGE_CASES, ids=_edge_id)
def test_mirror_edges_match_plain(case):
    """Causal sq > sk: the rows with no live key come out as the plain
    version's dropout-masked mean of V with lse -1e30 + log sk, though the
    other query tiles skip the tiles past their diagonal."""
    layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    args = (q, k, v, bias, causal, dtype, dropout, layout)
    out, lse = _run(flash_attention_fwd_mirror, *args)
    ref_out, ref_lse = _run(flash_attention_plain, *args)
    np.testing.assert_allclose(out.float().numpy(), ref_out.float().numpy(),
                               atol=_atol(dtype, ref_out), rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=_atol(dtype, ref_lse),
                               rtol=1e-6)
    if dtype == "float32":
        assert _gpu_margin(out, ref_out) <= 0.1
    if causal and sq > sk:
        dead = sq - sk  # rows 0 .. sq - sk - 1 see no key
        assert bool((lse[:, :, :dead] <= NEG_INF / 2).all())
        assert float(out.float().abs().sum()) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_flash_fwd_tc.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_CASES, ids=_edge_id)
def test_cuda_flash_fwd_edges_match_plain(case, cuda_device):
    layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    args = (q, k, v, bias, causal, dtype, dropout, layout, cuda_device)
    before = LAUNCHES["flash_fwd"]
    out, lse = _run(flash_attention, *args)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd"] == before + 1
    ref_out, ref_lse = _run(flash_attention_plain, *args)
    ref_out = ref_out.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref_out, **_tol(dtype, ref_out))
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_flash_fwd_strided_views(dtype, cuda_device):
    """q, k, v as views into a wider bshd tensor (rows not 16-byte
    aligned): the kernel's scalar copies."""
    q, k, v, bias = _inputs("bshd", 2, 3, 150, 190, 64, True)
    wide = [np.concatenate([t, np.zeros(t.shape[:-1] + (3,), np.float32)], -1)
            for t in (q, k, v)]
    qt, kt, vt, bt = _torch_inputs(*wide, bias, dtype, cuda_device)
    views = [t[..., :64] for t in (qt, kt, vt)]
    kw = dict(bias=bt, causal=True, dropout=0.2, seed=SEED, layout="bshd")
    out, lse = flash_attention(*views, **kw)
    ref_out, ref_lse = flash_attention_plain(*views, **kw)
    ref_out = ref_out.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref_out, **_tol(dtype, ref_out))
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_flash_fwd_is_deterministic(dtype, cuda_device):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v, bias = _inputs("bhsd", 2, 4, 700, 900, 64, True)
    args = (q, k, v, bias, True, dtype, 0.2, "bhsd", cuda_device)
    out1, lse1 = _run(flash_attention, *args)
    out2, lse2 = _run(flash_attention, *args)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
