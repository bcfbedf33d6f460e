"""The block math of the tensor-core short attention backward
(csrc/mha_short_bwd.cu), mirrored on the CPU by
`short_attention_bwd_mirror`, against the plain version (float64 inside)
and against `jax.vjp` through the Pallas kernels in interpret mode.

fp32 products in the kernel are 3xTF32 (x = hi + lo, hi = tf32(x),
lo = tf32(x - hi); hi*hi + hi*lo + lo*hi): the mirror stays within atol
1e-4 of both references, and at BERT's shape its error is at least 20x
smaller than that of single-pass TF32, which is why the kernel splits.

The `gpu`-marked test builds csrc/mma_probe.cu and holds the MMA
fragment layouts of csrc/mma_common.cuh against torch.matmul on the card;
the card has no JAX, so run
`python -m pytest -m gpu --noconftest tests/test_torch_short_bwd_tc.py`
there."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops.kernels import dtype_code, mha_short
from paddle_tpu_torch.ops.kernels.flash_attention import attention_delta, tf32_round
from paddle_tpu_torch.ops.kernels.mha_short import (
    short_attention,
    short_attention_bwd_mirror,
    short_attention_bwd_plain,
)
from test_torch_kernels import fp16_ulp
from test_torch_training_kernels import CASES, KEY_SEED, _case_id, _inputs, _jax_grads

# the six fp32 short cases of the training-kernel tests, and BERT-base's
# attention at b 2 with its dropout
MIRROR_CASES = [c for c in CASES if c[0] == "short" and c[9] == "float32"] + [
    ("short", "bshd", 2, 12, 128, 128, 64, True, False, "float32", 0.1),
]
BF16_CASES = [c for c in CASES if c[0] == "short" and c[9] == "bfloat16"]
FP16_CASES = [c for c in CASES if c[0] == "short" and c[9] == "float16"]
ATOL = 1e-4


def _run(case):
    """-> (mirror grads, plain grads, forward inputs) as torch tensors."""
    _, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, do, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    tdt = getattr(torch, dtype)
    qt, kt, vt, dot = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    bt = None if bias is None else torch.from_numpy(bias)
    seed = prng.randint(prng.key(KEY_SEED), 1, 0, 2**31 - 1)[0] if dropout > 0 else 0
    kw = dict(causal=causal, sm_scale=1.0 / np.sqrt(d), dropout=dropout, seed=seed,
              layout=layout)
    out, lse = short_attention(qt, kt, vt, bias=bt, **kw)
    args = (qt, kt, vt, bt, dot, lse, attention_delta(out, dot, layout))
    return args, kw, (q, k, v, do, bias)


@pytest.mark.parametrize("case", MIRROR_CASES, ids=_case_id)
def test_mirror_matches_plain_and_pallas(case, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    _, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    args, kw, (q, k, v, do, bias) = _run(case)
    mirror = short_attention_bwd_mirror(*args, **kw)
    plain = short_attention_bwd_plain(*args, **kw)
    ref = _jax_grads("short", q, k, v, do, bias, causal, kw["sm_scale"], dropout, layout,
                     dtype)
    for m, p, r, t in zip(mirror, plain, ref, (q, k, v)):
        assert m.dtype == torch.float32 and m.shape == t.shape
        np.testing.assert_allclose(m.numpy(), p.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(m.numpy(), r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", BF16_CASES, ids=_case_id)
def test_mirror_bf16_matches_plain(case):
    """bf16: exact products, fp32 sums; p_drop and dS rounded to bf16 as
    in the plain version, so the two differ by one bf16 ulp at most."""
    args, kw, _ = _run(case)
    for m, p in zip(short_attention_bwd_mirror(*args, **kw),
                    short_attention_bwd_plain(*args, **kw)):
        assert m.dtype == torch.bfloat16
        np.testing.assert_allclose(m.float().numpy(), p.float().numpy(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("case", FP16_CASES, ids=_case_id)
def test_mirror_fp16_matches_plain(case):
    """fp16: exact products, fp32 sums; p_drop and dS rounded to fp16 as in
    the plain version, so the two differ by one fp16 ulp of each grad's
    largest magnitude at most."""
    args, kw, _ = _run(case)
    for m, p in zip(short_attention_bwd_mirror(*args, **kw),
                    short_attention_bwd_plain(*args, **kw)):
        assert m.dtype == torch.float16
        p = p.float().numpy()
        np.testing.assert_allclose(m.float().numpy(), p, atol=fp16_ulp(p), rtol=0)


def _single_pass_tf32(a, b):
    """a @ b of fp32 inputs as single-pass TF32 makes it: tf32(a) tf32(b)."""
    return torch.matmul(tf32_round(a).double(), tf32_round(b).double()).float()


def test_single_pass_tf32_is_20x_worse_at_bert_shape(monkeypatch):
    args, kw, _ = _run(MIRROR_CASES[-1])
    plain = short_attention_bwd_plain(*args, **kw)
    err3 = max(float((m - p).abs().max()) for m, p in
               zip(short_attention_bwd_mirror(*args, **kw), plain))
    monkeypatch.setattr(mha_short, "_mma", _single_pass_tf32)
    err1 = max(float((m - p).abs().max()) for m, p in
               zip(short_attention_bwd_mirror(*args, **kw), plain))
    assert err3 <= ATOL and 20 * err3 <= err1, (err3, err1)


def test_tf32_round_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-11), 1.0 + 3 * 2**-12,
                      3.0e-3, 0.0, -7.5], dtype=torch.float32)
    got = tf32_round(x)
    # 1 + 2^-11 is a tie between 1 and 1 + 2^-10: away from zero
    want = [1.0, 1.0 + 2**-10, 1.0, -(1.0 + 2**-10), 1.0 + 2**-10]
    assert got[:5].tolist() == want
    assert float((got[5] - x[5]).abs()) <= 2**-11 * float(x[5])
    assert got[6:].tolist() == [0.0, -7.5]
    # 10 mantissa bits: the low 13 bits are clear
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_short_bwd_tc.py` on the card")


@pytest.fixture
def cuda_device():
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mma_probe(tmp_path_factory):
    """csrc/mma_probe.cu, built with the package's nvcc flags."""
    from paddle_tpu_torch.ops.kernels import _build

    _need_cuda()
    lib = tmp_path_factory.mktemp("mma_probe") / "libmma_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(_build.CSRC / "mma_probe.cu")], check=True)
    return ctypes.CDLL(str(lib)).mma_probe


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cuda_mma_fragment_layouts(dtype, mode, cuda_device, mma_probe):
    """One 16 x 8 tile through each loader pair of mma_common.cuh:
    mode 0 A @ B[:8]^T (load_a, load_b_nk), mode 1 A @ B[:, :8]
    (load_a_kn, load_b_kn), mode 2 (A @ B^T) @ B2[:, :8], the first
    product's C fragments fed back as A (a_from_c, load_b_kn)."""
    fn = mma_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    tdt = getattr(torch, dtype)
    rs = np.random.RandomState(mode)
    a, b, b2 = (torch.from_numpy(rs.randn(16, 16).astype(np.float32)).to(cuda_device, tdt)
                for _ in range(3))
    c = torch.empty(16, 8, dtype=torch.float32, device=cuda_device)
    rc = fn(a.data_ptr(), b.data_ptr(), b2.data_ptr(), c.data_ptr(),
            dtype_code(tdt), mode, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    a64, b64, b264 = (t.double() for t in (a, b, b2))
    if mode == 0:
        ref = a64 @ b64[:8].T
    elif mode == 1:
        ref = a64 @ b64[:, :8]
    else:
        c1 = (a64 @ b64.T).float()
        ref = c1.to(tdt).double() @ b264[:, :8]
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    if dtype != "float32" and mode == 2:
        # the first product's fp32 sums round to the 16-bit type: one ulp
        # of its significand (8 bits bf16, 11 fp16) of the largest |ref|
        tol = 2.0 ** (1 - {"bfloat16": 8, "float16": 11}[dtype]) * float(ref.abs().max())
    np.testing.assert_allclose(c.double().cpu().numpy(), ref.cpu().numpy(), atol=tol, rtol=0)
