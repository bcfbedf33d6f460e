"""The block math of the tensor-core short attention forward
(csrc/mha_short_fwd.cu), mirrored on the CPU by
`short_attention_fwd_mirror`, against the plain version (float64 inside)
and against the Pallas `_short_fwd_bshd` / `_short_fwd_pallas` in
interpret mode.

The mirror walks each key group's 64-key tiles (tile i in group
i % groups) in order with an online softmax in base 2 and float32, its
running max starting at the clamp NEG_INF log2(e) / 8, merges the groups
in order, and makes every product as the tensor cores do: fp32 as 3xTF32
(x = hi + lo, hi = tf32(x), lo = tf32(x - hi); hi*hi + hi*lo + lo*hi),
bf16 exactly, p rounded to v's dtype before P V. In fp32 it stays within
0.1 of the `gpu` tests' tolerance (atol 1e-5 + rtol 1e-5) of the plain
version on every case here (0.01-0.03 measured); in bf16 within one bf16
ulp of the outputs' largest magnitude (p rounds under the key group's
running max rather than the row's). Single-pass TF32 misses the card's
1e-4 gate by 6.5x at BERT's shape, which is why the kernel splits.

The `gpu`-marked tests hold the CUDA kernel against the plain version on
the card; the card has no JAX, so run
`python -m pytest -m gpu --noconftest tests/test_torch_short_fwd_tc.py`
there."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.ops.kernels import mha_short as ms
from paddle_tpu_torch.ops.kernels.flash_attention import NEG_INF, tf32_round
from paddle_tpu_torch.ops.kernels.mha_short import (
    short_attention,
    short_attention_fwd_mirror,
    short_attention_plain,
)
from test_torch_kernels import SEED, _inputs, _jax_short, _tol, _torch_inputs
from test_torch_short_bwd_tc import _single_pass_tf32

# (layout, b, h, sq, sk, d, bias, causal, dtype, dropout): BERT's shape at
# b 2, h 4 in both layouts; causal sq > sk (the first sq - sk rows see no
# key and come out 0) and sq <= sk; ragged 100 x 77; dropout 0.2; d 128;
# sk 512; d 36 in bf16 (rows not 16-byte aligned: the kernel's scalar
# copies); sq 1
CASES = [
    ("bshd", 2, 4, 128, 128, 64, True, False, "float32", 0.0),
    ("bshd", 2, 4, 128, 128, 64, True, False, "bfloat16", 0.0),
    ("bhsd", 2, 3, 128, 128, 64, True, False, "float32", 0.0),
    ("bhsd", 2, 3, 128, 128, 64, False, False, "bfloat16", 0.0),
    ("bshd", 2, 3, 100, 77, 64, False, True, "float32", 0.0),
    ("bshd", 2, 3, 100, 77, 64, True, True, "bfloat16", 0.2),
    ("bhsd", 1, 2, 64, 77, 64, True, True, "float32", 0.2),
    ("bshd", 1, 2, 100, 128, 128, True, True, "bfloat16", 0.0),
    ("bhsd", 1, 2, 200, 150, 128, False, False, "float32", 0.2),
    ("bshd", 1, 2, 512, 512, 64, True, False, "float32", 0.0),
    ("bhsd", 1, 2, 512, 512, 64, True, True, "bfloat16", 0.2),
    ("bshd", 1, 2, 300, 500, 40, True, True, "float32", 0.0),
    ("bshd", 2, 2, 77, 77, 36, False, False, "bfloat16", 0.0),
    ("bhsd", 1, 3, 1, 200, 64, True, False, "float32", 0.0),
    ("bshd", 2, 4, 128, 128, 64, True, False, "float16", 0.0),
    ("bhsd", 1, 2, 100, 77, 64, True, True, "float16", 0.2),
]
# the cases held against the Pallas kernels as well (interpret mode)
PALLAS_CASES = [CASES[i] for i in (0, 1, 3, 4, 5, 6, 8, 10, 14, 15)]
GPU_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 on the card: summation order only
_BITS = {"bfloat16": 8, "float16": 11}  # significant bits of the 16-bit types


def _id(c):
    return "-".join(str(x) for x in c)


@pytest.fixture(autouse=True)
def steady_torch_cpu():
    """The CPU math of each test with one intra-op thread and IEEE
    denormals, whatever the tests before it in the process left set: the
    mirror's float32 results then do not hang on the thread split of
    torch's kernels, and its many small ops run fast beside the suite's
    parallel workers."""
    threads = torch.get_num_threads()
    torch.set_flush_denormal(False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(fn, case, device="cpu", inputs=None):
    layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, bias = inputs or _inputs(layout, b, h, sq, sk, d, use_bias)
    return fn(*_torch_inputs(q, k, v, bias, dtype, device), causal=causal,
              sm_scale=1.0 / np.sqrt(d), dropout=dropout, seed=SEED, layout=layout)


def _gpu_margin(got, ref):
    """The largest |got - ref| as a share of atol 1e-5 + rtol 1e-5 |ref|."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max())


def _assert_within_bf16_ulp(got, ref, bits=8):
    """|got - ref| <= one bf16 ulp of the outputs' largest magnitude (bf16
    keeps 8 significant bits: ulp(x) = 2^(floor(log2 |x|) - 7); fp16,
    bits=11, 2^(floor(log2 |x|) - 10)). An output is a p-weighted mean of
    V, and p rounds to the 16-bit type under another max, so an output's
    error is on the scale of V, not of itself."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(ref).max())) - (bits - 1))
    err = float(np.abs(got - ref).max())
    assert err <= ulp, (err, ulp)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mirror_matches_plain(case):
    layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    out, lse = _run(short_attention_fwd_mirror, case)
    ref_out, ref_lse = _run(short_attention_plain, case)
    assert out.dtype == getattr(torch, dtype) and out.shape == ref_out.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    # lse: relative, for the rows with no key (NEG_INF / 8)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5, rtol=1e-6)
    if dtype == "float32":  # 3xTF32 keeps well inside the card's fp32 tolerance
        assert _gpu_margin(out, ref_out) <= 0.1 and _gpu_margin(lse, ref_lse) <= 0.1
    else:
        _assert_within_bf16_ulp(out.float().numpy(), ref_out.float().numpy(), _BITS[dtype])
    if causal and sq > sk:  # rows 0 .. sq - sk - 1 see no key: 0, lse NEG_INF / 8
        dead = (slice(None), slice(0, sq - sk)) if layout == "bshd" else (
            slice(None), slice(None), slice(0, sq - sk))
        assert int(torch.count_nonzero(out[dead])) == 0
        np.testing.assert_allclose(lse[:, :, :sq - sk].numpy(), NEG_INF / 8, rtol=1e-6)


@pytest.mark.parametrize("case", PALLAS_CASES, ids=_id)
def test_mirror_matches_pallas_kernel(case, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    inputs = _inputs(layout, b, h, sq, sk, d, use_bias)
    ref_out, ref_lse = _jax_short(*inputs, causal, 1.0 / np.sqrt(d), dropout, layout, dtype)
    out, lse = _run(short_attention_fwd_mirror, case, inputs=inputs)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **GPU_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref_out, **GPU_TOL)
    else:
        _assert_within_bf16_ulp(out.float().numpy(), ref_out, _BITS[dtype])


def test_single_pass_tf32_misses_the_fp32_gate(monkeypatch):
    """At BERT's shape (b 2, h 4, s 128, d 64, bias) one TF32 pass misses
    the 1e-4 gate by more than 5x (6.5x); 3xTF32 stays 100x inside it."""
    case = ("bshd", 2, 4, 128, 128, 64, True, False, "float32", 0.0)
    ref_out, _ = _run(short_attention_plain, case)
    err3 = float((_run(short_attention_fwd_mirror, case)[0] - ref_out).abs().max())
    monkeypatch.setattr(ms, "_mma", _single_pass_tf32)
    err1 = float((_run(short_attention_fwd_mirror, case)[0] - ref_out).abs().max())
    assert 100 * err3 <= 1e-4 < err1 / 5, (err3, err1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mirror_fully_masked_row_gives_zero(dtype):
    """A batch row whose keys the bias masks all (NEG_INF): the clamp keeps
    p = 0, so out is exactly 0 and lse NEG_INF / 8, as in Pallas."""
    case = ("bshd", 2, 2, 40, 70, 32, True, False, dtype, 0.2)
    q, k, v, bias = _inputs("bshd", 2, 2, 40, 70, 32, True)
    bias[1, :] = NEG_INF
    out, lse = _run(short_attention_fwd_mirror, case, inputs=(q, k, v, bias))
    ref_out, ref_lse = _run(short_attention_plain, case, inputs=(q, k, v, bias))
    assert int(torch.count_nonzero(out[1])) == 0 and int(torch.count_nonzero(ref_out[1])) == 0
    np.testing.assert_allclose(lse[1].numpy(), NEG_INF / 8, rtol=1e-6)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_short_fwd_tc.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cuda_short_fwd_matches_plain(case, cuda_device):
    dtype = case[8]
    before = LAUNCHES["mha_short_fwd"]
    out, lse = _run(short_attention, case, cuda_device)
    torch.cuda.synchronize()
    assert LAUNCHES["mha_short_fwd"] == before + 1
    ref_out, ref_lse = _run(short_attention_plain, case, cuda_device)
    ref_out = ref_out.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref_out, **_tol(dtype, ref_out))
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_short_fwd_strided_views(dtype, cuda_device):
    """q, k, v as views into a wider bshd tensor (rows not 16-byte
    aligned): the kernel's scalar copies and stores."""
    q, k, v, bias = _inputs("bshd", 2, 3, 150, 190, 64, True)
    wide = [np.concatenate([t, np.zeros(t.shape[:-1] + (3,), np.float32)], -1)
            for t in (q, k, v)]
    qt, kt, vt, bt = _torch_inputs(*wide, bias, dtype, cuda_device)
    views = [t[..., :64] for t in (qt, kt, vt)]
    kw = dict(bias=bt, causal=True, dropout=0.2, seed=SEED, layout="bshd")
    out, lse = short_attention(*views, **kw)
    ref_out, ref_lse = short_attention_plain(*views, **kw)
    ref_out = ref_out.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref_out, **_tol(dtype, ref_out))
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_short_fwd_is_deterministic(dtype, cuda_device):
    """No atomics: two launches on the same inputs agree bit for bit."""
    case = ("bhsd", 2, 4, 500, 300, 64, True, True, dtype, 0.2)
    out1, lse1 = _run(short_attention, case, cuda_device)
    out2, lse2 = _run(short_attention, case, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_short_fwd_fully_masked_row_gives_zero(dtype, cuda_device):
    q, k, v, bias = _inputs("bshd", 2, 2, 40, 70, 32, True)
    bias[1, :] = NEG_INF
    out, lse = short_attention(*_torch_inputs(q, k, v, bias, dtype, cuda_device)[:3],
                               bias=torch.from_numpy(bias).to(cuda_device), layout="bshd")
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(out[1])) == 0
    np.testing.assert_allclose(lse[1].cpu().numpy(), NEG_INF / 8, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("sq, sk", [(513, 64), (64, 513)])
def test_cuda_short_fwd_refuses_long_sequences(sq, sk, cuda_device):
    q, k, v, _ = _inputs("bhsd", 1, 1, sq, sk, 64, False)
    with pytest.raises(ValueError, match="sq, sk <= 512"):
        short_attention(*_torch_inputs(q, k, v, None, "float32", cuda_device)[:3])


@pytest.mark.gpu
def test_cuda_tf32_rounding_is_cvt_rna(cuda_device, tmp_path):
    """mma_common.cuh rounds to TF32 with integer operations (mma_tf32):
    on 2^22 random bit patterns (every finite float32 class: normals of
    every exponent, denormals, zeros, infinities), on the ties and on the
    largest finite values it equals the card's cvt.rna.tf32.f32 bit for
    bit, and the mirrors' tf32_round."""
    from paddle_tpu_torch.ops.kernels import _build

    lib = tmp_path / "libmma_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(_build.CSRC / "mma_probe.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).mma_tf32_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    bits = np.random.RandomState(0).randint(-2**31, 2**31, size=2**22, dtype=np.int64)
    ties = [(e << 23) | m for e in (1, 100, 127, 200, 254) for m in (0x1000, 0x3000, 0x7FF000)]
    edge = [0, 1, 0x1000, 0x1FFF, 0x7F7FFFFF, 0x7F7FF000, 0x7F800000, 0x00800000]
    signed = [x | 0x80000000 for x in ties + edge]
    bits = np.concatenate([bits, ties, edge, signed]).astype(np.int32)
    nan = ((bits & 0x7F800000) == 0x7F800000) & ((bits & 0x7FFFFF) != 0)
    bits = bits[~nan]
    x = torch.from_numpy(bits).view(torch.float32).to(cuda_device)
    out = torch.empty(2 * x.numel(), dtype=torch.int32, device=cuda_device)
    assert fn(x.data_ptr(), out.data_ptr(), x.numel(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    by_int, by_cvt = out.view(-1, 2).cpu().unbind(1)
    assert torch.equal(by_int, by_cvt)
    assert torch.equal(by_int, tf32_round(x.cpu()).view(torch.int32))
