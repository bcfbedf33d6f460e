"""The fused-block kernels (#9 fused_prologue_conv1x1, #10
conv1x1_with_stats) held against the JAX package's Pallas kernels.

On the CPU the plain versions of `paddle_tpu_torch/ops/kernels/
fused_block.py` are held against the Pallas kernels of
`tools/fused_block_pallas.py` in interpret mode, at M 2048 with the
tool's three (K, N), in bf16 and fp32, on the tool's inputs. The tool
reads its interpret flag from sys.argv when it is imported and at trace
time inside each jitted wrapper, so the test loads it by path and sets
`INTERPRET` before the first call.

Tolerances: y within one bf16 ulp of the Pallas value (2^-7 of its
magnitude, plus 1e-3) in bf16, and 1e-5 relative plus 1e-4 in fp32 (the
plain product is float64, the Pallas one fp32); the sums within 1e-4 of
the largest Pallas sum (fp32 block sums against float64). The twins,
which round differently, are checked loosely, as the tool checks its XLA
twins: the prologue within 5e-2 of the largest output, the sums within
2e-2.

The `gpu` tests hold the CUDA kernels against the plain versions on the
card, at the tool's shapes with M cut to 2048 and at a ragged M, and pin
that two launches of #10 give the same sums bit for bit
(`python -m pytest -m gpu --noconftest tests/test_torch_fused_block.py`).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.ops.kernels import fused_block as fb

ROOT = Path(__file__).resolve().parents[1]
M = 2048
CASES = [(name, k, n, dtype) for name, _, k, n in fb.SHAPES
         for dtype in ("bfloat16", "float32")]


def _case_id(case):
    return f"{case[0]}-{case[3]}"


@pytest.fixture(scope="module")
def tool():
    """tools/fused_block_pallas.py, loaded by path, in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "fused_block_pallas_interpret", ROOT / "tools" / "fused_block_pallas.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.INTERPRET = True
    return module


def _inputs(k, n, dtype, m=M, seed=0):
    """The tool's input recipe (tools/fused_block_pallas.py:main) in numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    res = (rng.randn(m, k) * 0.1).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    scale = (rng.rand(k) + 0.5).astype(np.float32)
    shift = (rng.randn(k) * 0.1).astype(np.float32)
    return x, scale, shift, res, w


def _port(arrays, dtype, device="cpu"):
    x, scale, shift, res, w = (torch.from_numpy(a).to(device) for a in arrays)
    tdt = getattr(torch, dtype)
    return x.to(tdt), scale, shift, res.to(tdt), w.to(tdt)


def _jax(arrays, dtype):
    import jax.numpy as jnp

    x, scale, shift, res, w = arrays
    jdt = jnp.dtype(dtype)
    return (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(shift),
            jnp.asarray(res, jdt), jnp.asarray(w, jdt))


def _as_torch(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_y(got, ref, dtype):
    """got within the dtype's tolerance of ref (both as float32)."""
    rtol = fb.Y_RTOL[getattr(torch, dtype)]
    atol = fb.Y_ATOL[getattr(torch, dtype)]
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), rtol=rtol, atol=atol)


def test_shapes_are_the_tools(tool):
    assert fb.SHAPES == tool.SHAPES


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prologue_plain_matches_pallas(case, tool):
    _, k, n, dtype = case
    arrays = _inputs(k, n, dtype)
    ref = _as_torch(tool.fused_prologue_conv1x1(*_jax(arrays, dtype)))
    launches = dict(LAUNCHES)
    got = fb.fused_prologue_conv1x1(*_port(arrays, dtype))
    assert LAUNCHES == launches  # a CPU tensor runs the plain version
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (M, n)
    _assert_y(got, ref, dtype)
    twin = fb.prologue_twin(*_port(arrays, dtype)).float()
    assert float((twin - ref).abs().max() / ref.abs().max()) < 5e-2


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_stats_plain_matches_pallas(case, tool):
    _, k, n, dtype = case
    arrays = _inputs(k, n, dtype)
    jx, _, _, _, jw = _jax(arrays, dtype)
    ry, rs1, rs2 = (_as_torch(a) for a in tool.conv1x1_with_stats(jx, jw))
    x, _, _, _, w = _port(arrays, dtype)
    y, s1, s2 = fb.conv1x1_with_stats(x, w)
    assert y.dtype == x.dtype and tuple(s1.shape) == tuple(s2.shape) == (1, n)
    assert s1.dtype == s2.dtype == torch.float32
    _assert_y(y, ry, dtype)
    for got, ref in ((s1, rs1), (s2, rs2)):
        assert fb.sum_err(got, ref) <= fb.SUM_RTOL
    _, t1, t2 = fb.stats_twin(x, w)
    for got, ref in ((t1, rs1), (t2, rs2)):
        assert fb.sum_err(got.reshape(1, -1), ref) < 2e-2


def test_ab_checks_pass_on_the_cpu():
    """The A/B's checks, plain against plain here, at M 1024 in both
    dtypes: every row within tolerance."""
    for dtype in (torch.bfloat16, torch.float32):
        shapes = [(name, 1024, k, n) for name, _, k, n in fb.SHAPES]
        rows = list(fb.ab(shapes, dtype, "cpu"))
        assert [r["shape"] for r in rows] == [s[0] for s in fb.SHAPES]
        assert all(r["prologue_err"] <= 0 and r["stats_y_err"] <= 0 for r in rows)


def test_y_err_is_one_bf16_ulp():
    ref = torch.tensor([4.0, 6.0, -8.0]).bfloat16()
    ulp_up = torch.tensor([4.03125, 6.03125, -8.0625]).bfloat16()  # one bf16 ulp each
    assert fb.y_err(ulp_up, ref) <= 0
    assert fb.y_err(torch.tensor([4.0625, 6.0, -8.0]).bfloat16(), ref) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_fused_block.py` on the card")
    return torch.device("cuda")


GPU_CASES = [(name, m, k, n, dtype) for name, _, k, n in fb.SHAPES
             for m in (M, 1000) for dtype in ("bfloat16", "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=lambda c: f"{c[0]}-m{c[1]}-{c[4]}")
def test_cuda_kernels_match_plain(case, cuda_device):
    _, m, k, n, dtype = case
    x, scale, shift, res, w = _port(_inputs(k, n, dtype, m=m), dtype, cuda_device)
    before = dict(LAUNCHES)
    y = fb.fused_prologue_conv1x1(x, scale, shift, res, w)
    ys, s1, s2 = fb.conv1x1_with_stats(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_prologue_conv1x1"] == before["fused_prologue_conv1x1"] + 1
    assert LAUNCHES["conv1x1_with_stats"] == before["conv1x1_with_stats"] + 1
    _assert_y(y.cpu(), fb.fused_prologue_conv1x1_plain(x, scale, shift, res, w).cpu(), dtype)
    ry, r1, r2 = fb.conv1x1_with_stats_plain(x, w)
    _assert_y(ys.cpu(), ry.cpu(), dtype)
    assert fb.sum_err(s1, r1) <= fb.SUM_RTOL and fb.sum_err(s2, r2) <= fb.SUM_RTOL


@pytest.mark.gpu
def test_cuda_stats_are_bitwise_repeatable(cuda_device):
    """No atomics: two launches give the same y and sums, bit for bit."""
    name, m, k, n = fb.SHAPES[0]
    x, _, _, _, w = fb.make_inputs(m, k, n, torch.bfloat16, cuda_device)
    first = fb.conv1x1_with_stats(x, w)
    second = fb.conv1x1_with_stats(x, w)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    x = torch.zeros(64, 32, device=cuda_device)
    with pytest.raises(ValueError):
        fb.conv1x1_with_stats(x, torch.zeros(16, 8, device=cuda_device))
    with pytest.raises(TypeError):
        fb.conv1x1_with_stats(x.half(), torch.zeros(32, 8, device=cuda_device).half())
    with pytest.raises(ValueError):
        fb.fused_prologue_conv1x1(x, torch.ones(32, device=cuda_device),
                                  torch.zeros(16, device=cuda_device), x,
                                  torch.zeros(32, 8, device=cuda_device))
