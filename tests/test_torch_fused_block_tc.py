"""The tensor-core fused-block kernels (csrc/fused_block.cu: #9
fused_prologue_conv1x1, #10 conv1x1_with_stats), mirrored on the CPU by
`fused_block_mirror`, against the plain versions (float64 inside) and
against the Pallas kernels of `tools/fused_block_pallas.py` in interpret
mode.

The mirror takes its block geometry from `fused_block_plan`, as the
wrapper does. It computes z as the kernel does (each operation rounded in
float32, then to x's dtype), walks K in the kernel's slices (32 bf16, 16
fp32) and adds each slice's product to a float32 accumulator: bf16
products exact, fp32 products as 3xTF32 (x = hi + lo, hi = tf32(x), lo =
tf32(x - hi); hi*hi + hi*lo + lo*hi), each slice's products summed in
float64 and rounded once, as the kernel's fresh accumulator of a slice is
added to the running one. #10's sums follow the kernel's order in float32:
a thread's rows of a column (row g, g + 8, g + 16, ... of its warp's
rows), the xor tree over the warp's 8 row groups, the block's warps in
order, one partial row a block; then the second launch: split s of 128
adds the partial rows s, s + 128, ... in order, and a fixed tree joins
the splits.

Tolerances are the A/B's (`fused_block.py`: Y_RTOL, Y_ATOL, SUM_RTOL):
y within one bf16 ulp in bf16, 1e-5 |y| + 1e-4 in fp32; the sums within
1e-4 of the largest. Single-pass TF32 misses the fp32 tolerance at stage
4's K 1024, which is why the kernel splits.

The `gpu`-marked tests hold the kernels against the plain versions and
the mirror on the card: the sum launch against the mirror's reduction of
the kernel's own partial rows bit for bit; in fp32, where y is the
accumulator, the block partials against the mirror's order over y bit for
bit too. The card has no JAX, so run
`python -m pytest -m gpu --noconftest tests/test_torch_fused_block_tc.py`
there."""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import LAUNCHES, device_kernels
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_block as fb
from paddle_tpu_torch.ops.kernels.flash_attention import tf32_round
from test_torch_fused_block import _as_torch, _inputs, _jax, _port, tool  # noqa: F401

M_CASES = (2048, 1000)  # a whole number of blocks, and a ragged last block
CASES = [(name, m, k, n, dtype) for name, _, k, n in fb.SHAPES for m in M_CASES
         for dtype in ("bfloat16", "float32")]
RED_SPLITS = 128  # the sum launch's splits of a column's partial rows


def _id(c):
    return "-".join(str(v) for v in c)


@pytest.fixture(autouse=True)
def steady_torch_cpu():
    """The mirror's float32 sums with one intra-op thread and IEEE
    denormals, whatever the tests before it in the process left set."""
    threads = torch.get_num_threads()
    torch.set_flush_denormal(False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seq_sum(t):
    """t[0] + t[1] + ... from 0, one float32 addition at a time."""
    s = torch.zeros_like(t[0])
    for row in t:
        s = s + row
    return s


def _slice_product(a, b, single_pass=False):
    """a @ b for one K-slice as the tensor cores make it, in float32."""
    if a.dtype == torch.bfloat16:
        return (a.double() @ b.double()).float()
    ah, bh = tf32_round(a), tf32_round(b)
    if single_pass:
        return (ah.double() @ bh.double()).float()
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (ah.double() @ bh.double() + ah.double() @ bl.double()
            + al.double() @ bh.double()).float()


def block_partials(acc, geo):
    """#10's per-block partial rows of the float32 accumulator [M, N] in the
    kernel's order -> [2, parts, N] (sums, sums of squares)."""
    m, n = acc.shape
    parts = -(-m // geo.bm)
    warps_m, mt = geo.bm // geo.wm, geo.wm // 16
    a = torch.cat([acc, acc.new_zeros(parts * geo.bm - m, n)])  # zero rows past M
    # block row r = warp row w * wm + 16 mi + 8 h + g -> [part, w, g, (mi, h), n]
    a = a.view(parts, warps_m, mt, 2, 8, n).permute(0, 1, 4, 2, 3, 5)
    a = a.reshape(parts, warps_m, 8, 2 * mt, n)
    out = []
    for t in (a, a * a):
        s = _seq_sum(t.movedim(3, 0))  # a thread's rows, in order
        for _ in range(2):  # lanes xor 4, then xor 8: neighbouring row groups
            s = s[:, :, 0::2] + s[:, :, 1::2]
        s = s[:, :, 0] + s[:, :, 1]  # xor 16
        out.append(_seq_sum(s.movedim(1, 0)))  # the block's warps in order
    return torch.stack(out)


def reduce_partials(part):
    """The sum launch over [2, parts, N] -> [2, 1, N]: split s adds rows s,
    s + 128, ... in order from 0, then the tree joins splits s and s + h
    for h = 64, 32, ..., 1."""
    two, parts, n = part.shape
    p = torch.cat([part, part.new_zeros(two, -parts % RED_SPLITS, n)], dim=1)
    a = _seq_sum(p.view(two, -1, RED_SPLITS, n).movedim(1, 0))
    h = RED_SPLITS // 2
    while h:
        a = a[:, :h] + a[:, h:2 * h]
        h //= 2
    return a


def fused_block_mirror(x, w, scale=None, shift=None, res=None, single_pass=False):
    """csrc/fused_block.cu's block math on the CPU. With scale, shift and
    res (#9) -> y; without (#10) -> (y, sum [1, N], sumsq [1, N], part [2,
    parts, N])."""
    m, k = x.shape
    geo, _, parts = fb.fused_block_plan(m, w.shape[1], x.dtype)
    z = x
    if scale is not None:
        z = x.float() * scale + shift  # two roundings, no contraction
        z = torch.clamp_min(z + res.float(), 0.0).to(x.dtype)
    acc = torch.zeros(m, w.shape[1])
    for k0 in range(0, k, geo.bk):
        acc = acc + _slice_product(z[:, k0:k0 + geo.bk], w[k0:k0 + geo.bk], single_pass)
    y = acc.to(x.dtype)
    if scale is not None:
        return y
    part = block_partials(acc, geo)
    assert part.shape[1] == parts
    sums = reduce_partials(part)
    return y, sums[0], sums[1], part


def _assert_y(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert fb.y_err(got, ref) <= 0, fb.y_err(got, ref)


def _assert_sums(got, ref):
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape) and g.dtype == torch.float32
        assert fb.sum_err(g, r) <= fb.SUM_RTOL, fb.sum_err(g, r)


# ---------------------------------------------------------------------------
# the geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, dtype, want", [
    (64, torch.bfloat16, fb.FbGeometry(32, 1, 256, 64, 64)),
    (128, torch.bfloat16, fb.FbGeometry(32, 2, 128, 128, 64)),
    (256, torch.bfloat16, fb.FbGeometry(64, 4, 128, 256, 64)),
    (64, torch.float32, fb.FbGeometry(32, 1, 256, 64, 32)),
    (128, torch.float32, fb.FbGeometry(32, 2, 128, 128, 32)),
    (256, torch.float32, fb.FbGeometry(32, 4, 64, 256, 32)),
    (8, torch.bfloat16, fb.FbGeometry(32, 1, 256, 64, 64)),
    (300, torch.float32, fb.FbGeometry(32, 4, 64, 256, 32)),
], ids=lambda v: str(v).replace("torch.", ""))
def test_geometry(n, dtype, want):
    """The fewest warp columns that cover N (all of it up to 256), 128
    fp32 accumulators a thread at most (64 with 3xTF32's fresh ones), K in
    128-byte slices."""
    geo = fb.fused_block_geometry(n, dtype)
    assert geo == want
    assert geo.bm * geo.nb == 8 * geo.wm * 64  # 8 warps, each wm x 64
    assert geo.wm * 64 // 32 <= (64 if dtype == torch.float32 else 128)


@pytest.mark.parametrize("m, n", [(802816, 64), (200704, 128), (50176, 256), (1000, 256),
                                  (1, 8), (300, 600)])
def test_plan(m, n):
    for dtype in (torch.bfloat16, torch.float32):
        geo, grid, parts = fb.fused_block_plan(m, n, dtype)
        assert grid == (-(-m // geo.bm), -(-n // geo.nb)) and parts == grid[0]
        assert (grid[1] == 1) == (n <= 256)  # x read once up to 256 columns


def test_source_builds_the_wrappers_geometries():
    """csrc/fused_block.cu builds each (wm, warps_n) that
    fused_block_geometry picks for each type, and no other, and walks K in
    the slices the wrapper and the mirror take."""
    src = (_build.CSRC / "fused_block.cu").read_text()
    body = src[src.index("if constexpr (sizeof(T) == 2) {"):src.index("#undef FB_CASE")]
    for dtype, block in zip((torch.bfloat16, torch.float32), body.split("} else {")):
        built = {tuple(map(int, c)) for c in re.findall(r"FB_CASE\((\d+), (\d+)\)", block)}
        picked = {(g.wm, g.warps_n) for g in (fb.fused_block_geometry(n, dtype)
                                              for n in (64, 128, 256))}
        assert built == picked
    assert f"#define FB_SLICE {fb._SLICE_BYTES} " in src


@pytest.mark.parametrize("m, n, dtype", [(1000, 64, torch.bfloat16), (2048, 256, torch.float32),
                                         (300, 600, torch.bfloat16), (1, 8, torch.float32)],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_wrapper_and_mirror_take_one_geometry(m, n, dtype, monkeypatch):
    """The wrapper passes the plan's (wm, warps_n, parts) to the kernel and
    sizes its [2, parts, N] scratch from it; the mirror makes as many
    partial rows. The library is stubbed to record its arguments."""
    seen = {}

    def stats(*args):
        seen["args"] = args
        return 0

    monkeypatch.setattr(fb, "_lib", lambda: types.SimpleNamespace(conv1x1_with_stats=stats))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(LAUNCHES, "conv1x1_with_stats", 0)
    k = 40
    x = torch.zeros(m, k, dtype=dtype)
    w = torch.zeros(k, n, dtype=dtype)
    y, s1, s2, part = fb.conv1x1_with_stats_partials(x, w)
    geo, _, parts = fb.fused_block_plan(m, n, dtype)
    assert seen["args"][8:14] == (m, k, n, geo.wm, geo.warps_n, parts)
    assert tuple(part.shape) == (2, parts, n) and tuple(y.shape) == (m, n)
    assert tuple(s1.shape) == tuple(s2.shape) == (1, n)
    assert fused_block_mirror(x, w)[3].shape == part.shape


# ---------------------------------------------------------------------------
# the mirror against the plain versions and the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_prologue_mirror_matches_plain(case):
    _, m, k, n, dtype = case
    args = _port(_inputs(k, n, dtype, m=m), dtype)
    _assert_y(fused_block_mirror(*args[:1], args[4], *args[1:4]),
              fb.fused_prologue_conv1x1_plain(*args))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_stats_mirror_matches_plain(case):
    _, m, k, n, dtype = case
    x, _, _, _, w = _port(_inputs(k, n, dtype, m=m), dtype)
    y, s1, s2, part = fused_block_mirror(x, w)
    ry, r1, r2 = fb.conv1x1_with_stats_plain(x, w)
    _assert_y(y, ry)
    _assert_sums((s1, s2), (r1, r2))
    assert tuple(part.shape) == (2, fb.fused_block_plan(m, n, x.dtype)[2], n)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mirror_matches_pallas_kernels(case, tool):  # noqa: F811
    """The tool's kernels in interpret mode, one block of 1000 rows for
    the ragged M (its grid takes M // block_m blocks)."""
    _, m, k, n, dtype = case
    arrays = _inputs(k, n, dtype, m=m)
    block_m = 512 if m % 512 == 0 else m
    jx, js, jh, jr, jw = _jax(arrays, dtype)
    x, scale, shift, res, w = _port(arrays, dtype)
    ref = _as_torch(tool.fused_prologue_conv1x1(jx, js, jh, jr, jw, block_m=block_m))
    _assert_y(fused_block_mirror(x, w, scale, shift, res), ref.to(x.dtype))  # exact cast
    ry, r1, r2 = (_as_torch(a) for a in tool.conv1x1_with_stats(jx, jw, block_m=block_m))
    y, s1, s2, _ = fused_block_mirror(x, w)
    _assert_y(y, ry.to(x.dtype))
    _assert_sums((s1, s2), (r1, r2))


def test_single_pass_tf32_misses_the_fp32_tolerance():
    """At stage 4's K 1024 one TF32 product a slice misses fp32's 1e-5 |y| +
    1e-4 by far; 3xTF32 keeps well inside it."""
    _, _, k, n = fb.SHAPES[-1]
    args = _port(_inputs(k, n, "float32", m=512), "float32")
    ref = fb.fused_prologue_conv1x1_plain(*args)
    mirror_args = (args[0], args[4], *args[1:4])
    three = fb.y_err(fused_block_mirror(*mirror_args), ref)
    one = fb.y_err(fused_block_mirror(*mirror_args, single_pass=True), ref)
    margin = fb.Y_ATOL[torch.float32]
    assert three < -0.5 * margin  # within half of the tolerance
    assert one > 2 * margin  # beyond it by more than twice atol


def test_partials_and_sum_launch_keep_their_order():
    """The mirror's reduction is the sum of the partial rows, and the block
    partials the column sums of their rows, both to float32 rounding; and
    the order is the kernel's: values chosen so that another order gives
    other bits."""
    geo = fb.fused_block_geometry(64, torch.bfloat16)
    rs = np.random.RandomState(0)
    acc = torch.from_numpy(rs.randn(1000, 64).astype(np.float32) * 10)
    part = block_partials(acc, geo)
    blocks = torch.cat([acc, acc.new_zeros(-1000 % geo.bm, 64)]).view(-1, geo.bm, 64).double()
    np.testing.assert_allclose(part[0].numpy(), blocks.sum(1).numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(part[1].numpy(), (blocks * blocks).sum(1).numpy(), rtol=1e-5)
    big = torch.from_numpy(rs.randn(2, 300, 64).astype(np.float32) * 1e4)
    sums = reduce_partials(big)
    np.testing.assert_allclose(sums[:, 0].numpy(), big.double().sum(1).numpy(), rtol=1e-5,
                               atol=1.0)
    # 2^24 + 1 rounds to 2^24: rows added in index order lose row 1's 1,
    # and so do the splits joined in split order; the kernel's order keeps
    # it: rows 0 and 128 cancel in split 0, rows 0 and 64 at the tree's
    # first level, before split 1 joins at its last
    for other in (128, 64):
        p = torch.zeros(2, 300, 1)
        p[:, 0], p[:, 1], p[:, other] = 2.0**24, 1.0, -(2.0**24)
        assert float(reduce_partials(p)[0, 0, 0]) == 1.0
        assert float(_seq_sum(p[0])) == 0.0


def test_cpu_tensors_run_the_plain_versions():
    x, scale, shift, res, w = _port(_inputs(64, 64, "float32", m=100), "float32")
    launches = dict(LAUNCHES)
    assert torch.equal(fb.fused_prologue_conv1x1(x, scale, shift, res, w),
                       fb.fused_prologue_conv1x1_plain(x, scale, shift, res, w))
    for g, r in zip(fb.conv1x1_with_stats(x, w), fb.conv1x1_with_stats_plain(x, w)):
        assert torch.equal(g, r)
    assert LAUNCHES == launches


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_fused_block_tc.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the tool's shapes at M 2048 and 1000; a partial last block at every
# geometry (M 4097); K and N off the 16-byte path (scalar loads), N past
# 256 (256-column blocks on the grid), one row
GPU_SHAPES = ([(m, k, n) for _, _, k, n in fb.SHAPES for m in M_CASES]
              + [(4097, 256, 64), (4097, 512, 128), (4097, 1024, 256), (300, 100, 40),
                 (77, 22, 10), (513, 96, 300), (513, 96, 304), (1, 64, 64)])
GPU_CASES = [(m, k, n, dtype) for m, k, n in GPU_SHAPES for dtype in ("bfloat16", "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=_id)
def test_cuda_kernels_match_plain_and_mirror(case, cuda_device):
    m, k, n, dtype = case
    x, scale, shift, res, w = _port(_inputs(k, n, dtype, m=m), dtype, cuda_device)
    before = dict(LAUNCHES)
    y = fb.fused_prologue_conv1x1(x, scale, shift, res, w)
    ys, s1, s2, part = fb.conv1x1_with_stats_partials(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_prologue_conv1x1"] == before["fused_prologue_conv1x1"] + 1
    assert LAUNCHES["conv1x1_with_stats"] == before["conv1x1_with_stats"] + 1
    assert tuple(part.shape) == (2, fb.fused_block_plan(m, n, x.dtype)[2], n)
    cpu = [t.cpu() for t in (x, scale, shift, res, w)]
    _assert_y(y.cpu(), fb.fused_prologue_conv1x1_plain(*cpu))
    ry, r1, r2 = fb.conv1x1_with_stats_plain(cpu[0], cpu[4])
    _assert_y(ys.cpu(), ry)
    _assert_sums((s1.cpu(), s2.cpu()), (r1, r2))
    # the mirror's y within the same tolerance of the kernel's
    _assert_y(y.cpu(), fused_block_mirror(cpu[0], cpu[4], *cpu[1:4]))
    # the sum launch, in the mirror's order over the kernel's own partials
    sums = reduce_partials(part.cpu())
    assert torch.equal(sums[0], s1.cpu()) and torch.equal(sums[1], s2.cpu())
    if dtype == "float32":  # y is the accumulator: the block partials bit for bit too
        assert torch.equal(block_partials(ys.cpu(), fb.fused_block_geometry(n, x.dtype)),
                           part.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_stats_repeat_bit_for_bit(dtype, cuda_device):
    """No float atomics: two launches give the same y, partials and sums."""
    _, m, k, n = fb.SHAPES[0]
    x, _, _, _, w = fb.make_inputs(m, k, n, getattr(torch, dtype), cuda_device)
    first = fb.conv1x1_with_stats_partials(x, w)
    second = fb.conv1x1_with_stats_partials(x, w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_launches_on_the_device(dtype, cuda_device):
    """#9 is one GEMM kernel a call, #10 one GEMM kernel and one sum
    kernel: no torch op around them."""
    x, scale, shift, res, w = fb.make_inputs(4096, 512, 128, getattr(torch, dtype), cuda_device)
    pro, _ = device_kernels(lambda: fb.fused_prologue_conv1x1(x, scale, shift, res, w))
    assert len(pro) == 1 and "fused_block_gemm_kernel" in next(iter(pro)), pro
    stats, _ = device_kernels(lambda: fb.conv1x1_with_stats(x, w))
    assert sorted(stats.values()) == [1, 1], stats
    assert any("fused_block_gemm_kernel" in k for k in stats)
    assert any("fused_block_stats_reduce_kernel" in k for k in stats)
