"""The one-launch LayerNorm backward (csrc/layer_norm_bwd.cu), mirrored on
the CPU by `ln_bwd_mirror`, against the plain version (float64 inside) and
against the Pallas `ln_bwd` in interpret mode.

The mirror sums in float32 in the kernel's order: each lane over its
columns (vectors v = 32 j + lane of `vec` columns, j ascending), the
xor-shuffle tree over the warp's lanes, each warp's dscale / dbias terms
over its rows (warp w of the grid's blocks x warps takes rows w, w + T,
...), the block's warps in warp order, then for each column the S warps
that take its tile, warp s over the blocks' partial rows s, s + S, ...,
and their sums in warp order. The card contracts some products and sums into
FMAs, the mirror does not; the tolerances below hold both.

Tolerances against the plain version and the Pallas kernel: dx at
`_tol(dtype)` (fp32 atol 1e-5 / rtol 1e-5, summation order only; bf16
atol 2e-2, about one bf16 ulp of these gradients; fp16 one fp16 ulp of
dx's largest magnitude); dscale / dbias at atol 1e-4 fp32 and fp16 and
2e-3 bf16 (with rtol 1e-5), sums of up to 4097 fp32 terms.

The `gpu`-marked tests hold the CUDA kernel against the plain version
and the mirror on the card, check that two launches agree bit for bit,
that a call is one kernel on the device and nothing else, and that
tensors not 16-byte aligned take the scalar loads. The card has no JAX,
so run `python -m pytest -m gpu --noconftest tests/test_torch_ln_bwd_tc.py`
there."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import LAUNCHES, device_kernels
from paddle_tpu_torch.ops.kernels.layer_norm import (
    LnGeometry,
    ln_bwd,
    ln_bwd_geometry,
    ln_bwd_plain,
    ln_bwd_plan,
)
from test_torch_training_kernels import LN_CASES, _ln_inputs, _tol, _torch

# (n, k): the shapes of LN_CASES; one row; a ragged n past 4096; k 33 and
# 100 (not a multiple of a bf16 vector: the scalar loads); 1024 (the
# register path's widest); 4096 and 6144 (the general path)
SHAPES = sorted({(n, k) for n, k, _ in LN_CASES}) + [
    (1, 768), (4097, 768), (64, 33), (64, 100), (256, 1024), (64, 4096), (32, 6144)]
CASES = [(n, k, dtype) for n, k in SHAPES for dtype in ("float32", "bfloat16")] + [
    (512, 768, "float16"), (64, 100, "float16"), (64, 4096, "float16")]
# fp16 keeps the unrounded dscale terms, as fp32 does
SUM_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=2e-3, rtol=1e-5),
           "float16": dict(atol=1e-4, rtol=1e-5)}
H100_SMS = 132  # the mirror's grid as on an H100 SXM holding one block an SM


def _id(c):
    return "-".join(str(x) for x in c)


@pytest.fixture(autouse=True)
def steady_torch_cpu():
    """The mirror's float32 math with one intra-op thread and IEEE
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


def _rows_of(t, groups):
    """[rows, ...] -> [ceil(rows / groups), groups, ...]: row r at
    [r // groups, r % groups], the missing rows zero (adding 0 is exact)."""
    pad = -t.shape[0] % groups
    t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    return t.view(-1, groups, *t.shape[1:])


def ln_bwd_mirror(x2, dy2, mean, rstd, scale, blocks=None, aligned=True):
    """csrc/layer_norm_bwd.cu's sums in its order, in float32 on the CPU ->
    (dx in x2's dtype, dscale, dbias). `blocks`: the grid (by default one
    block for every `warps` rows, as on a card with room for them)."""
    n, k = x2.shape
    geo = ln_bwd_geometry(k, x2.dtype, aligned)
    warps = geo.warps
    blocks = blocks or -(-n // warps)
    x, dy = x2.float(), dy2.float()
    mu, rs = mean.float()[:, None], rstd.float()[:, None]
    nrm = (x - mu) * rs
    dyg = dy * scale.float()[None, :]
    # lane l's columns in its order; k stands for a column it does not have
    nv = k // geo.vec
    per_lane = -(-nv // 32)
    cols = torch.full((32, per_lane * geo.vec), k, dtype=torch.long)
    for lane in range(32):
        for j in range(per_lane):
            v = 32 * j + lane
            if v < nv:
                cols[lane, j * geo.vec:(j + 1) * geo.vec] = torch.arange(v * geo.vec,
                                                                        (v + 1) * geo.vec)

    def lane_sums(t):  # [n, k] -> [n, 32]
        t = torch.cat([t, t.new_zeros(n, 1)], dim=1)[:, cols]
        return _seq_sum(t.permute(2, 0, 1))

    def warp_sum(s):  # the xor-shuffle tree: every lane ends with the same bits
        idx = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, idx ^ o]
        return s[:, :1]

    m1 = warp_sum(lane_sums(dyg)) / k
    m2 = warp_sum(lane_sums(dyg * nrm)) / k
    dx = rs * (dyg - m1 - nrm * m2)
    terms = dy * nrm
    if x2.dtype == torch.bfloat16:  # bf16(dy) * bf16(nrm), exact in float32
        terms = dy * nrm.to(torch.bfloat16).float()
    cols2 = torch.cat([terms, dy], dim=1)  # [n, 2k]: dscale then dbias terms
    # warp w of the grid sums rows w, w + T, ... from 0
    acc = _seq_sum(_rows_of(cols2, blocks * warps))
    # the block's warps in warp order
    part = _seq_sum(acc.view(blocks, warps, 2 * k).transpose(0, 1))
    # the S warps of a 32-column tile, S = warps / P where a block takes P
    # of its tiles at once: warp s over part rows s, s + S, ...; the S sums
    # in order
    tiles = -(-2 * k // 32)
    per_block = -(-tiles // blocks)
    p = 1
    while p < warps and p < per_block:
        p *= 2
    out = _seq_sum(_seq_sum(_rows_of(part, warps // p)))
    return dx.to(x2.dtype), out[:k], out[k:]


def _inputs(n, k, dtype, device="cpu"):
    x, dy, mean, rstd, scale = _ln_inputs(n, k)
    return (*_torch((x, dy), getattr(torch, dtype), device),
            *_torch((mean, rstd, scale), torch.float32, device))


def _assert_close(got, ref, dtype, sums_tol=None):
    tols = (_tol(dtype, ref[0].float().cpu().numpy()), sums_tol or SUM_TOL[dtype],
            sums_tol or SUM_TOL[dtype])
    for g, r, tol in zip(got, ref, tols):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.float().cpu().numpy(), r.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("k, dtype, aligned, want", [
    (768, torch.float32, True, LnGeometry(4, 6, 8)),
    (768, torch.bfloat16, True, LnGeometry(8, 3, 8)),
    (1024, torch.float32, True, LnGeometry(4, 8, 8)),
    (1024, torch.bfloat16, True, LnGeometry(8, 4, 8)),
    (100, torch.float32, True, LnGeometry(4, 1, 8)),
    (100, torch.bfloat16, True, LnGeometry(1, 0, 8)),
    (33, torch.float32, True, LnGeometry(1, 0, 8)),
    (768, torch.float32, False, LnGeometry(1, 0, 8)),
    (4096, torch.float32, True, LnGeometry(4, 0, 4)),
    (6144, torch.bfloat16, True, LnGeometry(8, 0, 4)),
    (12288, torch.float32, True, LnGeometry(4, 0, 2)),
    (12288, torch.bfloat16, False, LnGeometry(1, 0, 2)),
], ids=lambda v: str(v).replace("torch.", ""))
def test_geometry(k, dtype, aligned, want):
    """The register path up to k 1024 with 16-byte loads; every other k
    on the general path, its warps halved until their [warps, 2k] fp32
    partials fit 200 KB of shared memory."""
    geo = ln_bwd_geometry(k, dtype, aligned)
    assert geo == want
    assert ("registers" in geo.path) == (geo.vpl > 0)


@pytest.mark.parametrize("k", [0, 12289])
def test_geometry_refuses_widths_past_the_limit(k):
    with pytest.raises(ValueError, match="row width"):
        ln_bwd_geometry(k, torch.float32)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mirror_matches_plain(case):
    n, k, dtype = case
    args = _inputs(n, k, dtype)
    blocks = min(-(-n // ln_bwd_geometry(k, args[0].dtype).warps), H100_SMS)
    got = ln_bwd_mirror(*args, blocks=blocks)
    assert got[0].dtype == args[0].dtype and got[1].dtype == got[2].dtype == torch.float32
    _assert_close(got, ln_bwd_plain(*args), dtype)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mirror_matches_pallas_kernel(case, monkeypatch):
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
        # (nn_ops.py:598-605): dy and the normalized value rounded to bf16
        # before their products; the Pallas body keeps them in fp32
        def bf(a):
            return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

        nrm = (bf(x) - mean[:, None]) * rstd[:, None]
        ref[1] = (bf(dy) * bf(nrm)).sum(axis=0, dtype=np.float32)
    got = ln_bwd_mirror(*_inputs(n, k, dtype))
    _assert_close(got, [torch.from_numpy(np.array(r)) for r in ref], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mirror_unaligned_scalar_loads(dtype):
    """Tensors that do not start on 16 bytes: the kernel's scalar loads,
    whose lanes take one column each."""
    args = _inputs(300, 768, dtype)
    assert ln_bwd_geometry(768, args[0].dtype, aligned=False).vec == 1
    got = ln_bwd_mirror(*args, aligned=False, blocks=19)
    _assert_close(got, ln_bwd_plain(*args), dtype)


def test_cpu_tensors_run_the_plain_version():
    args = _inputs(64, 100, "float32")
    launches = dict(LAUNCHES)
    got = ln_bwd(*args)
    assert LAUNCHES == launches
    for g, r in zip(got, ln_bwd_plain(*args)):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_ln_bwd_tc.py` on the card")
    return torch.device("cuda")


def _unaligned(t):
    """A copy of t whose storage starts one element past 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cuda_ln_bwd_matches_plain_and_mirror(case, cuda_device):
    n, k, dtype = case
    args = _inputs(n, k, dtype, cuda_device)
    before = LAUNCHES["layer_norm_bwd"]
    got = ln_bwd(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_norm_bwd"] == before + 1
    _assert_close(got, ln_bwd_plain(*args), dtype)
    # the kernel's order of sums, up to its FMAs
    blocks = ln_bwd_plan(*args[:2], args[4])[1]
    mirror = ln_bwd_mirror(*(t.cpu() for t in args), blocks=blocks)
    _assert_close(got, mirror, dtype, sums_tol=dict(atol=1e-5, rtol=1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n, k", [(1024, 768), (4097, 768), (1100, 128), (64, 33),
                                  (64, 4096), (32, 6144)])
def test_cuda_ln_bwd_is_deterministic(n, k, dtype, cuda_device):
    """No float atomics: two launches on the same inputs, bit for bit."""
    args = _inputs(n, k, dtype, cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(ln_bwd(*args), ln_bwd(*args)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, k", [(1024, 768), (160, 768), (64, 4096)])
def test_cuda_ln_bwd_is_one_kernel(n, k, dtype, cuda_device):
    """A call is one launch of the kernel and nothing else on the device:
    no torch reduction after it."""
    args = _inputs(n, k, dtype, cuda_device)
    kernels, _ = device_kernels(lambda: ln_bwd(*args))
    assert len(kernels) == 1, kernels
    (name, count), = kernels.items()
    assert "layer_norm_bwd" in name and count == 1, kernels


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_ln_bwd_unaligned_inputs(dtype, cuda_device):
    """x and dy whose storage offset leaves them off 16 bytes take the
    scalar loads, on the kernel and not the plain version."""
    x, dy, mean, rstd, scale = _inputs(1024, 768, dtype, cuda_device)
    x, dy = _unaligned(x), _unaligned(dy)
    assert x.data_ptr() % 16 != 0
    geo, _ = ln_bwd_plan(x, dy, scale)
    assert geo.vec == 1 and geo.vpl == 0
    before = LAUNCHES["layer_norm_bwd"]
    got = ln_bwd(x, dy, mean, rstd, scale)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_norm_bwd"] == before + 1
    _assert_close(got, ln_bwd_plain(x, dy, mean, rstd, scale), dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, ln_bwd(x, dy, mean, rstd, scale)))
