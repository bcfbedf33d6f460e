"""The ResNet fused-block 1x1 convolutions (csrc/fused_block.cu): kernel
wrappers, their plain PyTorch versions, unfused torch twins, and the A/B
that drives them.

Counterpart of `tools/fused_block_pallas.py`. That tool A/Bs two Pallas
kernels against their XLA formulation at the ResNet-50 b256 bottleneck
1x1-conv shapes (1x1 convs are plain matmuls over M = b*h*w rows):

- `fused_prologue_conv1x1`: y = relu(x * scale + shift + res) @ w, the
  batch-norm apply, residual and relu done in the product's input read;
- `conv1x1_with_stats`: y = x @ w plus per-channel sum(y) and sum(y^2),
  the next batch norm's statistics taken while y is on chip.

Nothing on the ResNet training path calls them, in the JAX package or
here: the model computes its convolutions with conv2d and its batch norm
with batch_norm. They run in the A/B (`ab`), which `chip_smoke.py` drives
on the card.

The kernels (csrc/fused_block.cu) are one tensor-core GEMM template: a
block of 8 warps owns `bm` rows of y and all of its columns (N <= 256;
wider N in 256-column blocks on the grid), so each row of x and res is
read once; it walks K in 128-byte slices of a row through a ring of two
in shared memory with w's slice beside x's (and, for #9, res's: it
writes z = relu(x * scale + shift + res) in place of x), multiplies with
mma.sync (bf16; fp32 as 3xTF32) and, for #10, writes per-block partial
column sums that a second launch sums in a fixed order.
`fused_block_geometry` picks the block's shape from N and the dtype; the
wrapper sizes the partial-sum scratch from it, and the CPU mirror of the
kernel's order of sums (tests/test_torch_fused_block_tc.py) takes the
same geometry.

The `*_plain` functions are the Pallas bodies' function, with the
products and sums in float64; `prologue_twin` and `stats_twin` are the
counterparts of `xla_prologue` and `xla_stats`: unfused torch elementwise
ops and `torch.matmul`. The twins are the library yardstick of the A/B
and round differently (`stats_twin` sums the rounded y), so they are not
the gold."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import LAUNCHES, fp16_note
from ._build import load

__all__ = [
    "SHAPES",
    "FbGeometry",
    "fused_block_geometry",
    "fused_block_plan",
    "fused_prologue_conv1x1",
    "fused_prologue_conv1x1_plain",
    "conv1x1_with_stats",
    "conv1x1_with_stats_partials",
    "conv1x1_with_stats_plain",
    "prologue_twin",
    "stats_twin",
    "make_inputs",
    "ab",
]

# the top bottleneck-block 1x1 shapes of ResNet-50 at b 256, NHWC:
# (name, M = b*h*w, K, N)
SHAPES = [
    ("stage2_reduce", 256 * 56 * 56, 256, 64),
    ("stage3_reduce", 256 * 28 * 28, 512, 128),
    ("stage4_reduce", 256 * 14 * 14, 1024, 256),
]


def fused_prologue_conv1x1_plain(x, scale, shift, res, w):
    """relu(x * scale + shift + res) in fp32, one rounding per operation as
    the Pallas body has it, rounded to x's dtype; the product in float64;
    y in x's dtype (the function of `_prologue_kernel`)."""
    z = x.float() * scale.float() + shift.float()
    z = torch.clamp_min(z + res.float(), 0.0).to(x.dtype)
    return (z.double() @ w.double()).to(x.dtype)


def conv1x1_with_stats_plain(x, w):
    """(y in x's dtype, sum(y) [1, N], sum(y^2) [1, N] float32), the product
    and the sums in float64 (the function of `_stats_kernel`)."""
    y = x.double() @ w.double()
    return (y.to(x.dtype), y.sum(0, keepdim=True).float(),
            (y * y).sum(0, keepdim=True).float())


def prologue_twin(x, scale, shift, res, w):
    """`xla_prologue`: the elementwise chain, then torch.matmul."""
    z = torch.relu(x.float() * scale + shift + res.float()).to(x.dtype)
    return torch.matmul(z, w)


def stats_twin(x, w):
    """`xla_stats`: torch.matmul, then the sums of the rounded y."""
    y = torch.matmul(x, w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


class FbGeometry(NamedTuple):
    """A block of csrc/fused_block.cu: 8 warps as (8 / warps_n) rows of
    warps by warps_n columns, each warp a wm x 64 tile of y, walking K in
    slices of bk elements (128 bytes of a row, FB_SLICE)."""
    wm: int  # rows a warp
    warps_n: int  # warps across the columns
    bm: int  # rows a block
    nb: int  # columns a block
    bk: int  # K-slice depth (elements)


# wm by dtype and warps_n: a warp's fp32 accumulators (wm x 64 / 32 lanes)
# and, for fp32, the fresh accumulator of each 3xTF32 slice beside them,
# kept under 255 registers without spills; the geometries
# csrc/fused_block.cu builds
_WM = {torch.bfloat16: {1: 32, 2: 32, 4: 64}, torch.float32: {1: 32, 2: 32, 4: 32}}
_SLICE_BYTES = 128  # FB_SLICE


def fused_block_geometry(n, dtype):
    """The block shape of both kernels for N columns of `dtype` (float32 or
    bfloat16): the fewest warp columns that cover N up to 256 (wider N
    takes 256-column blocks on the grid), and wm from `_WM`."""
    warps_n = 1 if n <= 64 else 2 if n <= 128 else 4
    wm = _WM[dtype][warps_n]
    return FbGeometry(wm, warps_n, (8 // warps_n) * wm, 64 * warps_n,
                      _SLICE_BYTES // torch.empty((), dtype=dtype).element_size())


def fused_block_plan(m, n, dtype):
    """(geometry, grid (row blocks, column blocks), parts): `parts` is the
    number of #10's partial-sum rows, one per row block."""
    geo = fused_block_geometry(n, dtype)
    grid = (-(-m // geo.bm), -(-n // geo.nb))
    return geo, grid, grid[0]


@functools.cache
def _lib():
    lib = load("fused_block")
    lib.fused_prologue_conv1x1.restype = ctypes.c_int
    lib.fused_prologue_conv1x1.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.conv1x1_with_stats.restype = ctypes.c_int
    lib.conv1x1_with_stats.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return lib


def _check(name, x, w, mats=(), vecs=()):
    """x [M, K] and w [K, N] float32 or bf16 on one card, contiguous; each
    of `mats` like x, each of `vecs` a float32 [K]."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x [M, K] and w [K, N] expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must share dtype float32 or bfloat16, got "
                        f"{x.dtype}, {w.dtype}" + fp16_note(x.dtype, w.dtype))
    for t, want, dtype in ([(m, tuple(x.shape), x.dtype) for m in mats]
                           + [(v, (x.shape[1],), torch.float32) for v in vecs]
                           + [(x, tuple(x.shape), x.dtype), (w, tuple(w.shape), x.dtype)]):
        if (tuple(t.shape) != want or t.dtype != dtype or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name}: every input must be a contiguous tensor on x's "
                             f"device; got {tuple(t.shape)} {t.dtype}, want {want} {dtype}")


def fused_prologue_conv1x1(x, scale, shift, res, w):
    """relu(x * scale + shift + res) @ w -> y [M, N] in x's dtype. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return fused_prologue_conv1x1_plain(x, scale, shift, res, w)
    _check("fused_prologue_conv1x1", x, w, mats=(res,), vecs=(scale, shift))
    m, k = x.shape
    n = w.shape[1]
    geo = fused_block_geometry(n, x.dtype)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().fused_prologue_conv1x1(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), res.data_ptr(), w.data_ptr(),
            y.data_ptr(), int(x.dtype == torch.bfloat16), m, k, n, geo.wm, geo.warps_n,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_prologue_conv1x1: kernel launch failed with cudaError {rc}")
    LAUNCHES["fused_prologue_conv1x1"] += 1
    return y


def conv1x1_with_stats(x, w):
    """x @ w -> (y [M, N] in x's dtype, sum [1, N], sumsq [1, N] float32),
    the sums over the fp32 product. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (and its fixed-order partial-sum
    reduction)."""
    if x.device.type == "cpu":
        return conv1x1_with_stats_plain(x, w)
    return conv1x1_with_stats_partials(x, w)[:3]


def conv1x1_with_stats_partials(x, w):
    """The kernel's launch on CUDA tensors -> (y, sum [1, N], sumsq [1, N],
    part [2, parts, N]): `part` holds the per-block partial sums and sums
    of squares that the second launch reduced, for checks of its order."""
    _check("conv1x1_with_stats", x, w)
    m, k = x.shape
    n = w.shape[1]
    geo, _, parts = fused_block_plan(m, n, x.dtype)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((2, parts, n), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, 1, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().conv1x1_with_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), int(x.dtype == torch.bfloat16), m, k, n,
            geo.wm, geo.warps_n, parts, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1x1_with_stats: kernel launch failed with cudaError {rc}")
    LAUNCHES["conv1x1_with_stats"] += 1
    return y, sums[0], sums[1], part


# ---------------------------------------------------------------------------
# the A/B (tools/fused_block_pallas.py:main)
# ---------------------------------------------------------------------------

# bf16 outputs within one bf16 ulp of the plain value (2^-7 of its
# magnitude: at these shapes |y| reaches 4-8, where an ulp is 0.03);
# fp32 outputs within two fp32 summation orders over K terms; the sums
# within 1e-4 of the largest plain sum (fp32 partial sums of M rows
# against float64)
Y_RTOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-5}
Y_ATOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
SUM_RTOL = 1e-4


def y_err(got, ref):
    """max(|got - ref| - rtol |ref|) - atol over the elements: <= 0 when
    every element is within the dtype's tolerance."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() - Y_RTOL[ref.dtype] * r.abs()).max()) - Y_ATOL[ref.dtype]


def sum_err(got, ref):
    """max |got - ref| over max |ref|."""
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def make_inputs(m, k, n, dtype, device, seed=0):
    """The tool's inputs, drawn on `device`: x ~ N(0, 1), res ~ 0.1 N(0, 1),
    w ~ 0.05 N(0, 1) in `dtype`; scale ~ U(0.5, 1.5), shift ~ 0.1 N(0, 1)
    float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=device).to(dtype)
    res = (0.1 * torch.randn(m, k, generator=g, device=device)).to(dtype)
    w = (0.05 * torch.randn(k, n, generator=g, device=device)).to(dtype)
    scale = torch.rand(k, generator=g, device=device) + 0.5
    shift = 0.1 * torch.randn(k, generator=g, device=device)
    return x, scale, shift, res, w


def ab(shapes=SHAPES, dtype=torch.bfloat16, device="cuda", timer=None, seed=0):
    """For each (name, M, K, N): both kernels against their plain versions
    (the checks raise), the twins loosely against them as the tool checks
    its XLA twins, then with `timer` (fn -> ms) each kernel's time and its
    twin's. Yields one dict per shape."""
    for name, m, k, n in shapes:
        x, scale, shift, res, w = make_inputs(m, k, n, dtype, device, seed)
        row = {"shape": name, "m": m, "k": k, "n": n, "dtype": str(dtype).replace("torch.", "")}
        y = fused_prologue_conv1x1(x, scale, shift, res, w)
        ref = fused_prologue_conv1x1_plain(x, scale, shift, res, w)
        row["prologue_err"] = y_err(y, ref)
        if row["prologue_err"] > 0:
            raise RuntimeError(f"fused_prologue_conv1x1 {name} {dtype}: beyond tolerance by "
                               f"{row['prologue_err']}")
        twin = prologue_twin(x, scale, shift, res, w).float()
        row["prologue_twin_rel"] = float((twin - ref.float()).abs().max()
                                         / ref.float().abs().max())
        if row["prologue_twin_rel"] >= 5e-2:
            raise RuntimeError(f"prologue_twin {name}: relative error {row['prologue_twin_rel']}")
        del y, twin
        ys, s1, s2 = conv1x1_with_stats(x, w)
        ry, r1, r2 = conv1x1_with_stats_plain(x, w)
        row["stats_y_err"] = y_err(ys, ry)
        row["stats_sum_err"] = max(sum_err(s1, r1), sum_err(s2, r2))
        if row["stats_y_err"] > 0 or row["stats_sum_err"] > SUM_RTOL:
            raise RuntimeError(f"conv1x1_with_stats {name} {dtype}: y beyond tolerance by "
                               f"{row['stats_y_err']}, sums rel err {row['stats_sum_err']}")
        _, t1, t2 = stats_twin(x, w)
        row["stats_twin_rel"] = max(sum_err(t1.reshape(1, -1), r1), sum_err(t2.reshape(1, -1), r2))
        if row["stats_twin_rel"] >= 2e-2:
            raise RuntimeError(f"stats_twin {name}: sums rel err {row['stats_twin_rel']}")
        del ys, ry, ref
        if timer is not None:
            row["prologue_ms"] = timer(lambda: fused_prologue_conv1x1(x, scale, shift, res, w))
            row["prologue_twin_ms"] = timer(lambda: prologue_twin(x, scale, shift, res, w))
            row["stats_ms"] = timer(lambda: conv1x1_with_stats(x, w))
            row["stats_twin_ms"] = timer(lambda: stats_twin(x, w))
        yield row
