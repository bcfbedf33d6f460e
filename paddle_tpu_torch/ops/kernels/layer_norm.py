"""LayerNorm backward: the wrapper of csrc/layer_norm_bwd.cu and its plain
PyTorch version.

Counterpart of `paddle_tpu/ops/pallas/layer_norm.py` (`ln_bwd`). The JAX
package gates its Pallas kernel on `ln_bwd_viable` (n >= 1024, k <= 4096,
k % 128 == 0), a limit of the TPU's VMEM, and otherwise computes the same
fp32 function in plain XLA; here the kernel serves every n >= 1 and
1 <= k <= 12288, so on the card every layer_norm_grad launches it: one
cooperative launch that finishes dscale and dbias inside it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import LAUNCHES, dtype_code
from ._build import load

__all__ = ["LnGeometry", "ln_bwd", "ln_bwd_geometry", "ln_bwd_plain", "ln_bwd_plan"]

_MAX_K = 12288  # the widest row the wrapper takes
_REG_MAX_K = 1024  # the register path's widest row (LN_REG_MAX_K in the source)
_WARPS = 8  # warps a block; the general path halves them until its partials fit
_GEN_SMEM = 200 * 1024  # the general path's [warps, 2k] float partials, at most


class LnGeometry(NamedTuple):
    """How the kernel lays a row over a warp."""
    vec: int  # columns a load: 16 bytes of x's type, or 1 (the scalar loads)
    vpl: int  # vectors a lane of the register path; 0 = the general path
    warps: int  # warps a block

    @property
    def path(self) -> str:
        if self.vpl:
            return f"registers, {self.vpl} x {self.vec} columns a lane"
        return "general, " + ("16-byte loads" if self.vec > 1 else "scalar loads")


def ln_bwd_geometry(k: int, dtype: torch.dtype, aligned: bool = True) -> LnGeometry:
    """The kernel's geometry for rows of width k in `dtype`; `aligned`: x,
    dy and scale start on 16 bytes."""
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"layer_norm_bwd: row width {k} outside 1..{_MAX_K}")
    vec = 16 // dtype.itemsize
    if aligned and k % vec == 0:
        if k <= _REG_MAX_K:
            return LnGeometry(vec, -(-k // (32 * vec)), _WARPS)
    else:
        vec = 1
    warps = _WARPS
    while warps > 1 and 8 * warps * k > _GEN_SMEM:
        warps //= 2
    return LnGeometry(vec, 0, warps)


def ln_bwd_plain(x2, dy2, mean, rstd, scale):
    """x2, dy2 [n, k]; mean, rstd [n] and scale [k] float32 ->
    (dx [n, k] in x2's dtype, dscale [k] float32, dbias [k] float32), in
    float64 inside (the function of `_kernel`, layer_norm.py:23-35). With
    bf16 x the dscale terms are bf16(dy) * bf16(nrm), as the JAX package's
    layer_norm_grad computes them for bf16 X (nn_ops.py:598-605); fp16 x
    keeps the unrounded terms dy * nrm, as that lowering and the Pallas
    kernel do for every X but bf16."""
    x = x2.double()
    dy = dy2.double()
    nrm = (x - mean.double()[:, None]) * rstd.double()[:, None]
    dyg = dy * scale.double()[None, :]
    m1 = dyg.mean(dim=1, keepdim=True)
    m2 = (dyg * nrm).mean(dim=1, keepdim=True)
    dx = rstd.double()[:, None] * (dyg - m1 - nrm * m2)
    terms = dy * nrm
    if x2.dtype == torch.bfloat16:
        bf = torch.bfloat16
        # the normalized value in fp32, as the kernel and the JAX lowering
        # compute it, then rounded; the product of two bf16 is exact
        nrm32 = (x2.float() - mean.float()[:, None]) * rstd.float()[:, None]
        terms = dy2.to(bf).double() * nrm32.to(bf).double()
    return dx.to(x2.dtype), terms.sum(0).float(), dy.sum(0).float()


@functools.cache
def _lib():
    lib = load("layer_norm_bwd")
    lib.layer_norm_bwd.restype = ctypes.c_int
    lib.layer_norm_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p])
    lib.layer_norm_bwd_max_blocks.restype = ctypes.c_int
    lib.layer_norm_bwd_max_blocks.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.cache
def _max_blocks(lib, dtype: int, geo: LnGeometry, k: int, device: int) -> int:
    """The most blocks of the geometry's kernel the device holds at once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.layer_norm_bwd_max_blocks(dtype, int(geo.vec > 1), geo.vpl, geo.warps, k,
                                           ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd: no grid for {geo} at k {k}: cudaError {rc}")
    return blocks.value


def ln_bwd_plan(x2, dy2, scale) -> tuple[LnGeometry, int]:
    """(geometry, blocks) of the launch for these CUDA tensors: a block
    for every `warps` rows, or as many as the card holds at once."""
    n, k = x2.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, dy2, scale))
    geo = ln_bwd_geometry(k, x2.dtype, aligned)
    cap = _max_blocks(_lib(), dtype_code(x2.dtype), geo, k, x2.device.index or 0)
    return geo, min(-(-n // geo.warps), cap)


def ln_bwd(x2, dy2, mean, rstd, scale):
    """LayerNorm backward -> (dx, dscale, dbias). A CPU tensor runs the
    plain version; a CUDA tensor makes one launch of
    csrc/layer_norm_bwd.cu, which finishes dscale and dbias itself."""
    if x2.device.type == "cpu":
        return ln_bwd_plain(x2, dy2, mean, rstd, scale)
    n, k = x2.shape
    if x2.dtype not in (torch.float32, torch.bfloat16, torch.float16) or dy2.dtype != x2.dtype:
        raise TypeError("layer_norm_bwd: x and dy must share dtype float32, bfloat16 or "
                        f"float16, got {x2.dtype}, {dy2.dtype}")
    for name, t, shape in (("x", x2, (n, k)), ("dy", dy2, (n, k)), ("mean", mean, (n,)),
                           ("rstd", rstd, (n,)), ("scale", scale, (k,))):
        if tuple(t.shape) != shape or not t.is_contiguous() or t.device != x2.device:
            raise ValueError(f"layer_norm_bwd: {name} must be a contiguous {shape} "
                             "tensor on x's device")
        if name in ("mean", "rstd", "scale") and t.dtype != torch.float32:
            raise TypeError(f"layer_norm_bwd: {name} must be float32, got {t.dtype}")
    if n < 1:
        raise ValueError("layer_norm_bwd: no rows")
    with torch.cuda.device(x2.device):
        geo, blocks = ln_bwd_plan(x2, dy2, scale)
        dx = torch.empty_like(x2)
        part = torch.empty((blocks, 2 * k), dtype=torch.float32, device=x2.device)
        out = torch.empty((2, k), dtype=torch.float32, device=x2.device)
        rc = _lib().layer_norm_bwd(
            x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
            dx.data_ptr(), part.data_ptr(), out.data_ptr(), dtype_code(x2.dtype),
            int(geo.vec > 1), geo.vpl, geo.warps, n, k, blocks,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd: kernel launch failed with cudaError {rc}")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, out[0], out[1]
