"""LayerNorm backward: the wrapper of csrc/layer_norm_bwd.cu and its plain
PyTorch version.

Counterpart of `paddle_tpu/ops/pallas/layer_norm.py` (`ln_bwd`). The JAX
package gates its Pallas kernel on `ln_bwd_viable` (n >= 1024, k <= 4096,
k % 128 == 0), a limit of the TPU's VMEM, and otherwise computes the same
fp32 function in plain XLA; here the kernel serves every shape, so on the
card every layer_norm_grad launches it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES
from ._build import load

__all__ = ["ln_bwd", "ln_bwd_plain"]

# x and dy rows of one block, as float, in at most this much shared memory
_SMEM_BUDGET = 96 * 1024
_MAX_ROWS = 8


def _rows(k: int) -> int:
    """Rows per block of the kernel for row width k."""
    rows = min(_MAX_ROWS, _SMEM_BUDGET // (8 * k))
    if rows < 1:
        raise ValueError(f"layer_norm_bwd: row width {k} > {_SMEM_BUDGET // 8}")
    return rows


def ln_bwd_plain(x2, dy2, mean, rstd, scale):
    """x2, dy2 [n, k]; mean, rstd [n] and scale [k] float32 ->
    (dx [n, k] in x2's dtype, dscale [k] float32, dbias [k] float32), in
    float64 inside (the function of `_kernel`, layer_norm.py:23-35). With
    bf16 x the dscale terms are bf16(dy) * bf16(nrm), as the JAX package's
    layer_norm_grad computes them for bf16 X (nn_ops.py:598-605)."""
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
def _kernel_fn():
    fn = load("layer_norm_bwd").layer_norm_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def ln_bwd(x2, dy2, mean, rstd, scale):
    """LayerNorm backward -> (dx, dscale, dbias). A CPU tensor runs the
    plain version; a CUDA tensor launches csrc/layer_norm_bwd.cu."""
    if x2.device.type == "cpu":
        return ln_bwd_plain(x2, dy2, mean, rstd, scale)
    n, k = x2.shape
    if x2.dtype not in (torch.float32, torch.bfloat16) or dy2.dtype != x2.dtype:
        raise TypeError("layer_norm_bwd: x and dy must share dtype float32 or "
                        f"bfloat16, got {x2.dtype}, {dy2.dtype}")
    for name, t, shape in (("x", x2, (n, k)), ("dy", dy2, (n, k)), ("mean", mean, (n,)),
                           ("rstd", rstd, (n,)), ("scale", scale, (k,))):
        if tuple(t.shape) != shape or not t.is_contiguous() or t.device != x2.device:
            raise ValueError(f"layer_norm_bwd: {name} must be a contiguous {shape} "
                             "tensor on x's device")
        if name in ("mean", "rstd", "scale") and t.dtype != torch.float32:
            raise TypeError(f"layer_norm_bwd: {name} must be float32, got {t.dtype}")
    rows = _rows(k)
    blocks = (n + rows - 1) // rows
    dx = torch.empty_like(x2)
    dg = torch.empty((blocks, k), dtype=torch.float32, device=x2.device)
    db = torch.empty((blocks, k), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        rc = _kernel_fn()(x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                          scale.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                          int(x2.dtype == torch.bfloat16), n, k, rows,
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd: kernel launch failed with cudaError {rc}")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dg.sum(0), db.sum(0)
