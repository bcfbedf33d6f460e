"""A/B of the flash attention backward kernel (csrc/flash_bwd.cu) on one card.

Builds the tree's csrc/flash_bwd.cu and each other copy of it given on the
command line (a copy's own headers beside it are found first; each copy is
named by its directory) with the package's nvcc flags and prints ptxas's
registers, shared memory and spills. Then, at the long-sequence path's
shape and two others, in fp32 and bf16, it checks every build against the
plain version, checks that two launches agree bit for bit, times the builds
in turns (each order run forwards and backwards, so a drift of the card's
clock falls on all of them alike) beside the backward of
F.scaled_dot_product_attention, and reads the device time of each of the
tree kernel's two launches from torch.profiler. Run on the card from the
root of a checkout; an earlier copy of the kernel comes from git:

    mkdir -p build/flash_bwd_parent
    for f in flash_bwd.cu attn_bwd.cuh attn_common.cuh; do
      git show <rev>:paddle_tpu_torch/ops/kernels/csrc/$f > build/flash_bwd_parent/$f
    done
    python tools/flash_bwd_probe.py build/flash_bwd_parent/flash_bwd.cu

It imports torch, paddle_tpu_torch and chip_smoke.py's helpers only."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (b, h, sq, sk, d), causal: the long-sequence path's attention first
SHAPES = [((2, 12, 2048, 2048, 64), True), ((2, 12, 1000, 1000, 64), False),
          ((2, 12, 4096, 4096, 64), True)]
BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p, ctypes.c_void_p])  # ..., seed, seed_ptr, stream
LAUNCH_NAMES = ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other copies of flash_bwd.cu to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
    import torch

    from chip_smoke import attention_bwd_work, bound_ms, card_peaks, kernel_device_ms
    from flash_fwd_probe import build
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sources = {"tree": _build.CSRC / "flash_bwd.cu"}
    sources.update({Path(p).resolve().parent.name: Path(p).resolve() for p in args.others})
    t0 = time.perf_counter()
    fns = build(sources, ROOT / "build" / "flash_bwd_probe", "flash_bwd", BWD_ARGTYPES)
    print(f"[build] {len(fns)} builds in {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    _, peaks = card_peaks(torch.cuda.get_device_name(0))
    kernel_fn = fa._bwd_kernel_fn

    def run_with(name, *a, **kw):
        fa._bwd_kernel_fn = lambda: fns[name]
        try:
            return fa.flash_attention_bwd(*a, **kw)
        finally:
            fa._bwd_kernel_fn = kernel_fn

    def timed_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000_000)  # queue every launch behind a device-side hold
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def sdpa_bwd_ms(q, k, v, bias, causal, dout):
        """The backward alone of F.scaled_dot_product_attention on the same
        inputs (yardstick only)."""
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.zeros(q.shape[0], 1, sq, sk, device=dev) + bias[:, None, None, :]
        if causal:
            live = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
            mask = mask.masked_fill(~live, -1e30)
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                               attn_mask=mask.to(q.dtype))
        return timed_ms(lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True))

    order = list(fns) + list(fns)[::-1]
    for shape, causal in SHAPES:
        b, h, sq, sk, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)
                       for s in (sq, sk, sk))
            dout = (0.25 * torch.randn(q.shape, generator=gen, device=dev)).to(dtype)
            lengths = torch.randint(1, sk + 1, (b, 1), generator=gen, device=dev)
            bias = torch.where(torch.arange(sk, device=dev)[None, :] < lengths, 0.0,
                               -1e4).float().contiguous()
            kw = dict(causal=causal, layout="bhsd")
            out, lse = fa.flash_attention(q, k, v, bias=bias, **kw)
            a = (q, k, v, bias, dout, lse, fa.attention_delta(out, dout, "bhsd"))
            ref = fa.flash_attention_bwd_plain(*a, **kw)
            dname = str(dtype)[6:]
            work = attention_bwd_work(shape, dname, True, causal)
            row = {"shape": list(shape), "causal": causal, "dtype": dname,
                   "bound_ms": bound_ms(work, dname, peaks, tensor_cores=True)[0],
                   "bound_fma_ms": bound_ms(work, dname, peaks)[0],
                   "max_abs_err": {}, "bitwise_repeat": {}, "ms": {n: [] for n in fns}}
            for name in fns:
                got = run_with(name, *a, **kw)
                again = run_with(name, *a, **kw)
                torch.cuda.synchronize()
                row["max_abs_err"][name] = max(float((g.float() - r.float()).abs().max())
                                               for g, r in zip(got, ref))
                row["bitwise_repeat"][name] = all(torch.equal(x, y) for x, y in zip(got, again))
            del ref, got, again
            for name in order:
                row["ms"][name].append(timed_ms(lambda: run_with(name, *a, **kw)))
            row["sdpa_bwd_ms"] = sdpa_bwd_ms(q, k, v, bias, causal, dout)
            row["tree_by_launch_ms"] = kernel_device_ms(
                torch, lambda: run_with("tree", *a, **kw), LAUNCH_NAMES)
            print(f"[ab] {json.dumps(row)}", flush=True)
            del q, k, v, dout, out, lse, a
            torch.cuda.empty_cache()
    print(f"[ab] card {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
