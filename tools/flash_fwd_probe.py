"""A/B of the flash attention forward kernel (csrc/flash_fwd.cu) on one card.

Builds the tree's csrc/flash_fwd.cu and each other copy of it given on the
command line with the package's nvcc flags, prints ptxas's registers and
spills, then checks every build against the plain version and times them in
turns (each order run forwards and backwards, so a drift of the card's clock
falls on all of them alike), beside F.scaled_dot_product_attention, at the
long-sequence path's shape and two others, in fp32 and bf16. Run on the card
from the root of a checkout; an earlier copy of the kernel comes from git:

    git show <rev>:paddle_tpu_torch/ops/kernels/csrc/flash_fwd.cu > build/flash_fwd_parent.cu
    python tools/flash_fwd_probe.py build/flash_fwd_parent.cu

It imports torch and paddle_tpu_torch only."""

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


FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p, ctypes.c_void_p])  # ..., seed, seed_ptr, stream


def build(sources, out_dir, entry="flash_fwd", argtypes=FWD_ARGTYPES):
    """nvcc every source in parallel -> {name: its C entry point `entry`,
    typed for ctypes}."""
    from paddle_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out_dir / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(f"[build] {name} ({sources[name]}): rc {proc.returncode}")
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build]   {line.strip()}")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[name] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other copies of flash_fwd.cu to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_fwd_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sources = {"tree": _build.CSRC / "flash_fwd.cu"}
    sources.update({Path(p).stem: Path(p).resolve() for p in args.others})
    t0 = time.perf_counter()
    fns = build(sources, ROOT / "build" / "flash_fwd_probe")
    print(f"[build] {len(fns)} builds in {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernel_fn = fa._kernel_fn

    def run_with(name, *a, **kw):
        fa._kernel_fn = lambda _: fns[name]
        try:
            return fa.flash_attention(*a, **kw)
        finally:
            fa._kernel_fn = kernel_fn

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

    order = list(fns) + list(fns)[::-1]
    for shape, causal in SHAPES:
        b, h, sq, sk, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)
                       for s in (sq, sk, sk))
            lengths = torch.randint(1, sk + 1, (b, 1), generator=gen, device=dev)
            bias = torch.where(torch.arange(sk, device=dev)[None, :] < lengths, 0.0,
                               -1e4).float().contiguous()
            kw = dict(bias=bias, causal=causal, layout="bhsd")
            ref_out, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
            row = {"shape": list(shape), "causal": causal, "dtype": str(dtype)[6:],
                   "max_abs_err": {}, "ms": {n: [] for n in fns}}  # err: [out, lse]
            for name in fns:
                out, lse = run_with(name, q, k, v, **kw)
                torch.cuda.synchronize()
                row["max_abs_err"][name] = [float((out.float() - ref_out.float()).abs().max()),
                                            float((lse - ref_lse).abs().max())]
            for name in order:
                row["ms"][name].append(timed_ms(lambda: run_with(name, q, k, v, **kw)))
            mask = torch.zeros(b, 1, sq, sk, device=dev) + bias[:, None, None, :]
            if causal:
                live = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
                mask = mask.masked_fill(~live, -1e30)
            mask = mask.to(dtype)
            row["sdpa_ms"] = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            print(f"[ab] {json.dumps(row)}")
            del q, k, v, ref_out, ref_lse, mask
    print(f"[ab] card {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
