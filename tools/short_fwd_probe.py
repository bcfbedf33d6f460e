"""A/B of the short attention forward kernel (csrc/mha_short_fwd.cu) on one card.

Builds the tree's csrc/mha_short_fwd.cu and each other copy of it given on
the command line (a copy's own headers beside it are found first; each copy
is named by its directory) with the package's nvcc flags, and prints
ptxas's registers and spills. Then, at the shapes of chip_smoke.py's
phase 3, in fp32 and bf16, it checks every
build against the plain version, checks that two launches of each agree
bit for bit, and times the builds in turns (each order run forwards and
backwards, so a drift of the card's clock falls on all of them alike)
beside F.scaled_dot_product_attention and the flash forward (flash_fwd)
on the same inputs. Run on the card from the root of a checkout; an
earlier copy of the kernel comes from git:

    mkdir -p build/short_fwd_parent
    for f in mha_short_fwd.cu attn_common.cuh mma_common.cuh; do
      git show <rev>:paddle_tpu_torch/ops/kernels/csrc/$f > build/short_fwd_parent/$f
    done
    python tools/short_fwd_probe.py build/short_fwd_parent/mha_short_fwd.cu

A variant of the tree's kernel (another tile shape, say) goes in a
directory of its own with copies of the two headers, as the parent does.

It imports torch, paddle_tpu_torch and chip_smoke.py's helpers only."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py phase 3: (b, h, sq, sk, d), layout, bias, causal
SHAPES = [((8, 12, 128, 128, 64), "bshd", True, False),
          ((8, 12, 128, 128, 64), "bhsd", True, False),
          ((8, 12, 512, 512, 64), "bshd", True, False),
          ((2, 12, 100, 77, 64), "bshd", False, True)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # as chip_smoke.py


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other copies of mha_short_fwd.cu to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
    import torch

    from chip_smoke import attention_work, bound_ms, card_peaks
    from flash_fwd_probe import FWD_ARGTYPES, build
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import mha_short as ms

    if not torch.cuda.is_available():
        print("short_fwd_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sources = {"tree": _build.CSRC / "mha_short_fwd.cu"}
    for p in args.others:
        sources[Path(p).resolve().parent.name] = Path(p).resolve()
    t0 = time.perf_counter()
    fns = build(sources, ROOT / "build" / "short_fwd_probe", "mha_short_fwd", FWD_ARGTYPES)
    print(f"[build] {len(fns)} builds in {time.perf_counter() - t0:.1f} s")
    _, peaks = card_peaks(torch.cuda.get_device_name(0))

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernel_fn = fa._kernel_fn

    def run_with(name, *a, **kw):
        fa._kernel_fn = lambda _: fns[name]
        try:
            return ms.short_attention(*a, **kw)
        finally:
            fa._kernel_fn = kernel_fn

    def timed_ms(fn, iters=50):
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
    ok = True
    for shape, layout, use_bias, causal in SHAPES:
        b, h, sq, sk, d = shape
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            qs = (b, sq, h, d) if layout == "bshd" else (b, h, sq, d)
            ks = (b, sk, h, d) if layout == "bshd" else (b, h, sk, d)
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(tdt) for s in (qs, ks, ks))
            bias = None
            if use_bias:
                lengths = torch.randint(1, sk + 1, (b, 1), generator=gen, device=dev)
                bias = torch.where(torch.arange(sk, device=dev)[None, :] < lengths, 0.0,
                                   -1e4).float().contiguous()
            kw = dict(bias=bias, causal=causal, layout=layout)
            ref_out, ref_lse = ms.short_attention_plain(q, k, v, **kw)
            row = {"shape": list(shape), "layout": layout, "bias": use_bias,
                   "causal": causal, "dtype": dtype, "max_abs_err": {}, "bitwise": {},
                   "ms": {n: [] for n in fns}}  # err: [out, lse of the rows with a key]
            live = ref_lse > -1e20
            for name in fns:
                out, lse = run_with(name, q, k, v, **kw)
                out2, lse2 = run_with(name, q, k, v, **kw)
                torch.cuda.synchronize()
                err = float((out.float() - ref_out.float()).abs().max())
                row["max_abs_err"][name] = [err, float((lse - ref_lse)[live].abs().max())]
                row["bitwise"][name] = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
                ok = ok and err <= TOL[dtype] and row["bitwise"][name]
            for name in order:
                row["ms"][name].append(timed_ms(lambda: run_with(name, q, k, v, **kw)))
            row["flash_fwd_ms"] = timed_ms(lambda: fa.flash_attention(q, k, v, **kw))
            qt, kt, vt = ((x.transpose(1, 2) for x in (q, k, v)) if layout == "bshd"
                          else (q, k, v))
            mask = torch.zeros(b, 1, sq, sk, device=dev)
            if bias is not None:
                mask = mask + bias[:, None, None, :]
            if causal:
                keep = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
                mask = mask.masked_fill(~keep, -1e30)
            mask = mask.to(tdt)
            row["sdpa_ms"] = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            work = attention_work(shape, dtype, use_bias, causal)
            row["bound_ms"] = bound_ms(work, dtype, peaks, tensor_cores=True)
            row["bound_fma_ms"] = bound_ms(work, dtype, peaks)
            print(f"[ab] {json.dumps(row)}")
            del q, k, v, ref_out, ref_lse, mask
    print(f"[ab] card {smi}")
    print(f"[ab] every build within its gate and bit for bit repeatable: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
