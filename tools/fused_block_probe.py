"""A/B of the fused-block kernels (csrc/fused_block.cu) on one card.

Builds the tree's csrc/fused_block.cu and, given with --parent, an
earlier copy with the C interface of the FMA kernel (no geometry
arguments; its partial-sum rows from fused_block_rows_per_block()), with
the package's nvcc flags, and prints ptxas's registers and spills. Then,
at the three ResNet-50 b256 bottleneck shapes in bf16 and at stage 4 in
fp32, it checks every build against the plain versions at the A/B's
tolerances, checks that two launches of #10 agree bit for bit, and times
the builds in turns (each order run forwards and backwards, so a drift of
the card's clock falls on all of them alike) behind a `torch.cuda._sleep`
hold, beside the unfused torch twins, torch.matmul alone and the bounds
of chip_smoke.py. With --variants the tree's source is built and timed
with other rings too (RINGS: 64-byte K-slices three deep, 128-byte ones
three deep), and with --cuts with parts cut out, to see where the time
goes (their results are wrong and go unchecked): #9's transform reduced
to one addition (x and res still read), #10 without its sums epilogue,
#10 without the sum launch, the products, the loads after the first
slices. Run on the card from the root of a checkout; the parent's
copy comes from git:

    mkdir -p build/fused_block_parent
    git show <rev>:paddle_tpu_torch/ops/kernels/csrc/fused_block.cu \\
        > build/fused_block_parent/fused_block.cu
    python tools/fused_block_probe.py \\
        --parent build/fused_block_parent/fused_block.cu --variants --cuts

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
KERNELS = ("fused_prologue_conv1x1", "conv1x1_with_stats")
PRO, STA = ("fused_prologue_conv1x1",), ("conv1x1_with_stats",)
# the tree's source with other rings (checked): name -> nvcc flags
RINGS = {"tree_s64x3": ["-DFB_SLICE=64", "-DFB_STAGES=3"], "tree_s128x3": ["-DFB_STAGES=3"]}
# the tree's source with #9 held to one block an SM (checked)
PRO_MIN1 = ("(sizeof(T) == 2 && WM <= 32 &&", "(!PROLOGUE && sizeof(T) == 2 && WM <= 32 &&")
# the tree's source with parts cut out, to see where the time goes (their
# results are wrong and go unchecked): name -> (the kernels it is timed
# for, (text of the source, what takes its place) pairs)
CUTS = {
    "cut_transform": (PRO, [("z[j] = live ? fmaxf(__fadd_rn(v, rf[j]), 0.f) : 0.f;",
                             "z[j] = __fadd_rn(xf[j], rf[j]); (void)v; (void)live;")]),
    "cut_stats": (STA, [("  if (STATS) {\n    // rows past M",
                         "  if (false) {\n    // rows past M")]),
    "cut_sum_launch": (STA, [("  fused_block_stats_reduce_kernel<<<",
                              "  if (0) fused_block_stats_reduce_kernel<<<")]),
    # the products cut: loads, transform, barriers and stores alone
    "cut_mma": (PRO + STA, [("      fb_mma_slice<T, G>(acc, a_tile(s), w_tile(s), wrow, wcol);",
                             "      (void)wrow; (void)wcol;"),
                            ("      fb_mma_slice<T, G>(part, a_tile(s), w_tile(s), wrow, wcol);",
                             "")]),
    # the loads after the first slices cut: products on stale tiles
    "cut_loads": (PRO + STA, [("    if (s + STAGES - 1 < S) load(s + STAGES - 1);",
                               "    if (false) load(s + STAGES - 1);")]),
    "tree_pro_min1": (PRO, [PRO_MIN1]),
}


def build(sources, out_dir):
    """nvcc every (source, extra flags) in parallel -> {name: the loaded
    library}."""
    from paddle_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-o",
               str(out_dir / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(f"[build] {name} ({sources[name][0]} {' '.join(sources[name][1])}): "
              f"rc {proc.returncode}")
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build]   {line.strip()}")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[name][0]}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier fused_block.cu with the FMA kernel's interface")
    ap.add_argument("--variants", action="store_true",
                    help="also time the tree's kernels at the other geometries")
    ap.add_argument("--cuts", action="store_true",
                    help="also time the tree's kernels with the CUTS parts cut out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT)]
    import torch

    from chip_smoke import card_peaks, fused_block_bound_ms
    from paddle_tpu_torch.ops.kernels import _build, device_kernel_ms
    from paddle_tpu_torch.ops.kernels import fused_block as fb

    if not torch.cuda.is_available():
        print("fused_block_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    out_dir = ROOT / "build" / "fused_block_probe"
    tree_src = _build.CSRC / "fused_block.cu"
    sources = {"tree": (tree_src, [])}
    if args.variants:
        sources.update({name: (tree_src, flags) for name, flags in RINGS.items()})
    if args.cuts:
        (out_dir / "cuts").mkdir(parents=True, exist_ok=True)
        for name, (_, edits) in CUTS.items():
            src = tree_src.read_text()
            for old, new in edits:
                assert old in src, f"{name}: {old!r} not in the source"
                src = src.replace(old, new)
            path = out_dir / "cuts" / f"{name}.cu"
            path.write_text(src)
            sources[name] = (path, [])
    if args.parent:
        sources["parent"] = (Path(args.parent).resolve(), [])
    t0 = time.perf_counter()
    libs = build(sources, out_dir)
    print(f"[build] {len(libs)} builds in {time.perf_counter() - t0:.1f} s")
    _, peaks = card_peaks(torch.cuda.get_device_name(0))
    ptr = ctypes.c_void_p
    for name, lib in libs.items():
        new = name != "parent"
        lib.fused_prologue_conv1x1.restype = ctypes.c_int
        lib.fused_prologue_conv1x1.argtypes = [ptr] * 6 + [ctypes.c_int] * (6 if new else 4) + [
            ptr]
        lib.conv1x1_with_stats.restype = ctypes.c_int
        lib.conv1x1_with_stats.argtypes = [ptr] * 7 + [ctypes.c_int] * (7 if new else 4) + [ptr]

    def runner(lib, kernel):
        """A call of `kernel` from `lib`: the tree's interface at the
        wrapper's geometry, or the parent's."""
        parent = lib is libs.get("parent")

        def run(x, scale, shift, res, w):
            m, k = x.shape
            n = w.shape[1]
            g = fb.fused_block_geometry(n, x.dtype)
            stream = torch.cuda.current_stream().cuda_stream
            bf = int(x.dtype == torch.bfloat16)
            y = torch.empty((m, n), dtype=x.dtype, device=x.device)
            if kernel == "fused_prologue_conv1x1":
                tail = (bf, m, k, n) + (() if parent else (g.wm, g.warps_n))
                rc = lib.fused_prologue_conv1x1(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                                res.data_ptr(), w.data_ptr(), y.data_ptr(),
                                                *tail, stream)
                out = (y,)
            else:
                if parent:
                    fn = lib.fused_block_rows_per_block
                    fn.restype, fn.argtypes = ctypes.c_int, []
                    parts = -(-m // fn())
                else:
                    parts = -(-m // g.bm)
                part = torch.empty((2, parts, n), dtype=torch.float32, device=x.device)
                sums = torch.empty((2, 1, n), dtype=torch.float32, device=x.device)
                tail = (bf, m, k, n) + (() if parent else (g.wm, g.warps_n, parts))
                rc = lib.conv1x1_with_stats(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                            part[0].data_ptr(), part[1].data_ptr(),
                                            sums[0].data_ptr(), sums[1].data_ptr(), *tail,
                                            stream)
                out = (y, sums[0], sums[1])
            if rc:
                raise RuntimeError(f"{kernel}: cudaError {rc}")
            return out
        return run

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

    dev = torch.device("cuda")
    checks = [(s, "bfloat16") for s in fb.SHAPES] + [(fb.SHAPES[-1], "float32")]
    ok = True
    for (sname, m, k, n), dtype in checks:
        tdt = getattr(torch, dtype)
        a = fb.make_inputs(m, k, n, tdt, dev, args.seed)
        x, scale, shift, res, w = a
        ref = {"fused_prologue_conv1x1": (fb.fused_prologue_conv1x1_plain(*a),),
               "conv1x1_with_stats": fb.conv1x1_with_stats_plain(x, w)}
        for kernel in KERNELS:
            runs = {"tree": runner(libs["tree"], kernel)}
            if "parent" in libs:
                runs["parent"] = runner(libs["parent"], kernel)
            if args.variants:
                runs.update({name: runner(libs[name], kernel) for name in RINGS})
            if args.cuts:
                for name, (kernels, _) in CUTS.items():
                    if kernel in kernels:
                        runs[name] = runner(libs[name], kernel)
            row = {"kernel": kernel, "shape": sname, "m": m, "k": k, "n": n, "dtype": dtype,
                   "y_err": {}, "sum_err": {}, "bitwise": {}, "device_ms_by_kernel": {},
                   "ms": {name: [] for name in runs}}
            for name, run in runs.items():
                got = run(*a)
                again = run(*a)
                torch.cuda.synchronize()
                row["y_err"][name] = fb.y_err(got[0], ref[kernel][0])
                row["sum_err"][name] = max((fb.sum_err(g, r) for g, r in
                                            zip(got[1:], ref[kernel][1:])), default=0.0)
                row["bitwise"][name] = all(torch.equal(p, q) for p, q in zip(got, again))
                row["device_ms_by_kernel"][name] = {
                    key[:48]: round(v, 5) for key, v in
                    device_kernel_ms(lambda: run(*a), calls=10)[0].items()}
                if name in ("tree", "parent") or name.startswith("tree_"):
                    ok = ok and row["y_err"][name] <= 0 and row["sum_err"][name] <= \
                        fb.SUM_RTOL and row["bitwise"][name]
                del got, again
            order = list(runs) + list(runs)[::-1]
            for name in order:
                row["ms"][name].append(timed_ms(lambda: runs[name](*a)))
            twin = fb.prologue_twin if kernel == "fused_prologue_conv1x1" else (
                lambda x_, s_, h_, r_, w_: fb.stats_twin(x_, w_))
            row["twin_ms"] = timed_ms(lambda: twin(*a))
            row["matmul_ms"] = timed_ms(lambda: torch.matmul(x, w))
            row["bound_ms"], row["bound_by"] = fused_block_bound_ms(kernel, m, k, n, dtype,
                                                                    peaks)
            tree_ms = min(row["ms"]["tree"])
            row["share_of_bound"] = row["bound_ms"] / tree_ms
            if "parent" in row["ms"]:
                row["speedup_over_parent"] = min(row["ms"]["parent"]) / tree_ms
            row["speedup_over_twin"] = row["twin_ms"] / tree_ms
            print(f"[ab] {json.dumps(row)}", flush=True)
        del a, x, scale, shift, res, w, ref
        torch.cuda.empty_cache()
    print(f"[ab] card {smi}")
    print(f"[ab] every build within its gate and #10 bit for bit repeatable: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
