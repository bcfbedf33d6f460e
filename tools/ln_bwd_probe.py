"""A/B of the LayerNorm backward kernel (csrc/layer_norm_bwd.cu) on one card.

Builds the tree's csrc/layer_norm_bwd.cu and, given with --parent, an
earlier copy of it with the per-block-partials interface (dx and [blocks,
k] partials that torch sums) with the package's nvcc flags, and prints
ptxas's registers and spills. Then, at chip_smoke.py's LayerNorm shapes
and one row (the launch's own floor), in fp32 and bf16, it checks every
build against the plain version, checks that two launches of each agree
bit for bit, reads the device kernels of a call from torch.profiler, and
times the builds in turns (each order run forwards and backwards, so a
drift of the card's clock falls on all of them alike) beside aten's
native_layer_norm_backward on the same inputs. With --variants the tree's
kernel is timed in other geometries too (4 or 2 warps a block), and with
--cuts with parts of it cut out (the column sums; the barrier too; all
after the rows; then that launched as a plain kernel; all of the
register path's kernel). Run on the card
from the root of a checkout; the parent's copy comes from git:

    mkdir -p build/ln_bwd_parent
    git show <rev>:paddle_tpu_torch/ops/kernels/csrc/layer_norm_bwd.cu \\
        > build/ln_bwd_parent/layer_norm_bwd.cu
    python tools/ln_bwd_probe.py --parent build/ln_bwd_parent/layer_norm_bwd.cu

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
# chip_smoke.py phase 3's LayerNorm shapes, then one row
SHAPES = [(1024, 768), (160, 768), (1100, 128), (4096, 1024), (1024, 4096), (1, 768)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # dx, as chip_smoke.py; the sums 1e-4 relative
# the tree's geometry variants: (name, module constant, value)
VARIANTS = [("tree_w4", "_WARPS", 4), ("tree_w2", "_WARPS", 2)]
# the tree's kernel with parts cut out, to see where the time goes (their
# results are wrong and go unchecked): name -> (text of the source, what
# takes its place)
_SYNC = "  cg::this_grid().sync();\n"
_FINISH = "  const int k2 = 2 * k, G = gridDim.x;\n  __syncthreads();\n"
_REG_TOP = "  float g[VPL][V], b[VPL][V];\n"
CUTS = {
    "cut_columns": (_SYNC, _SYNC + "  return;\n"),  # no column sums after the barrier
    "cut_barrier": (_SYNC, "  return;\n"),  # the blocks' partial rows, no barrier
    "cut_finish": (_FINISH, "  return;\n" + _FINISH),  # the rows alone
    # the rows alone, launched as a plain kernel
    "cut_finish_plain_launch": ((_FINISH, "  return;\n" + _FINISH),
                                ("cudaLaunchCooperativeKernel(", "cudaLaunchKernel(")),
    # the register path's kernel returns at once: the launch alone
    "cut_all": (_REG_TOP, "  return;\n" + _REG_TOP),
}


def build(sources, out_dir):
    """nvcc every source in parallel -> {name: the loaded library}."""
    from paddle_tpu_torch.ops.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(f"[build] {name} ({sources[name]}): rc {proc.returncode}")
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build]   {line.strip()}")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier layer_norm_bwd.cu with per-block partials")
    ap.add_argument("--variants", action="store_true",
                    help="also time the tree's kernel in the VARIANTS geometries")
    ap.add_argument("--cuts", action="store_true",
                    help="also time the tree's kernel with the CUTS parts cut out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT)]
    import torch

    from chip_smoke import card_peaks, ln_bwd_bound_ms
    from paddle_tpu_torch.ops.kernels import _build, device_kernels
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    if not torch.cuda.is_available():
        print("ln_bwd_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    out_dir = ROOT / "build" / "ln_bwd_probe"
    sources = {"tree": _build.CSRC / "layer_norm_bwd.cu"}
    if args.cuts:
        (out_dir / "cuts").mkdir(parents=True, exist_ok=True)
        tree_src = sources["tree"].read_text()
        for name, edits in CUTS.items():
            src = tree_src
            for old, new in (edits if isinstance(edits[0], tuple) else (edits,)):
                assert old in src, f"{name}: {old!r} not in the source"
                src = src.replace(old, new)
            sources[name] = out_dir / "cuts" / f"{name}.cu"
            sources[name].write_text(src)
    if args.parent:
        sources["parent"] = Path(args.parent).resolve()
    t0 = time.perf_counter()
    libs = build(sources, out_dir)
    print(f"[build] {len(libs)} builds in {time.perf_counter() - t0:.1f} s")
    _, peaks = card_peaks(torch.cuda.get_device_name(0))

    def typed(lib):
        """The wrapper's bindings applied to `lib`."""
        saved_load = ln.load
        ln.load = lambda name: lib
        try:
            return ln._lib.__wrapped__()
        finally:
            ln.load = saved_load

    def tree_runner(lib, setting=None):
        def run(*a):
            saved_lib = ln._lib
            saved = setting and getattr(ln, setting[0])
            ln._lib = lambda: lib
            if setting:
                setattr(ln, setting[0], setting[1])
            try:
                return ln.ln_bwd(*a)
            finally:
                ln._lib = saved_lib
                if setting:
                    setattr(ln, setting[0], saved)
        return run

    def parent_run(x, dy, mean, rstd, scale):
        """The parent's wrapper: per-block partials, then two torch sums."""
        fn = libs["parent"].layer_norm_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        n, k = x.shape
        rows = min(8, 96 * 1024 // (8 * k))
        blocks = -(-n // rows)
        dx = torch.empty_like(x)
        dg = torch.empty((blocks, k), dtype=torch.float32, device=x.device)
        db = torch.empty((blocks, k), dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                scale.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                int(x.dtype == torch.bfloat16), n, k, rows,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent layer_norm_bwd: cudaError {rc}")
        return dx, dg.sum(0), db.sum(0)

    typed_tree = typed(libs["tree"])
    runs = {"tree": tree_runner(typed_tree)}
    if args.variants:
        for name, const, value in VARIANTS:
            runs[name] = tree_runner(typed_tree, (const, value))
    if args.cuts:
        for name in CUTS:
            runs[name] = tree_runner(typed(libs[name]))
    if args.parent:
        runs["parent"] = parent_run

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

    def short_names(counts):
        return {name[:60]: c for name, c in counts.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    order = list(runs) + list(runs)[::-1]
    ok = True
    for n, k in SHAPES:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            x = (2 * torch.randn(n, k, generator=gen, device=dev) + 0.5).to(tdt)
            dy = torch.randn(n, k, generator=gen, device=dev).to(tdt)
            xf = x.float()
            mean = xf.mean(1)
            rstd = torch.rsqrt(xf.var(1, unbiased=False) + 1e-5)
            scale = torch.rand(k, generator=gen, device=dev) + 0.5
            a = (x, dy, mean, rstd, scale)
            ref = ln.ln_bwd_plain(*a)
            geo, blocks = ln.ln_bwd_plan(x, dy, scale)
            row = {"n": n, "k": k, "dtype": dtype, "path": geo.path, "warps": geo.warps,
                   "blocks": blocks, "max_abs_err": {}, "sums_rel_err": {}, "bitwise": {},
                   "kernels_per_call": {}, "ms": {name: [] for name in runs}}
            for name, run in runs.items():
                got, again = run(*a), run(*a)
                torch.cuda.synchronize()
                err = float((got[0].float() - ref[0].float()).abs().max())
                err_sums = max(float((g - r).abs().max() / max(1.0, float(r.abs().max())))
                               for g, r in zip(got[1:], ref[1:]))
                row["max_abs_err"][name] = err
                row["sums_rel_err"][name] = err_sums
                row["bitwise"][name] = all(torch.equal(p, q) for p, q in zip(got, again))
                row["kernels_per_call"][name] = short_names(device_kernels(lambda: run(*a))[0])
                if name not in CUTS:
                    ok = ok and err <= TOL[dtype] and err_sums <= 1e-4 and row["bitwise"][name]
            for name in order:
                row["ms"][name].append(timed_ms(lambda: runs[name](*a)))
            w, bb = scale.to(tdt), torch.zeros(k, device=dev, dtype=tdt)
            _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [k], w, bb, 1e-5)
            row["native_ms"] = timed_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [k], lmean, lrstd, w, bb, [True, True, True]))
            row["native_kernels_per_call"] = short_names(device_kernels(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [k], lmean, lrstd, w, bb, [True, True, True]))[0])
            row["bound_ms"] = ln_bwd_bound_ms(n, k, dtype, peaks)
            print(f"[ab] {json.dumps(row)}")
    print(f"[ab] card {smi}")
    print(f"[ab] every build within its gate and bit for bit repeatable: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
