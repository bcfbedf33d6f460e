"""How often torch.profiler loses a short session's kernel records on the card.

At the LayerNorm backward shapes of chip_smoke.py's phase 3, in fp32 and
bf16, it takes SESSIONS profiler sessions of three `ln_bwd` calls each and
counts those that recorded fewer than three kernel launches, with the
longest run of such sessions in a row. Then it calls
`kernels.device_kernels`, which retakes such sessions, SESSIONS / 4
times and checks that each call reads one launch of the kernel a call.
Run on the card from the root of a checkout:

    python tools/profiler_drop_probe.py [SESSIONS]

It exits 1 if `device_kernels` read anything else. It imports torch and
paddle_tpu_torch only."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [(1024, 768), (160, 768), (1100, 128), (4096, 1024), (1024, 4096)]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.layer_norm import ln_bwd

    if not torch.cuda.is_available():
        print("profiler_drop_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    short_total = wrong_total = 0
    for n, k in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (2 * torch.randn(n, k, generator=gen, device=dev) + 0.5).to(dtype)
            dy = torch.randn(n, k, generator=gen, device=dev).to(dtype)
            mean = x.float().mean(1)
            rstd = torch.rsqrt(x.float().var(1, unbiased=False) + 1e-5)
            scale = torch.rand(k, generator=gen, device=dev) + 0.5

            def fn():
                return ln_bwd(x, dy, mean, rstd, scale)

            fn()
            torch.cuda.synchronize()
            short, run, longest = 0, 0, 0
            for _ in range(sessions):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                got = sum(ev.count for ev in prof.key_averages()
                          if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.count)
                run = run + 1 if got < 3 else 0
                short += got < 3
                longest = max(longest, run)
            wrong, taken = 0, 1
            for _ in range(sessions // 4):
                per_call, s = kernels.device_kernels(fn)
                taken = max(taken, s)
                wrong += not (len(per_call) == 1 and "layer_norm_bwd" in next(iter(per_call))
                              and next(iter(per_call.values())) == 1)
            short_total += short
            wrong_total += wrong
            print(f"[drop] n={n} k={k} {dtype}: sessions short {short} of {sessions}, "
                  f"longest run {longest}; device_kernels wrong {wrong} of {sessions // 4}, "
                  f"most sessions taken {taken}", flush=True)
    print(f"[drop] card {smi.strip()}")
    print(f"[drop] sessions short {short_total}; device_kernels wrong {wrong_total}")
    return 1 if wrong_total else 0


if __name__ == "__main__":
    sys.exit(main())
