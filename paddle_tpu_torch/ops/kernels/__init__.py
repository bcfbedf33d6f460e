"""Hand-written CUDA kernels for Hopper (csrc/*.cu) with their Python
wrappers and plain PyTorch versions.

Every wrapper adds one to its entry in `LAUNCHES` where it launches its
kernel, and nowhere else, so a run can show which kernels its main path
went through; an attention launch with a causal mask also adds one to
`CAUSAL_LAUNCHES`. A wrapper given a CPU tensor computes the kernel's plain
version instead; given a CUDA tensor it launches the kernel or raises."""

# the attention and LayerNorm kernels (#1-#8) take float32, bf16 and fp16;
# the fused-block kernels (#9-#10) float32 and bf16, and an fp16 input to
# them on the card raises TypeError with this note (nothing falls back to
# a plain version)
FP16_NOT_WRITTEN = ("the fused-block kernels take float32 and bfloat16; their float16 "
                    "versions are not written yet (ROADMAP Queue 2, \"fp16 for #9-#10\")")


def fp16_note(*dtypes) -> str:
    """FP16_NOT_WRITTEN, after a space, when any of `dtypes` is float16."""
    import torch

    return f" ({FP16_NOT_WRITTEN})" if torch.float16 in dtypes else ""


def dtype_code(dtype) -> int:
    """The C entry points' code for a tensor dtype: 0 float32, 1 bfloat16,
    2 float16 (csrc/attn_common.cuh ATTN_F32 / ATTN_BF16 / ATTN_F16)."""
    import torch

    return {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]


LAUNCHES = {
    "mha_short_fwd": 0,
    "mha_short_bwd": 0,
    "flash_fwd": 0,
    "flash_bwd": 0,
    "layer_norm_bwd": 0,
    "fused_prologue_conv1x1": 0,
    "conv1x1_with_stats": 0,
}


# of those, the attention launches with a causal mask (beside LAUNCHES,
# where the wrapper adds to both)
CAUSAL_LAUNCHES = {"mha_short_fwd": 0, "mha_short_bwd": 0, "flash_fwd": 0, "flash_bwd": 0}


def reset_launch_counts():
    for counts in (LAUNCHES, CAUSAL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def causal_launch_counts() -> dict:
    return dict(CAUSAL_LAUNCHES)


_MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, which opens and closes a session


def _profiled_kernels(fn, calls, tries):
    """`fn` `calls` times under torch.profiler -> ({kernel name: (launches,
    device microseconds)} of every kernel the device ran, sessions taken).

    CUPTI at times delivers none of a short session's kernel records (seen
    on an H100: up to three sessions in a row with no device event at all,
    `tools/profiler_drop_probe.py`), and in some processes one record of
    every session (two of three launches read in each of ten sessions in a
    row). Each session opens and closes with a marker launch, left out of
    the result, so that a record lost at either end of it is a marker's;
    a session that recorded fewer than `calls` launches of `fn` in all is
    taken again, up to `tries` sessions. The profiler loses records but
    never makes one up, so a retry hides no kernel that ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = {ev.key: (ev.count, ev.self_device_time_total) for ev in prof.key_averages()
                  if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.count
                  and _MARKER not in ev.key}
        if sum(count for count, _ in events.values()) >= calls:
            break
    return events, session


def device_kernel_stats(fn, calls=3, tries=10):
    """`fn` `calls` times under torch.profiler -> ({kernel name: (launches a
    call, device ms a call)} of every kernel the device ran, sessions
    taken); sessions that lost their records are taken again
    (`_profiled_kernels`)."""
    events, session = _profiled_kernels(fn, calls, tries)
    return {name: (count / calls, us / calls / 1e3)
            for name, (count, us) in events.items()}, session


def device_kernels(fn, calls=3, tries=10):
    """As `device_kernel_stats` -> ({kernel name: launches a call},
    sessions taken)."""
    stats, session = device_kernel_stats(fn, calls, tries)
    return {name: count for name, (count, _) in stats.items()}, session


def device_kernel_ms(fn, calls=20, tries=10):
    """As `device_kernel_stats` -> ({kernel name: its device ms a call},
    sessions taken)."""
    stats, session = device_kernel_stats(fn, calls, tries)
    return {name: ms for name, (_, ms) in stats.items()}, session
