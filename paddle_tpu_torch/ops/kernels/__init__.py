"""Hand-written CUDA kernels for Hopper (csrc/*.cu) with their Python
wrappers and plain PyTorch versions.

Every wrapper adds one to its entry in `LAUNCHES` where it launches its
kernel, and nowhere else, so a run can show which kernels its main path
went through. A wrapper given a CPU tensor computes the kernel's plain
version instead; given a CUDA tensor it launches the kernel or raises."""

LAUNCHES = {
    "mha_short_fwd": 0,
    "mha_short_bwd": 0,
    "flash_fwd": 0,
    "flash_bwd": 0,
    "layer_norm_bwd": 0,
    "fused_prologue_conv1x1": 0,
    "conv1x1_with_stats": 0,
}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
