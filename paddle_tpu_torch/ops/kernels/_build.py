"""Builds the hand-written CUDA kernels of csrc/ and binds them with ctypes.

Each `.cu` source has a plain C interface and becomes its own shared
library, compiled by `nvcc -gencode arch=compute_90a,code=sm_90a` at first
use. All sources compile at once (one nvcc process each) into
`build/torch_kernels/<hash>/` at the root of the checkout, where the hash
covers every source and header and the flags: an edited source rebuilds,
an unchanged tree reuses what it built. A missing nvcc or a failed build
raises; nothing falls back."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "build_dir"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# library name -> its source in csrc/
SOURCES = {
    "mha_short_fwd": "mha_short_fwd.cu",
    "mha_short_bwd": "mha_short_bwd.cu",
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "layer_norm_bwd": "layer_norm_bwd.cu",
    "fused_block": "fused_block.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, into ptxas.log
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of paddle_tpu_torch are built "
            "from csrc/ at first use and need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, all in parallel.
    Returns {name: path of the shared library}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    log = []
    for name, (proc, tmp, lib) in procs.items():
        output, _ = proc.communicate()
        log.append(f"== {SOURCES[name]} (rc {proc.returncode})\n{output}")
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)
    (out_dir / "ptxas.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library `name` (built first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


if __name__ == "__main__":
    # `python .../_build.py` builds every library, importing nothing of the
    # package (and so not torch)
    build_all()
