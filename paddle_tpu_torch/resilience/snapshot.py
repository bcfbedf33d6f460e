"""The wire half of `paddle_tpu/resilience/snapshot.py`: the data-stream
format of a snapshot's `state.bin` (sorted-name concatenated `np.save`
records, each with an offset-indexed locator and a crc32), which the
prefill -> decode KV handoff (`inference/handoff.py`) reuses. The port's
own copy, byte for byte the same format, so a blob or a stream written by
either package reads in the other. The snapshot engine, the atomic commit
and restore come with ROADMAP Queue 1 item 8."""

from __future__ import annotations

import io as _io
import time
import zlib

import numpy as np

from .faults import fault_point

__all__ = ["FORMAT_VERSION", "pack_stream"]

FORMAT_VERSION = 1


def _array_bytes(arr: np.ndarray) -> bytes:
    buf = _io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def pack_stream(f, arrays: dict, *, fault_site: str = None,
                delay: float = 0.0):
    """Write `arrays` (name -> host array-like) to the open binary stream
    `f` as the snapshot data format: sorted-name concatenated np.save
    records. Returns
    (entries, total): each name's locator {offset, bytes, dtype, shape,
    crc32} and the stream length in bytes.

    `fault_site` names a fault_point fired before each record; `delay`
    flushes and sleeps after each record to widen kill windows."""
    entries = {}
    total = 0
    for name in sorted(arrays):
        arr = np.asarray(arrays[name])
        data = _array_bytes(arr)
        if fault_site:
            fault_point(fault_site)
        f.write(data)
        if delay:
            f.flush()
            time.sleep(delay)
        entries[name] = {
            "offset": total,
            "bytes": len(data),
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
        }
        total += len(data)
    return entries, total

