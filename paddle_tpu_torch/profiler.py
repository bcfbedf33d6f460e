"""Named counters, the part of `paddle_tpu/profiler.py` (:30-60, 196-198,
235-245) the ported slices call: `bump_counter`, `set_counter`,
`counters` and `time_counter`, always on and guarded by one lock (server
threads bump concurrently). The Transformer's incremental decode bumps
`cross_kv_reuse` once for each decoder layer whose cross-attention K/V
arrive as feeds. The pass manager (passes/) bumps `pass_<name>_us`,
`pass_<name>_ops_removed`, `pass_manager_us`, `program_ops_before` /
`_after`, and layout_opt sets `transpose_ops_before` / `_after` and bumps
`pass_layout_opt_transposes_removed`; fuse_layer_scan bumps
`scan_fused_runs` (runs collapsed into one `layer_scan` op),
`scan_fused_layers` (segments absorbed by those runs) and
`scan_fused_ops_removed` (net ops removed). The spans, tables and `CounterSet`
come with the server slice (ROADMAP Queue 1, item 5)."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

__all__ = ["bump_counter", "set_counter", "counters", "time_counter"]

_counters: dict[str, int] = defaultdict(int)  # monotonic named counts
# the read-modify-write below is not atomic under the GIL
_counters_lock = threading.Lock()


def bump_counter(name: str, amount: int = 1) -> int:
    """Add `amount` to the counter `name` -> its new value."""
    with _counters_lock:
        _counters[name] += amount
        return _counters[name]


def set_counter(name: str, value: int) -> int:
    """Set the counter `name` to `value` (a gauge) -> that value."""
    with _counters_lock:
        _counters[name] = int(value)
        return _counters[name]


def counters() -> dict:
    """A copy of every counter."""
    with _counters_lock:
        return dict(_counters)


@contextlib.contextmanager
def time_counter(name: str):
    """The body's wall time, in microseconds, added to the counter
    `<name>_us`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        bump_counter(name + "_us", int((time.perf_counter() - t0) * 1e6))
