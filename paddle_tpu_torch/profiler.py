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
`scan_fused_ops_removed` (net ops removed). `CounterSet` (:201-233 there)
keeps an instance's counters (the inference server's `serve_*`, a KV
cache's `kv_*`) and rolls each bump up into the global names. The spans
and tables (`RecordEvent`, `start_profiler`) are not ported."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

__all__ = ["CounterSet", "bump_counter", "set_counter", "counters", "time_counter"]

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


class CounterSet:
    """Instance-scoped counters that also roll up into the process-global
    table above: two servers in one process keep separable accounting on
    their own /healthz while global observers see both."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, int] = {}

    def bump(self, name: str, amount: int = 1) -> int:
        with self._lock:
            self._data[name] = self._data.get(name, 0) + amount
            out = self._data[name]
        bump_counter(name, amount)
        return out

    def gauge(self, name: str, value: int) -> int:
        with self._lock:
            self._data[name] = int(value)
        set_counter(name, value)
        return int(value)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._data)


@contextlib.contextmanager
def time_counter(name: str):
    """The body's wall time, in microseconds, added to the counter
    `<name>_us`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        bump_counter(name + "_us", int((time.perf_counter() - t0) * 1e6))
