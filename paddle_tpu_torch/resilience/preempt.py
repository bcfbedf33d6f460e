"""Preemption handling, the circuit breaker and retry/backoff: the
port's own copy of `paddle_tpu/resilience/preempt.py` (stdlib only).

`PreemptionHandler` turns SIGTERM / SIGINT into a flag and an
`on_preempt` callback; the inference server's graceful drain rides on it
(`inference/server.py:serve`). Its `final_save` drains a checkpoint
manager and commits one synchronous snapshot; the port has no
`CheckpointManager` yet (ROADMAP Queue 1 item 8), so without a manager it
raises, exactly as the JAX one does.

`CircuitBreaker` is the server's predictor breaker. `retry_call` /
`backoff_delays` are the shared transient-failure wrapper (exponential
backoff, deterministic, no jitter).
"""

from __future__ import annotations

import signal
import threading
import time

__all__ = ["CircuitBreaker", "PreemptionHandler", "retry_call",
           "backoff_delays"]


class CircuitBreaker:
    """Consecutive-failure circuit-breaker state machine (the inference
    server's predictor breaker). Owns ONLY the thread-safe state transitions —
    what a "failure" is, and how to probe, stay with the caller:

    - `record_failure()` -> True when this failure TRIPS the breaker
      (streak reached `threshold` while closed).
    - `record_success()` -> True when this success CLOSES an open
      breaker (half-open trial or probe succeeded).
    - `probe_due()` -> True at most once per `probe_interval` while
      open: the caller owning that claim runs its recovery probe (a
      synthetic predict, a STAT round-trip, or simply letting one live
      request through). `probe_interval <= 0` means every call may
      probe."""

    def __init__(self, threshold=3, probe_interval=1.0):
        self.threshold = max(int(threshold), 1)
        self.probe_interval = float(probe_interval)
        self._lock = threading.Lock()
        self._streak = 0
        self._open = False
        self._last_probe = 0.0

    @property
    def open(self) -> bool:
        return self._open

    def record_failure(self) -> bool:
        with self._lock:
            self._streak += 1
            if self._streak >= self.threshold and not self._open:
                self._open = True
                self._last_probe = time.monotonic()
                return True
            return False

    def record_success(self) -> bool:
        with self._lock:
            was_open, self._open, self._streak = self._open, False, 0
            return was_open

    def probe_due(self) -> bool:
        with self._lock:
            if not self._open:
                return False
            now = time.monotonic()
            if (self.probe_interval > 0
                    and now - self._last_probe < self.probe_interval):
                return False
            self._last_probe = now
            return True


def backoff_delays(tries, base_delay=0.05, max_delay=2.0, factor=2.0):
    """Yield `tries - 1` exponentially growing sleep durations (the gaps
    BETWEEN attempts)."""
    d = float(base_delay)
    for _ in range(max(int(tries) - 1, 0)):
        yield min(d, float(max_delay))
        d *= float(factor)


def retry_call(fn, *args, tries=4, base_delay=0.05, max_delay=2.0,
               factor=2.0, retry_on=(ConnectionError, OSError, TimeoutError),
               on_retry=None, counter=None, **kwargs):
    """Call `fn(*args, **kwargs)`, retrying on `retry_on` with backoff.
    The final failure re-raises. `on_retry(exc, attempt)` observes each
    retry; `counter` names an always-on profiler counter bumped per
    retry (e.g. 'table_rpc_retries')."""
    delays = list(backoff_delays(tries, base_delay, max_delay, factor))
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= len(delays):
                raise
            if counter:
                from .. import profiler

                profiler.bump_counter(counter)
            if on_retry is not None:
                on_retry(e, attempt)
            time.sleep(delays[attempt])
            attempt += 1


class PreemptionHandler:
    """SIGTERM/SIGINT -> orderly final checkpoint.

    Usage::

        with PreemptionHandler(manager) as pre:
            for step in ...:
                exe.run(...)
                if pre.preempted:
                    pre.final_save(step, program=main, scope=scope,
                                   executor=exe)
                    break

    The signal handler itself only sets a flag (async-signal-safe; a
    SIGTERM landing mid-dispatch must not re-enter the runtime);
    `final_save` then drains the async engine and commits one blocking
    snapshot. Handlers install on the MAIN thread only (CPython
    restriction) and the previous handlers are restored on exit."""

    def __init__(self, manager=None, signals=(signal.SIGTERM, signal.SIGINT),
                 on_preempt=None):
        self._manager = manager
        self._signals = tuple(signals)
        self._on_preempt = on_preempt
        self._event = threading.Event()
        self._previous = {}
        self._received = None
        self._installed = False

    # -- lifecycle -------------------------------------------------------
    def install(self):
        if self._installed:
            return self
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _handle(self, signum, frame):
        self._received = signum
        self._event.set()
        from .. import profiler

        profiler.bump_counter("preemptions_observed")
        if self._on_preempt is not None:
            self._on_preempt(signum)

    # -- observation -----------------------------------------------------
    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    @property
    def signal_received(self):
        return self._received

    def wait(self, timeout=None):
        return self._event.wait(timeout)

    # -- the grace-window exit -------------------------------------------
    def final_save(self, step, state=None, program=None, scope=None,
                   executor=None):
        """Drain in-flight async saves, then one SYNCHRONOUS snapshot of
        the current state — returns the committed path. Safe to call
        even when not preempted (an orderly shutdown wants the same
        drain + final commit)."""
        if self._manager is None:
            raise RuntimeError("PreemptionHandler has no CheckpointManager")
        self._manager.drain()
        return self._manager.save(
            int(step), state=state, program=program, scope=scope,
            executor=executor, blocking=True,
        )
