"""Deterministic, seedable fault injection for resilience testing: the
port's own copy of `paddle_tpu/resilience/faults.py`, with the same
`FaultPlan` spec grammar and the same `PADDLE_TPU_FAULTS` variable, so one
plan spec drives a server of either package.

Named injection *sites* sit in the hot paths at effectively zero cost
when disabled — `fault_point()` is one global load + `is None` branch —
and, when a `FaultPlan` is installed, fire deterministic faults there:

    sites (wired in the port's inference/server.py):
      server.predict           admitted request, before dispatch (raise =
                               predictor failure; hold = park the request
                               deterministically, whether or not it later
                               coalesces)
      server.dispatch          INSIDE the predictor lock and the
                               dispatch-ms EWMA bracket (delay = a slow
                               substrate: the queue drains serially at the
                               injected rate and the derived Retry-After
                               reflects it)
      server.probe             the breaker's recovery probe
      server.reply             after predict, before the response write
      server.batch.dispatch    the request coalescer's batch LEADER
                               thread, after a batch seals, before its one
                               merged predictor dispatch (hold = park a
                               whole batch; raise = the merged dispatch
                               fails, every member 500s, the breaker is
                               charged once)
      server.prefill           /prefill, admitted, before the K/V
                               projection
      server.decode            /decode, after the handoff blob validates,
                               before paged admission

    sites (wired in the port's inference/registry.py):
      registry.load            a deploy, before the candidate bundle loads
      registry.cutover         a deploy, after the candidate is warmed and
                               verified, before the pointer flips (an abort
                               at either keeps the old version serving)

    sites (wired in the port's training path):
      executor.dispatch        Executor.run, before the step (the seed
                               counter has not advanced)
      trainer.step             Executor.run and the dygraph JIT, after the
                               state write-back, before the heartbeat and
                               the checkpoint hook (hold = a wedged step)
      trainer.heartbeat        the progress-file write (raise = a lost
                               heartbeat; training goes on)
      snapshot.flush.write     before each record of a snapshot's data
      snapshot.commit          just before the atomic publish rename
      fleet.kill_trainer       TrainSupervisor, once per global step first
                               reached (raise = SIGKILL that rank)
      fleet.kill_host          the same trigger; the kill is host loss
                               (with allow_shrink, the next attempt runs
                               at a smaller world)

Actions per rule: `raises=` an exception class (with `err=` an errno
name/number for OSError family), `delay=` seconds, `truncate=` the
payload of a bytes-site to N bytes, `corrupt=` XOR-flips N seeded byte
positions, `hold=` blocks until a filesystem path exists (a
*deterministic* barrier — tests synchronize on file creation, never on
sleeps). Triggers: `nth=` fires only on the Nth hit of the site
(1-based), `every=` on every Kth hit, `prob=` with the plan's seeded
per-site RNG, `times=` caps total fires. Same seed + same hit sequence
=> bit-identical fire pattern, across processes (site RNG keys off
crc32(site), not `hash()`).

Env contract (subprocess workers need no wiring):

    PADDLE_TPU_FAULTS="seed=7;server.predict:raises=RuntimeError:nth=2;\
table.client.frame:truncate=5:times=1"

installs the plan at import time of this module.
"""

from __future__ import annotations

import builtins
import contextlib
import errno as _errno_mod
import os
import random as _random
import threading
import time
import zlib

__all__ = [
    "FaultError",
    "FaultRule",
    "FaultPlan",
    "fault_point",
    "fault_bytes",
    "install",
    "clear",
    "active",
    "current_plan",
]

ENV_VAR = "PADDLE_TPU_FAULTS"

_HOLD_POLL_S = 0.002
_HOLD_TIMEOUT_S = 120.0


class FaultError(RuntimeError):
    """Default exception raised by a `raises=` rule with no class given."""


def _resolve_exception(name):
    if isinstance(name, type) and issubclass(name, BaseException):
        return name
    exc = getattr(builtins, str(name), None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    if str(name) == "FaultError":
        return FaultError
    raise ValueError(f"unknown exception class for fault rule: {name!r}")


def _resolve_errno(err):
    if err is None:
        return None
    if isinstance(err, int):
        return err
    code = getattr(_errno_mod, str(err), None)
    if not isinstance(code, int):
        raise ValueError(f"unknown errno name for fault rule: {err!r}")
    return code


class FaultRule:
    """One (site pattern, trigger, action) tuple of a FaultPlan."""

    __slots__ = (
        "site", "raises", "err", "delay", "truncate", "corrupt", "hold",
        "nth", "every", "times", "prob", "fired",
    )

    def __init__(self, site, raises=None, err=None, delay=None,
                 truncate=None, corrupt=None, hold=None, nth=None,
                 every=None, times=None, prob=None):
        self.site = str(site)
        self.raises = _resolve_exception(raises) if raises is not None else None
        self.err = _resolve_errno(err)
        if self.err is not None and self.raises is None:
            self.raises = OSError
        self.delay = float(delay) if delay is not None else None
        self.truncate = int(truncate) if truncate is not None else None
        self.corrupt = int(corrupt) if corrupt is not None else None
        self.hold = str(hold) if hold is not None else None
        self.nth = int(nth) if nth is not None else None
        self.every = int(every) if every is not None else None
        self.times = int(times) if times is not None else None
        self.prob = float(prob) if prob is not None else None
        self.fired = 0
        if not any(x is not None for x in
                   (self.raises, self.delay, self.truncate, self.corrupt,
                    self.hold)):
            raise ValueError(
                f"fault rule for {site!r} has no action (raises/delay/"
                "truncate/corrupt/hold)")

    def matches(self, site):
        if self.site == site or self.site == "*":
            return True
        return self.site.endswith(".*") and site.startswith(self.site[:-1])

    def triggers(self, hit, rng):
        """Deterministic fire decision for the `hit`-th occurrence of the
        site (1-based). `rng` is the plan's per-site seeded stream —
        consumed only when a prob gate is actually reached, so the
        sequence replays exactly for the same hit pattern."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None and hit != self.nth:
            return False
        if self.every is not None and hit % self.every != 0:
            return False
        if self.prob is not None and rng.random() >= self.prob:
            return False
        return True

    def act(self, site, hit, data, seed):
        """Apply the action; returns the (possibly transformed) data for
        bytes-sites. delay/hold first, then byte transforms, then raise."""
        if self.delay is not None:
            time.sleep(self.delay)
        if self.hold is not None:
            deadline = time.monotonic() + _HOLD_TIMEOUT_S
            while not os.path.exists(self.hold):
                if time.monotonic() > deadline:
                    raise FaultError(
                        f"hold barrier {self.hold!r} never appeared "
                        f"(site {site!r})")
                time.sleep(_HOLD_POLL_S)
        if data is not None:
            if self.truncate is not None:
                data = data[: self.truncate]
            if self.corrupt and len(data):
                # positions keyed off (seed, site, hit): bit-identical
                # corruption across runs, independent of thread timing
                r = _random.Random(
                    (int(seed) << 20) ^ zlib.crc32(site.encode()) ^ hit)
                ba = bytearray(data)
                for _ in range(self.corrupt):
                    ba[r.randrange(len(ba))] ^= 0xFF
                data = bytes(ba)
        if self.raises is not None:
            if self.err is not None and issubclass(self.raises, OSError):
                raise self.raises(
                    self.err,
                    f"{os.strerror(self.err)} [injected at {site!r} "
                    f"hit {hit}]")
            raise self.raises(f"injected fault at {site!r} (hit {hit})")
        return data

    def __repr__(self):
        parts = [f"site={self.site!r}"]
        for k in ("raises", "err", "delay", "truncate", "corrupt", "hold",
                  "nth", "every", "times", "prob"):
            v = getattr(self, k)
            if v is not None:
                parts.append(f"{k}={getattr(v, '__name__', v)!r}")
        return f"FaultRule({', '.join(parts)})"


class FaultPlan:
    """A seeded set of FaultRules plus per-site hit/fire accounting.

    Build programmatically::

        plan = (FaultPlan(seed=7)
                .add("snapshot.flush.write", raises=OSError, err="ENOSPC",
                     nth=2)
                .add("table.server.handle", delay=0.5, times=1))

    or from the env spec (`FaultPlan.from_spec`, auto-installed from
    PADDLE_TPU_FAULTS at import). `plan.hits[site]` counts every arrival
    at a site; `plan.fired[site]` counts actual injections — the chaos
    tests assert on both."""

    def __init__(self, seed=0):
        self.seed = int(seed)
        self.rules: list[FaultRule] = []
        self.hits: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self._rngs: dict[str, _random.Random] = {}
        self._lock = threading.Lock()

    def add(self, site, **kwargs):
        self.rules.append(FaultRule(site, **kwargs))
        return self

    # -- env spec --------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        plan = cls()
        for entry in str(spec).split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                plan.seed = int(entry[5:])
                continue
            fields = entry.split(":")
            site, kwargs = fields[0].strip(), {}
            if not site or "=" in site:
                raise ValueError(
                    f"bad {ENV_VAR} entry {entry!r}: expected "
                    "site:key=value[:key=value...]")
            known = {"raises", "raise", "err", "errno", "delay",
                     "truncate", "corrupt", "hold", "nth", "every",
                     "times", "prob"}

            def _is_field(f):
                return "=" in f and f.partition("=")[0].strip() in known

            i = 1
            while i < len(fields):
                if not _is_field(fields[i]):
                    raise ValueError(
                        f"bad {ENV_VAR} field {fields[i]!r} in {entry!r}")
                key, _, value = fields[i].partition("=")
                key = key.strip()
                if key == "raise":
                    key = "raises"
                if key == "errno":
                    key = "err"
                if key == "hold":
                    # a path may itself contain ':' — consume following
                    # fields until the next known key=value
                    while i + 1 < len(fields) and not _is_field(fields[i + 1]):
                        i += 1
                        value += ":" + fields[i]
                kwargs[key] = value
                i += 1
            plan.add(site, **kwargs)
        return plan

    @classmethod
    def from_env(cls):
        spec = os.environ.get(ENV_VAR)
        return cls.from_spec(spec) if spec else None

    # -- the hot-path entry ----------------------------------------------
    def _rng_for(self, site):
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = _random.Random(
                (self.seed << 1) ^ zlib.crc32(site.encode()))
        return rng

    def hit(self, site, data=None):
        with self._lock:
            hit = self.hits.get(site, 0) + 1
            self.hits[site] = hit
            rng = self._rng_for(site)
            rule = None
            for r in self.rules:
                if r.matches(site) and r.triggers(hit, rng):
                    r.fired += 1
                    self.fired[site] = self.fired.get(site, 0) + 1
                    rule = r
                    break
        if rule is None:
            return data
        # act OUTSIDE the lock: a delay/hold on one site must not
        # serialize every other site in the process
        return rule.act(site, hit, data, self.seed)

    def reset_counts(self):
        with self._lock:
            self.hits.clear()
            self.fired.clear()
            self._rngs.clear()
            for r in self.rules:
                r.fired = 0

    def __repr__(self):
        return f"FaultPlan(seed={self.seed}, rules={self.rules!r})"


# -- module-global installation (the disabled-cost contract) -------------

_PLAN: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make `plan` the process-wide active plan (replaces any previous)."""
    global _PLAN
    _PLAN = plan
    return plan


def clear():
    """Deactivate fault injection; sites return to the free path."""
    global _PLAN
    _PLAN = None


def current_plan():
    return _PLAN


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped installation: `with faults.active(plan): ...`."""
    prev = _PLAN
    install(plan)
    try:
        yield plan
    finally:
        if prev is not None:
            install(prev)
        else:
            clear()


def fault_point(site: str) -> None:
    """Named injection site for control-flow faults (raise/delay/hold).
    When no plan is installed this is one global load + branch — cheap
    enough to live in per-request and per-dispatch hot paths."""
    plan = _PLAN
    if plan is None:
        return
    plan.hit(site, None)


def fault_bytes(site: str, data: bytes) -> bytes:
    """Byte-transforming site: the active plan may truncate or corrupt
    `data` (wire frames, file payloads). Identity when disabled."""
    plan = _PLAN
    if plan is None:
        return data
    out = plan.hit(site, data)
    return data if out is None else out


# subprocess workers (the HTTP server, shard servers) inherit fault
# plans through the environment with zero wiring
if os.environ.get(ENV_VAR):
    install(FaultPlan.from_spec(os.environ[ENV_VAR]))
