"""The serving fleet: the port of `paddle_tpu/inference/fleet.py`. A
replica supervisor, a failover router and rolling drain around N
`paddle_tpu_torch.inference.server` worker processes, which share the
card (each worker has its own GIL):

    python -m paddle_tpu_torch.inference.fleet --model-dir D --replicas 3

The workers run on the card (`--device cuda`, the default) unless the
caller asks for the CPU (`--device cpu`, `worker_device="cpu"`). A card
fleet checks for the card and builds every hand-written kernel
(`ops/kernels/_build.build_all`) once, in the supervisor's process,
before the first spawn, so N workers do not each run nvcc on every
source; without a card or without nvcc `start()` raises and spawns
nothing. There is no CPU fallback.

Three layers, one process for the supervisor and router, N worker
processes:

- **FleetSupervisor** spawns N workers, each the single hardened server,
  handshakes through the `--ready-file` JSON (bind and warmup done,
  port / pid / warmup_ms machine-readable, no stdout parsing), detects
  crashes and respawns with exponential backoff
  (`resilience.preempt.backoff_delays`) gated by a per-replica respawn
  `CircuitBreaker` (a crash-looping replica stops burning spawns and
  retries once per probe interval), aggregates per-replica health, and
  performs **rolling drain/restart**: SIGTERM one replica at a time,
  wait for its graceful drain (in-flight requests complete), respawn,
  verify a warm 200 /healthz, only then move to the next.

- **FleetRouter** is one HTTP listener in front of the fleet: POST
  /predict routes to the **least-inflight live** replica (tie-break by
  replica index), forwards the body and the deadline header, and
  **fails over**: when the chosen replica dies mid-request or its
  per-replica routing breaker is open, the SAME request is retried on a
  DIFFERENT replica (/predict is idempotent server-side). Only when
  every replica is down, draining, or breaker-open does the client see
  a 503 + Retry-After shed. Replies relay byte-exact. GET /healthz
  aggregates the fleet: size, live / draining / dead counts,
  per-replica status / pid / port / inflight / restarts, router
  counters.

- **ServingFleet** wires both plus the process lifecycle: SIGTERM /
  SIGINT drain the whole fleet (router sheds first, replicas drain,
  exit 0); SIGHUP triggers a rolling restart.

Continuous batching rides below the router: each worker's own
RequestCoalescer (`--batch-window-ms`, forwarded by the CLI) merges the
requests the router spreads across replicas, and failover stays per
request: a replica killed mid-coalesced-batch fails every member of that
batch over individually. `FleetSupervisor.worker_counters()` aggregates
the worker-side serve_batch_* counters.

Replica lifecycle (observable via /healthz and `Replica.history`):

    starting -> live -> draining -> dead -> starting -> live ...
                  \\------------------^  (crash skips draining)

The router only ever sends to status == "live" replicas whose routing
breaker admits them; a status flip between pick and send surfaces as a
replica-side 503 (ServerDraining) which the router retries elsewhere.

**Disaggregated prefill/decode:** `roles=` (CLI: `--prefill-replicas /
--decode-replicas / --unified-replicas`) boots each replica as `--role
prefill|decode|unified` and turns POST /generate into a two-stage
schedule. Stage 1 routes the prompt to the live prefill replica with the
fewest queued prompt tokens (unified tier as fallback); the reply is one
opaque handoff blob (inference/handoff.py). Stage 2 places that blob on
the decode replica with the most free KV pages: the last-known /healthz
`kv` scrape (0.25 s TTL, refreshed by the X-KV-Free-Pages header on
every decode reply) minus pages already reserved by in-flight
placements. The blob is immutable in router memory and /decode is
admit -> decode -> release per request, so either stage fails over
idempotently; a fleet with no role-split replicas routes /generate
single-stage to a unified replica. /predict prefers prefill and
unified replicas so decode pools stay free for streams.

**Multi-model serving:** `registry=` (CLI: `--registry MANIFEST.json`)
boots every worker with the same model-registry manifest
(inference/registry.py): the router forwards `X-Model` / `X-Tenant`
verbatim on every stage, `FleetSupervisor.deploy(name, version,
bundle_dir)` hot-swaps one model fleet-wide one replica at a time (each
LIVE worker gets a POST /admin/deploy), and ANY failure rolls
already-deployed workers back to the old version before the error
surfaces. Fleet /healthz gains a `models` block and `worker_counters()`
folds each worker's per-model counters into `model.<name>.<counter>`
families. Registry-less fleets are byte-identical on the wire.

**Mixed backend classes:** `backend_classes=` (CLI: `--backend-classes
gpu,gpu,gpu-overflow`) declares each slot's class, a label carried from
spawn config through the `--ready-file` handshake onto every /healthz;
every worker gets the same `--device`. The router turns cost-aware: a
TTL'd stats scrape keeps per-replica queue depth and dispatch-ms EWMAs
fresh, and every /predict is planned by the pure `divert_decision` table
over the per-class queue-drain estimates (depth x EWMA / live). Requests
serve from the primary class but **divert** to the overflow class when
the primary's estimated time-to-service exceeds the request's remaining
X-Deadline-Ms budget; a **brownout controller** steers bulk QoS tenants
(the registry manifest's classes, via `registry.load_qos_config`) to the
overflow class as primary utilization crosses the steer watermark and
sheds them past the shed watermark, while gold tenants keep the primary
tier; and a **whole-tier outage** (every primary replica dead or
breaker-open) flips the router to `degraded: true` on /healthz, serves
everything from the overflow class, and clears when the primary heals.
Class-less fleets are byte-identical on the wire.

Chaos sites (resilience.faults; the `PADDLE_TPU_FAULTS` env spec
installs in this process AND every worker, so one seed drives
deterministic cross-process failure schedules): `fleet.spawn` before
each worker fork, `fleet.route.send` before a forward,
`fleet.route.recv` between the forward and the reply read, and
`fleet.kill_replica`: a FaultError fired there is caught by the router
and turned into a SIGKILL of the worker the request was just sent to.
The /generate stages use their own kill sites, `serve.handoff.send`
(prefill forward) and `serve.handoff.recv` (decode forward). Mixed
fleets add `fleet.divert` (a FaultError at the divert decision forces
the request onto the overflow class, reason "chaos") and
`fleet.tier_loss` (a FaultError there SIGKILLs every live primary-class
worker).

Counters (per fleet, rolled up into the global profiler):
fleet_spawns, fleet_replica_deaths, fleet_respawns,
fleet_respawn_failures, fleet_route_requests, fleet_failovers,
fleet_replica_503s, fleet_route_sheds, fleet_deadline_exceeded,
fleet_rolling_restarts, fleet_chaos_kills, fleet_drain_timeouts;
fleet_handoffs, fleet_handoff_ms (router-side overhead: stage-2 wall
minus the replica's X-Decode-Ms), the fleet_prefill_ms_ewma /
fleet_decode_ms_ewma gauges; fleet_deploys, fleet_deploy_failures,
fleet_deploy_rollbacks; fleet_diverts with a per-reason breakdown
(fleet_diverts.deadline / .brownout / .tier_loss / .chaos),
fleet_brownout_steered, fleet_brownout_sheds, fleet_tier_losses and the
fleet_degraded 0/1 gauge.

Every worker's /healthz also carries `kernel_launches`, its process's
hand-written kernel launch counts (a port-only block, outside
`counters`, so `worker_counters` sums nothing new).
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

from ..resilience.faults import FaultError, fault_point
from .server import JsonHandlerMixin, _Listener

__all__ = ["Replica", "FleetSupervisor", "FleetRouter", "ServingFleet",
           "divert_decision", "class_eta_ms", "class_utilization",
           "main"]

# replica lifecycle states
STARTING = "starting"
LIVE = "live"
DRAINING = "draining"
DEAD = "dead"

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _log_tail(path, limit=4000):
    """The last `limit` bytes of a worker's log, as text."""
    try:
        with open(path, "rb") as f:
            f.seek(max(os.path.getsize(path) - limit, 0))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


# -- mixed-fleet divert policy (pure functions: unit-testable with no
# -- fleet, no subprocesses — the router only feeds them measurements) --

def class_eta_ms(cls):
    """Estimated time-to-service (ms) for one MORE request landing on
    this backend class: the measured queue drains at one dispatch-EWMA
    per live replica, and the new request then pays its own dispatch.
    `cls` is {"live", "depth", "ewma_ms", ...}; None when the class has
    no dispatch estimate yet (a cold tier is not assumed slow OR
    fast)."""
    ewma = cls.get("ewma_ms")
    if not ewma or ewma <= 0:
        return None
    live = max(int(cls.get("live") or 0), 1)
    depth = max(int(cls.get("depth") or 0), 0)
    return (depth / live + 1.0) * float(ewma)


def class_utilization(cls):
    """Queue occupancy of a backend class in [0, inf): summed measured
    queue depth over summed queue capacity of its live replicas. 0.0
    when capacity is unknown — watermarks never trigger on a class the
    router has no measurements for."""
    cap = int(cls.get("capacity") or 0)
    if cap <= 0:
        return 0.0
    return max(int(cls.get("depth") or 0), 0) / cap


def divert_decision(primary, overflow, *, remaining_ms=None, bulk=False,
                    steer_watermark=0.75, shed_watermark=0.95):
    """The mixed-fleet routing decision table. `primary`/`overflow`
    summarize one backend class each: {"live": int, "depth": int
    (summed queue depth), "ewma_ms": float|None (dispatch EWMA),
    "capacity": int (summed max_queue of live replicas)}. Returns
    (target, reason) with target in {"primary", "overflow", "shed"}:

    - tier loss: no live primary -> ("overflow", "tier_loss") when the
      overflow tier is up, else ("shed", "unavailable"). Recovery is
      the same table re-evaluated: a live primary replica makes every
      non-brownout, non-deadline request plan ("primary", None) again.
    - brownout: BULK requests steer to the overflow class at primary
      utilization >= steer_watermark, and are shed outright past
      shed_watermark once the overflow class is itself unavailable or
      equally saturated (shedding while an idle overflow tier exists
      would deny service a slower substrate could still provide).
      Gold traffic never browns out — it holds the primary tier.
    - deadline divert: when the primary's estimated time-to-service
      exceeds the request's remaining budget and the overflow class
      is live and estimates BETTER (or has no estimate yet — a cold
      tier gets the chance), the request diverts.
    - otherwise ("primary", None): the steady state.
    """
    p_live = int(primary.get("live") or 0)
    o_live = int(overflow.get("live") or 0)
    if p_live <= 0:
        if o_live > 0:
            return ("overflow", "tier_loss")
        return ("shed", "unavailable")
    if bulk:
        util = class_utilization(primary)
        if util >= shed_watermark:
            if o_live > 0 and class_utilization(overflow) < shed_watermark:
                return ("overflow", "brownout")
            return ("shed", "brownout_shed")
        if util >= steer_watermark and o_live > 0:
            return ("overflow", "brownout")
    if remaining_ms is not None and remaining_ms > 0 and o_live > 0:
        p_eta = class_eta_ms(primary)
        if p_eta is not None and p_eta > remaining_ms:
            o_eta = class_eta_ms(overflow)
            if o_eta is None or o_eta <= remaining_ms or o_eta < p_eta:
                return ("overflow", "deadline")
    return ("primary", None)


class _NodelayHTTPConnection(http.client.HTTPConnection):
    """Pooled keep-alive replica connection with TCP_NODELAY: the
    replica writes its reply as many small sends, and on a kept-alive
    socket Nagle holds the later segments for the delayed ACK (~40 ms
    per request on loopback). Close-per-request clients never see it;
    the router's pool did."""

    def connect(self):
        super().connect()
        import socket as _socket

        self.sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)


class Replica:
    """One supervised worker process. All mutable fields are guarded by
    the owning supervisor's lock; `history` records every status
    transition so tests can assert the full lifecycle."""

    def __init__(self, idx, breaker_threshold, probe_interval_s,
                 role="unified", backend_class=None):
        from ..resilience import CircuitBreaker

        self.idx = int(idx)
        self.role = str(role or "unified")
        # declared substrate class (mixed fleets; None = class-less
        # legacy slot)
        self.backend_class = (str(backend_class) if backend_class
                              else None)
        self.proc = None
        self.pid = None
        self.port = None
        self.status = DEAD  # nothing spawned yet
        self.history = []
        self.inflight = 0  # router-side, concurrent forwards outstanding
        self.routed = 0  # total requests the router sent here
        self.restarts = 0  # completed respawns (not the initial spawn)
        self.warmup_ms = None
        self.live_since = None
        self.confirmed = False  # stayed live past min_uptime once
        # role-scheduler state (router-side, guarded by sup._lock):
        # queued_tokens is the least-queued-tokens prefill routing key;
        # kv_free_pages/kv_page_len mirror the replica's /healthz `kv`
        # block (kv_at = scrape time, TTL'd); reserved_pages counts
        # in-flight handoff placements not yet reflected in a scrape
        self.queued_tokens = 0
        self.kv_free_pages = None
        self.kv_page_len = None
        self.kv_at = 0.0
        self.reserved_pages = 0
        # class-routing stats, mirrored from the replica's /healthz by
        # the router's TTL'd scrape (stats_at = scrape time): measured
        # queue depth, queue capacity, and the worker's dispatch-ms
        # EWMA — the inputs to the per-class drain-rate estimate
        self.queue_depth = None
        self.max_queue = None
        self.dispatch_ms_ewma = None
        self.stats_at = 0.0
        # routing breaker: consecutive transport failures park this
        # replica; probe_due() admits one trial per interval
        self.route_breaker = CircuitBreaker(breaker_threshold,
                                            probe_interval_s)
        # respawn breaker: consecutive spawn failures / fast crashes
        # stop the respawn loop from burning forks
        self.respawn_breaker = CircuitBreaker(breaker_threshold,
                                              probe_interval_s)
        # serializes _spawn between the crash-respawn loop and a
        # concurrent rolling restart: one worker process per slot, ever
        self.spawn_lock = threading.Lock()

    def snapshot(self):
        snap = {
            "idx": self.idx,
            "role": self.role,
            "pid": self.pid,
            "port": self.port,
            "status": self.status,
            "inflight": self.inflight,
            "routed": self.routed,
            "restarts": self.restarts,
            "warmup_ms": self.warmup_ms,
            "route_breaker_open": self.route_breaker.open,
            "queued_tokens": self.queued_tokens,
            "kv_free_pages": self.kv_free_pages,
        }
        if self.backend_class is not None:
            # class-less fleets keep the legacy snapshot shape
            snap["backend_class"] = self.backend_class
        return snap


class FleetSupervisor:
    """Spawns, watches, respawns, and rolls a fleet of inference/server
    worker processes around one saved-model artifact."""

    def __init__(self, model_dir, replicas=2, *, server_args=(),
                 worker_device="cuda", ready_timeout_s=120.0,
                 monitor_interval_s=0.05, min_uptime_s=2.0,
                 respawn_base_delay_s=0.05, respawn_max_delay_s=2.0,
                 breaker_threshold=3, probe_interval_s=0.5,
                 drain_timeout_s=30.0, extra_env=None, python=None,
                 roles=None, registry=None, backend_classes=None):
        self.model_dir = str(model_dir)
        # multi-model fleets: `registry` is the manifest
        # JSON path every worker boots with. None keeps the legacy
        # single-model fleet with a byte-identical worker spawn
        # command (no --registry flag)
        self.registry = str(registry) if registry else None
        # role-split fleets: `roles` assigns each slot a
        # serving role ("prefill" | "decode" | "unified") and overrides
        # the replica count. None keeps the legacy all-unified fleet
        # with a byte-identical worker spawn command (no --role flag)
        self.roles = list(roles) if roles else None
        if self.roles is not None:
            bad = [r for r in self.roles
                   if r not in ("prefill", "decode", "unified")]
            if bad:
                raise ValueError(f"unknown fleet roles: {bad}")
            replicas = len(self.roles)
        # mixed fleets: `backend_classes` assigns each slot a declared
        # class label (one entry per replica, e.g. ["gpu", "gpu",
        # "gpu-overflow"]) and overrides the replica
        # count. None keeps the class-less legacy fleet with a
        # byte-identical worker spawn command (no --backend-class flag)
        self.backend_classes = ([str(c) for c in backend_classes]
                                if backend_classes else None)
        if self.backend_classes is not None:
            if any(not c for c in self.backend_classes):
                raise ValueError("backend_classes entries must be "
                                 "non-empty class names")
            if (self.roles is not None
                    and len(self.backend_classes) != len(self.roles)):
                raise ValueError(
                    f"backend_classes ({len(self.backend_classes)}) and "
                    f"roles ({len(self.roles)}) must assign the same "
                    f"number of replica slots")
            replicas = len(self.backend_classes)
        self.n = max(int(replicas), 1)
        self.server_args = list(server_args)
        if worker_device not in ("cuda", "cpu"):
            raise ValueError(f"worker_device must be 'cuda' or 'cpu', "
                             f"got {worker_device!r}")
        self.worker_device = worker_device
        self.ready_timeout_s = float(ready_timeout_s)
        self.monitor_interval_s = float(monitor_interval_s)
        self.min_uptime_s = float(min_uptime_s)
        self.respawn_base_delay_s = float(respawn_base_delay_s)
        self.respawn_max_delay_s = float(respawn_max_delay_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.extra_env = dict(extra_env or {})
        self.python = python or sys.executable

        self._lock = threading.RLock()
        self.replicas = [
            Replica(i, breaker_threshold, probe_interval_s,
                    role=(self.roles[i] if self.roles else "unified"),
                    backend_class=(self.backend_classes[i]
                                   if self.backend_classes else None))
            for i in range(self.n)]
        # role_counters on /healthz is a TTL-cached worker scrape so
        # health pollers don't multiply into per-worker scrape storms
        self._role_counters_cache = (0.0, None)
        self._role_cache_lock = threading.Lock()
        # models on /healthz is the same TTL-cached scrape discipline
        # (registry fleets only)
        self._models_cache = (0.0, None)
        self._models_cache_lock = threading.Lock()
        self._dir = tempfile.mkdtemp(prefix="ptpu_fleet_")
        self._stop = threading.Event()
        self._monitor_thread = None
        self._respawning = set()  # replica idxs with a respawn loop alive
        self._roll_lock = threading.Lock()  # one rolling restart at a time
        from .. import profiler

        self.counters = profiler.CounterSet()

    # -- counters ---------------------------------------------------------
    def bump(self, name, amount=1):
        self.counters.bump(name, amount)

    # -- lifecycle --------------------------------------------------------
    def start(self):
        """Spawn all replicas concurrently and wait until every one is
        live (ready handshake + warm healthz). Then start the crash
        monitor. A card fleet first checks for the card and builds
        every kernel once here (N workers would otherwise each run nvcc
        on every source at once); either failure raises before any
        spawn."""
        if self.worker_device == "cuda":
            try:
                self._prebuild_kernels()
            except BaseException:
                self.stop()
                raise
        errors = []

        def boot(rep):
            try:
                self._spawn(rep)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(f"replica {rep.idx}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=boot, args=(r,), daemon=True)
                   for r in self.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self.stop()
            raise RuntimeError("fleet start failed: " + "; ".join(errors))
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="fleet-monitor")
        self._monitor_thread.start()
        return self

    def stop(self, drain=True):
        """Stop the fleet: no more respawns, SIGTERM every worker (they
        drain in-flight requests), SIGKILL stragglers past the drain
        timeout."""
        self._stop.set()
        procs = []
        with self._lock:
            for rep in self.replicas:
                if rep.proc is not None and rep.proc.poll() is None:
                    self._set_status(rep, DRAINING)
                    try:
                        rep.proc.send_signal(
                            signal.SIGTERM if drain else signal.SIGKILL)
                    except OSError:
                        pass
                    procs.append((rep, rep.proc))
        deadline = time.monotonic() + (self.drain_timeout_s if drain
                                       else 5.0)
        for rep, proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self.bump("fleet_drain_timeouts")
                proc.kill()
                proc.wait(timeout=10)
            with self._lock:
                self._set_status(rep, DEAD)
        # respawn threads are daemons: a spawn in flight when _stop was
        # set has an UNpublished worker proc only that thread can kill
        # (the publish critical section and the _wait loops all abort
        # on _stop) — wait for them to drain or the process could exit
        # over an orphan inference server
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with self._lock:
                if not self._respawning:
                    break
            time.sleep(0.01)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
        import shutil

        shutil.rmtree(self._dir, ignore_errors=True)

    # -- spawning ---------------------------------------------------------
    @staticmethod
    def _prebuild_kernels():
        from ..ops.kernels import _build
        from ..place import CUDAPlace

        CUDAPlace(0).torch_device()  # raises without a card
        return _build.build_all()

    def _worker_env(self):
        env = dict(os.environ)
        env.update(self.extra_env)
        # workers must import paddle_tpu_torch regardless of the caller's
        # cwd; the caller's PADDLE_TPU_FAULTS passes through, so one seed
        # drives the workers' chaos
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get(
            "PYTHONPATH", "")
        # the workers import no JAX: the caller's JAX_* settings are
        # none of theirs
        for k in [k for k in env if k.startswith("JAX_")]:
            del env[k]
        return env

    def _spawn(self, rep):
        """Fork one worker and block until its ready-file handshake
        lands (bind + warmup done) and /healthz answers 200. Raises on
        spawn failure, early exit, or ready timeout — and EVERY failure
        path lands the slot back on DEAD: a phantom 'starting' with no
        process behind it would lie on /healthz and in the lifecycle
        history (the chaos site sits after the status flip exactly so a
        failed attempt reads starting -> dead)."""
        with self._lock:
            self._set_status(rep, STARTING)
        try:
            return self._spawn_attempt(rep)
        except BaseException:
            with self._lock:
                if rep.status == STARTING:
                    self._set_status(rep, DEAD)
            raise

    def _spawn_attempt(self, rep):
        fault_point("fleet.spawn")
        self.bump("fleet_spawns")
        ready = os.path.join(self._dir, f"replica-{rep.idx}.ready")
        try:
            os.unlink(ready)
        except FileNotFoundError:
            pass
        cmd = [self.python, "-m", "paddle_tpu_torch.inference.server",
               "--model-dir", self.model_dir, "--port", "0",
               "--ready-file", ready, "--device", self.worker_device]
        cmd += self.server_args
        if self.registry is not None:
            # only registry fleets pass --registry: the legacy spawn
            # command stays byte-identical for single-model fleets
            cmd += ["--registry", self.registry]
        if self.roles is not None:
            # only role-split fleets pass --role: the legacy spawn
            # command stays byte-identical for all-unified fleets
            cmd += ["--role", rep.role]
        if self.backend_classes is not None:
            # only mixed fleets pass --backend-class: the legacy spawn
            # command stays byte-identical for class-less fleets
            cmd += ["--backend-class", rep.backend_class]
        log_path = os.path.join(self._dir, f"replica-{rep.idx}.log")
        log = open(log_path, "ab")
        try:
            proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                    env=self._worker_env(),
                                    cwd=_REPO_ROOT)
        finally:
            log.close()  # the child holds its own fd now
        deadline = time.monotonic() + self.ready_timeout_s
        while not os.path.exists(ready):
            rc = proc.poll()
            if rc is not None:
                # the log's tail rides the error: a failed start() removes
                # the fleet's directory, log and all
                raise RuntimeError(
                    f"replica {rep.idx} exited rc={rc} before ready "
                    f"(log: {log_path}):\n{_log_tail(log_path)}")
            if time.monotonic() > deadline:
                proc.kill()
                proc.wait(timeout=10)
                raise TimeoutError(
                    f"replica {rep.idx} never wrote its ready file "
                    f"within {self.ready_timeout_s}s:\n{_log_tail(log_path)}")
            if self._stop.is_set():
                proc.kill()
                proc.wait(timeout=10)
                raise RuntimeError("fleet stopping")
            time.sleep(0.01)
        with open(ready) as f:
            info = json.load(f)
        try:
            if (rep.backend_class is not None
                    and info.get("backend_class") != rep.backend_class):
                # the handshake must echo the declared class: a worker
                # serving as the wrong substrate would poison every
                # per-class drain estimate the router builds on it
                raise RuntimeError(
                    f"replica {rep.idx} ready handshake echoed "
                    f"backend_class {info.get('backend_class')!r}, "
                    f"expected {rep.backend_class!r}")
            self._wait_healthz_ok(int(info["port"]),
                                  deadline - time.monotonic(), rep.idx,
                                  proc=proc)
        except Exception:
            # the worker is alive but unverified and NOT yet published
            # to rep.proc — kill it here or nothing ever will (stop()
            # only signals published procs) and the respawn loop would
            # fork a second worker for this slot
            proc.kill()
            proc.wait(timeout=10)
            raise
        with self._lock:
            # the stop check and the LIVE publish share one critical
            # section: stop() sets _stop BEFORE taking this lock for
            # its teardown snapshot, so a worker is either published
            # here (and torn down by stop) or killed below — never a
            # leaked orphan that went live after the snapshot
            stopping = self._stop.is_set()
            if not stopping:
                rep.proc = proc
                rep.pid = int(info["pid"])
                rep.port = int(info["port"])
                rep.warmup_ms = info.get("warmup_ms")
                rep.live_since = time.monotonic()
                rep.confirmed = False
                self._set_status(rep, LIVE)
        if not stopping:
            print(f"fleet: replica {rep.idx} live on port {info['port']} "
                  f"(pid {info['pid']}, {self.worker_device}, warmup "
                  f"{info.get('warmup_ms')} ms)", flush=True)
        if stopping:
            proc.kill()
            proc.wait(timeout=10)
            raise RuntimeError("fleet stopping")
        # a fresh worker starts with a clean slate: transport failures
        # accumulated against the dead predecessor must not keep the
        # router's breaker latched against this replica slot
        rep.route_breaker.record_success()
        return rep

    @staticmethod
    def _healthz(port, timeout=5.0):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=timeout) as r:
            return r.status, json.loads(r.read())

    def _wait_healthz_ok(self, port, budget_s, idx, proc=None):
        """Warm-healthz verification: the ready file proves bind+warmup,
        this proves the serving loop answers — the rolling restart must
        not advance to the next replica on anything weaker."""
        deadline = time.monotonic() + max(float(budget_s), 1.0)
        last = None
        while time.monotonic() < deadline:
            # a worker that dies between ready file and serving loop
            # must fail the attempt now, not after the full healthz
            # budget — a rolling restart would otherwise stall ~2min
            # per dead worker
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"replica {idx} exited rc={proc.returncode} after "
                    f"ready handshake, before warm /healthz ({last})")
            if self._stop.is_set():
                # abort fast on fleet stop: raising sends the caller
                # down its kill-the-unpublished-worker path, so stop()
                # can wait for every in-flight spawn to converge
                # instead of the process exiting over an orphan
                raise RuntimeError("fleet stopping")
            try:
                code, body = self._healthz(port)
                if code == 200 and body.get("status") == "ok":
                    return body
                last = f"healthz {code} {body.get('status')}"
            except (urllib.error.URLError, OSError, ValueError) as e:
                last = f"{type(e).__name__}: {e}"
            time.sleep(0.02)
        raise TimeoutError(
            f"replica {idx} never reached a warm 200 /healthz ({last})")

    def _set_status(self, rep, status):
        # caller holds self._lock
        if rep.status != status:
            rep.status = status
            rep.history.append(status)
            # bounded: a slot crash-looping at the breaker's probe
            # cadence appends ~4 entries/s indefinitely — the counters
            # hold the totals, history holds the recent lifecycle
            if len(rep.history) > 512:
                del rep.history[:-256]

    # -- crash detection + respawn ---------------------------------------
    def _monitor(self):
        while not self._stop.is_set():
            for rep in self.replicas:
                with self._lock:
                    proc, status = rep.proc, rep.status
                    if (status == LIVE and not rep.confirmed
                            and rep.live_since is not None
                            and (time.monotonic() - rep.live_since
                                 > self.min_uptime_s)):
                        # survived min_uptime: the respawn breaker's
                        # failure streak resets
                        rep.confirmed = True
                        rep.respawn_breaker.record_success()
                if (status == LIVE and proc is not None
                        and proc.poll() is not None):
                    # crash (an orderly drain flips status first) — the
                    # status is re-checked under the lock so a drain
                    # that began after the read above can't be
                    # mistaken for a crash and double-respawned
                    with self._lock:
                        if rep.status != LIVE or rep.proc is not proc:
                            continue
                        fast = (rep.live_since is not None
                                and (time.monotonic() - rep.live_since
                                     < self.min_uptime_s))
                        self._set_status(rep, DEAD)
                    self.bump("fleet_replica_deaths")
                    if fast:
                        rep.respawn_breaker.record_failure()
                    self._schedule_respawn(rep)
            self._stop.wait(self.monitor_interval_s)

    def _schedule_respawn(self, rep):
        with self._lock:
            if rep.idx in self._respawning or self._stop.is_set():
                return
            self._respawning.add(rep.idx)
        threading.Thread(target=self._respawn_loop, args=(rep,),
                         daemon=True,
                         name=f"fleet-respawn-{rep.idx}").start()

    def _respawn_loop(self, rep):
        """Respawn with exponential backoff (resilience.preempt's
        backoff_delays schedule); the respawn breaker turns a crash-loop
        / fork-fail streak into one attempt per probe interval instead
        of a hot loop."""
        from ..resilience.preempt import backoff_delays

        delays = backoff_delays(
            tries=1 << 20, base_delay=self.respawn_base_delay_s,
            max_delay=self.respawn_max_delay_s)
        try:
            while not self._stop.is_set():
                if (rep.respawn_breaker.open
                        and not rep.respawn_breaker.probe_due()):
                    self._stop.wait(self.monitor_interval_s)
                    continue
                try:
                    with rep.spawn_lock:
                        with self._lock:
                            if rep.status != DEAD:
                                # someone else (a rolling restart)
                                # already refilled this slot
                                return
                        self._spawn(rep)
                except Exception:  # noqa: BLE001 — retried with backoff
                    self.bump("fleet_respawn_failures")
                    rep.respawn_breaker.record_failure()
                    if self._stop.wait(next(delays,
                                            self.respawn_max_delay_s)):
                        return
                    continue
                with self._lock:
                    rep.restarts += 1
                self.bump("fleet_respawns")
                return
        finally:
            with self._lock:
                self._respawning.discard(rep.idx)
                stranded = rep.status == DEAD and not self._stop.is_set()
            if stranded:
                # a crash that landed between our last status check and
                # this exit was dropped by _schedule_respawn (it saw us
                # still registered) — re-arm or the slot stays dead
                # forever and the fleet silently shrinks
                self._schedule_respawn(rep)

    # -- rolling restart --------------------------------------------------
    def rolling_restart(self):
        """Drain/restart every replica, ONE at a time: SIGTERM, wait for
        the graceful drain to finish, respawn, verify a warm 200
        /healthz, then move on. With N >= 2 the fleet keeps serving
        throughout (the router routes around the draining slot)."""
        with self._roll_lock:
            self.bump("fleet_rolling_restarts")
            rolled = []
            for rep in self.replicas:
                self._restart_one(rep)
                rolled.append(rep.idx)
            return rolled

    def _restart_one(self, rep):
        with self._lock:
            proc = rep.proc
            if proc is not None and proc.poll() is None:
                # router stops sending BEFORE the SIGTERM lands
                self._set_status(rep, DRAINING)
            else:
                proc = None
        if proc is not None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass  # crashed and reaped between the poll and the kill
            try:
                proc.wait(timeout=self.drain_timeout_s + 10.0)
            except subprocess.TimeoutExpired:
                self.bump("fleet_drain_timeouts")
                proc.kill()
                proc.wait(timeout=10)
        with self._lock:
            # a crash-respawn _spawn may be mid-handshake (STARTING) or
            # may have just published an equally fresh LIVE worker into
            # the slot: flipping either DEAD would lie on /healthz —
            # and for the LIVE case would orphan a running process
            # (stop() only signals the published proc, and the spawn
            # below would overwrite it with a second worker)
            if (rep.status == LIVE and rep.proc is not None
                    and rep.proc.poll() is None):
                pass  # already_refilled below skips the spawn
            elif rep.status != STARTING:
                self._set_status(rep, DEAD)
        with rep.spawn_lock:
            with self._lock:
                already_refilled = rep.status == LIVE
            if not already_refilled:
                # (a crash-respawn loop may have refilled the slot with
                # an equally fresh worker while we drained — then
                # there's nothing left to do)
                try:
                    self._spawn(rep)
                except Exception:
                    # the roll failed here — _spawn left the slot DEAD;
                    # hand the hole to the backoff respawn loop so the
                    # fleet still heals, then surface it
                    self._schedule_respawn(rep)
                    raise
                with self._lock:
                    rep.restarts += 1
                self.bump("fleet_respawns")

    # -- hot-swap deploys -------------------------------------------------
    @staticmethod
    def _post_json(port, path, payload, timeout=120.0):
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except ValueError:
                return e.code, {}

    def deploy(self, name, version, bundle_dir=None, *, tolerance=0.01,
               deploy_timeout_s=120.0):
        """Hot-swap model `name` to `version` fleet-wide: each LIVE
        worker gets a POST /admin/deploy (the worker warms, probes,
        drift-gates, and atomically cuts over its own registry — see
        inference/registry.py), one replica at a time under the same
        `_roll_lock` as rolling_restart so a concurrent roll cannot
        interleave. ANY failure — a worker 4xx/5xx, a SIGKILLed worker
        dropping the connection — rolls every already-deployed worker
        back to the old version (drift gate off: the old bundle is by
        definition the verified baseline) and re-raises, so the old
        version stays authoritative fleet-wide. The deploy is refused
        unless every replica is LIVE: deploying around a dead slot
        would skew versions when the respawn boots from the manifest
        (which still names the old version)."""
        if self.registry is None:
            raise RuntimeError(
                "fleet has no model registry: boot with registry="
                "MANIFEST.json to hot-swap models")
        with self._roll_lock:
            with self._lock:
                targets = [(r.idx, r.port) for r in self.replicas
                           if r.status == LIVE and r.port]
                total = self.n
            if len(targets) != total:
                raise RuntimeError(
                    f"deploy refused: {total - len(targets)} of {total} "
                    f"replicas are not live (a partial deploy would skew "
                    f"model versions across the fleet)")
            # the rollback target is the old version as the FIRST
            # worker's registry reports it — every worker booted from
            # the same manifest, so pre-deploy they agree
            _, health0 = self._healthz(targets[0][1])
            old = (health0.get("models") or {}).get(name)
            if old is None:
                raise KeyError(f"no model named {name!r} in the fleet "
                               f"registry")
            old_spec = {"name": name, "version": old.get("version"),
                        "bundle_dir": old.get("bundle_dir"),
                        "tolerance": None}
            self.bump("fleet_deploys")
            payload = {"name": name, "version": version,
                       "bundle_dir": bundle_dir, "tolerance": tolerance}
            done = []
            for idx, port in targets:
                try:
                    code, body = self._post_json(
                        port, "/admin/deploy", payload,
                        timeout=deploy_timeout_s)
                except (urllib.error.URLError, OSError, ValueError) as e:
                    code, body = None, {"error": type(e).__name__,
                                        "message": str(e)}
                if code != 200:
                    self.bump("fleet_deploy_failures")
                    self._rollback_deploy(done, old_spec,
                                          deploy_timeout_s)
                    raise RuntimeError(
                        f"deploy of {name}@{version} failed on replica "
                        f"{idx}: {body.get('error')}: "
                        f"{body.get('message')}"
                        + (f" — rolled {len(done)} replica(s) back to "
                           f"{old_spec['version']}" if done else ""))
                done.append((idx, port))
            return {"name": name, "version": version,
                    "replicas": [i for i, _ in done]}

    def _rollback_deploy(self, done, old_spec, timeout):
        """Best-effort re-deploy of the old bundle on every worker that
        already cut over, so a mid-deploy failure never settles the
        fleet on a version skew. Best-effort because a worker that dies
        here heals harder: its respawn boots from the manifest, which
        still names the old version."""
        for idx, port in done:
            try:
                code, _ = self._post_json(port, "/admin/deploy",
                                          old_spec, timeout=timeout)
            except (urllib.error.URLError, OSError, ValueError):
                code = None
            if code == 200:
                self.bump("fleet_deploy_rollbacks")

    # -- health -----------------------------------------------------------
    def worker_counters(self, by_role=False):
        """Aggregate of the live workers' /healthz counter snapshots
        (monotonic counters summed, gauges by max) — the
        fleet-level view of the per-replica serve_* accounting (the
        coalescing counters serve_batches / serve_batch_members /
        serve_coalesce_wait_ms live worker-side; the router cannot see
        how requests merged). Since the server merges its paged cache's
        CounterSet into /healthz counters, the kv_* family (pages,
        evictions, decode streams) aggregates here too — kv occupancy
        gauges (kv_pages_in_use, kv_decode_streams, kv_slots_inflight)
        are per-replica pool occupancies, so SUM is the correct fleet
        total for them. `by_role=True` returns {role: totals} instead
        of one flat dict. Best-effort: a worker that dies mid-scrape
        just drops out of the sum.

        Registry fleets additionally fold each worker's per-model
        registry snapshots into `model.<name>.<counter>` families
        (plus `model.<name>.serve_dispatch_ms_ewma` and
        `model.<name>.serve_queue_depth` synthesized from the
        snapshot's EWMA/inflight gauges), same sum-vs-max discipline
        keyed by the bare counter name."""
        # gauges must not SUM across replicas (two workers each at
        # batch-size-p50 4 are not a fleet p50 of 8) — aggregate those
        # with max instead
        gauge_keys = {"serve_batch_size_p50", "serve_dispatch_ms_ewma",
                      "serve_queue_depth", "serve_prefill_ms_ewma",
                      "serve_decode_ms_ewma"}

        def _note(total, k, v, gauge):
            if gauge:
                total[k] = max(total.get(k, 0), v)
            else:
                total[k] = total.get(k, 0) + v

        with self._lock:
            targets = [(r.port, r.role) for r in self.replicas
                       if r.status == LIVE and r.port]
        per_role = {}
        for port, role in targets:
            try:
                _, body = self._healthz(port)
            except (urllib.error.URLError, OSError, ValueError):
                continue
            total = per_role.setdefault(body.get("role", role), {})
            for k, v in (body.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    _note(total, k, v, k in gauge_keys)
            for mname, snap in sorted((body.get("models") or {}).items()):
                fam = f"model.{mname}."
                for k, v in (snap.get("counters") or {}).items():
                    if isinstance(v, (int, float)):
                        _note(total, fam + k, v, k in gauge_keys)
                ewma = snap.get("dispatch_ms_ewma")
                if isinstance(ewma, (int, float)):
                    _note(total, fam + "serve_dispatch_ms_ewma", ewma,
                          True)
                infl = snap.get("inflight")
                if isinstance(infl, (int, float)):
                    _note(total, fam + "serve_queue_depth", infl, True)
        if by_role:
            return per_role
        flat = {}
        for total in per_role.values():
            for k, v in total.items():
                # per-model keys classify by their BARE counter name
                # (`model.alt.serve_queue_depth` aggregates like
                # `serve_queue_depth`); plain keys are unchanged
                _note(flat, k, v, k.rsplit(".", 1)[-1] in gauge_keys)
        return flat

    def role_counters(self):
        """TTL-cached per-role worker counter aggregate for the fleet
        /healthz (a health poller must not turn into a per-worker
        scrape storm)."""
        with self._role_cache_lock:
            at, val = self._role_counters_cache
            if val is not None and time.monotonic() - at < 1.0:
                return val
        val = self.worker_counters(by_role=True)
        with self._role_cache_lock:
            self._role_counters_cache = (time.monotonic(), val)
        return val

    def fleet_models(self):
        """TTL-cached per-model aggregate of the live workers' registry
        `models` healthz blocks: replicas serving, version set (a
        mid-deploy fleet transiently shows two), summed inflight,
        breaker-open count, max dispatch EWMA. Registry fleets only —
        the fleet /healthz `models` block."""
        with self._models_cache_lock:
            at, val = self._models_cache
            if val is not None and time.monotonic() - at < 1.0:
                return val
        with self._lock:
            ports = [r.port for r in self.replicas
                     if r.status == LIVE and r.port]
        agg = {}
        for port in ports:
            try:
                _, body = self._healthz(port)
            except (urllib.error.URLError, OSError, ValueError):
                continue
            for mname, snap in (body.get("models") or {}).items():
                cur = agg.setdefault(mname, {
                    "versions": set(), "replicas": 0, "inflight": 0,
                    "breaker_open": 0, "dispatch_ms_ewma": None,
                    "quantized": False, "default": False})
                cur["versions"].add(snap.get("version"))
                cur["replicas"] += 1
                cur["inflight"] += int(snap.get("inflight") or 0)
                cur["breaker_open"] += 1 if snap.get("breaker_open") else 0
                ewma = snap.get("dispatch_ms_ewma")
                if isinstance(ewma, (int, float)):
                    cur["dispatch_ms_ewma"] = max(
                        cur["dispatch_ms_ewma"] or 0.0, float(ewma))
                cur["quantized"] = (cur["quantized"]
                                    or bool(snap.get("quantized")))
                cur["default"] = (cur["default"]
                                  or bool(snap.get("default")))
        out = {}
        for mname in sorted(agg):
            cur = agg[mname]
            cur["versions"] = sorted(v for v in cur["versions"]
                                     if v is not None)
            out[mname] = cur
        with self._models_cache_lock:
            self._models_cache = (time.monotonic(), out)
        return out

    def health(self):
        with self._lock:
            reps = [r.snapshot() for r in self.replicas]
        counters = self.counters.snapshot()
        counts = {s: 0 for s in (STARTING, LIVE, DRAINING, DEAD)}
        for r in reps:
            counts[r["status"]] = counts.get(r["status"], 0) + 1
        status = ("ok" if counts[LIVE] == self.n
                  else "unavailable" if counts[LIVE] == 0 else "degraded")
        payload = {
            "status": status,
            "replicas": self.n,
            "live": counts[LIVE],
            "starting": counts[STARTING],
            "draining": counts[DRAINING],
            "dead": counts[DEAD],
            "replica_status": reps,
            "counters": counters,
        }
        if self.roles is not None:
            role_live = {}
            for r in reps:
                role_live.setdefault(r["role"], [0, 0])
                role_live[r["role"]][0] += 1
                if r["status"] == LIVE:
                    role_live[r["role"]][1] += 1
            payload["roles"] = {role: {"replicas": t, "live": lv}
                                for role, (t, lv) in role_live.items()}
            payload["role_counters"] = self.role_counters()
        if self.backend_classes is not None:
            cls_live = {}
            for r in reps:
                cls = r.get("backend_class")
                cls_live.setdefault(cls, [0, 0])
                cls_live[cls][0] += 1
                if r["status"] == LIVE:
                    cls_live[cls][1] += 1
            payload["backend_classes"] = {
                cls: {"replicas": t, "live": lv}
                for cls, (t, lv) in cls_live.items()}
        if self.registry is not None:
            payload["models"] = self.fleet_models()
        return payload


class FleetRouter:
    """One HTTP listener that fronts a FleetSupervisor's replicas:
    least-inflight routing, cross-replica failover, aggregate healthz,
    end-to-end client deadlines, its own bounded admission
    (max_inflight), 503 + Retry-After sheds only when nothing can serve
    or the cap is hit."""

    def __init__(self, supervisor, port=0, replica_timeout_s=60.0,
                 request_timeout_s=60.0, max_body_bytes=64 << 20,
                 max_inflight=64, primary_class=None, overflow_class=None,
                 brownout_steer=0.75, brownout_shed=0.95):
        self.sup = supervisor
        self.replica_timeout_s = float(replica_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        # mixed-fleet routing config: the primary class serves by
        # default, the overflow class absorbs diverts/brownouts/tier
        # loss. Defaults derive from the supervisor's declared classes
        # (first listed = primary, first OTHER class = overflow); a
        # fleet with fewer than two distinct classes routes class-blind
        self.primary_class = primary_class
        self.overflow_class = overflow_class
        declared = list(dict.fromkeys(supervisor.backend_classes or []))
        if self.primary_class is None and declared:
            self.primary_class = declared[0]
        if self.overflow_class is None:
            others = [c for c in declared if c != self.primary_class]
            if others:
                self.overflow_class = others[0]
        self.brownout_steer = float(brownout_steer)
        self.brownout_shed = float(brownout_shed)
        # degraded mode: the whole primary tier is out and the overflow
        # class is carrying everything (fleet_degraded gauge mirrors it)
        self._degraded = False
        self._degraded_lock = threading.Lock()
        self._qos_cfg = None
        self._qos_loaded = False
        self._qos_lock = threading.Lock()
        # the router's OWN admission bound: every replica slow/parked
        # must shed fast with 503, not pin an unbounded handler thread
        # per client for replica_timeout_s — the same bounded-admission
        # property the single server is built around, one layer up
        self.max_inflight = max(int(max_inflight), 1)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._draining = False
        # keep-alive connection pool, {(replica idx, port): [conns]} —
        # the hot path must not pay a TCP handshake per request; the
        # port in the key invalidates a respawned slot's old conns
        self._pool = {}
        self._pool_lock = threading.Lock()
        # router-side per-stage dispatch EWMAs (fleet_prefill_ms_ewma /
        # fleet_decode_ms_ewma), published as supervisor counter gauges
        self._stage_ewma = {}
        self._stage_ewma_lock = threading.Lock()
        # the server's listener (a backlog of 1024, not the stdlib's 5,
        # which drops the connects of a burst of clients)
        self._httpd = _Listener(("127.0.0.1", port), self._make_handler())
        self.port = self._httpd.server_address[1]

    # -- replica selection ------------------------------------------------
    def _pick(self, exclude, tiers=None, order=None, classes=None):
        """Least-inflight live replica (tie-break: lowest index) whose
        routing breaker is closed; when every live candidate's breaker
        is open, fall back to one whose probe is due. The probe_due()
        slot is claimed only HERE, where the trial request will really
        be sent — a losing candidate must not burn its once-per-
        interval recovery chance. `exclude` holds indices already tried
        for this request — failover never re-picks them.

        Role-split scheduling: `tiers` is an ordered sequence of role
        tuples — the first tier with a live candidate wins (e.g.
        (("prefill",), ("unified",)) = prefill replicas, falling back
        to unified when the role is absent; None = every live replica,
        the legacy fleet behavior). `classes` is the same ordered-tier
        filter over declared backend classes (mixed fleets: e.g.
        (("gpu",), ("gpu-overflow",)) = primary first, overflow as
        fallback); it composes with `tiers` — class tier first, then
        role tier within it. `order` replaces the least-inflight sort
        key (smaller wins), e.g. least-queued-tokens for prefill
        dispatch."""
        if order is None:
            order = lambda r: (r.inflight, r.idx)  # noqa: E731
        with self.sup._lock:
            live = [r for r in self.sup.replicas
                    if r.idx not in exclude and r.status == LIVE]
            if classes is not None:
                for ctier in classes:
                    sel = [r for r in live if r.backend_class in ctier]
                    if sel:
                        live = sel
                        break
                else:
                    live = []
            if tiers is not None:
                for tier in tiers:
                    sel = [r for r in live if r.role in tier]
                    if sel:
                        live = sel
                        break
                else:
                    live = []
            best = None
            open_candidates = []
            for rep in live:
                if rep.route_breaker.open:
                    open_candidates.append(rep)
                    continue
                if best is None or order(rep) < order(best):
                    best = rep
            # the once-per-interval recovery trial outranks the healthy
            # pick: a latched LIVE replica (e.g. breaker tripped by
            # deadline-capped timeouts) would otherwise never see
            # traffic while any closed-breaker peer exists — no success
            # could ever close it, and the fleet runs short a replica
            # forever. probe_due() claims the slot, so at most one
            # request per interval is diverted to the trial; stop at
            # the first due candidate so losers keep their claim.
            # EXCEPT on a failover retry (exclude non-empty) with a
            # healthy candidate in hand: a request that already failed
            # once must not be the sacrificial probe against a
            # known-failing replica — fresh traffic runs the trials.
            # And at most ONE trial outstanding per open replica
            # (inflight == 0): a wedged-but-alive worker holds each
            # trial for up to replica_timeout_s, so unbounded diversion
            # would park ~probe-rate x timeout concurrent requests
            # there and exhaust the router's own admission cap — one
            # wedged replica must cost the fleet one replica, not the
            # whole router.
            if best is None or not exclude:
                for rep in open_candidates:
                    if (rep.inflight == 0
                            and rep.route_breaker.probe_due()):
                        best = rep
                        break
            if best is not None:
                best.inflight += 1
                best.routed += 1
            return best

    def _release(self, rep):
        with self.sup._lock:
            rep.inflight -= 1

    # -- forwarding -------------------------------------------------------
    def _conn_get(self, rep, timeout, fresh=False):
        """A pooled keep-alive connection to this replica incarnation,
        or a fresh one. Returns (conn, reused)."""
        if not fresh:
            with self._pool_lock:
                # a respawned slot has a new port: its predecessor's
                # pooled conns are dead weight — drop them
                stale = [k for k in self._pool
                         if k[0] == rep.idx and k[1] != rep.port]
                for k in stale:
                    for c in self._pool.pop(k):
                        c.close()
                stack = self._pool.get((rep.idx, rep.port))
                if stack:
                    conn = stack.pop()
                    if conn.sock is not None:
                        conn.sock.settimeout(timeout)
                    conn.timeout = timeout
                    return conn, True
        return _NodelayHTTPConnection("127.0.0.1", rep.port,
                                      timeout=timeout), False

    def _conn_put(self, rep, conn):
        with self._pool_lock:
            stack = self._pool.setdefault((rep.idx, rep.port), [])
            if len(stack) < 4 and conn.sock is not None:
                stack.append(conn)
                return
        conn.close()

    def _forward(self, rep, body, headers, timeout=None,
                 path="/predict", kill_site="fleet.kill_replica"):
        """One attempt against one replica. Returns (status, headers,
        body); raises OSError/HTTPException family on transport death
        (the failover triggers). A transport failure on a REUSED pooled
        connection is retried once on a fresh socket against the SAME
        replica first — an idle keep-alive the worker closed must not
        read as a replica death (every routed endpoint is idempotent,
        so the duplicate dispatch is safe). Chaos sites fire once per
        forward, never again on the stale-conn retry, so seed-pinned
        schedules stay deterministic. `kill_site` names the
        kill-replica chaos site for this forward — the handoff stages
        pass serve.handoff.send/.recv so the mid-handoff drill can
        SIGKILL exactly the prefill or decode leg."""
        timeout = self.replica_timeout_s if timeout is None else timeout
        fault_point("fleet.route.send")
        conn, reused = self._conn_get(rep, timeout)
        try:
            try:
                conn.request("POST", path, body=body,
                             headers=headers)
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                # a TIMEOUT is not a stale-keep-alive signal: the
                # replica may be wedged (SIGSTOP, predictor deadlock) —
                # re-dialing it would burn up to another full
                # replica_timeout_s before failover; let it escape
                if not reused or isinstance(e, TimeoutError):
                    raise
                conn, reused = self._conn_get(rep, timeout, fresh=True)
                conn.request("POST", path, body=body,
                             headers=headers)
            # chaos hooks sit OUTSIDE the stale-conn catches: an
            # injected OSError-family fault must always escape to the
            # failover loop, never read as a stale keep-alive and be
            # silently retried on the same replica. A FaultError at
            # the kill site IS the kill action — SIGKILL the worker
            # this request is now in flight on (see resilience/faults)
            try:
                fault_point(kill_site)
            except FaultError:
                self._chaos_kill(rep)
            fault_point("fleet.route.recv")
            try:
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                # same timeout exclusion as the send side: only
                # reset/closed-class errors mean a stale keep-alive
                if not reused or isinstance(e, TimeoutError):
                    raise
                conn, reused = self._conn_get(rep, timeout, fresh=True)
                conn.request("POST", path, body=body,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
        except BaseException:
            conn.close()
            raise
        keep = {}
        for k, v in resp.getheaders():
            if k.lower() in ("content-type", "retry-after",
                             "x-handoff-tokens", "x-decode-ms",
                             "x-kv-free-pages"):
                keep[k] = v
        if resp.will_close:
            conn.close()
        else:
            self._conn_put(rep, conn)
        return resp.status, keep, data

    def _chaos_kill(self, rep):
        try:
            os.kill(rep.pid, signal.SIGKILL)
        except (OSError, TypeError):
            # stale/None pid (the replica died and respawned between
            # pick and the fault firing): no kill happened, so no
            # count — tests synchronize on this counter as proof a
            # worker is actually dead
            return
        self.sup.bump("fleet_chaos_kills")

    # -- mixed-fleet class routing ----------------------------------------
    def _mixed(self):
        """True when the fleet routes class-aware: two distinct classes
        configured (a one-class fleet has no overflow tier to divert
        to — it routes class-blind, the legacy behavior)."""
        return (self.primary_class is not None
                and self.overflow_class is not None
                and self.primary_class != self.overflow_class)

    def _refresh_stats(self, rep):
        """TTL'd mirror of one replica's /healthz routing stats
        (measured queue depth, queue capacity, dispatch-ms EWMA) — the
        same 0.25 s scrape discipline as the kv view. Scrape failures
        are SILENT and must NEVER charge the route breaker: a slow or
        dead /healthz poll is not a failed /predict — the breaker
        guards the forward path only (a dead replica is already
        excluded by status; a wedged one fails real forwards soon
        enough), so a health-poll hiccup must not park a replica that
        is still serving."""
        with self.sup._lock:
            port, at = rep.port, rep.stats_at
        if port is None or time.monotonic() - at < self._KV_TTL_S:
            return
        try:
            _, body = self.sup._healthz(port, timeout=2.0)
        except (urllib.error.URLError, OSError, ValueError):
            return
        counters = body.get("counters") or {}
        ewma = counters.get("serve_dispatch_ms_ewma")
        with self.sup._lock:
            rep.stats_at = time.monotonic()
            rep.queue_depth = body.get("queue_depth")
            rep.max_queue = body.get("max_queue")
            if isinstance(ewma, (int, float)):
                rep.dispatch_ms_ewma = float(ewma)

    def _class_summary(self):
        """(primary, overflow) measurement dicts for divert_decision:
        live counts SERVICEABLE replicas only (status live, breaker
        closed — a breaker-open tier is as lost as a dead one), depth
        sums the last-scraped queue depths (router-side inflight as
        the cold fallback), capacity sums max_queue, ewma_ms averages
        the workers' dispatch EWMAs."""
        with self.sup._lock:
            cands = [r for r in self.sup.replicas
                     if r.backend_class in (self.primary_class,
                                            self.overflow_class)
                     and r.status == LIVE]
        for rep in cands:
            self._refresh_stats(rep)
        out = {}
        with self.sup._lock:
            for cls in (self.primary_class, self.overflow_class):
                live = depth = cap = 0
                ewmas = []
                for rep in self.sup.replicas:
                    if (rep.backend_class != cls or rep.status != LIVE
                            or rep.route_breaker.open):
                        continue
                    live += 1
                    depth += (rep.queue_depth
                              if rep.queue_depth is not None
                              else rep.inflight)
                    cap += int(rep.max_queue or 0)
                    if rep.dispatch_ms_ewma:
                        ewmas.append(rep.dispatch_ms_ewma)
                out[cls] = {
                    "live": live,
                    "depth": depth,
                    "capacity": cap,
                    "ewma_ms": (sum(ewmas) / len(ewmas)
                                if ewmas else None),
                }
        return out[self.primary_class], out[self.overflow_class]

    def _set_degraded(self, flag):
        """Flip degraded mode (whole primary tier out, overflow
        carrying the fleet): fleet_tier_losses counts entries, the
        fleet_degraded gauge mirrors the current state for scrapes."""
        with self._degraded_lock:
            if flag == self._degraded:
                return
            self._degraded = flag
            if flag:
                self.sup.bump("fleet_tier_losses")
            self.sup.counters.gauge("fleet_degraded", 1 if flag else 0)

    def _eval_degraded(self):
        """Recompute degraded mode from the live fleet view: degraded
        iff NO primary-class replica is serviceable (live + breaker
        closed). Both the per-request plan and /healthz call this, so
        recovery (a respawned primary worker going live) clears the
        flag even on an idle fleet."""
        if not self._mixed():
            return False
        with self.sup._lock:
            p_ok = any(r.backend_class == self.primary_class
                       and r.status == LIVE
                       and not r.route_breaker.open
                       for r in self.sup.replicas)
        self._set_degraded(not p_ok)
        return self._degraded

    def _qos(self):
        """The registry manifest's QoS config, loaded once (the router
        reads the SAME manifest the workers boot with — only for
        tenant classing; workers keep doing the actual DRR gating)."""
        if not self._qos_loaded:
            with self._qos_lock:
                if not self._qos_loaded:
                    cfg = None
                    if self.sup.registry:
                        from .registry import load_qos_config

                        cfg = load_qos_config(self.sup.registry)
                    self._qos_cfg = cfg
                    self._qos_loaded = True
        return self._qos_cfg

    def _is_bulk(self, h):
        """True when this request's tenant maps to a low-weight
        ("bulk") QoS class — the traffic a brownout steers/sheds
        first. No registry or no QoS block means nobody is bulk."""
        cfg = self._qos()
        if cfg is None or not cfg.enabled:
            return False
        return cfg.class_of(h.headers.get("X-Tenant")) \
            in cfg.bulk_classes()

    def _chaos_kill_class(self, cls):
        """The fleet.tier_loss chaos action: SIGKILL every live
        replica of one backend class — the whole-tier outage drill."""
        with self.sup._lock:
            targets = [r for r in self.sup.replicas
                       if r.backend_class == cls and r.status == LIVE]
        for rep in targets:
            self._chaos_kill(rep)

    def _class_plan(self, h, deadline):
        """Evaluate the divert table for one /predict. Returns
        (classes, reason): `classes` is the _pick class-tier sequence
        (None = shed now, reason says why). Bumps the divert/brownout
        counters and maintains degraded mode."""
        primary, overflow = self._class_summary()
        remaining_ms = None
        if deadline is not None:
            remaining_ms = max((deadline - time.monotonic()) * 1e3, 0.0)
        target, reason = divert_decision(
            primary, overflow, remaining_ms=remaining_ms,
            bulk=self._is_bulk(h),
            steer_watermark=self.brownout_steer,
            shed_watermark=self.brownout_shed)
        # an injected FaultError at the decision point FORCES the
        # divert (chaos schedules exercise the overflow path without
        # having to saturate the primary first)
        try:
            fault_point("fleet.divert")
        except FaultError:
            if overflow["live"] > 0:
                target, reason = "overflow", "chaos"
        self._set_degraded(primary["live"] <= 0)
        if target == "overflow":
            self.sup.bump("fleet_diverts")
            self.sup.bump(f"fleet_diverts.{reason}")
            if reason == "brownout":
                self.sup.bump("fleet_brownout_steered")
            if reason == "tier_loss":
                # the whole primary tier is out: serve from overflow,
                # but keep the (breaker-open) primary replicas in a
                # fallback tier so probe trials can heal a
                # wedged-but-alive primary back into service
                return (((self.overflow_class, self.primary_class),),
                        reason)
            return (((self.overflow_class,), (self.primary_class,)),
                    reason)
        if target == "shed":
            if reason == "brownout_shed":
                self.sup.bump("fleet_brownout_sheds")
                return None, reason
            # "unavailable": nothing can serve anywhere — let the
            # normal failover loop confirm and shed FleetUnavailable
            return (((self.primary_class,), (self.overflow_class,)),
                    reason)
        return (((self.primary_class,), (self.overflow_class,)), reason)

    def _retry_after_hint(self):
        """Class-aware Retry-After (seconds): the estimated drain time
        of the BEST candidate class — min over classes of the
        queue x EWMA / live estimate — so a saturated primary with an
        idle overflow tier never tells clients to back off 30 s.
        Class-less fleets form one implicit class. A class with no
        dispatch estimate yet could serve immediately: the 1 s floor.
        Clamped to [1, 30] like the worker-side derivation."""
        import math

        groups = {}
        with self.sup._lock:
            for rep in self.sup.replicas:
                if rep.status != LIVE or rep.route_breaker.open:
                    continue
                g = groups.setdefault(rep.backend_class,
                                      {"live": 0, "depth": 0,
                                       "ewmas": []})
                g["live"] += 1
                g["depth"] += (rep.queue_depth
                               if rep.queue_depth is not None
                               else rep.inflight)
                if rep.dispatch_ms_ewma:
                    g["ewmas"].append(rep.dispatch_ms_ewma)
        best = None
        for g in groups.values():
            eta = class_eta_ms({
                "live": g["live"], "depth": g["depth"],
                "ewma_ms": (sum(g["ewmas"]) / len(g["ewmas"])
                            if g["ewmas"] else None)})
            if eta is None:
                return 1  # a cold class could serve right now
            best = eta if best is None else min(best, eta)
        if best is None:
            return 1
        return max(1, min(30, math.ceil(best / 1000.0)))

    # -- request handling -------------------------------------------------
    def _handle_predict(self, h):
        self.sup.bump("fleet_route_requests")
        if self._draining:
            self._shed(h, "FleetDraining", "fleet is draining for shutdown")
            return
        with self._inflight_lock:
            admitted = self._inflight < self.max_inflight
            if admitted:
                self._inflight += 1
        if not admitted:
            self._shed(h, "RouterQueueFull",
                       f"router is at its in-flight cap "
                       f"({self.max_inflight})")
            return
        try:
            self._route_predict(h)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _route_predict(self, h):
        # deadline anchor = request ARRIVAL, like the single server's
        # (its t0 is taken before the body read): a slow-uploading
        # client spends its own budget on the upload, it doesn't get a
        # fresh window once the body lands
        t_arrival = time.monotonic()
        n = h._content_length()
        if n is None:
            return
        if n > self.max_body_bytes:
            h._json(413, {"error": "PayloadTooLarge",
                          "message": f"body is {n} bytes, cap is "
                                     f"{self.max_body_bytes}"}, close=True)
            return
        # the client's X-Deadline-Ms budget is END-TO-END across
        # failover attempts: each forward carries only the REMAINING
        # budget (replicas compute their deadline from arrival time) and
        # is socket-capped by it, so a hung replica can't stretch a
        # 200 ms request into replica_timeout_s per attempt. Parsed
        # BEFORE the body read: a malformed header must be rejected
        # cheaply, not after buffering up to max_body_bytes
        try:
            dl_ms = float(h.headers.get("X-Deadline-Ms", 0) or 0)
        except (TypeError, ValueError):
            h._json(400, {"error": "ValueError",
                          "message": "X-Deadline-Ms must be a number"},
                    close=True)
            return
        body = h._read_body(n)
        if body is None:  # trickling/truncated client: 400, never a
            return        # silently-truncated forward to a replica
        deadline = t_arrival + dl_ms / 1000.0 if dl_ms > 0 else None
        # role-split fleets keep /predict off the latency-bound decode
        # replicas (prefill + unified absorb it) unless nothing else is
        # live; legacy fleets route over everyone, unchanged
        tiers = ((("prefill", "unified"), ("decode",))
                 if self.sup.roles is not None else None)
        classes = None
        if self._mixed():
            # whole-tier outage drill: a FaultError here SIGKILLs
            # every live primary-class worker before the plan runs
            try:
                fault_point("fleet.tier_loss")
            except FaultError:
                self._chaos_kill_class(self.primary_class)
            classes, reason = self._class_plan(h, deadline)
            if classes is None:
                self._shed(h, "BrownoutShed",
                           "bulk tenant shed: primary class past the "
                           "brownout shed watermark with no overflow "
                           "headroom")
                return
        self._failover_forward(h, body, dl_ms, deadline, tiers=tiers,
                               classes=classes,
                               extra_headers=self._model_headers(h))

    def _model_headers(self, h):
        """X-Model / X-Tenant passthrough for registry fleets: the
        workers do the per-model admission and QoS classing, the
        router only relays the scheduling keys. Registry-less fleets
        forward NOTHING extra — the legacy wire stays byte-identical
        (a worker without a registry ignores the headers anyway, but
        the forwarded request must not change shape)."""
        if self.sup.registry is None:
            return None
        extra = {}
        for hk in ("X-Model", "X-Tenant"):
            hv = h.headers.get(hk)
            if hv is not None:
                extra[hk] = hv
        return extra or None

    def _failover_forward(self, h, body, dl_ms, deadline, *,
                          path="/predict", tiers=None, order=None,
                          classes=None,
                          content_type="application/npz",
                          kill_site="fleet.kill_replica",
                          extra_headers=None):
        """The single-stage route-with-failover loop (/predict and the
        unified /generate path): pick, forward, retry elsewhere on
        transport death, relay the first non-503 reply."""
        fwd_headers = {"Content-Type": content_type}
        if extra_headers:
            fwd_headers.update(extra_headers)

        tried = set()
        shed_reply = None  # last replica-side 503, relayed if all shed
        transport_failed = False
        for _ in range(self.sup.n):
            timeout = None
            if deadline is not None:
                remaining_s = deadline - time.monotonic()
                if remaining_s <= 0:
                    self.sup.bump("fleet_deadline_exceeded")
                    h._json(504, {"error": "DeadlineExceeded",
                                  "message": "deadline expired before a "
                                             "replica could serve",
                                  "deadline_ms": dl_ms})
                    return
                # clamp: a forwarded "0.000" would read as NO deadline
                fwd_headers["X-Deadline-Ms"] = (
                    f"{max(remaining_s * 1e3, 0.001):.3f}")
                timeout = min(self.replica_timeout_s, remaining_s + 0.05)
            rep = self._pick(tried, tiers=tiers, order=order,
                             classes=classes)
            if rep is None:
                break
            if transport_failed:
                # only an actual retry dispatch counts as a failover —
                # a transport death with nobody left to try is a shed
                self.sup.bump("fleet_failovers")
                transport_failed = False
            tried.add(rep.idx)
            try:
                status, rheaders, data = self._forward(rep, body,
                                                       fwd_headers,
                                                       timeout=timeout,
                                                       path=path,
                                                       kill_site=kill_site)
            except (OSError, http.client.HTTPException, FaultError):
                if deadline is not None and time.monotonic() >= deadline:
                    # the socket timeout was deadline-capped: the
                    # CLIENT's budget expired mid-predict — reply 504
                    # directly, never burn a failover on it. It still
                    # charges the breaker: a wedged-but-alive worker
                    # (SIGSTOP, predictor deadlock — poll() stays None,
                    # status stays live) would otherwise be re-picked
                    # forever under deadline traffic. A healthy replica
                    # unfairly charged self-corrects: ANY success closes
                    # the breaker and probe_due() admits one trial per
                    # interval even while it is open.
                    rep.route_breaker.record_failure()
                    self.sup.bump("fleet_deadline_exceeded")
                    h._json(504, {"error": "DeadlineExceeded",
                                  "message": "deadline expired "
                                             "mid-request",
                                  "deadline_ms": dl_ms})
                    return
                # replica died mid-request / unreachable (FaultError =
                # an injected route.send/recv loss): its in-flight work
                # is gone, but /predict is idempotent — fail over
                rep.route_breaker.record_failure()
                transport_failed = True
                continue
            finally:
                self._release(rep)
            rep.route_breaker.record_success()
            if status == 503:
                # replica-level shed (draining / queue full / breaker):
                # another replica may still serve this request
                self.sup.bump("fleet_replica_503s")
                shed_reply = (status, rheaders, data)
                continue
            self._relay(h, status, rheaders, data)
            return
        if shed_reply is not None:
            self.sup.bump("fleet_route_sheds")
            status, rheaders, data = shed_reply
            hint = str(self._retry_after_hint())
            if self._mixed():
                # class-aware Retry-After: the shedding replica derived
                # its hint from ITS OWN queue — a saturated primary
                # must not tell the client to back off 30 s while an
                # idle overflow tier could serve on the next try
                rheaders = {k: v for k, v in rheaders.items()
                            if k.lower() != "retry-after"}
            self._relay(h, status, rheaders, data, retry_after=hint)
            return
        self._shed(h, "FleetUnavailable",
                   "no live replica could serve the request")

    # -- disaggregated /generate scheduling -------------------------------
    _KV_TTL_S = 0.25

    def _refresh_kv(self, rep):
        """Refresh this replica's free-pages view from its /healthz
        `kv` block when the cached scrape is stale. Runs OUTSIDE the
        supervisor lock (it is an HTTP call); X-KV-Free-Pages on every
        decode reply keeps the view fresh between scrapes."""
        with self.sup._lock:
            port, at = rep.port, rep.kv_at
        if port is None or time.monotonic() - at < self._KV_TTL_S:
            return
        try:
            _, body = self.sup._healthz(port, timeout=2.0)
            kv = body.get("kv") or {}
        except (urllib.error.URLError, OSError, ValueError):
            return
        with self.sup._lock:
            rep.kv_at = time.monotonic()
            rep.kv_free_pages = kv.get("free_pages")
            rep.kv_page_len = kv.get("page_len")

    def _pick_decode(self, exclude, total_tokens):
        """Handoff placement: the live decode replica (unified
        fallback) with the most free-pages headroom — the replica's
        last-known free pages minus pages already reserved by in-flight
        placements the scrape can't see yet. Returns (replica, pages
        reserved); the caller MUST pair with _release_decode."""
        with self.sup._lock:
            live = [r for r in self.sup.replicas
                    if r.idx not in exclude and r.status == LIVE]
            cands = ([r for r in live if r.role == "decode"]
                     or [r for r in live if r.role == "unified"])
        for rep in cands:
            self._refresh_kv(rep)
        with self.sup._lock:
            best = best_key = None
            open_candidates = []
            needs = {}
            for rep in cands:
                if rep.status != LIVE:
                    continue  # flipped while we scraped
                if rep.kv_page_len:
                    needs[rep.idx] = max(
                        1, -(-int(total_tokens) // int(rep.kv_page_len)))
                else:
                    needs[rep.idx] = 0
                if rep.route_breaker.open:
                    open_candidates.append(rep)
                    continue
                free = (rep.kv_free_pages
                        if rep.kv_free_pages is not None else 0)
                headroom = free - rep.reserved_pages
                # fits-first, then most headroom, then least loaded
                key = (0 if headroom >= needs[rep.idx] else 1,
                       -headroom, rep.inflight, rep.idx)
                if best is None or key < best_key:
                    best, best_key = rep, key
            if best is None:
                for rep in open_candidates:
                    if rep.inflight == 0 and rep.route_breaker.probe_due():
                        best = rep
                        break
            if best is None:
                return None, 0
            need = needs.get(best.idx, 0)
            best.inflight += 1
            best.routed += 1
            best.reserved_pages += need
            return best, need

    def _release_decode(self, rep, need):
        with self.sup._lock:
            rep.inflight -= 1
            rep.reserved_pages = max(rep.reserved_pages - need, 0)

    def _note_stage_ewma(self, name, ms):
        """fleet_prefill_ms_ewma / fleet_decode_ms_ewma gauges: the
        per-role dispatch EWMAs as the ROUTER observes them (wall time
        of the winning forward, failovers included)."""
        with self._stage_ewma_lock:
            prev = self._stage_ewma.get(name)
            cur = ms if prev is None else 0.7 * prev + 0.3 * ms
            self._stage_ewma[name] = cur
        self.sup.counters.gauge(name, int(cur))

    def _handle_generate(self, h):
        self.sup.bump("fleet_route_requests")
        if self._draining:
            self._shed(h, "FleetDraining", "fleet is draining for shutdown")
            return
        with self._inflight_lock:
            admitted = self._inflight < self.max_inflight
            if admitted:
                self._inflight += 1
        if not admitted:
            self._shed(h, "RouterQueueFull",
                       f"router is at its in-flight cap "
                       f"({self.max_inflight})")
            return
        try:
            self._route_generate(h)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _route_generate(self, h):
        """Two-stage disaggregated generation: (1) prefill on the
        least-queued-tokens prefill replica -> one opaque handoff blob;
        (2) decode on the decode replica with the most free KV pages.
        Each stage fails over independently — the blob is immutable in
        router memory and both endpoints are idempotent, so a replica
        SIGKILLed mid-handoff costs a retry, never a wrong answer.
        Fleets with no prefill/decode roles route /generate single-stage
        to a unified replica (the bitwise-baseline path)."""
        t_arrival = time.monotonic()
        n = h._content_length()
        if n is None:
            return
        if n > self.max_body_bytes:
            h._json(413, {"error": "PayloadTooLarge",
                          "message": f"body is {n} bytes, cap is "
                                     f"{self.max_body_bytes}"}, close=True)
            return
        try:
            dl_ms = float(h.headers.get("X-Deadline-Ms", 0) or 0)
        except (TypeError, ValueError):
            h._json(400, {"error": "ValueError",
                          "message": "X-Deadline-Ms must be a number"},
                    close=True)
            return
        body = h._read_body(n)
        if body is None:
            return
        deadline = t_arrival + dl_ms / 1000.0 if dl_ms > 0 else None

        # the request's token accounting feeds BOTH scheduling keys:
        # prompt size -> least-queued-tokens, final stream length ->
        # the decode-side page reservation
        import io as _bytesio

        import numpy as np

        try:
            payload = np.load(_bytesio.BytesIO(body), allow_pickle=False)
            ntok = int(np.asarray(payload["tokens"]).size)
            max_new = int(np.asarray(payload["max_new"]).reshape(()))
        except Exception as e:  # noqa: BLE001 — malformed body is a 400
            h._json(400, {"error": type(e).__name__, "message": str(e)},
                    close=True)
            return
        total_tokens = max(ntok - 1, 0) + max_new

        with self.sup._lock:
            split = any(r.role in ("prefill", "decode")
                        for r in self.sup.replicas)
        model_headers = self._model_headers(h)
        if not split:
            self._failover_forward(h, body, dl_ms, deadline,
                                   path="/generate",
                                   tiers=(("unified",),),
                                   extra_headers=model_headers)
            return

        # ---- stage 1: prefill (least queued tokens) ----
        fwd = {"Content-Type": "application/npz"}
        if model_headers:
            fwd.update(model_headers)
        tried = set()
        shed_reply = None
        transport_failed = False
        blob = None
        handoff_tokens = total_tokens
        for _ in range(self.sup.n):
            timeout = None
            if deadline is not None:
                remaining_s = deadline - time.monotonic()
                if remaining_s <= 0:
                    self.sup.bump("fleet_deadline_exceeded")
                    h._json(504, {"error": "DeadlineExceeded",
                                  "message": "deadline expired before a "
                                             "prefill replica could serve",
                                  "deadline_ms": dl_ms})
                    return
                fwd["X-Deadline-Ms"] = (
                    f"{max(remaining_s * 1e3, 0.001):.3f}")
                timeout = min(self.replica_timeout_s, remaining_s + 0.05)
            rep = self._pick(
                tried, tiers=(("prefill",), ("unified",)),
                order=lambda r: (r.queued_tokens, r.inflight, r.idx))
            if rep is None:
                break
            if transport_failed:
                self.sup.bump("fleet_failovers")
                transport_failed = False
            tried.add(rep.idx)
            with self.sup._lock:
                rep.queued_tokens += ntok
            t0 = time.monotonic()
            try:
                status, rheaders, data = self._forward(
                    rep, body, fwd, timeout=timeout, path="/prefill",
                    kill_site="serve.handoff.send")
            except (OSError, http.client.HTTPException, FaultError):
                if deadline is not None and time.monotonic() >= deadline:
                    rep.route_breaker.record_failure()
                    self.sup.bump("fleet_deadline_exceeded")
                    h._json(504, {"error": "DeadlineExceeded",
                                  "message": "deadline expired "
                                             "mid-prefill",
                                  "deadline_ms": dl_ms})
                    return
                rep.route_breaker.record_failure()
                transport_failed = True
                continue
            finally:
                self._release(rep)
                with self.sup._lock:
                    rep.queued_tokens = max(rep.queued_tokens - ntok, 0)
            rep.route_breaker.record_success()
            if status == 503:
                self.sup.bump("fleet_replica_503s")
                shed_reply = (status, rheaders, data)
                continue
            if status != 200:
                self._relay(h, status, rheaders, data)
                return
            self._note_stage_ewma("fleet_prefill_ms_ewma",
                                  (time.monotonic() - t0) * 1e3)
            blob = data
            try:
                handoff_tokens = int(rheaders.get("X-Handoff-Tokens",
                                                  total_tokens))
            except (TypeError, ValueError):
                pass
            break
        if blob is None:
            if shed_reply is not None:
                self.sup.bump("fleet_route_sheds")
                self._relay(h, *shed_reply, retry_after="1")
                return
            self._shed(h, "FleetUnavailable",
                       "no prefill-capable replica could serve")
            return

        # ---- stage 2: decode (free-pages placement) ----
        from .handoff import CONTENT_TYPE as _HANDOFF_CT

        fwd2 = {"Content-Type": _HANDOFF_CT}
        if model_headers:
            fwd2.update(model_headers)
        tried2 = set()
        shed_reply = None
        transport_failed = False
        for _ in range(self.sup.n):
            timeout = None
            if deadline is not None:
                remaining_s = deadline - time.monotonic()
                if remaining_s <= 0:
                    self.sup.bump("fleet_deadline_exceeded")
                    h._json(504, {"error": "DeadlineExceeded",
                                  "message": "deadline expired before a "
                                             "decode replica could admit",
                                  "deadline_ms": dl_ms})
                    return
                fwd2["X-Deadline-Ms"] = (
                    f"{max(remaining_s * 1e3, 0.001):.3f}")
                timeout = min(self.replica_timeout_s, remaining_s + 0.05)
            rep, need = self._pick_decode(tried2, handoff_tokens)
            if rep is None:
                break
            if transport_failed:
                self.sup.bump("fleet_failovers")
                transport_failed = False
            tried2.add(rep.idx)
            t1 = time.monotonic()
            try:
                status, rheaders, data = self._forward(
                    rep, blob, fwd2, timeout=timeout, path="/decode",
                    kill_site="serve.handoff.recv")
            except (OSError, http.client.HTTPException, FaultError):
                if deadline is not None and time.monotonic() >= deadline:
                    rep.route_breaker.record_failure()
                    self.sup.bump("fleet_deadline_exceeded")
                    h._json(504, {"error": "DeadlineExceeded",
                                  "message": "deadline expired "
                                             "mid-decode",
                                  "deadline_ms": dl_ms})
                    return
                # the handoff blob is still whole in router memory and
                # /decode is stateless-per-request (admit -> decode ->
                # release) — resending the SAME blob elsewhere is
                # idempotent, which is what makes the mid-handoff kill
                # drill converge bitwise
                rep.route_breaker.record_failure()
                transport_failed = True
                continue
            finally:
                self._release_decode(rep, need)
            rep.route_breaker.record_success()
            if status == 503:
                self.sup.bump("fleet_replica_503s")
                shed_reply = (status, rheaders, data)
                continue
            if status == 200:
                wall = (time.monotonic() - t1) * 1e3
                try:
                    decode_ms = float(rheaders.get("X-Decode-Ms", 0) or 0)
                except (TypeError, ValueError):
                    decode_ms = 0.0
                self.sup.bump("fleet_handoffs")
                self.sup.bump("fleet_handoff_ms",
                              max(int(wall - decode_ms), 0))
                self._note_stage_ewma("fleet_decode_ms_ewma", wall)
                try:
                    free_after = int(rheaders.get("X-KV-Free-Pages"))
                except (TypeError, ValueError):
                    free_after = None
                if free_after is not None:
                    with self.sup._lock:
                        rep.kv_free_pages = free_after
                        rep.kv_at = time.monotonic()
            self._relay(h, status, rheaders, data)
            return
        if shed_reply is not None:
            self.sup.bump("fleet_route_sheds")
            self._relay(h, *shed_reply, retry_after="1")
            return
        self._shed(h, "FleetUnavailable",
                   "no decode-capable replica could admit the handoff")

    def _handle_deploy(self, h):
        """Fleet-wide hot-swap: POST /admin/deploy with JSON {name,
        version, bundle_dir?, tolerance?} runs FleetSupervisor.deploy
        (replica-by-replica cutover, rollback-on-failure). The router
        endpoint mirrors the worker's status mapping: 404 when the
        fleet has no registry or the model name is unknown, 409 when
        the deploy failed and was rolled back."""
        n = h._content_length()
        if n is None:
            return
        if n > self.max_body_bytes:
            h._json(413, {"error": "PayloadTooLarge",
                          "message": f"body is {n} bytes, cap is "
                                     f"{self.max_body_bytes}"}, close=True)
            return
        body = h._read_body(n)
        if body is None:
            return
        if self.sup.registry is None:
            h._json(404, {"error": "NoRegistry",
                          "message": "fleet was booted without a model "
                                     "registry manifest"})
            return
        try:
            spec = json.loads(body or b"{}")
            name, version = spec["name"], spec["version"]
        except (ValueError, KeyError, TypeError):
            h._json(400, {"error": "ValueError",
                          "message": "body must be a JSON object with "
                                     "name and version"}, close=True)
            return
        try:
            out = self.sup.deploy(name, version,
                                  bundle_dir=spec.get("bundle_dir"),
                                  tolerance=spec.get("tolerance", 0.01))
        except KeyError as e:
            h._json(404, {"error": "NoSuchModel", "message": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — rolled back, surfaced
            h._json(409, {"error": "DeployFailed",
                          "message": f"{type(e).__name__}: {e}"})
            return
        h._json(200, dict(out, status="active"))

    def _shed(self, h, err, msg):
        self.sup.bump("fleet_route_sheds")
        h._json(503, {"error": err, "message": msg},
                retry_after=self._retry_after_hint(), close=True)

    @staticmethod
    def _relay(h, status, headers, data, retry_after=None):
        h.send_response(status)
        for k, v in headers.items():
            h.send_header(k, v)
        if retry_after is not None and "Retry-After" not in headers:
            h.send_header("Retry-After", retry_after)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _handle_healthz(self, h):
        payload = self.sup.health()
        payload["port"] = self.port
        payload["router_draining"] = self._draining
        with self._inflight_lock:
            payload["router_inflight"] = self._inflight
        payload["router_max_inflight"] = self.max_inflight
        if self._mixed():
            # recomputed per scrape so recovery shows on an idle
            # fleet; class-less fleets keep the legacy payload shape
            payload["degraded"] = self._eval_degraded()
            payload["primary_class"] = self.primary_class
            payload["overflow_class"] = self.overflow_class
        if self._draining:
            payload["status"] = "draining"
        code = 503 if (payload["live"] == 0 or self._draining) else 200
        h._json(code, payload)

    # -- HTTP plumbing ----------------------------------------------------
    def _make_handler(self):
        outer = self

        class Handler(JsonHandlerMixin, BaseHTTPRequestHandler):
            timeout = outer.request_timeout_s

            def do_GET(self):
                if self.path != "/healthz":
                    self.send_error(404)
                    return
                outer._handle_healthz(self)

            def do_POST(self):
                if self.path == "/predict":
                    outer._handle_predict(self)
                elif self.path == "/generate":
                    outer._handle_generate(self)
                elif self.path == "/admin/deploy":
                    outer._handle_deploy(self)
                else:
                    self.send_error(404)

        return Handler

    def begin_drain(self):
        self._draining = True

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()

    def close(self):
        self._httpd.server_close()
        with self._pool_lock:
            for stack in self._pool.values():
                for conn in stack:
                    conn.close()
            self._pool.clear()


class ServingFleet:
    """Supervisor + router as one unit (in-process embedding and the
    CLI both use this)."""

    def __init__(self, model_dir, replicas=2, port=0, router_kwargs=None,
                 **supervisor_kwargs):
        self.supervisor = FleetSupervisor(model_dir, replicas,
                                          **supervisor_kwargs)
        self._router_kwargs = dict(router_kwargs or {})
        self._port = port
        self.router = None
        self._router_thread = None

    def start(self):
        self.supervisor.start()
        try:
            self.router = FleetRouter(self.supervisor, port=self._port,
                                      **self._router_kwargs)
        except Exception:
            # router bind failure (e.g. port already in use) must not
            # orphan the N just-spawned workers: __exit__ never runs
            # when __enter__ raises, so tear the supervisor down here
            self.supervisor.stop(drain=False)
            raise
        self._router_thread = threading.Thread(
            target=self.router.serve_forever, daemon=True,
            name="fleet-router")
        self._router_thread.start()
        return self

    @property
    def base_url(self):
        return f"http://127.0.0.1:{self.router.port}"

    def rolling_restart(self):
        return self.supervisor.rolling_restart()

    def stop(self):
        """Fleet-wide graceful drain: router sheds new work first, then
        every replica drains its in-flight requests, then the listener
        closes."""
        if self.router is not None:
            self.router.begin_drain()
        self.supervisor.stop(drain=True)
        if self.router is not None:
            self.router.shutdown()
            self.router.close()
        if self._router_thread is not None:
            self._router_thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch serving fleet: supervisor + failover "
                    "router over N inference.server workers")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--port", type=int, default=0,
                    help="router TCP port (0 = auto)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every worker runs (cuda raises without a "
                    "card or without nvcc)")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="per-replica in-flight cap (forwarded)")
    ap.add_argument("--router-max-inflight", type=int, default=64,
                    help="router admission cap: requests beyond it shed "
                    "503 fast instead of pinning a handler thread")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-replica default deadline (forwarded)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="per-replica request-coalescing window "
                    "(forwarded; deadline-tight requests bypass it, "
                    "0 disables coalescing)")
    ap.add_argument("--bucket-table", default=None,
                    help="shape-bucket table JSON for the workers "
                    "(forwarded; default: the checked-in table)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="per-replica graceful-drain budget (forwarded; "
                    "also bounds rolling restart and fleet shutdown)")
    ap.add_argument("--ready-timeout", type=float, default=120.0,
                    help="seconds to wait for a worker's ready handshake")
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="replicas booted with --role prefill (role-split "
                    "fleet when >0; /generate routes prompts here first)")
    ap.add_argument("--decode-replicas", type=int, default=0,
                    help="replicas booted with --role decode (KV handoffs "
                    "land on the one with the most free pages)")
    ap.add_argument("--unified-replicas", type=int, default=0,
                    help="extra --role unified replicas in a role-split "
                    "fleet (fallback tier when a role has no live member)")
    ap.add_argument("--decode-weights", default=None,
                    help="toy decode-model weights .npz (forwarded; "
                    "required for any prefill/decode/unified generation)")
    ap.add_argument("--kv-profile", default=None,
                    help="page-pool sizing profile from kv_page_table.json "
                    "(forwarded to the workers)")
    ap.add_argument("--registry", default=None,
                    help="model-registry manifest JSON (forwarded to "
                    "every worker): multi-model fleet with X-Model "
                    "routing, POST /admin/deploy hot-swaps, per-tenant "
                    "QoS classes")
    ap.add_argument("--backend-classes", default=None,
                    help="comma-separated per-replica substrate classes "
                    "(e.g. gpu,gpu,gpu-overflow): mixed fleet with "
                    "class-aware divert/brownout routing; overrides "
                    "--replicas with the list length")
    ap.add_argument("--primary-class", default=None,
                    help="backend class that serves by default "
                    "(default: the first class in --backend-classes)")
    ap.add_argument("--overflow-class", default=None,
                    help="backend class that absorbs diverts, brownout "
                    "steering, and whole-tier failover (default: the "
                    "first class != primary)")
    ap.add_argument("--brownout-steer-watermark", type=float,
                    default=0.75,
                    help="primary queue utilization at which bulk QoS "
                    "tenants steer to the overflow class")
    ap.add_argument("--brownout-shed-watermark", type=float,
                    default=0.95,
                    help="primary queue utilization past which bulk "
                    "tenants shed 503 once the overflow class is "
                    "saturated or down")
    args = ap.parse_args(argv)

    server_args = ["--max-queue", str(args.max_queue),
                   "--drain-timeout", str(args.drain_timeout),
                   "--batch-window-ms", str(args.batch_window_ms)]
    if args.deadline_ms:
        server_args += ["--deadline-ms", str(args.deadline_ms)]
    if args.bucket_table:
        server_args += ["--bucket-table", args.bucket_table]
    if args.decode_weights:
        server_args += ["--decode-weights", args.decode_weights]
    if args.kv_profile:
        server_args += ["--kv-profile", args.kv_profile]
    roles = None
    if args.prefill_replicas or args.decode_replicas:
        roles = (["prefill"] * args.prefill_replicas
                 + ["decode"] * args.decode_replicas
                 + ["unified"] * args.unified_replicas)
    backend_classes = None
    if args.backend_classes:
        backend_classes = [c.strip()
                           for c in args.backend_classes.split(",")
                           if c.strip()]
    router_kwargs = {"max_inflight": args.router_max_inflight}
    if backend_classes:
        router_kwargs.update(
            primary_class=args.primary_class,
            overflow_class=args.overflow_class,
            brownout_steer=args.brownout_steer_watermark,
            brownout_shed=args.brownout_shed_watermark)
    fleet = ServingFleet(
        args.model_dir,
        replicas=(len(roles) if roles
                  else len(backend_classes) if backend_classes
                  else args.replicas),
        port=args.port,
        router_kwargs=router_kwargs,
        server_args=server_args, worker_device=args.device,
        ready_timeout_s=args.ready_timeout,
        drain_timeout_s=args.drain_timeout,
        roles=roles,
        registry=args.registry,
        backend_classes=backend_classes,
    )
    stop = threading.Event()

    def on_term(signum, frame):
        stop.set()

    def on_hup(signum, frame):
        # the zero-downtime roll: SIGHUP rolls every replica in turn
        threading.Thread(target=fleet.rolling_restart,
                         daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, on_hup)
    fleet.start()
    print(f"fleet of {fleet.supervisor.n} serving {args.model_dir} on "
          f"http://127.0.0.1:{fleet.router.port}", flush=True)
    try:
        while not stop.wait(0.2):
            pass
    finally:
        fleet.stop()
        print("fleet drained, exiting", flush=True)


if __name__ == "__main__":
    main()
