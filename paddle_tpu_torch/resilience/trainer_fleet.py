"""Elastic training supervisor: crash-respawn train jobs and a hang
watchdog. The port's copy of `paddle_tpu/resilience/trainer_fleet.py`.

The serving tier survives replica SIGKILLs and rolling restarts
(inference/fleet.py); this module is the training-side analog. It
composes with the resilience subsystem so a restart is not merely a
respawn but an exact resume:

    python -m paddle_tpu_torch.resilience.trainer_fleet \\
        --nproc_per_node 2 --hang-timeout 120 -- train.py args...

**On the card** (`device="cuda"`, the default; CLI `--device cuda`) the
supervisor checks for the card and builds every kernel of
`ops/kernels/` once in its own process before the first spawn
(`_build.build_all()`, as the serving fleet does), so no two workers race
nvcc into one build directory; without a card it raises. `device="cpu"`
(`--device cpu`) skips both. Workers inherit the caller's environment
with every `JAX_*` variable removed: they import no JAX.

**TrainSupervisor** runs the training script as supervised workers
through the `distributed.launch` env contract (PADDLE_TRAINER_ID /
_ENDPOINTS — single- or multi-process):

- **crash-respawn**: any rank dying nonzero (or by signal) triggers a
  coordinated SIGKILL of the remaining ranks — a distributed step
  cannot complete with a member gone, and a half-dead collective would
  pin chips — then a restart of the whole job. The training script
  resumes itself from the newest valid snapshot
  (`CheckpointManager.restore_or_initialize` + `track_reader`), so the
  restarted attempt replays NOTHING: PRNG counter and data cursor both
  rewind to the snapshot boundary and the completed run's fetches are
  bitwise-identical to an uninterrupted run.
- **step-progress watchdog**: each rank heartbeats its current step to
  a per-rank progress file (executor.py's step-boundary hook; temp +
  `os.replace`, the fleet `--ready-file` idiom — the watchdog never
  reads a torn JSON). A live rank whose step has not advanced within
  `hang_timeout_s` is a hung/straggling rank (wedged collective,
  deadlocked input pipeline, SIGSTOP): the supervisor SIGKILLs the job
  and restarts it rather than letting the wedge pin chips forever.
- **restart pacing**: restarts ride `backoff_delays` and a
  `CircuitBreaker` — a fast-crash loop (dead before `min_uptime_s` or
  before the first heartbeat) degrades to one attempt per probe
  interval; `max_restarts` bounds the whole job.
- **orderly stop**: SIGTERM/SIGINT to the supervisor fan out SIGTERM to
  every rank (each worker's PreemptionHandler commits a final snapshot)
  and the supervisor exits with the group's code, no respawn. Every
  spawned worker is killed and reaped on EVERY exit path — zero orphan
  processes after supervisor exit.

Chaos sites (resilience.faults; seed-pinned, cross-process):

- `trainer.step` (worker, executor.py and the dygraph JIT): fires once per
  completed executor DISPATCH (startup/eval included — `nth=` counts
  dispatches, not training steps; use fleet.kill_trainer below to pin
  a training step) — `raises=` is a crash there, `hold=` wedges the
  dispatch so its heartbeat never lands (the watchdog drill).
- `trainer.heartbeat` (worker, executor.py): a raise is a LOST
  heartbeat — training continues, the supervisor sees silence.
- `fleet.kill_trainer` (supervisor, this module): hit once per global
  step value N >= 1 the fleet first reaches (monotonic across
  restarts — a resumed run re-crossing old steps does not re-hit, so
  `nth=N` means "SIGKILL a trainer when step N is first reached",
  exactly once per spec). A FaultError fired there SIGKILLs the rank
  that reached the step, mid-job. Delivery precision is bounded by
  `poll_interval_s` relative to step duration: steps shorter than the
  poll are observed in batches (the catch-up loop still hits every
  crossed value, so the kill fires — just possibly a few steps after
  N), and a job that EXITS inside one poll gap is never observed at
  its final steps at all; chaos drills should keep steps at or above
  the poll interval.
- `fleet.kill_host` (supervisor, this module): same step-crossing
  trigger semantics as fleet.kill_trainer, but the kill is HOST LOSS —
  the hardware is gone, not merely the process. The rank is SIGKILLed
  AND, when `allow_shrink=True`, the next attempt relaunches the
  SURVIVING world at the next valid smaller world size instead of
  respawning at full width (see the shrink policy below). With shrink
  disabled the site degrades to a plain kill-and-respawn.

**Topology-elastic shrink policy**: worker count stops being
a fatal constant. `allow_shrink=True` arms two triggers — a
`fleet.kill_host` chaos hit (hardware gone NOW: shrink on the very next
restart, no budget burned first) and the per-world restart budget
exhausting (`max_restarts` crashes at the current width: the width
itself is presumed unhealthy). Either one relaunches the job at the
next valid smaller world — the largest proper divisor of the ORIGINAL
world size at or above `min_world` (`distributed.launch.
shrink_candidates`; divisor targets keep the global batch exact, see
below) — with the restart budget reset for the new width; only when no
smaller world remains does the supervisor give up.

**Autoshard-planned shrinks**: with `plan_table=` (CLI
`--autoshard-plans plans.json`, a table of one planner `Plan` per
candidate world, as the JAX package's `tools/autoshard_plan.py --worlds`
writes it) the shrink policy
stops defaulting to "largest divisor" and re-ranks the candidate
worlds by planner score — infeasible placements (per-device HBM over
the topology cap on the SMALLER world) are skipped, ties go to the
larger world, and an empty/unhelpful table degrades to the
largest-divisor policy exactly. The chosen placement (mesh shape + PartitionSpecs)
is exported to every relaunched worker as
`PADDLE_TPU_AUTOSHARD_PLACEMENT` (autoshard/elastic.py
`placement_from_env` on the worker side), so a topology-elastic shrink
lands on the BEST smaller placement, not just a valid divisor. The
supervisor never plans in-process: the restart path only compares
numbers (pure stdlib). The launch env is
re-derived per attempt: a multi-process job respawns proportionally
fewer ranks (PADDLE_TRAINER_ID/_ENDPOINTS/_NUM rebuilt by
`distributed.launch.build_world`), and every attempt additionally
carries

    PADDLE_TPU_BASE_WORLD     the job's ORIGINAL logical world width
    PADDLE_TPU_ELASTIC_WORLD  the width of THIS attempt

**Global-batch contract**: a worker on the elastic path sizes its mesh
(or data shard) from PADDLE_TPU_ELASTIC_WORLD and keeps the GLOBAL
batch by scaling grad-accum microbatches by base/current — an integer,
exactly, because shrink targets are divisors (single-process mesh
workers that feed the full global batch keep it implicitly: a narrower
mesh only changes layout). A worker launched at a NON-divisor width
(operator override) must log its per-step global-batch change — that
is the documented degraded-mode drift, never silent. The port's
CheckpointManager has no mesh-elastic restore yet (`restore(mesh=...)`
raises; ROADMAP Queue 1 item 9): a shrunk world resumes its snapshot
unsharded, DataLoader cursor and PRNG counter riding the resume as on
any restart.

Per-attempt worker fault specs (`worker_faults={0: "seed=7;..."}`)
inject PADDLE_TPU_FAULTS into chosen attempts only — attempt 0 wedges
at step M, the respawned attempt runs clean; the supervisor otherwise
STRIPS the variable from worker envs so a supervisor-targeted spec
never re-fires inside every respawned worker.

Always-on profiler counters (CounterSet, rolled into the global table):
trainer_restarts, trainer_crashes, trainer_hangs_detected,
trainer_chaos_kills, trainer_host_losses, trainer_shrinks; gauges
trainer_resume_step (first step a restarted attempt heartbeats),
train_mttr_ms (kill-to-first-resumed-step), trainer_world_size (the
current attempt's width) and mesh_shrink_mttr_ms (host-loss kill to the
first step heartbeat of the SHRUNK world — the headline recovery number
of the topology-elastic path).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time

from ..autoshard.elastic import (
    PLACEMENT_ENV,
    best_shrink_world,
    load_plan_table,
    placement_env_value,
)
from ..distributed.launch import (
    build_world,
    kill_group,
    shrink_candidates,
    spawn_workers,
)
from .faults import ENV_VAR as _FAULTS_ENV
from .faults import FaultError, fault_point
from .preempt import CircuitBreaker, backoff_delays

__all__ = ["TrainSupervisor", "main"]

PROGRESS_ENV = "PADDLE_TPU_PROGRESS_FILE"
ATTEMPT_ENV = "PADDLE_TPU_TRAINER_ATTEMPT"
# the topology-elastic env contract (see the shrink-policy section of
# the module docstring): BASE is the job's original logical world
# width, WORLD the width of the current attempt — a worker keeps the
# global batch exact by scaling grad-accum microbatches by BASE/WORLD
BASE_WORLD_ENV = "PADDLE_TPU_BASE_WORLD"
ELASTIC_WORLD_ENV = "PADDLE_TPU_ELASTIC_WORLD"


class _Rank:
    """One supervised rank of the current attempt."""

    def __init__(self, rank, proc, progress_path, t_spawn):
        self.rank = rank
        self.proc = proc
        self.progress_path = progress_path
        self.step = None           # newest TRAINING step (manager-counted)
        self.tick = None           # newest dispatch ordinal (any dispatch)
        self.t_change = t_spawn    # when the heartbeat last advanced
        self.rc = None             # exit code once reaped


class TrainSupervisor:
    """Supervise a training command as an elastic, exactly-resumable
    job: crash detection -> coordinated kill -> backoff-paced restart,
    plus the step-progress hang watchdog. `cmd` is the argv after the
    interpreter (['train.py', '--flag', ...])."""

    def __init__(self, cmd, *, device="cuda", nproc_per_node=1,
                 cluster_node_ips="127.0.0.1", node_ip="127.0.0.1",
                 started_port=6170, selected_devices=None, workdir=None,
                 log_dir=None, hang_timeout_s=120.0, start_timeout_s=None,
                 poll_interval_s=0.05,
                 max_restarts=16, min_uptime_s=2.0,
                 respawn_base_delay_s=0.05, respawn_max_delay_s=2.0,
                 breaker_threshold=3, probe_interval_s=0.5,
                 term_grace_s=10.0, extra_env=None, worker_faults=None,
                 allow_shrink=False, elastic_world=None, min_world=1,
                 plan_table=None):
        self.cmd = list(cmd)
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.device = device
        self._kernels_built = False
        self.nproc = max(int(nproc_per_node), 1)
        self.node_ips, self.world = build_world(
            cluster_node_ips, started_port, self.nproc)
        self.node_id = self.node_ips.index(node_ip)
        # topology-elastic state: base_world is the job's ORIGINAL
        # logical width (defaults to the rank count; a single-process
        # mesh worker whose internal mesh is W wide passes
        # elastic_world=W), cur_world the width of the current attempt
        self.allow_shrink = bool(allow_shrink)
        self.min_world = max(int(min_world), 1)
        self.base_world = int(elastic_world or len(self.world))
        self.cur_world = self.base_world
        self.started_port = int(started_port)
        if self.allow_shrink and len(self.node_ips) > 1:
            raise ValueError(
                "allow_shrink=True supports single-node supervisors "
                "(one supervisor per host; cross-host membership is the "
                "cluster scheduler's job)")
        self._host_lost = False          # fleet.kill_host fired
        self._restarts_this_world = 0    # budget resets per shrink
        self._shrunk_pending_mttr = False
        # {world -> planner Plan dict} — the shrink policy re-ranks
        # candidate worlds by planner score when present (autoshard
        # plan table; path, dict, or None)
        self.plan_table = load_plan_table(plan_table) if plan_table else {}
        self._placement_env = None       # chosen plan for the cur world
        self.selected_devices = selected_devices
        self._own_dir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="ptpu_trainsup_")
        os.makedirs(self.workdir, exist_ok=True)
        self.log_dir = log_dir
        self.hang_timeout_s = float(hang_timeout_s)
        # a rank with NO heartbeat yet is importing/compiling, not
        # wedged mid-collective: it gets the (larger) start budget
        self.start_timeout_s = (max(self.hang_timeout_s, 120.0)
                                if start_timeout_s is None
                                else float(start_timeout_s))
        self.poll_interval_s = float(poll_interval_s)
        self.max_restarts = int(max_restarts)
        self.min_uptime_s = float(min_uptime_s)
        self.respawn_base_delay_s = float(respawn_base_delay_s)
        self.respawn_max_delay_s = float(respawn_max_delay_s)
        self.term_grace_s = float(term_grace_s)
        self.extra_env = dict(extra_env or {})
        # {attempt index: PADDLE_TPU_FAULTS spec} — deterministic
        # per-attempt worker chaos; attempts not listed get NO plan
        self.worker_faults = dict(worker_faults or {})
        self.respawn_breaker = CircuitBreaker(breaker_threshold,
                                              probe_interval_s)
        self._stop = threading.Event()
        self._stop_signum = None
        self._ranks = []           # current attempt's _Rank list
        self._lock = threading.Lock()
        self.attempt = 0
        self.restarts = 0
        # fleet.kill_trainer hit bookkeeping: highest global step ever
        # observed (across attempts) — each step value hits the site
        # once, so nth=N schedules are monotonic under restarts
        self._chaos_step_seen = 0
        from .. import profiler

        self.counters = profiler.CounterSet()
        self.counters.gauge("trainer_world_size", self.cur_world)

    # -- env + spawn ------------------------------------------------------
    def _progress_path(self, rank):
        return os.path.join(self.workdir, f"rank-{rank}.progress")

    def _per_rank_env(self, attempt):
        def per_rank(rank):
            extra = dict(self.extra_env)
            extra[PROGRESS_ENV] = self._progress_path(rank)
            extra[ATTEMPT_ENV] = str(attempt)
            # elastic contract: every attempt learns the job's original
            # width and its own — the worker scales grad-accum (or its
            # mesh slice) by BASE/WORLD to keep the global batch exact
            extra[BASE_WORLD_ENV] = str(self.base_world)
            extra[ELASTIC_WORLD_ENV] = str(self.cur_world)
            # the planner-chosen placement for THIS width (set by a
            # planned shrink; cleared/empty otherwise so an inherited
            # value never leaks into an unplanned attempt)
            extra[PLACEMENT_ENV] = self._placement_env or ""
            spec = self.worker_faults.get(attempt)
            if spec is not None:
                extra[_FAULTS_ENV] = str(spec)
            else:
                # a supervisor-side spec (fleet.kill_trainer) must not
                # leak into every worker of every attempt — an inherited
                # nth= schedule would re-fire per respawned process
                extra[_FAULTS_ENV] = ""
            return extra

        return per_rank

    # -- shrink policy ----------------------------------------------------
    def _next_world(self):
        """(world, plan dict | None): the next width below the current
        one — the best-scoring feasible candidate when a plan table is
        loaded (ties to the larger world), else the largest proper
        divisor of the ORIGINAL width at or above min_world (divisors
        keep the global-batch contract exact either way). (None, None)
        when no smaller world remains."""
        candidates = [w for w in shrink_candidates(self.base_world)
                      if w < self.cur_world and w >= self.min_world]
        if not candidates:
            return None, None
        if self.plan_table:
            return best_shrink_world(self.plan_table, candidates,
                                     self.min_world)
        return candidates[0], None

    def _shrink_to(self, w, reason, plan=None):
        """Relaunch the surviving world at width `w`: re-derive the
        distributed.launch env (proportionally fewer ranks for a
        multi-process job; a single-process mesh job keeps one rank and
        carries the width in PADDLE_TPU_ELASTIC_WORLD) and reset the
        per-world restart budget. A planner `plan` dict (from the
        autoshard plan table) additionally exports the chosen placement
        to the relaunched workers. The next `_spawn_attempt` picks all
        of this up — nothing respawns here."""
        new_nproc = max(1, self.nproc * w // self.cur_world)
        self._placement_env = (placement_env_value(plan) if plan
                               else None)
        placed = (f", placement {plan.get('config')}"
                  if plan and plan.get("config") else "")
        sys.stderr.write(
            f"trainer_fleet: {reason} — shrinking world "
            f"{self.cur_world} -> {w} ({self.nproc} -> {new_nproc} "
            f"rank(s)){placed}; global batch kept exact via the "
            f"{self.base_world}//{w} grad-accum contract\n")
        self.cur_world = w
        if new_nproc != self.nproc:
            self.nproc = new_nproc
            self.node_ips, self.world = build_world(
                ",".join(self.node_ips), self.started_port, self.nproc)
        self._restarts_this_world = 0
        self._shrunk_pending_mttr = True
        self.counters.bump("trainer_shrinks")
        self.counters.gauge("trainer_world_size", self.cur_world)

    # -- env + spawn (continued) ------------------------------------------
    def _prebuild_kernels(self):
        """On the card: check for it and build every kernel once here, so
        the workers load the built libraries instead of racing nvcc."""
        if self.device != "cuda" or self._kernels_built:
            return
        from ..ops.kernels import _build
        from ..place import CUDAPlace

        CUDAPlace(0).torch_device()  # raises without a card
        _build.build_all()
        self._kernels_built = True

    @staticmethod
    def _base_env():
        """The caller's env minus JAX_*: the workers import no JAX."""
        return {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}

    def _spawn_attempt(self, attempt):
        self._prebuild_kernels()
        for rank in range(max(len(self.world), self.base_world)):
            # stale heartbeats from the previous attempt must not read
            # as progress (a pre-shrink attempt may have had MORE ranks
            # than this one — clear the whole original width)
            try:
                os.unlink(self._progress_path(rank))
            except FileNotFoundError:
                pass
        procs = spawn_workers(
            self.cmd, self.world, self.node_id, self.nproc,
            selected_devices=self.selected_devices, log_dir=self.log_dir,
            per_rank_extra=self._per_rank_env(attempt),
            base_env=self._base_env(),
        )
        now = time.monotonic()
        with self._lock:
            self._ranks = [
                _Rank(self.node_id * self.nproc + i, p,
                      self._progress_path(self.node_id * self.nproc + i),
                      now)
                for i, p in enumerate(procs)
            ]
        return self._ranks

    # -- progress ---------------------------------------------------------
    def _read_progress(self, rank):
        """(step, tick) from the rank's heartbeat file. `tick` counts
        EVERY dispatch (startup programs included — pure liveness);
        `step` is the CheckpointManager-counted training step (absent
        until a manager is attached). The write side is temp+os.replace,
        so a read never sees a torn JSON — only absent or whole."""
        try:
            with open(rank.progress_path) as f:
                data = json.load(f)
            step = data.get("step")
            tick = data.get("tick", step)
            return (None if step is None else int(step),
                    None if tick is None else int(tick))
        except (OSError, ValueError, KeyError, TypeError):
            return None, None  # absent yet

    def _observe_progress(self, ranks, t_restart_ref):
        """Poll every rank's heartbeat. Side effects: watchdog
        timestamps (tick-driven: any dispatch is liveness),
        resume/MTTR gauges and fleet.kill_trainer step-crossing hits
        (step-driven: only manager-counted training steps — a startup
        dispatch can never impersonate training step N)."""
        for rank in ranks:
            if rank.proc.poll() is not None:
                continue  # exited; its progress is final
            step, tick = self._read_progress(rank)
            if tick is not None and tick != rank.tick:
                rank.tick = tick
                rank.t_change = time.monotonic()
            if step is None or step == rank.step:
                continue
            first = rank.step is None
            rank.step = step
            rank.t_change = time.monotonic()
            if first and t_restart_ref[0] is not None:
                # first TRAINING step of a restarted job: the recovery
                # is complete — kill-to-first-resumed-step is the MTTR
                mttr_ms = int((rank.t_change - t_restart_ref[0]) * 1000)
                t_restart_ref[0] = None
                self.counters.gauge("train_mttr_ms", mttr_ms)
                self.counters.gauge("trainer_resume_step", int(step))
                if self._shrunk_pending_mttr:
                    # the restart that just resumed was a topology
                    # shrink: host-loss kill to the SMALLER world's
                    # first step is the elastic-recovery headline
                    self._shrunk_pending_mttr = False
                    self.counters.gauge("mesh_shrink_mttr_ms", mttr_ms)
            # chaos: one hit per NEW global step value (>= 1), monotonic
            # across restarts — nth=N == "when step N is first reached"
            while self._chaos_step_seen < step:
                self._chaos_step_seen += 1
                try:
                    fault_point("fleet.kill_trainer")
                except FaultError:
                    self.counters.bump("trainer_chaos_kills")
                    try:
                        rank.proc.kill()
                    except OSError:
                        pass
                try:
                    fault_point("fleet.kill_host")
                except FaultError:
                    # host LOSS, not process death: the chips under this
                    # rank are gone — kill it now and arm the shrink
                    # path (the next restart relaunches the survivors
                    # at the next valid smaller world)
                    self.counters.bump("trainer_host_losses")
                    self._host_lost = True
                    try:
                        rank.proc.kill()
                    except OSError:
                        pass

    # -- the supervision loop ---------------------------------------------
    def run(self):
        """Blocking: supervise to completion. Returns the job's exit
        code — 0 when an attempt finishes cleanly, the group's first
        nonzero code when restarts are exhausted or a stop was
        requested mid-run."""
        installed = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                installed[sig] = signal.signal(sig, self._on_signal)
        delays = backoff_delays(
            tries=1 << 20, base_delay=self.respawn_base_delay_s,
            max_delay=self.respawn_max_delay_s)
        t_restart_ref = [None]  # monotonic kill time of the last restart
        last_rc = 1
        try:
            while True:
                ranks = self._spawn_attempt(self.attempt)
                outcome, rc = self._watch(ranks, t_restart_ref)
                if outcome == "done":
                    return 0
                if outcome == "stopped":
                    return rc
                # crashed or hung: the group is already dead (coordinated
                # kill) — decide whether to restart, and at what width
                last_rc = rc if rc else last_rc
                t_restart_ref[0] = time.monotonic()
                budget_out = self._restarts_this_world >= self.max_restarts
                if self.allow_shrink and (self._host_lost or budget_out):
                    w, plan = self._next_world()
                    if w is not None:
                        self._shrink_to(
                            w,
                            "host lost (fleet.kill_host)" if self._host_lost
                            else f"{self._restarts_this_world} restart(s) "
                                 f"at world {self.cur_world} exhausted "
                                 f"max_restarts={self.max_restarts}",
                            plan=plan)
                        budget_out = False
                self._host_lost = False
                if budget_out:
                    sys.stderr.write(
                        f"trainer_fleet: giving up after {self.restarts} "
                        f"restarts (max_restarts={self.max_restarts}"
                        + (", no smaller world left"
                           if self.allow_shrink else "") + ")\n")
                    return last_rc
                if self._stop.is_set():
                    return last_rc
                # pace the respawn: backoff always, breaker gating on a
                # fast-crash streak (failed before min_uptime / first
                # heartbeat)
                if self._stop.wait(next(delays, self.respawn_max_delay_s)):
                    return last_rc
                while (self.respawn_breaker.open
                       and not self.respawn_breaker.probe_due()):
                    if self._stop.wait(self.poll_interval_s):
                        return last_rc
                self.attempt += 1
                self.restarts += 1
                self._restarts_this_world += 1
                self.counters.bump("trainer_restarts")
        finally:
            # EVERY exit path reaps the whole group — no orphan worker
            # may outlive the supervisor (wedged ranks would pin chips)
            with self._lock:
                procs = [r.proc for r in self._ranks]
            kill_group(procs, grace_s=0.5)
            for sig, prev in installed.items():
                signal.signal(sig, prev)

    def _watch(self, ranks, t_restart_ref):
        """One attempt's monitor loop. Returns (outcome, rc):
        ('done', 0) | ('stopped', rc) | ('crashed', rc) |
        ('hung', None). On crash/hang the remaining ranks are already
        killed when this returns."""
        t_spawn = time.monotonic()
        progressed = False
        while True:
            if self._stop.is_set():
                # orderly stop: kill_group SIGTERMs every live rank
                # (workers commit their final snapshot via
                # PreemptionHandler), waits the grace window, SIGKILLs
                # stragglers, reaps everything
                kill_group([r.proc for r in ranks],
                           grace_s=self.term_grace_s)
                rcs = [r.proc.poll() for r in ranks]
                rc = next((c for c in rcs if c), 0)
                return "stopped", rc
            self._observe_progress(ranks, t_restart_ref)
            progressed = progressed or any(
                r.step is not None or r.tick is not None for r in ranks)
            # -- crash detection ------------------------------------------
            live, first_bad = [], None
            done = 0
            for r in ranks:
                rc = r.proc.poll()
                if rc is None:
                    live.append(r)
                elif rc == 0:
                    done += 1
                elif first_bad is None:
                    first_bad = rc
            if first_bad is not None:
                # coordinated kill: a distributed step cannot complete
                # with a member gone; SIGKILL (not drain) — the
                # survivors may be wedged inside the broken collective
                self.counters.bump("trainer_crashes")
                for r in live:
                    try:
                        r.proc.kill()
                    except OSError:
                        pass
                kill_group([r.proc for r in ranks], grace_s=0.5)
                fast = (time.monotonic() - t_spawn < self.min_uptime_s
                        or not progressed)
                if fast:
                    self.respawn_breaker.record_failure()
                else:
                    self.respawn_breaker.record_success()
                return "crashed", first_bad
            if done == len(ranks):
                self.respawn_breaker.record_success()
                return "done", 0
            # -- hang watchdog --------------------------------------------
            now = time.monotonic()

            def _budget(r):
                # a rank with no heartbeat yet is importing/compiling
                # (start budget); one that heartbeat and stopped is hung
                return (self.start_timeout_s
                        if r.tick is None and r.step is None
                        else self.hang_timeout_s)

            hung = [r for r in live if now - r.t_change > _budget(r)]
            if hung:
                self.counters.bump("trainer_hangs_detected")
                detail = ", ".join(
                    f"rank {r.rank}: "
                    + (f"no first heartbeat within start_timeout "
                       f"{self.start_timeout_s}s"
                       if r.tick is None and r.step is None else
                       f"no progress past step {r.step} within "
                       f"hang_timeout {self.hang_timeout_s}s")
                    for r in hung)
                sys.stderr.write(
                    f"trainer_fleet: watchdog — {detail}; killing the "
                    "job\n")
                kill_group([r.proc for r in ranks], grace_s=0.0)
                self.respawn_breaker.record_failure()
                return "hung", None
            time.sleep(self.poll_interval_s)

    # -- external control -------------------------------------------------
    def request_stop(self, signum=signal.SIGTERM):
        """Programmatic SIGTERM-equivalent: fan out, drain, no respawn."""
        self._stop_signum = signum
        self._stop.set()

    def _on_signal(self, signum, frame):
        self.request_stop(signum)

    def stats(self):
        with self._lock:
            rank_view = [
                {"rank": r.rank, "pid": r.proc.pid, "step": r.step,
                 "alive": r.proc.poll() is None}
                for r in self._ranks
            ]
        return {
            "attempt": self.attempt,
            "restarts": self.restarts,
            "world_size": self.cur_world,
            "base_world": self.base_world,
            "placement": (json.loads(self._placement_env)
                          if self._placement_env else None),
            "ranks": rank_view,
            "counters": self.counters.snapshot(),
        }

    def close(self):
        """Remove the supervisor's own scratch dir (progress files)."""
        if self._own_dir:
            import shutil

            shutil.rmtree(self.workdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        "paddle_tpu_torch.resilience.trainer_fleet",
        description="elastic training supervisor: crash-respawn + hang "
                    "watchdog over the distributed.launch env contract")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the default) checks for the card and builds "
                    "the kernels once before the first spawn")
    ap.add_argument("--cluster_node_ips", default="127.0.0.1")
    ap.add_argument("--node_ip", default="127.0.0.1")
    ap.add_argument("--started_port", type=int, default=6170)
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--selected_devices", default=None)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--hang-timeout", type=float, default=120.0,
                    help="seconds without step progress before a live "
                    "rank counts as hung and the job restarts")
    ap.add_argument("--start-timeout", type=float, default=None,
                    help="budget for a rank's FIRST heartbeat (import + "
                    "compile); default max(hang-timeout, 120)")
    ap.add_argument("--max-restarts", type=int, default=16)
    ap.add_argument("--min-uptime", type=float, default=2.0,
                    help="an attempt dying sooner counts as a fast crash "
                    "(feeds the respawn circuit breaker)")
    ap.add_argument("--term-grace", type=float, default=10.0,
                    help="graceful-drain window after SIGTERM fan-out")
    ap.add_argument("--attempt0-faults", default=None,
                    help="PADDLE_TPU_FAULTS spec injected into attempt 0 "
                    "workers only (deterministic elastic chaos drills)")
    ap.add_argument("--allow-shrink", action="store_true",
                    help="on host loss (fleet.kill_host) or an exhausted "
                    "per-world restart budget, relaunch the survivors at "
                    "the next valid smaller world instead of giving up")
    ap.add_argument("--elastic-world", type=int, default=None,
                    help="the job's logical world width when it differs "
                    "from the rank count (single-process mesh worker "
                    "with an internal W-wide mesh); default = rank count")
    ap.add_argument("--min-world", type=int, default=1,
                    help="never shrink below this width")
    ap.add_argument("--autoshard-plans", default=None,
                    help="planner plan table (the JAX package's "
                    "tools/autoshard_plan.py --worlds JSON): shrinks re-rank "
                    "candidate worlds "
                    "by planner score and export the chosen placement "
                    "to workers via PADDLE_TPU_AUTOSHARD_PLACEMENT")
    ap.add_argument("training_script")
    ap.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    sup = TrainSupervisor(
        [args.training_script] + list(args.training_script_args),
        device=args.device, nproc_per_node=args.nproc_per_node,
        cluster_node_ips=args.cluster_node_ips, node_ip=args.node_ip,
        started_port=args.started_port,
        selected_devices=args.selected_devices, log_dir=args.log_dir,
        hang_timeout_s=args.hang_timeout,
        start_timeout_s=args.start_timeout,
        max_restarts=args.max_restarts,
        min_uptime_s=args.min_uptime, term_grace_s=args.term_grace,
        worker_faults=(
            {0: args.attempt0_faults} if args.attempt0_faults else None),
        allow_shrink=args.allow_shrink, elastic_world=args.elastic_world,
        min_world=args.min_world, plan_table=args.autoshard_plans,
    )
    try:
        rc = sup.run()
    finally:
        sup.close()
    stats = sup.stats()
    print(f"trainer_fleet: exit rc={rc} after {stats['restarts']} "
          f"restart(s), counters={stats['counters']}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
