"""Fault tolerance on the card: the port's copy of `paddle_tpu/resilience/`.

- `snapshot.py`: the async atomic snapshot engine. A snapshot is the
  JAX package's format byte for byte (either package loads the other's);
  the step's tensors leave the card through pinned buffers on a CUDA copy
  stream of the engine's own, and serialization and file I/O run on a
  flush thread while the next steps run. Commit is a temp directory, a
  checksummed manifest written last and one `os.replace`.
- `manager.py`: `CheckpointManager`, cadence (`attach` to a Program and
  `Executor.run` snapshots on it), discovery that skips torn snapshots,
  restore-or-initialize with the executor's seed counter and the tracked
  DataLoaders' cursors, so a resumed run replays the uninterrupted run bit
  for bit.
- `guard.py`: `NanGuard` skips non-finite steps and rolls back after a
  streak.
- `preempt.py`: SIGTERM -> a drained, committed final snapshot; the
  circuit breaker and retry/backoff.
- `trainer_fleet.py`: `TrainSupervisor`, crash-respawn of training jobs
  over the `distributed.launch` env contract with a step-progress
  watchdog over per-rank heartbeat files (imported lazily).
- `faults.py`: deterministic fault injection.

Not in the port yet (ROADMAP Queue 1 item 9): mesh-elastic restore
(`restore(mesh=...)` raises) and the CompiledProgram hooks.

Counters: ckpt_save_ms, ckpt_bytes, ckpt_async_overlap_ms,
ckpt_snapshots_committed, nan_steps_skipped, nan_rollbacks, resume_step,
preemptions_observed, trainer_restarts, trainer_crashes,
trainer_hangs_detected, trainer_chaos_kills, trainer_host_losses,
trainer_shrinks, trainer_resume_step, trainer_world_size, train_mttr_ms,
mesh_shrink_mttr_ms, and a `retry_call(counter=...)` name bumped per
retry.
"""

from . import faults
from .faults import FaultPlan, fault_bytes, fault_point
from .guard import GuardedOptimizer, NanGuard
from .manager import CheckpointManager
from .preempt import CircuitBreaker, PreemptionHandler, backoff_delays, retry_call
from .snapshot import (
    FORMAT_VERSION,
    AsyncSnapshotEngine,
    SnapshotError,
    atomic_write_array,
    atomic_write_bytes,
    list_snapshots,
    load_snapshot,
    pack_stream,
    prune_snapshots,
    read_manifest,
    validate_snapshot,
    write_snapshot,
)

__all__ = [
    "AsyncSnapshotEngine",
    "CheckpointManager",
    "CircuitBreaker",
    "FORMAT_VERSION",
    "FaultPlan",
    "fault_bytes",
    "fault_point",
    "faults",
    "GuardedOptimizer",
    "NanGuard",
    "PreemptionHandler",
    "SnapshotError",
    "atomic_write_array",
    "atomic_write_bytes",
    "backoff_delays",
    "list_snapshots",
    "load_snapshot",
    "pack_stream",
    "prune_snapshots",
    "read_manifest",
    "retry_call",
    "TrainSupervisor",
    "validate_snapshot",
    "write_snapshot",
]


def __getattr__(name):
    # lazy: trainer_fleet pulls in distributed.launch; the executor
    # imports faults through this package at startup
    if name == "TrainSupervisor":
        from .trainer_fleet import TrainSupervisor

        return TrainSupervisor
    raise AttributeError(name)
