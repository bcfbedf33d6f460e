"""shard_propagation: the autoshard planner's PartitionSpec assignment,
attached to the Program clone a mesh run walks (the port's copy of
`paddle_tpu/passes/shard_propagation.py`).

When autoshard is enabled (`PADDLE_TPU_AUTOSHARD=1` or
`BuildStrategy.auto_shard=True`; the variable wins) and a
CompiledProgram runs over a mesh of more than one device, the pass runs
the device-free planner (paddle_tpu_torch/autoshard) for that mesh's
shape and records the winning specs on the clone as `_autoshard_specs`.
The Executor's mesh run (`Executor._prepare_mesh`) merges them over the
ZeRO-1 flag's assignment, where the hand-written ZeRO-1 assignment
enters, so a planned placement and a manual one go through one plan
(parallel/step.py).

Contract notes:

* The pass never edits ops (returns 0 removed; `ctx.mutated` keeps the
  clone when specs were attached), and `analysis.check_sharding` has
  already validated the specs inside the planner.
* It is part of `cache_signature()` / `resolve_pass_names()` only while
  autoshard is enabled (passes/__init__ gates it), so flipping
  `PADDLE_TPU_AUTOSHARD` misses the Executor's pass cache.
* Without a mesh, or on a 1-device mesh, it does nothing.
* A plan failure (an unknown-shape state var, no feasible placement)
  writes one warning to stderr per program fingerprint and leaves the
  manual placement in charge: opting into autoshard never turns a
  runnable program into an error.
"""

from __future__ import annotations

import os
import sys

from . import register_pass

__all__ = ["AUTOSHARD_ENV", "autoshard_enabled"]

AUTOSHARD_ENV = "PADDLE_TPU_AUTOSHARD"

_warned_programs = set()


def autoshard_enabled(build_strategy=None) -> bool:
    """The env var wins over the BuildStrategy knob (the precedence of
    PADDLE_TPU_PASSES over the pass knobs)."""
    env = os.environ.get(AUTOSHARD_ENV)
    if env is not None:
        return env.strip().lower() not in ("", "0", "off", "none", "false")
    return bool(getattr(build_strategy, "auto_shard", False))


@register_pass("shard_propagation", version=1)
def shard_propagation_pass(program, block, feed_names, fetch_names, ctx):
    if not autoshard_enabled(getattr(ctx, "build_strategy", None)):
        return 0
    mesh = getattr(ctx, "mesh", None)
    if mesh is None:
        return 0  # the plain Executor walk: nothing to place
    from ..parallel.mesh import axis_sizes as _axis_sizes

    axis_sizes = _axis_sizes(mesh)
    total = 1
    for s in axis_sizes.values():
        total *= s
    if total <= 1:
        return 0

    from ..autoshard import PlanError, Topology, plan_program

    feeds = None
    feed_sig = getattr(ctx, "feed_sig", None)
    if feed_sig:
        feeds = {n: (tuple(s), dt) for n, s, dt in feed_sig}
    try:
        plan = plan_program(program, Topology.from_env(default_chips=total), feeds=feeds,
                            mesh_shape=axis_sizes)
    except PlanError as e:
        # content-keyed: each run's clone is a fresh object, so id() would
        # warn on every miss of the same source program
        key = program.fingerprint() if hasattr(program, "fingerprint") else id(program)
        if key not in _warned_programs:
            _warned_programs.add(key)
            sys.stderr.write(f"shard_propagation: planner declined ({e}); running "
                             "with the manual spec assignment\n")
        return 0
    if plan.specs:
        program._autoshard_specs = dict(plan.specs)
        program._autoshard_plan = plan.to_dict()
        ctx.mutated = True
        from .. import profiler

        profiler.set_counter("autoshard_planned_vars", len(plan.specs))
    return 0
