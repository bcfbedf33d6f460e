"""The planner: annotated Program IR + topology -> chosen placement (the
port's copy of `paddle_tpu/autoshard/planner.py`, line for line).

`plan_program` is the subsystem's front door. It runs the static
analysis layer (`analysis.infer_program` — no tracing, no devices),
extracts the cost inputs (cost_table), searches mesh shapes × spec
assignments (search.py), validates the winner with
`analysis.check_sharding`, and returns a `Plan`: the (batch, model,
pipe) mesh shape plus the extra-spec assignment that
`mesh.assign_state_shardings` emits for the mesh run. Placement becomes a
derived artifact of the IR instead of user input.

Device-free by contract: it imports no torch.cuda and initializes no
CUDA context (tests/test_torch_independence.py holds it to that), so a
plan for a 256-GPU job computes in milliseconds on a host without one.
"""

from __future__ import annotations

import json

from .cost_model import CostModel
from .cost_table import param_groups, state_var_names, unknown_state_vars
from .search import mesh_shape_candidates, search_specs
from .topology import Topology

__all__ = ["Plan", "PlanError", "plan_program", "hand_config_specs"]


class PlanError(ValueError):
    """Planning cannot proceed — unknown-shape state vars (shape-fn
    coverage hole), no feasible placement, or an invalid topology."""


class Plan:
    """One chosen placement: mesh shape + extra specs + its cost."""

    def __init__(self, axis_sizes, specs, cost, *, world, choices=None,
                 config_tag=None, requires_pipeline_stages=False):
        self.axis_sizes = {a: int(axis_sizes.get(a, 1))
                           for a in ("batch", "model", "pipe")}
        self.specs = dict(specs)
        self.cost = cost
        self.world = int(world)
        self.choices = dict(choices or {})
        self.config_tag = config_tag or self.tag()
        # pipe > 1 on a program with no pipeline cut: the 'pipe' specs
        # are valid at-rest sharding, but running a pp SCHEDULE needs
        # device_guard stages (PipelineOptimizer) — flagged, not hidden
        self.requires_pipeline_stages = bool(requires_pipeline_stages)

    def tag(self) -> str:
        b, m, p = (self.axis_sizes[a] for a in ("batch", "model", "pipe"))
        kinds = sorted({t for t in self.choices.values() if t != "rep"})
        return f"dp{b}xtp{m}xpp{p}" + ("+" + "+".join(kinds) if kinds
                                       else "")

    # -- serialization (plain JSON: the supervisor's shrink policy and
    # the worker placement env both consume this) -----------------------
    def to_dict(self) -> dict:
        from ..parallel.mesh import spec_to_manifest

        return {
            "world": self.world,
            "mesh": dict(self.axis_sizes),
            "config": self.config_tag,
            "specs": {n: spec_to_manifest(s)
                      for n, s in sorted(self.specs.items())},
            "choices": dict(sorted(self.choices.items())),
            "requires_pipeline_stages": self.requires_pipeline_stages,
            "cost": {
                "hbm_state_mb_per_device": self.cost.hbm_per_device_mb,
                "hbm_state_mb_replicated": self.cost.hbm_replicated_mb,
                "collective_bytes_estimate": round(
                    self.cost.collective_bytes, 2),
                "bubble_fraction": round(self.cost.bubble_fraction, 4),
                "feasible": self.cost.feasible,
                "score": (None if self.cost.score == float("inf")
                          else round(self.cost.score, 6)),
            },
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def specs_from_dict(cls, data: dict) -> dict:
        """{name: PartitionSpec} back from a `to_dict` payload (the
        worker side of the supervisor's placement env)."""
        from ..parallel.mesh import spec_from_manifest

        return {n: spec_from_manifest(e)
                for n, e in (data.get("specs") or {}).items()}

    def __repr__(self):
        return (f"Plan({self.config_tag}, world={self.world}, "
                f"hbm={self.cost.hbm_per_device_mb:.2f}MB/dev, "
                f"coll={self.cost.collective_bytes:.0f}B)")


def _runs_pipe_schedule(program) -> bool:
    return int(getattr(program, "_pipeline_microbatches", 1) or 1) > 1


def _analyze(program, feeds):
    from .. import analysis

    result = analysis.infer_program(program, feeds=feeds)
    block = program.global_block()
    state_names = state_var_names(program)
    unknown = unknown_state_vars(result.env, state_names)
    if unknown:
        raise PlanError(
            "cannot cost placement: state vars with unknown static "
            f"shape/dtype {sorted(unknown)[:8]}"
            f"{'...' if len(unknown) > 8 else ''} — declare "
            "their shapes (the port has no shape-function library yet: "
            "ROADMAP Queue 1 item 11)"
        )
    groups = param_groups(block, state_names, result.env)
    return result, block, state_names, groups


def _validate(program, result, specs, axis_sizes):
    from .. import analysis

    findings = analysis.check_sharding(
        program, mesh=axis_sizes, specs={}, extra_specs=specs, env=result,
    )
    if findings:
        raise PlanError(
            "planner produced an invalid assignment (checker findings): "
            + "; ".join(str(f) for f in findings[:5])
        )


def plan_program(program, topology=None, *, feeds=None, world=None,
                 mesh_shape=None, micro=None, beam_width=4,
                 cost_model=None, max_model=None,
                 baseline_specs=None) -> Plan:
    """Choose the placement for `program` on `topology`.

    `mesh_shape` (a {batch, model, pipe} dict) pins the shape and
    searches only the spec assignment — the per-config planner the
    dryrun-grid comparison and the shard_propagation pass use (the pass
    plans for the mesh the executor is about to compile on). Without
    it, every factorization of `world` (default: topology.chips) is
    searched and the best-scoring feasible shape wins.

    `baseline_specs` (with a pinned `mesh_shape`) is a known-good
    hand-written assignment for that shape: selection then prefers
    candidates that match-or-beat it on BOTH gate metrics (per-device
    HBM, tier-weighted collective bytes) — the planner never emits a
    regression against the config it replaces.
    """
    if topology is None:
        topology = Topology.from_env(default_chips=world)
    if topology is None:
        raise PlanError("no topology: pass one, set PADDLE_TPU_TOPOLOGY, "
                        "or give world=")
    world = int(world or topology.chips)
    result, block, state_names, groups = _analyze(program, feeds)
    model = cost_model or CostModel(topology)
    micro = int(micro or getattr(program, "_pipeline_microbatches", 1) or 1)
    runs_pipe = _runs_pipe_schedule(program)

    baseline_cost = None
    if mesh_shape is not None:
        shapes = [{a: int(mesh_shape.get(a, 1))
                   for a in ("batch", "model", "pipe")}]
        prod = shapes[0]["batch"] * shapes[0]["model"] * shapes[0]["pipe"]
        world = prod
        if baseline_specs is not None:
            baseline_cost = model.cost(
                result.env, state_names, groups, baseline_specs,
                shapes[0], micro=micro,
                runs_pipe_schedule=runs_pipe and shapes[0]["pipe"] > 1,
            )
    else:
        shapes = mesh_shape_candidates(world, max_model=max_model)

    best = None
    for axis_sizes in shapes:
        res = search_specs(
            result.env, state_names, groups, block, model, axis_sizes,
            micro=micro,
            runs_pipe_schedule=runs_pipe and axis_sizes["pipe"] > 1,
            beam_width=beam_width,
            baseline_cost=baseline_cost,
        )
        if best is None or res.cost.score < best.cost.score:
            best = res
    if best is None or not best.cost.feasible:
        detail = ("no mesh shape fits: per-device state "
                  f"{best.cost.hbm_per_device_mb:.1f} MB > "
                  f"{topology.hbm_gb_per_chip * (1 - model.hbm_headroom) * 1e3:.0f} MB cap"
                  if best is not None else "no candidate shapes")
        raise PlanError(f"no feasible placement for world={world}: {detail}")
    _validate(program, result, best.specs, best.axis_sizes)
    return Plan(
        best.axis_sizes, best.specs, best.cost, world=world,
        choices=best.choices,
        requires_pipeline_stages=(best.axis_sizes["pipe"] > 1
                                  and not runs_pipe),
    )


def hand_config_specs(program, world: int) -> list:
    """The hand-written dryrun-grid configs as (tag, axis_sizes, specs)
    — the JAX package's `tools/dryrun_multichip.py --static` grid (replicated
    dp, ZeRO-1 dp, ZeRO-over-pipe) plus the pp4xtp2 shape the r01-r05
    evidence lines carry. The comparison baseline the planner must
    match or beat, per shape."""
    from ..parallel import mesh as mesh_mod

    block = program.global_block()
    state_names = state_var_names(program)
    pipe_n = 4 if world % 4 == 0 else (2 if world % 2 == 0 else 1)
    configs = [
        ("replicated_dp",
         {"batch": world, "model": 1, "pipe": 1}, {}),
        (f"zero1_dp{world}",
         {"batch": world, "model": 1, "pipe": 1},
         mesh_mod.zero1_accumulators(block, state_names, world)),
        (f"zero_over_pipe{pipe_n}",
         {"batch": world // pipe_n, "model": 1, "pipe": pipe_n},
         mesh_mod.pipe_shardable_state(block, state_names, pipe_n)),
    ]
    if world % 8 == 0:
        configs.append((
            "pp4xtp2",
            {"batch": world // 8, "model": 2, "pipe": 4},
            mesh_mod.pipe_shardable_state(block, state_names, 4),
        ))
    return configs
