"""Autoshard: cost-model-driven placement planning (the port's copy of
`paddle_tpu/autoshard/`).

`plan_program` reads the annotated Program IR (analysis.infer_program)
and a `Topology` (device count, memory per device, the two bandwidth
tiers) and chooses the split: a cost model over static per-device state
bytes, tier-weighted collective bytes and pipeline bubble, a beam search
over PartitionSpec assignments seeded from the hand-written heuristics,
and emission through the mesh run's spec assignment (the
`shard_propagation` pass in passes/).

Entirely device-free: no module here imports torch.cuda or initializes a
CUDA context.
    * python -m paddle_tpu_torch.autoshard   the planner CLI (__main__.py)
    * PADDLE_TPU_AUTOSHARD=1 /               opt-in emission on a mesh run
      BuildStrategy.auto_shard
    * autoshard.elastic                      the supervisor's shrink policy
                                             re-ranks candidate worlds by
                                             planner score (stdlib only)

Lazy exports (PEP 562): `paddle_tpu_torch.autoshard.elastic` stays
importable from the supervisor's restart path without loading the
analysis layer.
"""

from __future__ import annotations

__all__ = [
    "Topology",
    "CostModel",
    "PlacementCost",
    "Plan",
    "PlanError",
    "plan_program",
    "hand_config_specs",
    "mesh_shape_candidates",
]

_LAZY = {
    "Topology": ("topology", "Topology"),
    "CostModel": ("cost_model", "CostModel"),
    "PlacementCost": ("cost_model", "PlacementCost"),
    "Plan": ("planner", "Plan"),
    "PlanError": ("planner", "PlanError"),
    "plan_program": ("planner", "plan_program"),
    "hand_config_specs": ("planner", "hand_config_specs"),
    "mesh_shape_candidates": ("search", "mesh_shape_candidates"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod_name}", __name__), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
