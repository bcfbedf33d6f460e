"""The placement cost model: HBM feasibility, tier-weighted collective
bytes, pipeline bubble (the port's copy of `paddle_tpu/autoshard/cost_model.py`,
line for line).

Per "Synthesizing Optimal Parallelism Placement and Reduction Strategies
on Hierarchical Systems" (PAPERS.md), a placement is scored from the
topology hierarchy rather than measured per workload. Three terms:

* **HBM** — static per-device persistent-state bytes (cost_table): a
  hard feasibility bound against `Topology.hbm_bytes_per_chip` (leaving
  `hbm_headroom` for activations/workspace), then a soft preference for
  lower footprints.

* **Collective bytes, tier-weighted** — per optimizer step, ring-model
  per-device wire bytes, each mesh axis weighted by its link tier
  (`Topology.axis_tier_weights`):

    - grad sync over 'batch' (b > 1): `2·B·(b-1)/b` per param group of
      grad bytes B — the all-reduce ring cost. ZeRO-1 moves the SAME
      bytes (reduce-scatter + param all-gather), so sharding moments is
      wire-free: the moment update happens on the grad shard that is
      already local. That is exactly why the model prefers ZeRO-1 over
      replicated at any scale where state dominates.
    - params sharded at rest over 'pipe': `2·B·(p-1)/p` — the per-step
      all-gather on use plus reduce-scatter of the update.
    - params annotated over 'model' (tensor parallelism): their grad
      sync shrinks by the model factor (grads are sharded too); the
      activation collectives tp inserts are charged as one
      `2·B·(m-1)/m` term on the sharded params' bytes — a proxy, the
      same order GSPMD emits for Megatron-style splits.

* **Pipeline bubble** — `(p-1)/(p-1+micro)` for a pp schedule with
  `micro` microbatches; zero when p == 1 or the program carries no
  pipeline schedule (at-rest 'pipe' state sharding alone runs the plain
  step).

* **Compute fraction** — the share of the global step each device
  computes: `1 / (batch * pipe-if-scheduled)`. Only axes that actually
  SPLIT work count: 'batch' shards the global batch, 'pipe' splits
  layers only when a microbatch schedule runs; an unannotated 'model'
  axis (no Megatron splits in the program) replicates compute and buys
  nothing. This is what keeps the search from the degenerate
  batch=1 placement whose collectives are zero because every device
  redundantly computes the whole step.

The score is a weighted sum of the normalized terms; infeasible (score
inf) when the footprint busts HBM. Deterministic, pure arithmetic: no
torch, no device.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["PlacementCost", "CostModel"]


class PlacementCost(NamedTuple):
    hbm_per_device_mb: float
    hbm_replicated_mb: float
    collective_bytes: float      # tier-weighted, per device per step
    bubble_fraction: float
    compute_fraction: float      # per-device share of the global step
    feasible: bool
    score: float                 # lower is better; inf when infeasible

    def dominates(self, other, tol=1e-9) -> bool:
        """Weakly better on BOTH gate metrics (the dryrun-grid
        acceptance comparison)."""
        return (
            self.hbm_per_device_mb <= other.hbm_per_device_mb + tol
            and self.collective_bytes <= other.collective_bytes + tol
        )


class CostModel:
    """Scores (axis_sizes, specs) placements for one annotated program.

    `groups` are cost_table.ParamGroups; `residual_bytes` is the
    replicated state outside any group (BN stats, frozen params) —
    costed into HBM, never into collectives."""

    def __init__(self, topology, *, hbm_headroom=0.35,
                 w_coll=1.0, w_mem=0.25, w_bubble=1.0, w_compute=2.0):
        self.topology = topology
        # fraction of HBM reserved for activations/workspace: state may
        # use at most (1 - headroom) of the chip
        self.hbm_headroom = float(hbm_headroom)
        self.w_coll = float(w_coll)
        self.w_mem = float(w_mem)
        self.w_bubble = float(w_bubble)
        self.w_compute = float(w_compute)

    # -- term: collective bytes ------------------------------------------
    def collective_bytes(self, groups, specs, axis_sizes) -> float:
        """Tier-weighted per-device wire bytes per step (docstring
        formulas). `specs` maps var name -> PartitionSpec-like."""
        from .cost_table import spec_shard_factor

        w = self.topology.axis_tier_weights(axis_sizes)
        b = int(axis_sizes.get("batch", 1))
        total = 0.0
        for g in groups:
            pspec = specs.get(g.param)
            pipe_f = spec_shard_factor(pspec, {"pipe": axis_sizes.get(
                "pipe", 1)}) if pspec is not None else 1
            model_f = spec_shard_factor(pspec, {"model": axis_sizes.get(
                "model", 1)}) if pspec is not None else 1
            grad_bytes = g.param_bytes / model_f
            if b > 1:
                total += 2.0 * grad_bytes * (b - 1) / b * w["batch"]
            if pipe_f > 1:
                total += (2.0 * g.param_bytes / model_f
                          * (pipe_f - 1) / pipe_f * w["pipe"])
            if model_f > 1:
                # activation-collective proxy for tensor parallelism
                total += (2.0 * g.param_bytes * (model_f - 1) / model_f
                          * w["model"])
        return total

    # -- term: bubble -----------------------------------------------------
    @staticmethod
    def bubble_fraction(axis_sizes, micro) -> float:
        p = int(axis_sizes.get("pipe", 1))
        micro = max(int(micro or 1), 1)
        if p <= 1 or micro < 1:
            return 0.0
        return (p - 1) / (p - 1 + micro)

    # -- term: compute fraction ------------------------------------------
    @staticmethod
    def compute_fraction(axis_sizes, runs_pipe_schedule) -> float:
        split = int(axis_sizes.get("batch", 1))
        if runs_pipe_schedule:
            split *= int(axis_sizes.get("pipe", 1))
        return 1.0 / max(split, 1)

    # -- the full score ---------------------------------------------------
    def cost(self, env, state_names, groups, specs, axis_sizes,
             micro=1, runs_pipe_schedule=False) -> PlacementCost:
        from .cost_table import config_state_mb

        per_dev_mb, full_mb = config_state_mb(
            env, state_names, specs, axis_sizes
        )
        coll = self.collective_bytes(groups, specs, axis_sizes)
        bubble = (self.bubble_fraction(axis_sizes, micro)
                  if runs_pipe_schedule else 0.0)
        compute = self.compute_fraction(axis_sizes, runs_pipe_schedule)
        cap_mb = (self.topology.hbm_bytes_per_chip
                  * (1.0 - self.hbm_headroom)) / 1e6
        feasible = per_dev_mb <= cap_mb
        if not feasible:
            score = float("inf")
        else:
            # normalize: collectives against the replicated-dp baseline
            # (all grads all-reduced), memory against the replicated
            # footprint — both dimensionless, so the weights compose
            coll_base = max(
                sum(2.0 * g.param_bytes for g in groups), 1.0
            )
            score = (
                self.w_compute * compute
                + self.w_coll * (coll / coll_base)
                + self.w_mem * (per_dev_mb / max(full_mb, 1e-9))
                + self.w_bubble * bubble
            )
        return PlacementCost(
            round(per_dev_mb, 6), round(full_mb, 6), coll, bubble,
            compute, feasible, score,
        )
