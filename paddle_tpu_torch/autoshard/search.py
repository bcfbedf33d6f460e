"""Candidate enumeration + beam search over PartitionSpec assignments
(the port's copy of `paddle_tpu/autoshard/search.py`, line for line).

Two nested searches:

* **mesh shapes** — every (batch, model, pipe) factorization of the
  world size (`mesh_shape_candidates`); the planner scores each shape's
  best spec assignment and picks the shape whose placement wins.

* **spec assignment per shape** — a beam search over per-param-group
  sharding choices. The choice vocabulary per group is derived from THE
  emission helpers the executor's mesh run uses (`mesh.zero1_accumulators`
  / `mesh.pipe_shardable_state`), so anything the search selects is by
  construction something `mesh.assign_state_shardings` can carry:

      rep    — everything replicated
      zero1  — optimizer accumulators P('batch')   (wire-free: the
               moment update runs on the grad shard already local)
      pipe   — param + accumulators P('pipe')      (at-rest ZeRO-over-
               pipe; pays the per-step all-gather/reduce-scatter)
      pipe_z — param P('pipe'), accumulators P('batch') (the combo the
               hand-written configs never tried: rest the big params on
               'pipe' while the moments ride the wider 'batch' axis)

  The beam is seeded with the three heuristic full assignments (all-rep
  / all-zero1 / all-pipe) — the hand-written dryrun configs — so the
  search result can only match or beat them; groups are visited largest
  first and partial assignments pruned by an additive (HBM, collective)
  proxy before the exact `CostModel.cost` rescoring of the survivors.
"""

from __future__ import annotations

__all__ = ["mesh_shape_candidates", "ShapeResult", "search_specs"]


class ShapeResult:
    """Best assignment found for one mesh shape."""

    __slots__ = ("axis_sizes", "specs", "cost", "choices")

    def __init__(self, axis_sizes, specs, cost, choices):
        self.axis_sizes = dict(axis_sizes)
        self.specs = dict(specs)
        self.cost = cost
        self.choices = dict(choices)  # param -> choice tag

    def __repr__(self):
        shape = "x".join(
            f"{a[0]}{self.axis_sizes[a]}" for a in ("batch", "model", "pipe")
        )
        return f"ShapeResult({shape}, {len(self.specs)} specs, " \
               f"score={self.cost.score:.4f})"


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def mesh_shape_candidates(world: int, max_model: int = None,
                          max_pipe: int = None) -> list:
    """All (batch, model, pipe) factorizations of `world`, batch-major
    order (the dp-leaning ones first so ties break toward data
    parallelism)."""
    world = max(int(world), 1)
    out = []
    for pipe in _divisors(world):
        if max_pipe and pipe > max_pipe:
            continue
        for model in _divisors(world // pipe):
            if max_model and model > max_model:
                continue
            out.append({
                "batch": world // (pipe * model),
                "model": model,
                "pipe": pipe,
            })
    out.sort(key=lambda s: (-s["batch"], s["model"], s["pipe"]))
    return out


def _group_choice_table(block, state_names, groups, axis_sizes):
    """Per group, the applicable {tag: {var: spec}} choices — derived
    from the SAME helpers the executor's spec-emission path runs, so
    search output always round-trips through assign_state_shardings."""
    from ..parallel import mesh as mesh_mod

    batch_n = int(axis_sizes.get("batch", 1))
    pipe_n = int(axis_sizes.get("pipe", 1))
    zero1 = mesh_mod.zero1_accumulators(block, state_names, batch_n)
    pipe = mesh_mod.pipe_shardable_state(block, state_names, pipe_n)
    table = []
    for g in groups:
        choices = {"rep": {}}
        accs_z = {a: zero1[a] for a in g.accumulators if a in zero1}
        if accs_z and len(accs_z) == len(g.accumulators):
            choices["zero1"] = accs_z
        if g.param in pipe:
            choices["pipe"] = {
                n: pipe[n] for n in (g.param,) + g.accumulators
                if n in pipe
            }
            if accs_z:
                combo = {g.param: pipe[g.param]}
                combo.update(accs_z)
                choices["pipe_z"] = combo
        table.append((g, choices))
    return table


def _proxy_delta(model, g, spec_map, axis_sizes):
    """Additive (hbm_bytes, coll_bytes) contribution of one group under
    one choice — the beam's pruning key (exact rescoring follows)."""
    from .cost_table import spec_shard_factor

    hbm = g.param_bytes / spec_shard_factor(
        spec_map.get(g.param), axis_sizes)
    for a in g.accumulators:
        # evenly sized accumulators: bytes tracked as a sum, split here
        per = g.acc_bytes / max(len(g.accumulators), 1)
        hbm += per / spec_shard_factor(spec_map.get(a), axis_sizes)
    coll = model.collective_bytes([g], spec_map, axis_sizes)
    return hbm, coll


def search_specs(env, state_names, groups, block, model, axis_sizes,
                 micro=1, runs_pipe_schedule=False,
                 beam_width=4, baseline_cost=None) -> ShapeResult:
    """Best spec assignment for one mesh shape: heuristic seeds + beam
    over per-group choices, exact-rescored.

    `baseline_cost` (a PlacementCost, e.g. of the hand-written specs
    for this shape) turns the selection match-or-beat: candidates that
    DOMINATE the baseline on (HBM, collective bytes) outrank every
    candidate that does not, regardless of score — the planner never
    regresses against a known-good placement for the same shape. The
    baseline's own specs are always in the candidate pool (the seeds),
    so a dominating candidate always exists."""
    table = _group_choice_table(block, state_names, groups, axis_sizes)
    # largest groups first: their choice dominates the score, so the
    # beam decides them while it is widest
    order = sorted(
        range(len(table)),
        key=lambda i: -(table[i][0].param_bytes + table[i][0].acc_bytes),
    )

    # -- seeds: the hand-written heuristics as complete assignments ------
    seed_tags = {"rep"}
    if any("zero1" in c for _, c in table):
        seed_tags.add("zero1")
    if any("pipe" in c for _, c in table):
        seed_tags.add("pipe")
    candidates = {}  # choices tuple -> specs dict

    def _complete(tag_fn):
        choices, specs = [], {}
        for g, ch in table:
            tag = tag_fn(ch)
            choices.append(tag)
            specs.update(ch[tag])
        return tuple(choices), specs

    for seed in sorted(seed_tags):
        key, specs = _complete(
            lambda ch, s=seed: s if s in ch else "rep")
        candidates[key] = specs

    # -- beam -------------------------------------------------------------
    beams = [((), {}, 0.0, 0.0)]  # (choice tags, specs, hbm, coll)
    for idx in order:
        g, ch = table[idx]
        nxt = []
        for tags, specs, hbm, coll in beams:
            for tag, spec_map in sorted(ch.items()):
                d_hbm, d_coll = _proxy_delta(model, g, spec_map,
                                             axis_sizes)
                ns = dict(specs)
                ns.update(spec_map)
                nxt.append((tags + ((idx, tag),), ns,
                            hbm + d_hbm, coll + d_coll))
        # prune on the weighted proxy; keep the frontier diverse by
        # also retaining the best-HBM and best-collective partials
        nxt.sort(key=lambda b: model.w_mem * b[2] + model.w_coll * b[3])
        keep = nxt[:beam_width]
        keep.append(min(nxt, key=lambda b: b[2]))
        keep.append(min(nxt, key=lambda b: b[3]))
        seen, beams = set(), []
        for b in keep:
            if b[0] not in seen:
                seen.add(b[0])
                beams.append(b)
    for tags, specs, _, _ in beams:
        ordered = ["rep"] * len(table)
        for idx, tag in tags:
            ordered[idx] = tag
        candidates[tuple(ordered)] = specs

    # -- exact rescoring --------------------------------------------------
    def rank(cost):
        beats = (baseline_cost is None
                 or cost.dominates(baseline_cost))
        return (0 if beats else 1, cost.score, cost.hbm_per_device_mb)

    best = None
    for tags, specs in sorted(candidates.items()):
        cost = model.cost(env, state_names, groups, specs, axis_sizes,
                          micro=micro,
                          runs_pipe_schedule=runs_pipe_schedule)
        if best is None or rank(cost) < rank(best.cost):
            best = ShapeResult(
                axis_sizes, specs, cost,
                {table[i][0].param: t for i, t in enumerate(tags)},
            )
    return best
