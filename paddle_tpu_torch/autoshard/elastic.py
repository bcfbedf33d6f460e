"""Supervisor-side glue, the port's copy of the four stdlib functions of
`paddle_tpu/autoshard/elastic.py`: pick the best smaller world from a plan
table.

With a plan table (one planner `Plan.to_dict()` per candidate world, as
the JAX package's `tools/autoshard_plan.py --worlds` writes it), the
TrainSupervisor's shrink policy re-ranks the candidate worlds by planner
score and relaunches the survivors onto the best feasible smaller
placement, exporting it to the workers through
`PADDLE_TPU_AUTOSHARD_PLACEMENT`. The supervisor only compares numbers:
the table is computed ahead of time.
"""

from __future__ import annotations

import json
import os

__all__ = [
    "PLACEMENT_ENV",
    "load_plan_table",
    "best_shrink_world",
    "placement_env_value",
    "placement_from_env",
]

PLACEMENT_ENV = "PADDLE_TPU_AUTOSHARD_PLACEMENT"


def load_plan_table(path_or_dict) -> dict:
    """{world:int -> plan dict}. Accepts the `tools/autoshard_plan.py
    --worlds` JSON file ({"plans": {"8": {...}, ...}} or a bare
    world-keyed object) or an already-loaded dict."""
    if isinstance(path_or_dict, dict):
        data = path_or_dict
    else:
        with open(path_or_dict) as f:
            data = json.load(f)
    plans = data.get("plans", data)
    out = {}
    for k, v in plans.items():
        try:
            out[int(k)] = v
        except (TypeError, ValueError):
            continue
    return out


def _score(plan: dict):
    cost = (plan or {}).get("cost") or {}
    if not cost.get("feasible", True):
        return None
    s = cost.get("score")
    return float(s) if s is not None else None


def best_shrink_world(plan_table: dict, candidates, min_world=1):
    """(world, plan dict | None) — the best-scoring feasible candidate
    world (candidates: descending valid widths below the current one).
    Falls back to the largest candidate with NO plan when the table has
    no feasible entry for any of them (the largest-divisor policy); an
    infeasible plan is never exported to workers."""
    candidates = [int(w) for w in candidates if int(w) >= int(min_world)]
    if not candidates:
        return None, None
    best_w, best_plan, best_s = None, None, None
    for w in candidates:
        s = _score(plan_table.get(w)) if plan_table else None
        if s is None:
            continue
        # strictly better score wins; ties go to the LARGER world
        # (more chips at equal placement quality)
        if best_s is None or s < best_s - 1e-12 or (
            abs(s - best_s) <= 1e-12 and w > best_w
        ):
            best_w, best_plan, best_s = w, plan_table.get(w), s
    if best_w is None:
        return candidates[0], None
    return best_w, best_plan


def placement_env_value(plan: dict) -> str:
    """Compact JSON for PADDLE_TPU_AUTOSHARD_PLACEMENT (mesh + specs +
    tag; the cost block is dropped — workers only need the placement)."""
    slim = {k: plan[k] for k in ("world", "mesh", "config", "specs")
            if k in plan}
    return json.dumps(slim, separators=(",", ":"), sort_keys=True)


def placement_from_env() -> dict | None:
    """The worker side: the placement the supervisor chose for THIS
    attempt, or None."""
    raw = os.environ.get(PLACEMENT_ENV)
    if not raw:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None
