"""Mesh and sharding annotation API: the port's copy of
`paddle_tpu/parallel/api.py`. Parallelism is declared as per-parameter
PartitionSpecs over the one named mesh (parallel/mesh.py); legacy axis
names (dp/tp/sp/ep/pp) canonicalize. The mesh spans the ranks of the
default torch.distributed process group, one device a rank."""

from __future__ import annotations

from .mesh import AXES, Mesh, build_mesh, canonical_axis, canonicalize_spec, current_mesh

__all__ = [
    "make_mesh",
    "get_mesh",
    "shard_parameter",
    "sharding_specs",
    "DistributedStrategy",
    "compile_distributed",
]


def make_mesh(axes: dict | None = None, devices=None) -> Mesh:
    """Build THE unified mesh from an axis-size dict; legacy axis names
    fold into their canonical axis (sizes multiply). Without `axes` every
    rank of the process group goes on 'batch' (or `len(devices)` ranks,
    when a list of places is given)."""
    sizes = {a: 1 for a in AXES}
    for name, size in (axes or {}).items():
        sizes[canonical_axis(name)] *= int(size)
    batch = sizes["batch"]
    if not axes:
        batch = len(devices) if devices is not None else None
    return build_mesh(batch=batch, model=sizes["model"], pipe=sizes["pipe"])


def get_mesh() -> Mesh | None:
    return current_mesh()


def shard_parameter(program, param, spec):
    """Annotate a parameter (or var name) with a PartitionSpec; the mesh
    run's spec assignment (mesh.assign_state_shardings) reads it. Legacy
    axis names canonicalize here."""
    name = param if isinstance(param, str) else param.name
    program._sharding_specs[name] = canonicalize_spec(spec)
    return param


def sharding_specs(program) -> dict:
    return dict(program._sharding_specs)


class DistributedStrategy:
    """fleet-style strategy facade over the unified mesh axes: dp->batch,
    tp/sp->model, pp->pipe. `zero1=True` shards optimizer accumulators
    along 'batch' (mesh.zero1_accumulators)."""

    def __init__(self):
        self.dp = None  # None = every remaining rank
        self.tp = 1
        self.pp = 1
        self.sp = 1
        self.amp = False
        self.recompute = False
        self.zero1 = False
        self.gradient_merge_steps = 1

    def build_mesh(self, devices=None) -> Mesh:
        model = max(1, int(self.tp)) * max(1, int(self.sp))
        pipe = max(1, int(self.pp))
        dp = self.dp
        if dp is None and devices is not None:
            dp = max(1, len(devices) // (model * pipe))
        return build_mesh(batch=dp, model=model, pipe=pipe)


def compile_distributed(
    executor,
    program,
    mesh: Mesh,
    feed_sig,
    fetch_names,
    scope,
    batch_axes: tuple = ("batch",),
):
    """Prepare a program's global block for the mesh step over `mesh`:
    the post-pass Program and its mesh plan (the grad reductions, the
    fetch rule, the ZeRO-1 assignment), as the Executor's mesh run
    prepares them. `feed_sig`: (name, shape, dtype) triples; the batch
    axes must be ('batch',): the port's mesh splits feeds over 'batch'
    alone (the ranks of one model group feed the same rows)."""
    axes = tuple(canonical_axis(a) for a in batch_axes)
    if axes != ("batch",):
        raise NotImplementedError(
            f"batch_axes {batch_axes}: a feed split over 'model' or 'pipe' (sequence "
            "parallelism, pipeline microbatches) is not ported yet: the port's mesh "
            "splits feeds over 'batch' alone (ROADMAP Queue 1 item 9d)")
    return executor._prepare_mesh(program, mesh, feed_sig, list(fetch_names), scope)
