"""One named mesh, axes ``('batch', 'model', 'pipe')``: the port's copy of
`paddle_tpu/parallel/mesh.py`.

In the JAX package one process drives every device and GSPMD shards one
jitted step over a `jax.sharding.Mesh`. In the port one process drives
one device, and the mesh is a `torch.distributed.device_mesh.DeviceMesh`
over the ranks of the default process group (gloo on the CPU, NCCL on the
card). Each rank walks the same Program on its own shard of the batch, and
the CompiledProgram's mesh step (executor.py) adds the collectives that
make its result the one GSPMD gives for the whole batch.

Without an initialized process group the mesh is the degenerate 1x1x1
`Mesh` with no DeviceMesh: its run is the plain Executor walk, bit for
bit. A `pipe` axis larger than 1 raises NotImplementedError naming
ROADMAP Queue 1 item 9d.

Axis contract (as the JAX package's):

- ``batch``: data parallelism. Feeds are per-rank batch shards; gradients
  are averaged over this axis. ZeRO-1 shards optimizer accumulators along
  it.
- ``model``: everything intra-layer: the program's annotations over it
  run as Megatron tensor parallelism (parallel/tensor_parallel.py). The
  ranks of one model group feed the same rows.
- ``pipe``: pipeline stages (item 9d).

The ranks lay out row-major over (batch, model, pipe): rank
b * model * pipe + m * pipe + p, so a model group is `model` consecutive
ranks.

Legacy axis names (``dp``, ``tp``, ``sp``, ``ep``, ``pp``) canonicalize
as in the JAX package: dp->batch, tp/sp/ep->model, pp->pipe. A
PartitionSpec is the port's own `P`, a tuple of axis names per tensor dim
whose repr is `jax.sharding.PartitionSpec`'s, so `mesh_signature` and the
snapshot manifests agree with the JAX package's. Where the JAX package
returns a NamedSharding, the port returns DTensor placements, one per
mesh axis.

The IR analysis (`zero1_accumulators`, `pipe_shardable_state`,
`assign_state_shardings`, `feed_shardings`) is the JAX package's, line for
line.
"""

from __future__ import annotations

__all__ = [
    "AXES",
    "P",
    "Mesh",
    "axis_sizes",
    "build_mesh",
    "current_mesh",
    "set_current_mesh",
    "canonical_axis",
    "canonicalize_spec",
    "spec_to_manifest",
    "spec_from_manifest",
    "spec_of_placements",
    "named_sharding",
    "sharding_with_degrade",
    "smaller_mesh_shapes",
    "mesh_signature",
    "assign_state_shardings",
    "feed_shardings",
    "zero1_accumulators",
    "pipe_shardable_state",
]

AXES = ("batch", "model", "pipe")

# legacy axis vocabulary -> the one mesh's axes
_LEGACY = {
    "dp": "batch",
    "data": "batch",
    "batch": "batch",
    "tp": "model",
    "mp": "model",
    "sp": "model",
    "ep": "model",
    "model": "model",
    "pp": "pipe",
    "stage": "pipe",
    "pipe": "pipe",
}



class P(tuple):
    """PartitionSpec: per tensor dim, None, an axis name or a tuple of axis
    names. Its repr is `jax.sharding.PartitionSpec`'s."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "PartitionSpec" + repr(tuple(self))

    __str__ = __repr__


class Mesh:
    """The mesh: `shape` {axis: size} over AXES, and `device_mesh`, the
    torch DeviceMesh over the default process group's ranks (None for the
    1x1x1 mesh without a process group)."""

    axis_names = AXES

    def __init__(self, batch=1, model=1, pipe=1, device_mesh=None):
        self.shape = {"batch": int(batch), "model": int(model), "pipe": int(pipe)}
        self.device_mesh = device_mesh

    @property
    def device_type(self):
        return None if self.device_mesh is None else self.device_mesh.device_type

    def group(self, axis="batch"):
        """The process group of `axis` (None without a DeviceMesh)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def local_rank(self, axis="batch") -> int:
        """This rank's coordinate on `axis`."""
        return 0 if self.device_mesh is None else int(self.device_mesh.get_local_rank(axis))

    def __repr__(self):
        dm = "no process group" if self.device_mesh is None else self.device_type
        return f"Mesh({self.shape}, {dm})"


_current_mesh: Mesh | None = None
# DeviceMeshes built so far, by (device type, shape), each beside the default
# group it was built on (a DeviceMesh creates process groups, a collective of
# every rank; a new default group builds its own)
_device_meshes: dict = {}


def canonical_axis(name):
    """Map a legacy axis name onto the unified mesh axis (None passes
    through; unknown names raise: a typo'd annotation must be loud)."""
    if name is None:
        return None
    try:
        return _LEGACY[name]
    except KeyError:
        raise ValueError(
            f"unknown mesh axis {name!r}: the unified mesh has axes "
            f"{AXES} (legacy dp/tp/sp/ep/pp accepted)"
        )


def canonicalize_spec(spec) -> P:
    """PartitionSpec with every axis name canonicalized. Two legacy axes
    that fold into the same unified axis cannot both shard one tensor: the
    FIRST occurrence wins, later duplicates degrade to replicated."""
    if spec is None:
        return P()
    seen = set()
    out = []
    for el in spec:
        names = el if isinstance(el, tuple) else (el,)
        keep = []
        for a in names:
            c = canonical_axis(a)
            if c is not None and c not in seen:
                seen.add(c)
                keep.append(c)
        out.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*out)


def spec_to_manifest(spec) -> list:
    """JSON form of a PartitionSpec (a snapshot manifest records one per
    sharded var, so a restore re-places it sharded)."""
    out = []
    for el in canonicalize_spec(spec):
        if el is None:
            out.append(None)
        elif isinstance(el, tuple):
            out.append(list(el))
        else:
            out.append(el)
    return out


def spec_from_manifest(entry) -> P:
    """Inverse of spec_to_manifest."""
    if not entry:
        return P()
    return P(*[tuple(e) if isinstance(e, list) else e for e in entry])


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def build_mesh(batch=None, model=1, pipe=1, device_type=None) -> Mesh:
    """THE mesh: axes ('batch', 'model', 'pipe'), all present. batch=None
    takes every rank of the default process group over model * pipe (1
    without one). A 1x1x1 mesh without a process group, or asked for under
    a larger one, has no DeviceMesh; any other mesh spans the whole group,
    on `device_type` (default: "cuda" under NCCL, else "cpu"). pipe > 1
    raises (ROADMAP Queue 1 item 9d)."""
    model = max(1, int(model))
    pipe = max(1, int(pipe))
    if pipe > 1:
        raise NotImplementedError(
            f"a mesh with pipe={pipe}: pipeline stages are not ported yet "
            "(ROADMAP Queue 1 item 9d)")
    world = _world()
    if batch is None:
        batch = max(1, (world or 1) // (model * pipe))
    batch = max(1, int(batch))
    n = batch * model * pipe
    device_mesh = None
    if world is None:
        if n != 1:
            raise ValueError(
                f"mesh batch={batch} x model={model} x pipe={pipe} needs {n} ranks: "
                "initialize a torch.distributed process group of that many ranks "
                "first (one process drives one device)")
    elif n == world:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        key = (device_type, (batch, model, pipe))
        world_group, device_mesh = _device_meshes.get(key, (None, None))
        if world_group is not dist.group.WORLD:
            device_mesh = init_device_mesh(device_type, (batch, model, pipe),
                                           mesh_dim_names=AXES)
            _device_meshes[key] = (dist.group.WORLD, device_mesh)
    elif n != 1:
        raise ValueError(
            f"mesh batch={batch} x model={model} x pipe={pipe} needs {n} ranks, "
            f"the process group has {world}")
    mesh = Mesh(batch, model, pipe, device_mesh)
    set_current_mesh(mesh)
    return mesh


def set_current_mesh(mesh: Mesh | None):
    global _current_mesh
    _current_mesh = mesh
    _publish_counters(mesh)
    return mesh


def current_mesh() -> Mesh | None:
    return _current_mesh


def _publish_counters(mesh):
    """Always-on mesh gauges: mesh_axes = number of non-trivial axes,
    mesh_shape = total mesh size, plus mesh_shape_batch / _model / _pipe."""
    from .. import profiler

    if mesh is None:
        return
    shape = dict(mesh.shape)
    profiler.set_counter("mesh_axes", sum(1 for v in shape.values() if v > 1))
    n = 1
    for v in shape.values():
        n *= int(v)
    profiler.set_counter("mesh_shape", n)
    for ax in AXES:
        profiler.set_counter(f"mesh_shape_{ax}", int(shape.get(ax, 1)))


def mesh_signature(mesh, specs=None) -> tuple:
    """Hashable (mesh shape, spec assignment) digest for the caches: the
    Executor's pass cache under a CompiledProgram and the dygraph JIT
    bridge's key carry it, so flipping a sharding never serves a stale
    entry."""
    if mesh is None:
        return ("nomesh",)
    shape = tuple((a, int(s)) for a, s in mesh.shape.items())
    if not specs:
        return (shape,)
    table = tuple(sorted(
        (name, str(canonicalize_spec(s))) for name, s in specs.items()
    ))
    return (shape, table)


def _placements(spec):
    """DTensor placements, one per mesh axis, of a clean canonical spec."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for ax in AXES:
        dim = next((i for i, el in enumerate(spec)
                    if ax in (el if isinstance(el, tuple) else (el,))), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def spec_of_placements(placements) -> P:
    """The PartitionSpec of DTensor placements over AXES, up to the last
    sharded dim (as a spec assigned as P('batch') reads back)."""
    dims = {}
    for ax, pl in zip(AXES, placements):
        if pl.is_shard():
            dims.setdefault(int(pl.dim), []).append(ax)
    n = max(dims) + 1 if dims else 0
    return P(*[None if i not in dims else
               (tuple(dims[i]) if len(dims[i]) > 1 else dims[i][0]) for i in range(n)])


def named_sharding(mesh, spec, shape=None):
    """DTensor placements of `spec` on `mesh`, with the degrade rule every
    consumer shares: a dim whose size the axis group does not divide falls
    back to replicated."""
    return sharding_with_degrade(mesh, spec, shape)[0]


def sharding_with_degrade(mesh, spec, shape=None):
    """The degrade rule of `named_sharding`, plus a report: returns
    ``(placements, degraded)`` where `degraded` lists one
    ``(dim, axes, dim_size, group_size)`` tuple per dim that wanted to
    shard but fell back to replicated (an axis absent from the mesh counts
    with group_size 0). The mesh-elastic restore uses the report to
    degrade LOUDLY."""
    spec = canonicalize_spec(spec)
    clean = []
    degraded = []
    for i, el in enumerate(spec):
        names = el if isinstance(el, tuple) else (el,)
        wanted = tuple(a for a in names if a is not None)
        keep = tuple(a for a in wanted if a in mesh.axis_names)
        if wanted and not keep:
            degraded.append((i, wanted, None, 0))
        if keep and shape is not None and i < len(shape):
            group = 1
            for a in keep:
                group *= mesh.shape[a]
            if not isinstance(shape[i], int) or shape[i] % group != 0:
                degraded.append((i, keep,
                                 shape[i] if i < len(shape) else None,
                                 group))
                keep = ()
        clean.append(keep if len(keep) > 1
                     else (keep[0] if keep else None))
    return _placements(P(*clean)), degraded


def axis_sizes(mesh_or_sizes) -> dict:
    """{axis: size} from a Mesh or a plain dict."""
    if mesh_or_sizes is None:
        return {}
    shape = getattr(mesh_or_sizes, "shape", mesh_or_sizes)
    return {a: int(s) for a, s in dict(shape).items()}


def smaller_mesh_shapes(base_world: int):
    """Valid shrink targets for a `base_world`-wide job, descending (the
    supervisor's shrink policy, distributed.launch.shrink_candidates)."""
    from ..distributed.launch import shrink_candidates

    return shrink_candidates(base_world)


# ---------------------------------------------------------------------------
# PartitionSpec assignment over Program IR variables
# ---------------------------------------------------------------------------


def _post_ops(block):
    from ..framework import core_op_role

    post_role = core_op_role.Optimize | core_op_role.LRSched
    return [op for op in block.ops
            if (op.attrs.get("op_role") or 0) & post_role]


def _fwd_ops(block):
    from ..framework import core_op_role

    post_role = core_op_role.Optimize | core_op_role.LRSched
    return [op for op in block.ops
            if not ((op.attrs.get("op_role") or 0) & post_role)]


def _var_shape(block, name):
    v = block._find_var_recursive(name)
    return tuple(v.shape) if v is not None and v.shape else ()


def _param_grad_pairs(block, state_names):
    """(param, grad) pairs the optimizer segment consumes, plus the read
    count per grad (multi-consumer grads need full-grad semantics and are
    excluded from sharded updates)."""
    from ..framework import GRAD_SUFFIX

    post = _post_ops(block)
    post_reads = {n for op in post for n in op.input_arg_names()}
    grad_names = sorted(n for n in post_reads if n.endswith(GRAD_SUFFIX))
    state_set = set(state_names)
    pairs = [
        (g[: -len(GRAD_SUFFIX)], g) for g in grad_names
        if g[: -len(GRAD_SUFFIX)] in state_set
    ]
    counts = {}
    for op in post:
        for n in op.input_arg_names():
            if n.endswith(GRAD_SUFFIX):
                counts[n] = counts.get(n, 0) + 1
    return pairs, counts, post


def _accumulators_for(block, state_names, param, grad, post_ops, fwd_read):
    """Optimizer accumulators ride with their param, associated
    STRUCTURALLY: the optimizer op consuming the param's grad names them
    as its other param-shaped persistable inputs/outputs."""
    state_set = set(state_names)
    shape = _var_shape(block, param)
    out = set()
    for op in post_ops:
        if grad not in op.input_arg_names():
            continue
        for n in set(op.input_arg_names()) | set(op.output_arg_names()):
            if (
                n in state_set
                and n not in (param, grad)
                and n not in fwd_read
                and _var_shape(block, n) == shape
            ):
                out.add(n)
    return out


def zero1_accumulators(block, state_names, axis_size) -> dict:
    """ZeRO-1 over 'batch': optimizer accumulators (moments) whose dim0
    divides the batch axis get P('batch') on dim0; parameters stay
    replicated."""
    if axis_size <= 1:
        return {}
    pairs, counts, post = _param_grad_pairs(block, state_names)
    fwd_read = {n for op in _fwd_ops(block)
                for n in op.input_arg_names()}
    specs = {}
    for p, g in pairs:
        shp = _var_shape(block, p)
        if not (shp and isinstance(shp[0], int) and shp[0] % axis_size == 0):
            continue
        if counts.get(g, 0) != 1:
            continue
        for acc in _accumulators_for(block, state_names, p, g, post,
                                     fwd_read):
            specs[acc] = P("batch")
    return specs


def pipe_shardable_state(block, state_names, pipe_size,
                         stateful_fwd=(), model_dim0=()) -> dict:
    """ZeRO over 'pipe' for pipeline programs (item 9d runs them): master
    params and their accumulators sharded 1/pipe at rest."""
    if pipe_size <= 1:
        return {}
    pairs, counts, post = _param_grad_pairs(block, state_names)
    fwd_read = {n for op in _fwd_ops(block)
                for n in op.input_arg_names()}
    stateful = set(stateful_fwd)
    model0 = set(model_dim0)
    specs = {}
    for p, g in pairs:
        shp = _var_shape(block, p)
        if (
            shp
            and isinstance(shp[0], int)
            and shp[0] >= pipe_size
            and shp[0] % pipe_size == 0
            and counts.get(g, 0) == 1
            and p not in stateful
            and p not in model0
        ):
            specs[p] = P("pipe")
            for acc in _accumulators_for(block, state_names, p, g, post,
                                         fwd_read):
                specs[acc] = P("pipe")
    return specs


def assign_state_shardings(program, block, state_names, mesh, scope=None,
                           extra_specs=None) -> dict:
    """Every persistable -> its placements on `mesh`. Priority per var:
    `extra_specs` (this run's ZeRO-1 assignment) > the program's
    `shard_parameter` annotations > a live DTensor already on this mesh >
    replicated."""
    annotations = dict(getattr(program, "_sharding_specs", {}) or {})
    extra_specs = dict(extra_specs or {})
    out = {}
    for n in state_names:
        live = scope.get(n) if scope is not None and scope.has(n) else None
        dims = getattr(live, "shape", None)
        dims = tuple(dims) if dims is not None else (_var_shape(block, n) or None)
        if n in extra_specs:
            out[n] = named_sharding(mesh, extra_specs[n], dims)
            continue
        if n in annotations:
            out[n] = named_sharding(mesh, annotations[n], dims)
            continue
        live_mesh = getattr(live, "device_mesh", None)
        if live_mesh is not None and live_mesh is mesh.device_mesh:
            out[n] = tuple(live.placements)
            continue
        out[n] = named_sharding(mesh, None, dims)
    return out


def feed_shardings(mesh, feed_sig, batch_axes=("batch",)) -> dict:
    """Feeds shard their batch (leading) dim over `batch_axes`; scalars
    replicate. `feed_sig`: (name, shape, dtype) triples."""
    axes = tuple(dict.fromkeys(
        canonical_axis(a) for a in batch_axes if a is not None
    ))
    axes = tuple(a for a in axes if a in mesh.axis_names
                 and mesh.shape[a] >= 1)
    spec = axes if len(axes) > 1 else (axes[0] if axes else None)
    out = {}
    for n, shape, _ in feed_sig:
        if len(shape) >= 1:
            out[n] = named_sharding(
                mesh, P(spec, *([None] * (len(shape) - 1))), shape
            )
        else:
            out[n] = _placements(P())
    return out
