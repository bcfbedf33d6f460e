"""Sharding consistency checker over Program IR PartitionSpec
annotations (the port's copy of `paddle_tpu/analysis/sharding_check.py`).

assign_state_shardings (parallel/mesh.py) resolves a priority stack of
spec sources silently; this checker surfaces the problems that silently
degrade or would crash the compile instead:

  * every spec axis must canonicalize onto a real mesh axis
    (batch/model/pipe, legacy dp/tp/sp/ep/pp accepted);
  * a spec must not have more entries than its variable has dims;
  * a sharded dim must divide by the product of its mesh axis sizes
    (unless the caller opts into degrade semantics: mesh.py's
    sharding_with_degrade replicates it);
  * no state var may be assigned two different shardings for one
    compiled step (annotation vs ZeRO/pipe extra specs).

Shapes come from the static inference env when provided, else from
declared Variable shapes.
"""

from __future__ import annotations

from .verifier import Finding

__all__ = ["check_spec_axes", "check_sharding"]


def _spec_elements(spec):
    """Normalize a PartitionSpec-like into a list of per-dim axis name
    tuples (None -> empty tuple)."""
    out = []
    for el in tuple(spec):
        if el is None:
            out.append(())
        elif isinstance(el, (tuple, list)):
            out.append(tuple(el))
        else:
            out.append((el,))
    return out


def _canonical(spec):
    from ..parallel.mesh import canonicalize_spec

    return canonicalize_spec(spec)


def _find_var(program, name):
    for blk in program.blocks:
        if name in blk.vars:
            return blk.vars[name]
    return None


def check_spec_axes(program, name, spec) -> list:
    """Axis-name + rank validity of one annotation (the cheap subset the
    per-pass verifier runs without a mesh)."""
    out = []
    try:
        canon = _canonical(spec)
    except ValueError as e:
        out.append(Finding(
            "sharding-unknown-axis", str(e), var=name,
        ))
        return out
    var = _find_var(program, name)
    if var is None:
        out.append(Finding(
            "sharding-missing-var",
            "PartitionSpec annotation names a variable the program does "
            "not declare", var=name,
        ))
        return out
    if var.shape is not None and len(tuple(canon)) > len(var.shape):
        out.append(Finding(
            "sharding-rank",
            f"PartitionSpec {tuple(spec)} has more entries than the "
            f"variable has dims ({len(var.shape)})", var=name,
        ))
    return out


def _axis_sizes(mesh):
    if mesh is None:
        return None
    from ..parallel.mesh import axis_sizes

    return axis_sizes(mesh)


def check_sharding(
    program,
    mesh=None,
    specs=None,
    extra_specs=None,
    env=None,
    allow_degrade=False,
) -> list:
    """Full consistency check. `mesh` is a parallel.mesh.Mesh or a plain
    {axis: size} dict; without it only axis names/ranks/conflicts are
    checked. `env` is a shape-inference environment (InferResult or
    {name: VarMeta}) used for concrete dims; declared shapes are the
    fallback. `extra_specs` are the per-compile ZeRO/pipe assignments
    layered over the program annotations — a var appearing in both with
    different canonical specs is a conflict (one compiled step must not
    shard one state var two ways)."""
    out: list[Finding] = []
    if specs is None:
        specs = dict(getattr(program, "_sharding_specs", {}) or {})
    extra_specs = dict(extra_specs or {})
    sizes = _axis_sizes(mesh)
    metas = getattr(env, "env", env) or {}

    def dim_of(name, i):
        m = metas.get(name)
        if m is not None and getattr(m, "shape", None) is not None:
            return m.shape[i]
        var = _find_var(program, name)
        if (
            var is not None and var.shape is not None
            and all(isinstance(d, int) and d >= 0 for d in var.shape)
        ):
            return var.shape[i]
        return None

    for name in sorted(set(specs) | set(extra_specs)):
        spec = extra_specs.get(name, specs.get(name))
        findings = check_spec_axes(program, name, spec)
        out.extend(findings)
        if findings:
            continue
        canon = _canonical(spec)
        if name in specs and name in extra_specs:
            if tuple(_canonical(specs[name])) != tuple(canon):
                out.append(Finding(
                    "sharding-conflict",
                    f"variable is annotated {tuple(specs[name])} but the "
                    f"compiled step assigns {tuple(spec)} — one step must "
                    "not shard a state var two different ways", var=name,
                ))
        if sizes is None:
            continue
        for i, axes in enumerate(_spec_elements(canon)):
            if not axes:
                continue
            size = 1
            for a in axes:
                if a not in sizes:
                    out.append(Finding(
                        "sharding-unknown-axis",
                        f"mesh has no axis {a!r} (axes: {sorted(sizes)})",
                        var=name,
                    ))
                    size = None
                    break
                size *= sizes[a]
            if not size or size == 1:
                continue
            dim = dim_of(name, i)
            if dim is not None and dim % size != 0 and not allow_degrade:
                out.append(Finding(
                    "sharding-indivisible",
                    f"dim {i} of size {dim} is sharded over "
                    f"{'x'.join(axes)} = {size} but is not divisible "
                    "(mesh.sharding_with_degrade would replicate it "
                    "with a WARNING)", var=name,
                ))
    return out
