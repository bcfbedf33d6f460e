"""Static per-config cost table over an annotated Program IR (the port's
copy of `paddle_tpu/autoshard/cost_table.py`, line for line).

Given a shape-inference environment (`analysis.infer_program`) and a
PartitionSpec assignment, compute the per-device vs replicated
persistent-state bytes each mesh config would carry, with no tracing and
no devices.

On top of the raw MB math this module extracts the planner's unit of
decision: `param_groups` — (param, grad, optimizer accumulators) tuples
with their static byte sizes — so the beam search can assign one
sharding choice per group and score it additively.
"""

from __future__ import annotations

import numpy as np

from ..analysis.meta import itemsize

__all__ = [
    "state_var_names",
    "spec_shard_factor",
    "config_state_mb",
    "state_bytes",
    "ParamGroup",
    "param_groups",
    "unknown_state_vars",
]


def state_var_names(program) -> tuple:
    """Persistables the step carries as state (the
    scope-free mirror of the Executor's state analysis)."""
    names = set()
    persistable = {
        n for blk in program.blocks
        for n, v in blk.vars.items() if v.persistable
    }
    for blk in program.blocks:
        for op in blk.ops:
            for n in op.input_arg_names() + op.output_arg_names():
                if n in persistable:
                    names.add(n)
    return tuple(sorted(names))


def spec_shard_factor(spec, axis_sizes: dict) -> int:
    """Product of the mesh-axis sizes a PartitionSpec shards over
    (the divisor the per-device footprint gains)."""
    shard = 1
    if spec is not None:
        for el in tuple(spec):
            axes = el if isinstance(el, tuple) else ((el,) if el else ())
            for a in axes:
                shard *= axis_sizes.get(a, 1)
    return shard


def config_state_mb(env, state_names, specs, axis_sizes):
    """(per_device_mb, replicated_mb) from the annotated program: each
    state var's bytes divided by the product of the mesh axes sharding
    it (the checker has already validated divisibility)."""
    per_dev = full = 0.0
    for n in state_names:
        meta = env.get(n)
        if meta is None or meta.shape is None or meta.dtype is None:
            continue
        nbytes = float(np.prod(meta.shape or (1,))) * itemsize(meta.dtype)
        full += nbytes
        per_dev += nbytes / spec_shard_factor(specs.get(n), axis_sizes)
    return per_dev / 1e6, full / 1e6


def state_bytes(env, state_names) -> dict:
    """{state var: static byte size} (unknown-shape vars omitted — see
    `unknown_state_vars` for the loud side)."""
    out = {}
    for n in state_names:
        meta = env.get(n)
        if meta is None or meta.shape is None or meta.dtype is None:
            continue
        out[n] = int(
            np.prod(meta.shape or (1,)) * itemsize(meta.dtype)
        )
    return out


def unknown_state_vars(env, state_names) -> list:
    """State vars whose static shape or dtype is unknown — a nonempty
    list means the cost table would silently under-count HBM; the
    planner refuses instead."""
    return [
        n for n in state_names
        if (env.get(n) is None
            or env.get(n).shape is None
            or env.get(n).dtype is None)
    ]


class ParamGroup:
    """One placement decision unit: a trainable param, its grad, and the
    optimizer accumulators structurally associated with it (the
    `parallel.mesh` association rules — shared, not re-derived)."""

    __slots__ = ("param", "grad", "accumulators", "shape",
                 "param_bytes", "acc_bytes", "single_consumer_grad")

    def __init__(self, param, grad, accumulators, shape, param_bytes,
                 acc_bytes, single_consumer_grad):
        self.param = param
        self.grad = grad
        self.accumulators = tuple(sorted(accumulators))
        self.shape = tuple(shape or ())
        self.param_bytes = int(param_bytes)
        self.acc_bytes = int(acc_bytes)
        self.single_consumer_grad = bool(single_consumer_grad)

    def __repr__(self):
        return (f"ParamGroup({self.param!r}, accs={len(self.accumulators)},"
                f" {self.param_bytes + self.acc_bytes}B)")


def param_groups(block, state_names, env) -> list:
    """Extract the planner's decision units from the optimizer segment.
    Only params whose grad the optimizer reads form groups (frozen
    params / BN stats stay out — they are costed as residual replicated
    state by the caller)."""
    from ..parallel.mesh import _accumulators_for, _fwd_ops, _param_grad_pairs

    bytes_of = state_bytes(env, state_names)
    pairs, counts, post = _param_grad_pairs(block, state_names)
    fwd_read = {n for op in _fwd_ops(block) for n in op.input_arg_names()}
    groups = []
    for p, g in pairs:
        accs = _accumulators_for(block, state_names, p, g, post, fwd_read)
        meta = env.get(p)
        shape = meta.shape if meta is not None else None
        groups.append(ParamGroup(
            p, g, accs, shape,
            bytes_of.get(p, 0),
            sum(bytes_of.get(a, 0) for a in accs),
            counts.get(g, 0) == 1,
        ))
    return groups
