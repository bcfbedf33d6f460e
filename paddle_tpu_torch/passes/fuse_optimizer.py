"""Fused multi-tensor optimizer apply (`paddle_tpu/passes/fuse_optimizer.py`;
reference fuse_all_optimizer_ops, details/build_strategy.cc:299).

A minimize() emits one optimizer op per parameter; on Transformer-base
that is 254 adam ops, each ~20 torch calls the Executor issues on every
step. This pass coalesces them: within a consecutive run of optimizer
ops, same-signature updates (same op type, attrs, learning-rate var and
param dtype) collapse into ONE fused_<type> op updating the whole group,
lowered on torch._foreach_* (ops/optimizer_ops.py) with each tensor's
math the per-op lowering's.

Safety: a run is only fused when its ops are provably commutative: no
name is written by two ops and every written name is read only by its
writer. Duplicate params, other slot layouts or dataflow out of the run
leave the ops untouched.
"""

from __future__ import annotations

from ..framework import convert_dtype
from . import register_pass

# op type -> (list-fusable input slots, shared input slots, output slots)
FUSABLE = {
    "sgd": (("Param", "Grad"), ("LearningRate",), ("ParamOut",)),
    "momentum": (
        ("Param", "Grad", "Velocity"),
        ("LearningRate",),
        ("ParamOut", "VelocityOut"),
    ),
    "adam": (
        ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
        ("LearningRate",),
        ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
         "Beta2PowOut"),
    ),
    "adamw": (
        ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
        ("LearningRate",),
        ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
         "Beta2PowOut"),
    ),
    "lamb": (
        ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
        ("LearningRate",),
        ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
         "Beta2PowOut"),
    ),
}

_SIG_SKIP_ATTRS = ("op_role",)


def _op_signature(block, op):
    """Grouping key, or None when this op's shape doesn't fit fusion."""
    per_param, shared, outs = FUSABLE[op.type]
    for slot in per_param + shared:
        if len(op.input(slot)) != 1:
            return None
    for slot in outs:
        if len(op.output(slot)) != 1:
            return None
    pvar = block._find_var_recursive(op.input("Param")[0])
    if pvar is None or pvar.dtype is None:
        return None
    attrs = tuple(
        sorted(
            (k, repr(v))
            for k, v in op.attrs.items()
            if k not in _SIG_SKIP_ATTRS
        )
    )
    return (op.type, op.input("LearningRate")[0],
            convert_dtype(pvar.dtype), attrs)


def _run_is_commutative(run_ops):
    """True iff any ordering of the run is observationally equivalent:
    every name is written at most once, and only its writer reads it."""
    writers: dict[str, int] = {}
    for i, op in enumerate(run_ops):
        for n in op.output_arg_names():
            if not n:
                continue
            if n in writers:
                return False  # double write (shared param/accumulator)
            writers[n] = i
    for i, op in enumerate(run_ops):
        for n in op.input_arg_names():
            if n in writers and writers[n] != i:
                return False  # cross-op read of a written name
    return True


def _fuse_run(block, run):
    """run: list of (index, op, signature). Returns {index: replacement
    op or None (dropped)} for fused members; empty when nothing fuses."""
    from ..framework import Operator, core_op_role

    groups: dict[tuple, list] = {}
    for idx, op, sig in run:
        groups.setdefault(sig, []).append((idx, op))
    replacements: dict[int, object] = {}
    for sig, members in groups.items():
        if len(members) < 2:
            continue
        op_type = sig[0]
        per_param, shared, out_slots = FUSABLE[op_type]
        inputs = {
            slot: [op.input(slot)[0] for _, op in members]
            for slot in per_param
        }
        for slot in shared:
            inputs[slot] = [members[0][1].input(slot)[0]]
        outputs = {
            slot: [op.output(slot)[0] for _, op in members]
            for slot in out_slots
        }
        attrs = {
            k: v
            for k, v in members[0][1].attrs.items()
            if k not in _SIG_SKIP_ATTRS
        }
        attrs["op_role"] = core_op_role.Optimize
        fused = Operator(block, f"fused_{op_type}", inputs, outputs, attrs)
        first_idx = members[0][0]
        replacements[first_idx] = fused
        for idx, _ in members[1:]:
            replacements[idx] = None
    return replacements


@register_pass("fuse_optimizer", strategy_knob="fuse_all_optimizer_ops")
def fuse_optimizer_ops(program, block, feed_names, fetch_names, ctx=None):
    ops = block.ops
    removed = 0
    new_ops = []
    i = 0
    while i < len(ops):
        if ops[i].type not in FUSABLE:
            new_ops.append(ops[i])
            i += 1
            continue
        # maximal consecutive run of fusable-typed ops
        j = i
        run = []
        while j < len(ops) and ops[j].type in FUSABLE:
            sig = _op_signature(block, ops[j])
            run.append((j, ops[j], sig))
            j += 1
        fusable_members = [r for r in run if r[2] is not None]
        replacements = {}
        if len(fusable_members) >= 2 and _run_is_commutative(
            [op for _, op, _ in run]
        ):
            replacements = _fuse_run(block, fusable_members)
        for idx, op, _sig in run:
            if idx in replacements:
                rep = replacements[idx]
                if rep is not None:
                    new_ops.append(rep)
                else:
                    removed += 1
            else:
                new_ops.append(op)
        i = j
    if removed:
        block.ops = new_ops
    return removed
