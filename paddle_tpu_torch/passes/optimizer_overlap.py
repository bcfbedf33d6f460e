"""Split fused optimizer waves by where each member's grad is final
(`paddle_tpu/passes/optimizer_overlap.py`). Opt-in:
BuildStrategy.optimizer_overlap or PADDLE_TPU_OPTIMIZER_OVERLAP=1 (absent
from the resolved pass set until enabled).

fuse_optimizer leaves one fused_<type> op at the end of the program. Each
member's update is legal as soon as its OWN grad is final, and the
backward finalizes grads in reverse layer order. This pass partitions
each fused op's members by the program position where their update
becomes legal:

    e_m = 1 + max( last writer of any member input  (its grad, its
                   lr schedule),
                   last reader of any name the member writes (the
                   param itself: every backward op that re-reads it
                   must see the PRE-update value) )

clamped at the fused op's position. Members cluster by largest-gap
splitting on e_m into at most PADDLE_TPU_OPT_OVERLAP_GROUPS (default 8)
groups, and each group is emitted as its own fused op right after its
latest producer. Per-member math is the fused lowering's, member state is
disjoint, and group order keeps member order, so fetches are bitwise
equal with the pass on and off.

It is pure IR over the fused ops, with no lowering of its own. Under the
JAX package the split lets XLA schedule updates under the backward tail;
here the Executor issues every op on one CUDA stream in program order, so
the split moves where the updates are issued and the device runs them
there, between backward kernels, not beside them.

Counter: optimizer_overlap_groups. One fused op becomes k, so the pass
returns a negative removal count.
"""

from __future__ import annotations

import os

from .. import profiler
from ..framework import Operator, core_op_role
from . import register_pass
from .fuse_optimizer import FUSABLE


def enabled(build_strategy=None) -> bool:
    if os.environ.get("PADDLE_TPU_OPTIMIZER_OVERLAP", "").strip().lower() in (
        "1", "true", "on", "yes"
    ):
        return True
    return bool(getattr(build_strategy, "optimizer_overlap", False))


def _max_groups() -> int:
    return max(1, int(os.environ.get("PADDLE_TPU_OPT_OVERLAP_GROUPS", "8")
                      or 8))


def _member_views(op):
    """Per-member (inputs, outputs) name dicts of a fused_* op."""
    base = op.type[len("fused_"):]
    per_param, shared, out_slots = FUSABLE[base]
    count = len(op.input(per_param[0]))
    members = []
    for m in range(count):
        ins = {slot: op.input(slot)[m] for slot in per_param}
        for slot in shared:
            ins[slot] = op.input(slot)[0]
        outs = {slot: op.output(slot)[m] for slot in out_slots}
        members.append((ins, outs))
    return members


def _earliest_position(member, pos, writes, reads):
    """First index at which this member's update is legal, capped at the
    fused op's original position `pos`."""
    ins, outs = member
    e = 0
    for nm in ins.values():
        for w in writes.get(nm, ()):
            if w < pos:
                e = max(e, w + 1)
    for nm in outs.values():
        for r in reads.get(nm, ()):
            if r < pos:
                e = max(e, r + 1)
        # another writer of this name before us (lr-schedule updating
        # Beta*Pow in place) also fences the move
        for w in writes.get(nm, ()):
            if w < pos:
                e = max(e, w + 1)
    return min(e, pos)


def _cluster(positions, max_groups):
    """Largest-gap clustering of sorted (position, member_idx) pairs into
    at most max_groups contiguous groups."""
    order = sorted(range(len(positions)), key=lambda m: (positions[m], m))
    gaps = [
        (positions[order[j + 1]] - positions[order[j]], j)
        for j in range(len(order) - 1)
    ]
    cuts = sorted(
        j for gap, j in sorted(gaps, reverse=True)[: max_groups - 1] if gap > 0
    )
    groups, prev = [], 0
    for j in cuts:
        groups.append(order[prev: j + 1])
        prev = j + 1
    groups.append(order[prev:])
    return [g for g in groups if g]


def _hoist_input_free_producers(ops):
    """Move input-free Optimize/LRSched-role producers (the assign_value
    / fill_constant ops that materialize the learning rate right before
    the optimizer wave) to their own earliest legal position. Left in
    place they fence EVERY member at the wave's original index — the
    lr write is the last op before the fused update. Returns True when
    anything moved."""
    moved = False
    for i in range(len(ops)):
        op = ops[i]
        if op.attr("op_role", 0) not in (
            core_op_role.Optimize, core_op_role.LRSched
        ):
            continue
        if any(nm for names in op.inputs.values() for nm in names):
            continue
        out_names = set(op.output_arg_names())
        target = 0
        for j in range(i):
            other = ops[j]
            touches = out_names.intersection(
                other.input_arg_names()
            ) or out_names.intersection(other.output_arg_names())
            if touches:
                target = j + 1
        if target < i:
            ops.insert(target, ops.pop(i))
            moved = True
    return moved


def _split_one(block, ops, max_groups):
    """Split the LAST not-yet-split fused wave in `ops`; returns the new
    group count (0 when nothing split). One wave per call: every splice
    shifts indices, so the caller re-indexes between waves."""
    writes: dict[str, list] = {}
    reads: dict[str, list] = {}
    for i, op in enumerate(ops):
        for nm in op.output_arg_names():
            if nm:
                writes.setdefault(nm, []).append(i)
        for nm in op.input_arg_names():
            if nm:
                reads.setdefault(nm, []).append(i)

    for pos in range(len(ops) - 1, -1, -1):
        op = ops[pos]
        if not op.type.startswith("fused_") or (
            op.type[len("fused_"):] not in FUSABLE
        ) or op.attr("overlap_group", False):
            continue
        members = _member_views(op)
        if len(members) < 2:
            continue
        e = [_earliest_position(m, pos, writes, reads) for m in members]
        groups = _cluster(e, max_groups)
        # a single group still gets the marker: the wave was considered
        # and must not be revisited forever by the caller's loop
        base = op.type[len("fused_"):]
        per_param, shared, out_slots = FUSABLE[base]
        attrs = dict(op.attrs)
        attrs["overlap_group"] = True
        group_ops = []
        for g in groups:
            # keep original member order inside the group: the fused
            # lowering's per-tensor math is order-independent, the IR
            # diff stays readable
            g = sorted(g)
            inputs = {
                slot: [members[m][0][slot] for m in g] for slot in per_param
            }
            for slot in shared:
                inputs[slot] = [members[g[0]][0][slot]]
            outputs = {
                slot: [members[m][1][slot] for m in g] for slot in out_slots
            }
            at = min(max(e[m] for m in g), pos)
            group_ops.append(
                (at, Operator(block, op.type, inputs, outputs, attrs))
            )
        # splice: drop the original, insert each group after its latest
        # producer, highest position first so lower insert points stay
        # valid
        del ops[pos]
        for at, gop in sorted(group_ops, key=lambda t: t[0], reverse=True):
            ops.insert(min(at, len(ops)), gop)
        return len(groups)
    return 0


@register_pass("optimizer_overlap", strategy_knob="optimizer_overlap",
               version=1)
def optimizer_overlap(program, block, feed_names, fetch_names, ctx=None):
    ops = list(block.ops)
    hoisted = _hoist_input_free_producers(ops)
    max_groups = _max_groups()
    added = 0
    total_groups = 0
    while True:
        n_groups = _split_one(block, ops, max_groups)
        if not n_groups:
            break
        added += n_groups - 1
        total_groups += n_groups

    if added or hoisted:
        block.ops = ops
        if total_groups > 1:
            profiler.bump_counter("optimizer_overlap_groups", total_groups)
        if ctx is not None:
            ctx.mutated = True
    return -added
