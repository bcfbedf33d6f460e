"""Fuse runs of structurally identical layer blocks into `layer_scan`
(`paddle_tpu/passes/fuse_layer_scan.py`, the same detection, proofs and
attrs, so both packages give the same post-pass Program).

The pass finds maximal runs of consecutive, repeated op segments (the
same op sequence and attrs, differing only in variable names) and
replaces each run with one `layer_scan` op (ops/scan_ops.py). The
per-layer grad closures that backward.py emits are themselves repeated
segments (one a layer, in reverse layer order, chained through the
output-grad partials), so the same detector fuses the backward region in
a second run; the forward run re-exposes, under their own names, the
per-layer activations the backward reads (`StackedOut`). The JAX package
saves trace and compile time so. Here the body still issues every
template op from Python, so the fusion saves no host issue time
(chip_smoke.py's scan phase measures it no lower, PERF.md); what falls
is peak memory, because each layer's intermediate bindings die with its
iteration.

Segment equivalence is proven, not pattern-matched:
  * a per-op structural signature (type, role, slot arity and declared
    shapes, non-name attrs; np.ndarray attrs by bytes) gates candidate
    periods;
  * a renaming map sigma_k (segment-0 name -> segment-k name) is built
    by zipping every slot of every op pair, and the attrs that carry
    names (OpDef.name_attrs; __auto_grad__'s fwd_inputs / fwd_outputs),
    and must be consistent and injective;
  * every external read is invariant (sigma_k(x) == x), carry
    (sigma_k(x) == sigma_{k-1}(y) for a segment-defined y) or stacked
    (distinct per-layer names, all live before the run); anything else
    bails the run.

Safety bails, per run: ops with sub-blocks, side-effect or collective
ops, counter-sequenced RNG ops (dce.ORDER_RNG_OPS, whose draws depend on
the lowering order), writes to persistables or feeds, and names written
outside the run. Bailing costs only the fusion.

The crc table (`crc_names`, `crc_rows`: crc32 of each template name's
per-layer image) gives the body each layer's dropout keys and the keys
of the graphs its forward recorded (ops/registry.py `var_id`).

Opt-in: BuildStrategy.fuse_layer_scan or PADDLE_TPU_FUSE_LAYER_SCAN=1,
absent from the cache signature until enabled. Tuning:
PADDLE_TPU_SCAN_MIN_SEGMENTS (default 2) and PADDLE_TPU_SCAN_MIN_OPS
(default 4) set the floor under which a run is not fused. Counters:
scan_fused_runs, scan_fused_layers, scan_fused_ops_removed.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib

import numpy as np

from .. import profiler
from ..framework import Operator, op_has_sub_block
from . import register_pass
from .dce import COLLECTIVE_PREFIXES, ORDER_RNG_OPS, SIDE_EFFECT_OPS

_MAX_PERIOD = 160  # ops per segment worth trying (a layer is ~20-60)


def enabled(build_strategy=None) -> bool:
    if os.environ.get("PADDLE_TPU_FUSE_LAYER_SCAN", "").strip().lower() in (
        "1", "true", "on", "yes"
    ):
        return True
    return bool(getattr(build_strategy, "fuse_layer_scan", False))


def _min_segments() -> int:
    return max(2, int(os.environ.get("PADDLE_TPU_SCAN_MIN_SEGMENTS", "2") or 2))


def _min_ops() -> int:
    return max(2, int(os.environ.get("PADDLE_TPU_SCAN_MIN_OPS", "4") or 4))


def _name_attr_spec(op_type: str) -> tuple:
    """Attrs of this op type whose values are var names (see
    OpDef.name_attrs). __auto_grad__ is synthesized by backward.py, not
    registered, so it is spelled here."""
    if op_type == "__auto_grad__":
        return ("fwd_inputs", "fwd_outputs")
    from ..ops.registry import _OP_REGISTRY

    opdef = _OP_REGISTRY.get(op_type)
    return opdef.name_attrs if opdef is not None else ()


def _hashable_attr(v):
    """A hashable, comparable stand-in for an attr value, or None when
    the value can't be proven equal across segments (unknown object)."""
    if isinstance(v, (bool, int, float, str, bytes)) or v is None:
        return (type(v).__name__, v)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        parts = tuple(_hashable_attr(x) for x in v)
        return None if any(p is None for p in parts) else ("seq", parts)
    if isinstance(v, dict):
        try:
            keys = sorted(v)
        except TypeError:
            return None
        parts = tuple((k, _hashable_attr(v[k])) for k in keys)
        return None if any(p is None for _, p in parts) else ("map", parts)
    return None


def _op_sig(block, op, feeds):
    """Structural signature (name-free), or None when the op can never
    participate in a run."""
    t = op.type
    if (
        t == "layer_scan"
        or t in SIDE_EFFECT_OPS
        or t in ORDER_RNG_OPS
        or t.startswith(COLLECTIVE_PREFIXES)
        or op_has_sub_block(op)
    ):
        return None
    for n in op.output_arg_names():
        if not n:
            continue
        if n in feeds:
            return None
        var = block._find_var_recursive(n)
        if var is not None and var.persistable:
            return None
    name_attrs = set(_name_attr_spec(t))
    attr_parts = []
    for k in sorted(op.attrs):
        if k in name_attrs:
            v = op.attrs[k]
            # names compare through sigma; only the SHAPE of the attr
            # (slots and arities for the __auto_grad__ dicts) is
            # structural
            if isinstance(v, dict):
                attr_parts.append(
                    (k, "names", tuple(sorted(
                        (s, len(v[s]), tuple(bool(n) for n in v[s]))
                        for s in v
                    )))
                )
            else:
                attr_parts.append((k, "name", v is not None))
            continue
        hv = _hashable_attr(op.attrs[k])
        if hv is None:
            return None
        attr_parts.append((k, hv))
    sig = [t, tuple(attr_parts)]
    for side, slots in (("i", op.inputs), ("o", op.outputs)):
        for slot in sorted(slots):
            # declared shape/dtype are structural: the JAX lowering
            # stacks each slot across segments, so a same-op-sequence
            # segment with a different width (e.g. the head fc's grad
            # after a run of uniform blocks) must not join the run
            metas = []
            for n in slots[slot]:
                var = block._find_var_recursive(n) if n else None
                metas.append((
                    bool(n),
                    tuple(var.shape) if var is not None and var.shape
                    else None,
                    str(var.dtype) if var is not None else None,
                ))
            sig.append((side, slot, tuple(metas)))
    return tuple(sig)


def _name_pairs(o0, ok):
    """(segment-0 name, segment-k name) pairs across every slot and
    name-bearing attr of an op pair with equal structural signatures."""
    for slots0, slotsk in ((o0.inputs, ok.inputs), (o0.outputs, ok.outputs)):
        for slot in slots0:
            yield from zip(slots0[slot], slotsk[slot])
    for attr in _name_attr_spec(o0.type):
        v0, vk = o0.attrs.get(attr), ok.attrs.get(attr)
        if isinstance(v0, str) and isinstance(vk, str):
            yield (v0, vk)
        elif isinstance(v0, dict) and isinstance(vk, dict):
            for slot in v0:
                yield from zip(v0[slot], vk[slot])


class _Bail(Exception):
    pass


def _build_sigma(segments):
    """sigma_k (k=1..n-1) mapping segment-0 names to segment-k names;
    raises _Bail on any inconsistency or non-injectivity."""
    maps = []
    for k in range(1, len(segments)):
        fwd: dict[str, str] = {}
        inv: dict[str, str] = {}
        for o0, ok in zip(segments[0], segments[k]):
            for n0, nk in _name_pairs(o0, ok):
                if bool(n0) != bool(nk):
                    raise _Bail()
                if not n0:
                    continue
                if fwd.setdefault(n0, nk) != nk or inv.setdefault(nk, n0) != n0:
                    raise _Bail()
        maps.append(fwd)
    return maps


def _op_read_names(op):
    return [n for names in op.inputs.values() for n in names if n]


def _op_write_names(op):
    return [n for names in op.outputs.values() for n in names if n]


def _sub_block_reads(op):
    if not op_has_sub_block(op):
        return ()
    from ..framework import block_external_reads

    reads = []
    for v in op.attrs.values():
        if hasattr(v, "ops") and hasattr(v, "vars"):
            reads.extend(block_external_reads(v))
    return reads


class _RunSpec:
    """Verified rewrite plan for one run."""

    def __init__(self):
        self.carry_pairs = []       # (init name, template carry-out name)
        self.invariants = []
        self.stacked = []           # (template name, [per-k names])
        self.ys = []                # (template name, [name or "" per k])
        self.finals = []            # (template carry-out, final name)
        self.crc = []               # (template name, [per-k crc rows])
        self.internal_names = set() # per-layer names the scan absorbs


def _verify_run(block, ops, start, p, n, feeds, fetches, writes, reads_after):
    """Prove segments ops[start : start+n*p] are sigma-equivalent and
    classify the dataflow. Returns a _RunSpec or None."""
    segments = [ops[start + k * p: start + (k + 1) * p] for k in range(n)]
    try:
        maps = _build_sigma(segments)
    except _Bail:
        return None

    def sigma(k, name):
        return name if k == 0 else maps[k - 1].get(name, name)

    end = start + n * p
    spec = _RunSpec()

    # names defined by each segment (template name -> per-k images)
    defined0 = {}
    for j, op in enumerate(segments[0]):
        for nm in _op_write_names(op):
            defined0.setdefault(nm, j)
    images = {
        d: [sigma(k, d) for k in range(n)] for d in defined0
    }
    all_images = {nm for imgs in images.values() for nm in imgs}
    # a run-defined name must be written only inside the run, exactly
    # once per segment (multiple writes inside one segment are fine —
    # sequential re-binding — but a write from OUTSIDE aliases state the
    # scan can't see)
    for imgs in images.values():
        if len(set(imgs)) != n:
            return None
        for nm in imgs:
            if any(w < start or w >= end for w in writes.get(nm, ())):
                return None

    def live_before(name):
        if name in feeds:
            return True
        w = writes.get(name)
        if w and min(w) < start:
            return True
        var = block._find_var_recursive(name)
        return var is not None and (
            var.persistable or getattr(var, "is_data", False)
        )

    # classify segment-0 external reads
    seen = set()
    for op in segments[0]:
        for r in _op_read_names(op):
            if r in seen or r in defined0:
                continue
            seen.add(r)
            imgs = [sigma(k, r) for k in range(n)]
            if all(nm == r for nm in imgs):
                # invariant: must not be written inside the run
                if any(start <= w < end for w in writes.get(r, ())):
                    return None
                spec.invariants.append(r)
                continue
            y = imgs[1] if n > 1 else None
            if y in defined0:
                # carry: segment k reads what segment k-1 defined at y
                if all(imgs[k] == sigma(k - 1, y) for k in range(1, n)):
                    if not live_before(r):
                        return None
                    if any(start <= w < end for w in writes.get(r, ())):
                        return None
                    spec.carry_pairs.append((r, y))
                    continue
                return None
            # stacked: distinct per-layer externals, all live before
            if len(set(imgs)) != n:
                return None
            if not all(live_before(nm) for nm in imgs):
                return None
            if any(
                start <= w < end
                for nm in imgs
                for w in writes.get(nm, ())
            ):
                return None
            spec.stacked.append((r, imgs))

    # exposure: which per-layer defined names are read outside the run
    carry_outs = {y for _, y in spec.carry_pairs}
    for d, imgs in images.items():
        exposed = [
            k for k, nm in enumerate(imgs)
            if nm in fetches or any(
                ri >= end or ri < start for ri in reads_after.get(nm, ())
            )
        ]
        if not exposed:
            spec.internal_names.update(imgs)
            continue
        if d in carry_outs and exposed == [n - 1]:
            spec.finals.append((d, imgs[n - 1]))
            spec.internal_names.update(imgs[:-1])
        else:
            spec.ys.append(
                (d, [imgs[k] if k in exposed else "" for k in range(n)])
            )
            spec.internal_names.update(
                imgs[k] for k in range(n) if k not in exposed
            )

    # crc table over the whole sigma domain (defined + read + attr
    # names): scan_ops keys per-iteration RNG on these
    domain = set(defined0) | seen
    for op in segments[0]:
        for attr in _name_attr_spec(op.type):
            v = op.attrs.get(attr)
            if isinstance(v, str):
                domain.add(v)
            elif isinstance(v, dict):
                for names in v.values():
                    domain.update(nm for nm in names if nm)
    for nm in sorted(domain):
        spec.crc.append((
            nm,
            [zlib.crc32(sigma(k, nm).encode()) & 0x7FFFFFFF
             for k in range(n)],
        ))
    return spec


def _template_sig(segments0, spec, n):
    payload = {
        "n": n,
        "ops": [op.to_dict() for op in segments0],
        "carry": spec.carry_pairs,
        "stacked": spec.stacked,
        "ys": spec.ys,
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _make_scan_op(block, segments0, spec, n):
    inputs = {
        "Carry": [x for x, _ in spec.carry_pairs],
        "Stacked": [nm for _, imgs in spec.stacked for nm in imgs],
        "Inv": list(spec.invariants),
    }
    outputs = {
        "FinalOut": [nm for _, nm in spec.finals],
        "StackedOut": [nm for _, names in spec.ys for nm in names if nm],
    }
    attrs = {
        "template_ops": list(segments0),
        "num_iters": n,
        "carry_out_names": [y for _, y in spec.carry_pairs],
        "stacked_templates": [t for t, _ in spec.stacked],
        "ys_templates": [t for t, _ in spec.ys],
        "ys_names": [list(names) for _, names in spec.ys],
        "final_templates": [t for t, _ in spec.finals],
        "crc_names": [nm for nm, _ in spec.crc],
        "crc_rows": [list(rows) for _, rows in spec.crc],
        "sig": _template_sig(segments0, spec, n),
        "op_role": segments0[0].attr("op_role", 0),
    }
    return Operator(block, "layer_scan", inputs, outputs, attrs)


def _index_block(block, ops, feeds):
    sigs = []
    writes: dict[str, list] = {}
    reads: dict[str, list] = {}
    for i, op in enumerate(ops):
        sigs.append(_op_sig(block, op, feeds))
        for nm in _op_write_names(op):
            writes.setdefault(nm, []).append(i)
        for nm in _op_read_names(op):
            reads.setdefault(nm, []).append(i)
        for nm in _sub_block_reads(op):
            reads.setdefault(nm, []).append(i)
    return sigs, writes, reads


def _find_run(block, ops, sigs, i, feeds, fetches, writes, reads, min_seg,
              min_ops):
    if sigs[i] is None:
        return None
    limit = len(ops)
    for p in range(1, min(_MAX_PERIOD, (limit - i) // 2) + 1):
        if sigs[i + p] != sigs[i]:
            continue
        if any(sigs[i + j] is None for j in range(p)):
            return None  # an ineligible op caps every larger period too
        n = 1
        while (
            i + (n + 1) * p <= limit
            and sigs[i + n * p: i + (n + 1) * p] == sigs[i: i + p]
        ):
            n += 1
        if n < min_seg or n * p < min_ops:
            continue
        # a trailing segment can break the carry chain (e.g. its output
        # feeds a different consumer shape) — trim from the end before
        # giving up on this period
        for nn in range(n, min_seg - 1, -1):
            if nn * p < min_ops:
                break
            spec = _verify_run(
                block, ops, i, p, nn, feeds, fetches, writes, reads
            )
            if spec is not None:
                return p, nn, spec
    return None


def _drop_orphan_decls(block, names):
    for nm in names:
        var = block.vars.get(nm)
        if var is None or var.persistable or getattr(var, "is_data", False):
            continue
        del block.vars[nm]


@register_pass("fuse_layer_scan", strategy_knob="fuse_layer_scan", version=1)
def fuse_layer_scan(program, block, feed_names, fetch_names, ctx=None):
    feeds = set(feed_names)
    fetches = set(fetch_names)
    min_seg, min_ops = _min_segments(), _min_ops()
    removed = 0
    fused_runs = 0
    # re-index after every rewrite: positions shift and a fused forward
    # run changes nothing for the backward run's detection (per-layer
    # names survive as StackedOut), but its write positions move
    changed = True
    while changed:
        changed = False
        ops = list(block.ops)
        sigs, writes, reads = _index_block(block, ops, feeds)
        i = 0
        while i < len(ops) - 1:
            found = _find_run(
                block, ops, sigs, i, feeds, fetches, writes, reads,
                min_seg, min_ops
            )
            if found is None:
                i += 1
                continue
            p, n, spec = found
            scan_op = _make_scan_op(block, ops[i: i + p], spec, n)
            block.ops = ops[:i] + [scan_op] + ops[i + n * p:]
            _drop_orphan_decls(block, spec.internal_names)
            removed += n * p - 1
            fused_runs += 1
            profiler.bump_counter("scan_fused_runs")
            profiler.bump_counter("scan_fused_layers", n)
            changed = True
            break
    if fused_runs:
        profiler.bump_counter("scan_fused_ops_removed", removed)
        if ctx is not None:
            ctx.mutated = True
    return removed
