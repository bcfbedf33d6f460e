"""Static per-op shape/dtype inference over the Program IR: the engine of
`paddle_tpu/analysis/shape_infer.py`.

The engine walks a Block in op order, driving the per-op *shape
functions* of `SHAPE_FNS`, and produces a {var name -> VarMeta}
environment: the static mirror of what LoweringContext.values holds
during the walk. Seeds are the program's persistables (their declared
shapes, concrete for parameters) plus the caller's feed metas.

Grad ops need no per-type functions: `__auto_grad__` maps each
IGRAD_<slot> output to the forward input it differentiates (the op's
fwd_inputs attr), and custom *_grad ops' IGRAD_ outputs are named
`<fwd>@GRAD[...]` by backward.py's helpers: both resolve to the forward
var's meta.

The JAX package's library of shape functions (its ops/shape_fns.py) is
ROADMAP Queue 1 item 11, so `SHAPE_FNS` starts empty: an op without a
shape function poisons its outputs to unknown (the engine never
guesses), except a persistable output, which keeps its declared meta (a
step writes a persistable back in the shape it read). The result records
the ops it could not cover.
"""

from __future__ import annotations

from ..framework import GRAD_SUFFIX
from .meta import InferError, Unknown, VarMeta, lowered_dtype

__all__ = ["SHAPE_FNS", "InferContext", "InferResult", "infer_program", "infer_block"]

# op type -> fn(InferContext, op) writing the op's output metas
SHAPE_FNS: dict = {}


class InferResult:
    def __init__(self, program, block):
        self.program = program
        self.block = block
        self.env: dict[str, VarMeta] = {}
        # (block_idx, op_idx, op_type) of ops lacking a shape function
        self.missing: list[tuple] = []
        # (block_idx, op_idx, op_type, message) of shape-fn failures
        self.errors: list[tuple] = []
        self.ops_total = 0
        self.ops_covered = 0

    def meta(self, name) -> VarMeta | None:
        return self.env.get(name)

    @property
    def missing_types(self) -> set:
        return {t for _, _, t in self.missing}

    def coverage(self) -> float:
        return self.ops_covered / self.ops_total if self.ops_total else 1.0


class InferContext:
    """Mirror of LoweringContext for shape functions: in_/ins/out sugar
    over VarMetas instead of tensors."""

    def __init__(self, program, block, result: InferResult, is_test=False):
        self.program = program
        self.block = block
        self.result = result
        self.env = result.env
        self.is_test = is_test

    # -- access -------------------------------------------------------------
    def meta(self, name) -> VarMeta | None:
        return self.env.get(name)

    def in_(self, op, slot, idx=0, default=None):
        names = op.input(slot)
        if len(names) <= idx or not names[idx]:
            return default
        return self.env.get(names[idx])

    def ins(self, op, slot):
        return [self.env.get(n) if n else None for n in op.input(slot)]

    def require(self, *metas):
        """Unwrap metas, raising Unknown (silent poison, not an error)
        when any is missing a shape or dtype — for shape functions that
        cannot produce anything without them."""
        for m in metas:
            if m is None or m.shape is None or m.dtype is None:
                raise Unknown()
        return metas if len(metas) > 1 else metas[0]

    def out(self, op, slot, meta, idx=0):
        names = op.output(slot)
        if names and idx < len(names) and names[idx]:
            self.env[names[idx]] = meta

    def op_is_test(self, op) -> bool:
        return bool(op.attr("is_test", False)) or self.is_test


def _seed_env(program, block, feeds, result):
    for blk in program.blocks:
        for name, var in blk.vars.items():
            if not var.persistable:
                continue
            shape = None
            if var.shape is not None and all(
                isinstance(d, int) and d >= 0 for d in var.shape
            ):
                shape = tuple(var.shape)
            try:
                dt = lowered_dtype(var.dtype)
            except (InferError, ValueError):
                dt = None
            result.env[name] = VarMeta(shape, dt)
    if feeds:
        for name, spec in feeds.items():
            if isinstance(spec, VarMeta):
                result.env[name] = spec
            else:
                shape, dtype = spec
                result.env[name] = VarMeta(
                    tuple(shape) if shape is not None else None,
                    lowered_dtype(dtype) if dtype is not None else None,
                )
    else:
        # no concrete feed signature: seed data vars from declarations
        # (negative dims -> unknown shape, dtype still known)
        for blk in program.blocks:
            for name, var in blk.vars.items():
                if not getattr(var, "is_data", False) or name in result.env:
                    continue
                shape = None
                if var.shape is not None and all(
                    isinstance(d, int) and d >= 0 for d in var.shape
                ):
                    shape = tuple(var.shape)
                try:
                    dt = lowered_dtype(var.dtype)
                except (InferError, ValueError):
                    dt = None
                result.env[name] = VarMeta(shape, dt)


def _grad_base(name):
    """`x@GRAD`, `x@GRAD@PARTIAL_3`, `x@GRAD@RENAME...` -> `x`."""
    i = name.find(GRAD_SUFFIX)
    return name[:i] if i > 0 else None


def _infer_auto_grad(ictx, op):
    fwd_inputs = op.attr("fwd_inputs") or {}
    for slot, names in op.outputs.items():
        if not slot.startswith("IGRAD_"):
            continue
        fwd_names = fwd_inputs.get(slot[len("IGRAD_"):], [])
        for i, gname in enumerate(names):
            if not gname:
                continue
            meta = None
            if i < len(fwd_names) and fwd_names[i]:
                meta = ictx.env.get(fwd_names[i])
            if meta is None:
                base = _grad_base(gname)
                meta = ictx.env.get(base) if base else None
            if meta is not None:
                ictx.env[gname] = meta


def _infer_custom_grad(ictx, op):
    """Custom *_grad ops: the cotangent for input slot S carries the
    meta of the op's OWN input S when it has one — this survives pass
    renames (layout_opt points the grad twin's X at its NHWC alias, so
    IGRAD_X is NHWC-shaped too). Ops that don't re-read the forward
    input (dropout_grad, softmax_grad) name their IGRAD outputs after
    the forward var (backward.py _GradHelpers.grad_name), which resolves
    by parsing the name."""
    wrote = False
    for slot, names in op.outputs.items():
        if not slot.startswith("IGRAD_"):
            continue
        src_names = op.inputs.get(slot[len("IGRAD_"):], ())
        for i, gname in enumerate(names):
            if not gname:
                continue
            meta = None
            if i < len(src_names) and src_names[i]:
                meta = ictx.env.get(src_names[i])
            if meta is None:
                base = _grad_base(gname)
                meta = ictx.env.get(base) if base else None
            if meta is not None:
                ictx.env[gname] = meta
                wrote = True
    return wrote


def infer_block(program, block, feeds=None, is_test=None) -> InferResult:
    if is_test is None:
        is_test = bool(getattr(program, "_is_test_clone", False))
    result = InferResult(program, block)
    _seed_env(program, block, feeds, result)
    ictx = InferContext(program, block, result, is_test=is_test)

    persistable = {n for blk in program.blocks for n, v in blk.vars.items() if v.persistable}

    def poison(op):
        # unknown outputs are EXPLICIT: a rebinding op that fails must
        # not leave its output names bound to the stale pre-op meta; a
        # persistable keeps its declared meta
        for n in op.output_arg_names():
            if n and n not in persistable:
                result.env[n] = VarMeta(None, None)

    def walk(blk):
        for op_idx, op in enumerate(blk.ops):
            result.ops_total += 1
            fn = SHAPE_FNS.get(op.type)
            try:
                if fn is not None:
                    fn(ictx, op)
                    result.ops_covered += 1
                elif op.type == "__auto_grad__":
                    _infer_auto_grad(ictx, op)
                    result.ops_covered += 1
                elif any(
                    s.startswith("IGRAD_") for s in op.outputs
                ) and _infer_custom_grad(ictx, op):
                    result.ops_covered += 1
                else:
                    result.missing.append((blk.idx, op_idx, op.type))
                    poison(op)
            except Unknown:
                poison(op)  # unknown inputs, not an error
            except InferError as e:
                result.errors.append((blk.idx, op_idx, op.type, str(e)))
                poison(op)
            except Exception as e:  # a buggy shape fn is recorded, not raised
                result.errors.append(
                    (blk.idx, op_idx, op.type, f"{type(e).__name__}: {e}")
                )
                poison(op)
            # sub-blocks (while/cond bodies) write parent names in place;
            # loop-carried metas are shape-stable, so one lenient pass
            # covers them
            for attr in op.attrs.values():
                if hasattr(attr, "ops") and hasattr(attr, "vars"):
                    walk(attr)

    walk(block)
    return result


def infer_program(program, feeds=None, is_test=None) -> InferResult:
    """Infer over the global block (the compiled step's op list).

    `feeds` maps var name -> (shape, dtype) | VarMeta — typically the
    executor's resolved feed signature. Without it, data vars seed from
    their declarations (batch dims of -1 stay unknown), which still
    concretely covers the persistable/optimizer side of the graph.
    """
    return infer_block(
        program, program.global_block(), feeds=feeds, is_test=is_test
    )
