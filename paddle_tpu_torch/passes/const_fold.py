"""Constant folding (`paddle_tpu/passes/const_fold.py`): evaluate
fill_constant / scale / cast / shape chains at pass time, so shape
plumbing and constant arithmetic never reach the Executor's walk (the
role of the reference's constant_folding_pass,
framework/ir/constant_folding_pass.cc).

A chain folds into a single `assign_value` op placed at the defining
op's position, keeping its op_role. Values are computed with numpy in the
dtype the port's lowering would use (ops/registry.py TORCH_DTYPE: float64
runs as float32, int64 stays int64), and the ops folded are elementwise or
creation ops whose scalar arithmetic numpy and torch round alike.
fill_constant honours `str_value` as its lowering does. A dtype numpy
cannot hold (bfloat16) is left to the lowering.
"""

from __future__ import annotations

import numpy as np

from ..framework import Operator, convert_dtype, op_reads
from . import register_pass

# never embed arrays larger than this in the IR (assign_value stores a
# Python list attr; huge constants belong on device, not in the program)
_MAX_ELEMS = 16384


# the numpy twin of ops/registry.py TORCH_DTYPE; bfloat16 is absent, so a
# bf16 constant raises KeyError below and stays unfolded
_NP_DTYPES = {
    "float32": np.float32,
    "float64": np.float32,
    "float16": np.float16,
    "int8": np.int8,
    "uint8": np.uint8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "bool": np.bool_,
}


def _np_dtype(dtype_attr):
    return np.dtype(_NP_DTYPES[convert_dtype(dtype_attr)])


def _eval_fill_constant(op, consts):
    shape = tuple(op.attr("shape", [1]))
    value = op.attr("value", 0.0)
    if op.attr("str_value", ""):
        value = float(op.attr("str_value"))
    return np.full(shape, value, dtype=_np_dtype(op.attr("dtype", "float32")))


def _eval_assign_value(op, consts):
    values = (
        op.attr("fp32_values") or op.attr("int32_values") or op.attr("values")
    )
    if values is None:
        return None
    return np.asarray(
        np.array(values), dtype=_np_dtype(op.attr("dtype", "float32"))
    ).reshape(op.attr("shape"))


def _eval_cast(op, consts):
    x = consts[op.input("X")[0]]
    return x.astype(_np_dtype(op.attr("out_dtype")))


def _eval_scale(op, consts):
    x = consts[op.input("X")[0]]
    scale = op.attr("scale", 1.0)
    if op.input("ScaleTensor"):
        scale = consts[op.input("ScaleTensor")[0]]
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        return x * scale + bias
    return (x + bias) * scale


def _eval_shape(op, consts):
    x = consts[op.input("Input")[0]]
    return np.array(x.shape, dtype=np.int32)


def _eval_assign(op, consts):
    return consts[op.input("X")[0]]


def _eval_fill_zeros_like(op, consts):
    return np.zeros_like(consts[op.input("X")[0]])


def _eval_fill_any_like(op, consts):
    x = consts[op.input("X")[0]]
    dtype = op.attr("dtype", None)
    dt = x.dtype if dtype in (None, -1) else _np_dtype(dtype)
    return np.full_like(x, op.attr("value", 0.0), dtype=dt)


def _eval_eye(op, consts):
    return np.eye(
        op.attr("num_rows"),
        op.attr("num_columns", None) or op.attr("num_rows"),
        dtype=_np_dtype(op.attr("dtype", "float32")),
    )


# `range` is absent, as in the JAX package: np.arange accumulates float
# steps in float64, and the 1-ulp difference would break the pass-on/off
# bitwise contract. Every folder below evaluates in the lowering dtype.
_FOLDERS = {
    "fill_constant": _eval_fill_constant,
    "assign_value": _eval_assign_value,
    "cast": _eval_cast,
    "scale": _eval_scale,
    "shape": _eval_shape,
    "assign": _eval_assign,
    "fill_zeros_like": _eval_fill_zeros_like,
    "fill_any_like": _eval_fill_any_like,
    "eye": _eval_eye,
}


def _writes_persistable(block, op):
    for n in op.output_arg_names():
        if not n:
            continue
        v = block._find_var_recursive(n)
        if v is not None and v.persistable:
            return True
    return False


@register_pass("const_fold", strategy_knob="constant_folding")
def fold_constants(program, block, feed_names, fetch_names, ctx=None):
    feed_set = set(feed_names)
    consts: dict[str, np.ndarray] = {}  # name -> latest constant binding
    vals_by_idx: dict[int, np.ndarray] = {}  # folded op index -> its value

    for i, op in enumerate(block.ops):
        folder = _FOLDERS.get(op.type)
        folded_here = False
        if folder is not None:
            outs = [n for n in op.output_arg_names() if n]
            if len(outs) == 1 and not _writes_persistable(block, op):
                ins = [n for n in op.input_arg_names() if n]
                # a feed name shadows any same-named would-be constant
                if not any(n in feed_set or n not in consts for n in ins):
                    try:
                        val = folder(op, consts)
                    except Exception:
                        val = None  # malformed attrs — leave to the lowering
                    # size-0 arrays can't ride assign_value (empty list
                    # attr reads back as missing)
                    if val is not None and 0 < val.size <= _MAX_ELEMS:
                        consts[outs[0]] = val
                        vals_by_idx[i] = val
                        folded_here = True
        if not folded_here:
            # any other definition of a name invalidates its constant
            # binding for downstream folds (name rebinding)
            for n in op.output_arg_names():
                consts.pop(n, None)
    folded_idx = set(vals_by_idx)

    if not folded_idx:
        return 0

    # names still needed at runtime: read by any surviving op, or fetched
    live_reads: set[str] = set(fetch_names)
    for i, op in enumerate(block.ops):
        if i not in folded_idx:
            live_reads.update(op_reads(op))

    new_ops = []
    materialized = 0
    for i, op in enumerate(block.ops):
        if i not in folded_idx:
            new_ops.append(op)
            continue
        out = next(n for n in op.output_arg_names() if n)
        if out not in live_reads:
            continue  # dead chain link — vanishes entirely
        arr = vals_by_idx[i]
        attrs = {
            "shape": list(arr.shape),
            "dtype": str(np.dtype(arr.dtype)),
            "values": arr.ravel().tolist(),
            # keep the folded op's role/device/segment tags: the
            # microbatch splitter partitions by op_role and the
            # recompute step groups consecutive recompute_segment tags —
            # an untagged replacement would split a segment in two
            "op_role": op.attrs.get("op_role", 0),
        }
        for tag in ("device", "recompute_segment"):
            if tag in op.attrs:
                attrs[tag] = op.attrs[tag]
        new_ops.append(Operator(block, "assign_value", {}, {"Out": [out]},
                                attrs))
        materialized += 1
    removed = len(block.ops) - len(new_ops)
    block.ops = new_ops
    return removed
