"""Inference-time conv+BN folding, with a trailing relu absorbed
(`paddle_tpu/passes/fuse_conv_bn.py`; the reference's fuse_conv_bn_pass /
conv_affine_channel_fuse_pass, framework/ir/fuse_conv_bn_pass.cc).

On a frozen inference graph an eval-mode BatchNorm is a per-channel
affine, and that affine folds into the preceding conv's weights:

    W' = W * (gamma * rsqrt(var + eps))[O]        (per output channel)
    b' = beta - mean * gamma * rsqrt(var + eps)

so the BN op disappears; a relu that is the BN output's only reader
rides the conv's `fused_act` attr and disappears too (the conv2d
lowering takes `Bias` and `fused_act`, ops/nn_ops.py).

The fold is evaluated at pass time in numpy float32 with the JAX
package's formula, reading the parameters through the executor scope
(`ctx.scope`: torch tensors, possibly on the card, or numpy arrays). The
folded tensors are written back to the scope, on the device of the conv
weight they replace, under derived persistable names
(`<bn_out>@bnfold.w/.b`). The user's parameters are never mutated.

Safety gates:
  * the block holds NO backward / optimize-role ops;
  * the batch_norm op carries is_test=True (a clone(for_test=True)
    program, or an eval graph built so);
  * the program is not under AMP (the unfused path computes the affine
    in float32);
  * the conv output feeds ONLY the bn; the bn's stats outputs are
    neither read nor fetched.

The folded values snapshot the scope when the passes run. Each value
the fold reads is recorded (`PassContext.read_scope`), and the Executor
re-runs the passes once the scope holds another value under one of those
names: a training step between two runs of its eval clone writes new
parameters and statistics, and the next eval folds those.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import core_op_role
from ..scope import to_numpy
from . import register_pass


def _single_consumer_map(ops):
    """name -> reader op indexes. Sub-block external reads (while/cond
    bodies pulling parent vars) count as readers too — folding away a
    var a loop body still reads would leave it producer-less (the same
    hazard layout_opt tracks via subblock_reads)."""
    from ..framework import op_has_sub_block, op_reads

    readers: dict[str, list] = {}
    for i, op in enumerate(ops):
        names = op_reads(op) if op_has_sub_block(op) else [
            n for n in op.input_arg_names() if n
        ]
        for n in names:
            if n:
                readers.setdefault(n, []).append(i)
    return readers


@register_pass("fuse_conv_bn", strategy_knob="fuse_conv_bn")
def fold_conv_bn(program, block, feed_names, fetch_names, ctx=None):
    scope = getattr(ctx, "scope", None)
    if scope is None:
        return 0
    if getattr(program, "_amp_dtype", None) is not None:
        return 0
    for op in block.ops:
        if (op.attrs.get("op_role") or 0) & (
            core_op_role.Backward | core_op_role.Optimize
        ):
            return 0  # training program: never fire

    fetched = set(fetch_names)
    readers = _single_consumer_map(block.ops)
    ops = block.ops
    drop: set = set()
    removed = 0

    for bi, bn in enumerate(ops):
        if bn.type != "batch_norm" or bi in drop:
            continue
        if not bn.attr("is_test", False):
            continue
        x_name = (bn.input("X") or [None])[0]
        if not x_name or x_name in fetched:
            continue
        # stats outputs must be unconsumed and unfetched (eval-mode BN
        # does not produce them; anything depending on them keeps the op)
        stats_ok = True
        for slot in ("SavedMean", "SavedVariance"):
            for n in bn.output(slot):
                if n and (n in fetched or readers.get(n)):
                    stats_ok = False
        if not stats_ok:
            continue
        conv_idx = None
        for ci, cop in enumerate(ops[:bi]):
            if ci in drop:
                continue
            if cop.type in ("conv2d", "depthwise_conv2d") and (
                (cop.output("Output") or [None])[0] == x_name
            ):
                conv_idx = ci
        if conv_idx is None:
            continue
        conv = ops[conv_idx]
        if readers.get(x_name, []) != [bi]:
            continue  # conv output used elsewhere too
        if conv.input("Bias") or conv.attr("fused_act", ""):
            continue  # already folded once
        if conv.attr("data_format", "NCHW") != "NCHW":
            continue  # run before layout_opt (pass order guarantees it)

        w_name = (conv.input("Filter") or [None])[0]
        names = {
            "gamma": (bn.input("Scale") or [None])[0],
            "beta": (bn.input("Bias") or [None])[0],
            "mean": (bn.input("Mean") or [None])[0],
            "var": (bn.input("Variance") or [None])[0],
        }
        if not w_name or not all(names.values()):
            continue
        if not all(scope.has(n) and scope.get(n) is not None
                   for n in [w_name, *names.values()]):
            continue

        w_value = ctx.read_scope(w_name)
        w = np.asarray(to_numpy(w_value), dtype=np.float32)
        gamma, beta, mean, var = (
            np.asarray(to_numpy(ctx.read_scope(names[k])), dtype=np.float32)
            for k in ("gamma", "beta", "mean", "var"))
        device = (w_value.device if isinstance(w_value, torch.Tensor)
                  else torch.device("cpu"))
        eps = np.float32(bn.attr("epsilon", 1e-5))
        scale = gamma / np.sqrt(var + eps)
        if scale.shape[0] != w.shape[0]:
            continue  # grouped filter layout mismatch — leave unfused
        w_fused = (w * scale.reshape(-1, 1, 1, 1)).astype(w.dtype)
        b_fused = (beta - mean * scale).astype(np.float32)

        y_name = (bn.output("Y") or [None])[0]
        out_name = y_name
        # absorb a relu that is the SOLE consumer of the bn output
        bn_readers = readers.get(y_name, [])
        fold_relu = None
        if (
            y_name not in fetched
            and len(bn_readers) == 1
            and ops[bn_readers[0]].type == "relu"
            and (ops[bn_readers[0]].input("X") or [None])[0] == y_name
        ):
            fold_relu = bn_readers[0]
            out_name = (ops[fold_relu].output("Out") or [None])[0]

        base = (bn.output("Y") or ["convbn"])[0]
        wf_name = f"{base}@bnfold.w"
        bf_name = f"{base}@bnfold.b"
        for nm, val, shape in (
            (wf_name, w_fused, list(w_fused.shape)),
            (bf_name, b_fused, list(b_fused.shape)),
        ):
            if not block.has_var_local(nm):
                block.create_var(name=nm, shape=shape,
                                 dtype=str(val.dtype), persistable=True,
                                 stop_gradient=True)
            block.vars[nm].persistable = True
            scope.set(nm, torch.from_numpy(val).to(device))

        conv.inputs["Filter"] = [wf_name]
        conv.inputs["Bias"] = [bf_name]
        conv.outputs["Output"] = [out_name]
        if fold_relu is not None:
            conv.attrs["fused_act"] = "relu"
            drop.add(fold_relu)
            removed += 1
        drop.add(bi)
        removed += 1

    if not drop:
        return 0
    block.ops = [op for i, op in enumerate(block.ops) if i not in drop]
    return removed
