"""`layer_scan`: N structurally identical op segments as one op
(`paddle_tpu/ops/scan_ops.py`).

The fuse_layer_scan pass (passes/fuse_layer_scan.py) replaces each run
of repeated layer blocks, forward or backward, with one `layer_scan` op
whose `template_ops` are segment 0's ops. Where the JAX package lowers
it as one `lax.scan`, this lowering is a Python loop over `num_iters`:
iteration k lowers the template ops, the same per-op lowerings the
unfused Program runs in the same order, in a body context that binds

  * Inv      the names every segment reads alike (the attention bias);
  * Carry    the values flowing from segment to segment (the hidden state
             forward, the output-grad chain backward): the inits at k = 0,
             then what iteration k - 1 defined;
  * Stacked  each per-layer read (parameters, and the forward
             activations the backward reads) to its layer's own tensor,
             `Stacked[j * n + k]`: nothing is stacked or copied.

The body's `var_id` and `rng_for` (ops/registry.py) map a name of the
crc table (`crc_names`, `crc_rows`) to the crc32 of layer k's name for
it, and so does its `child()`: every dropout mask and attention-dropout
seed is the one the unfused Program draws, in a re-run forward too.

In a training step the forward `layer_scan` lowers each template op
through `lower_forward_op`, so each layer's ops record their graphs on
the executor's tape under the ids of layer k's output names, and the
backward `layer_scan`'s `__auto_grad__` ops, whose `fwd_outputs` name
segment 0 of the backward run, find them through the same crc table: no
forward is re-run, fused or not on either side.

Outputs: `FinalOut` binds a carry's last value to its real name,
`StackedOut` each exposed per-layer value (the activations the backward
reads, the per-layer parameter grads the optimizer reads) to its own
name, so the rest of the Program never sees the fusion.
"""

from __future__ import annotations

from .registry import lower_forward_op, lower_op, register_op, scan_crc_maps


@register_op("layer_scan", differentiable=False)
def _layer_scan(ctx, op):
    """One fused run; see passes/fuse_layer_scan.py for its attrs."""
    lower_layer_scan(ctx, op)


def lower_layer_scan(ctx, op, users=None):
    """One fused run. With `users`, a training step's tape keys
    (graph_users), each template op lowers through `lower_forward_op`
    and records its graph; without, through `lower_op`."""
    tops = op.attr("template_ops")
    n = int(op.attr("num_iters"))
    carry_ins = op.input("Carry")
    carry_tpls = op.attr("carry_out_names") or []
    stacked_tpls = op.attr("stacked_templates") or []
    stacked_names = op.input("Stacked")
    ys = list(zip(op.attr("ys_templates") or [], op.attr("ys_names") or []))
    inv = {nm: ctx.get(nm) for nm in op.input("Inv")}
    carry = [ctx.get(nm) for nm in carry_ins]
    for k, crcs in enumerate(scan_crc_maps(op)):
        sub = ctx.scan_body(crcs)
        sub.values.update(inv)
        sub.values.update(zip(carry_ins, carry))
        for j, tpl in enumerate(stacked_tpls):
            sub.values[tpl] = ctx.get(stacked_names[j * n + k])
        for top in tops:
            if users is None:
                lower_op(sub, top)
            else:
                lower_forward_op(sub, top, users)
        carry = [sub.get(t) for t in carry_tpls]
        for tpl, names in ys:
            if names[k]:
                ctx.values[names[k]] = sub.get(tpl)
    for tpl, name in zip(op.attr("final_templates") or [], op.output("FinalOut")):
        ctx.values[name] = carry[carry_tpls.index(tpl)]
