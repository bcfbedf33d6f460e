"""The `moe_ffn` op (paddle_tpu/ops/moe_ops.py): GShard's dense-dispatch
mixture of experts (parallel/moe.py) -> Out (X's shape) and AuxLoss [1].

AMP as the JAX op: the two expert products run in the AMP dtype (both
operands cast inside moe_ffn); routing and the aux loss stay float32.

The expert rule (parallel/tensor_parallel.py): when the layout plan has
W1 / B1 / W2 / B2 sharded on their expert dim over the `model` group, this
rank holds experts [rank * E/m, (rank + 1) * E/m). The tokens and the gate
enter through `CopyToModel`, every rank routes all tokens, its partial
combine is all-reduced at once (`AllReduceFromModel`), and the aux loss,
the same on every rank, passes its grad on one rank only (rank 0; the
others add it as aux.detach() + 0 * aux, the same value), so the gate's
grad, summed over the group, counts it once.
"""

from __future__ import annotations

from .registry import register_op


@register_op("moe_ffn")
def _moe_ffn(ctx, op):
    from ..parallel.moe import moe_ffn

    x = ctx.in_(op, "X")
    gate = ctx.in_(op, "Gate")
    params = {"gate": gate, "w1": ctx.in_(op, "W1"), "b1": ctx.in_(op, "B1"),
              "w2": ctx.in_(op, "W2"), "b2": ctx.in_(op, "B2")}
    shard = None
    if ctx.model_group is not None and ctx.model_dims.get(op.input("W1")[0]) == 0:
        from ..parallel.tensor_parallel import CopyToModel

        count = params["w1"].shape[0]
        shard = (ctx.model_rank * count, count)
        x = CopyToModel.apply(x, ctx.model_group)
        params["gate"] = CopyToModel.apply(gate, ctx.model_group)
    y, aux = moe_ffn(params, x, capacity_factor=op.attr("capacity_factor", 1.25),
                     k=op.attr("k", 2), compute_dtype=ctx.amp_dtype_for(op),
                     expert_shard=shard)
    if shard is not None:
        from ..parallel.tensor_parallel import AllReduceFromModel

        y = AllReduceFromModel.apply(y, ctx.model_group)
        if ctx.model_rank != 0:
            aux = aux.detach() + aux * 0.0
    ctx.out(op, "Out", y)
    ctx.out(op, "AuxLoss", aux.reshape(1))
