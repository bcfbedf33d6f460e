"""Copy propagation (`paddle_tpu/passes/copy_prop.py`): eliminate pure
`assign` renames.

append_backward's accumulation protocol emits one
`assign(partial -> final@GRAD)` per single-partial gradient: on
BERT-base that is ~36% of the training Program, each an op the Executor
issues on every step. The reference folds these in its inplace /
memory-optimize passes (build_strategy enable_inplace); here the rename is
resolved at pass time.

The PRODUCER's output is renamed to the assign's target (and the assign
dropped), never the other way round, so names keep their @GRAD suffix.

A rename P.out: x -> out requires:
  * the assign is x's ONLY reader and x's producer P is unique;
  * `out` has no other definition and no read before the assign;
  * neither name is a feed; x is not fetched or persistable (its binding
    disappears), out is not persistable (the assign IS the state write);
  * P carries no sub-block and is not output-name-keyed RNG (dropout and
    the attention op derive their masks from the output name through
    ctx.rng_for: a rename would change the masks against the
    pass-disabled run).

The port's `__auto_grad__` op finds its forward's autograd graph by the
forward's output names (ops/registry.py `graph_users`), so renaming such
an output would make the grad op run the forward again; the Executor
reports that in `Executor.recomputed_forwards`, which stays empty on the
training Programs of the BERT, ResNet and Transformer models (their
forward outputs are read by more than an assign).
"""

from __future__ import annotations

from collections import Counter

from ..framework import op_has_sub_block, op_reads
from . import register_pass

# lowerings keying ctx.rng_for on an output name: renaming the output
# would re-key their randomness (dropout_grad also replays the forward
# mask from the recorded name)
OUTPUT_NAME_KEYED = frozenset({
    "dropout",
    "fused_multihead_attention",
    "nce",
    "shuffle_batch",
})


@register_pass("copy_prop", strategy_knob="enable_inplace")
def propagate_copies(program, block, feed_names, fetch_names, ctx=None):
    ops = block.ops
    reads = Counter()
    defs = Counter()
    def_op: dict[str, int] = {}
    first_read: dict[str, int] = {}
    for i, op in enumerate(ops):
        for n in op_reads(op):
            reads[n] += 1
            first_read.setdefault(n, i)
        for n in op.output_arg_names():
            if n:
                defs[n] += 1
                def_op[n] = i
    feed_set = set(feed_names)
    protected = set(fetch_names)
    # executor paths that look up the loss by name post-transform
    for a in ("_recompute_loss", "_pipeline_loss"):
        v = getattr(program, a, None)
        if v:
            protected.add(v)

    def _persistable(name):
        v = block._find_var_recursive(name)
        return v is not None and v.persistable

    dropped: set[int] = set()
    removed = 0
    for i, op in enumerate(ops):
        if op.type != "assign":
            continue
        ins = [n for n in op.input_arg_names() if n]
        outs = [n for n in op.output_arg_names() if n]
        if len(ins) != 1 or len(outs) != 1:
            continue
        x, out = ins[0], outs[0]
        if x == out or x in feed_set or out in feed_set:
            continue
        if x in protected:  # fetched/loss-anchored x would lose its binding
            continue
        if reads[x] != 1 or defs.get(x, 0) != 1 or defs.get(out, 0) != 1:
            continue
        if first_read.get(out, len(ops)) < i:
            continue
        if _persistable(x) or _persistable(out):
            continue
        p_idx = def_op.get(x)
        if p_idx is None or p_idx in dropped or p_idx >= i:
            continue
        producer = ops[p_idx]
        if producer.type in OUTPUT_NAME_KEYED or op_has_sub_block(producer):
            continue
        # rewrite the producer's output binding x -> out, drop the assign
        for slot, names in producer.outputs.items():
            producer.outputs[slot] = [
                out if n == x else n for n in names
            ]
        dropped.add(i)
        removed += 1
        # bookkeeping for chained assigns (a->b dropped, then b->c)
        defs[x] -= 1
        reads[x] -= 1
        def_op[out] = p_idx
        def_op.pop(x, None)

    if removed:
        block.ops = [op for i, op in enumerate(ops) if i not in dropped]
    return removed
