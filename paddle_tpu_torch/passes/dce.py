"""Fetch- and state-driven dead-code elimination
(`paddle_tpu/passes/dce.py`): ops whose outputs reach neither the run's
fetches nor any persistable (parameters, optimizer accumulators, BN
statistics) are dropped before the Executor walks the Program.

Side-effectful ops survive:

  * persistable writes: any op writing a persistable var is a root;
  * order-dependent RNG consumers: ORDER_RNG_OPS is the JAX package's
    set of lowerings that draw from ctx.next_rng(). The port's lowerings
    of those ops that exist (uniform_random, gaussian_random,
    truncated_gaussian_random) draw from the run's torch.Generator in op
    order instead, which is just as order-dependent, so the same set
    anchors them; no port lowering calls ctx.next_rng() (ops/registry.py).
    Dropout and the attention kernels derive their masks from their
    output name (ctx.rng_for) and need no anchor;
  * collectives, which stay symmetric across replicas;
  * control flow: ops carrying sub-blocks are kept, with their bodies'
    external reads joining the live set (framework.op_reads).

An `__auto_grad__` op reads its forward's inputs, not its outputs, so a
forward op whose outputs reach nothing else (an unfetched loss) is dropped
and its grad op runs that forward again (ops/registry.py).
"""

from __future__ import annotations

from ..framework import op_has_sub_block, op_reads
from . import register_pass

# lowerings that draw from ctx.next_rng() (order-dependent functional
# PRNG): see ops/tensor_ops.py _op_rng and friends. dropout & co. use the
# name-keyed ctx.rng_for and need no anchoring.
ORDER_RNG_OPS = frozenset({
    "uniform_random",
    "uniform_random_batch_size_like",
    "gaussian_random",
    "gaussian_random_batch_size_like",
    "truncated_gaussian_random",
    "randint",
    "randperm",
    "sampling_id",
    "sample_logits",
    "random_crop",
    "rpn_target_assign",
    "generate_proposal_labels",
})

# ops whose execution is observable outside the dataflow graph
SIDE_EFFECT_OPS = frozenset({
    "feed",
    "fetch",
    "print",
    "assert",
    "py_func",
    "send",
    "recv",
})

# cross-replica collectives stay symmetric across the mesh
COLLECTIVE_PREFIXES = ("c_", "collective_", "partial_send", "partial_recv")


def _is_anchor(block, op):
    if op.type in SIDE_EFFECT_OPS or op.type in ORDER_RNG_OPS:
        return True
    if op.type.startswith(COLLECTIVE_PREFIXES):
        return True
    if op_has_sub_block(op):
        return True
    for n in op.output_arg_names():
        if not n:
            continue
        v = block._find_var_recursive(n)
        if v is not None and v.persistable:
            return True
    return False


@register_pass("dce", strategy_knob="memory_optimize")
def eliminate_dead_ops(program, block, feed_names, fetch_names, ctx=None):
    needed = set(fetch_names)
    kept = []
    for op in reversed(block.ops):
        if _is_anchor(block, op) or any(
            n in needed for n in op.output_arg_names()
        ):
            kept.append(op)
            needed.update(op_reads(op))
    removed = len(block.ops) - len(kept)
    if removed:
        block.ops = list(reversed(kept))
    return removed
