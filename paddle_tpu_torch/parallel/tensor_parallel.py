"""Tensor parallelism over the mesh's `model` axis: the layout plan a mesh
run applies to a Program whose parameters carry `shard_parameter`
annotations (models/bert.py records Megatron's splits: column-parallel
q/k/v and ffn1 `P(None, "tp")`, row-parallel attention output and ffn2
`P("tp", None)`). GSPMD partitions the JAX package's step from those
specs; the port has no partitioner, so this module decides, op by op,
what each rank of a model group holds and which collectives it needs.

Layouts. Every variable is *replicated* on the model group or *sharded on
dim d* (each rank holds its contiguous chunk of dim d, rank i the i-th);
a *partial* value (a sum over the group still due) exists only inside
one op's lowering and is all-reduced at once. Parameters take the layout
of their annotation (a dim whose size the group does not divide stays
replicated), their optimizer accumulators the layout of their parameter,
and `x@GRAD` the layout of `x`. The plan walks the post-pass Program
once and gives every op one rule:

- plain: no input is sharded; the op runs as it is.
- column: `mul` / `matmul` of a replicated X by a weight sharded on its
  output dim gives an output sharded on its last dim. X enters through
  `CopyToModel` (identity forward, all-reduce of its grad backward).
- row: `mul` / `matmul` of an X sharded on its contraction dim by a weight
  sharded on its rows gives a partial output, all-reduced at once
  (`AllReduceFromModel`: all-reduce forward, identity backward).
- local: the op runs on the local chunks and keeps the layout:
  element-wise activations, `scale`, `cast`, `dropout` (its mask drawn at
  the chunk's place in the global tensor, `LoweringContext.global_place`),
  `softmax` over an unsharded axis, binary element-wise ops whose Y is
  sharded alike or broadcast along the sharded dim (such a replicated Y
  enters through `CopyToModel`, so its grad is the group's sum),
  `reshape2` and `transpose2` that move the sharded dim (the clone's
  `shape` attr gets the local size, e.g. nh/m heads), batched `matmul`
  sharded on a batch dim, `fused_multihead_attention` on local heads
  (the kernels hash global head indices: `LoweringContext.head_shard`),
  the grad accumulation `sum`, the bias grad `elementwise_add_grad` (its
  Y grad all-reduced where Y was broadcast along the sharded dim), every
  `__auto_grad__` (its graph holds the forward's collectives), and the
  element-wise optimizer updates on the local chunks (Lamb all-reduces
  its two sums of squares over the group, `LoweringContext.model_sum`).
- partial: `squared_l2_norm` and a full `reduce_sum` of a sharded input
  sum the local chunk and all-reduce (a global-norm clip's squared
  norms).
- gather: any other op that reads a sharded var all-gathers it first
  (`GatherFromModel`: all-gather forward, the rank's chunk of the grad
  backward), so it is right whatever it computes: `split` of a fused qkv
  projection, the vocab-sharded logits into `softmax_with_cross_entropy`,
  reductions. Its outputs are replicated, but for a grad of a sharded
  var, which is cut to the rank's chunk.

The backward is autograd through each forward op's own graph
(`__auto_grad__`), so the collectives are `torch.autograd.Function`s
applied inside the forward op's lowering (`lower_forward_op(...,
lower=)`), where its graph records them. Replicated parameters
(LayerNorm, embeddings, row-parallel biases) see the same grads on every
rank of a model group and stay bit-identical there; sharded parameters'
grads are averaged over the batch group alone (parallel/step.py).

The sequence layout. When the sequence-parallel mode is on for the run
(`ops.fused_ops.sequence_parallel_mode` of the Program's attention ops:
PADDLE_TPU_SP_MODE = ring | ulysses, or unset with a sequence of at least
RING_MIN_SEQ), the `model` axis carries the sequence, not Megatron's
heads (context parallelism). A var is then *sharded on its sequence dim*
(each rank its contiguous chunk of the sequence); the Program's `model`
weight annotations are not applied, so every parameter is replicated on
the model group. The ranks of a model group still feed the same rows: a
feed [b, s, ...] of the attention's sequence length s is cut to the
rank's chunk where a rule first needs it. The rules:

- local, keeping the layout: `lookup_table` of sequence-sharded ids,
  element-wise ops, `scale`, `dropout` (at the chunk's global place),
  `layer_norm` over dims after the sequence (`layer_norm_grad` all-reduces
  its Scale / Bias grads over the group), `mul` / `matmul` by a
  replicated weight, `gelu`, and `reshape2` / `transpose2` that keep the
  sequence dim whole. A replicated parameter enters through
  `CopyToModel`, so its grad is the group's sum;
- `fused_multihead_attention` on sequence-sharded q / k / v runs the ring
  or Ulysses across the model group (its key bias cut to the chunk);
- gather: every other op that reads a sequence-sharded var gathers it
  (the [CLS] slice, the MLM gather over flattened positions, the loss
  reductions). Where GSPMD keeps the weights tp-sharded under sequence
  parallelism, the port replicates them: the numbers are the same, the
  memory is not (ROADMAP Queue 3).

The expert rule, in either layout. `moe_ffn` reads its expert-sharded
W1 / B1 / W2 / B2 (annotated `P(ep)`, the expert dim over `model`) and
replicated tokens (gathered first under the sequence layout, since
capacity and positions count every token): every rank routes all tokens
with the replicated gate, runs the FFNs of its E/m experts, and
all-reduces its partial combine at once (ops/moe_ops.py). The expert
params' grads stay local shards, averaged over the batch group alone.

The plan rewrites a clone of the post-pass Program (reshape attrs), never
the user's Program, and the Executor keys it on the mesh signature and
PADDLE_TPU_SP_MODE.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import GRAD_SUFFIX
from .mesh import canonicalize_spec

__all__ = ["TensorParallelPlan", "CopyToModel", "AllReduceFromModel", "GatherFromModel"]


class CopyToModel(torch.autograd.Function):
    """Identity forward; the grad all-reduced over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class AllReduceFromModel(torch.autograd.Function):
    """All-reduce forward (a partial sum made whole); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x, dim, group, ranks):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(ranks)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x, dim, rank, ranks):
    n = x.shape[dim] // ranks
    return x.narrow(dim, rank * n, n).contiguous()


class GatherFromModel(torch.autograd.Function):
    """All-gather of the chunks along `dim` forward; the rank's chunk of
    the grad backward."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, ranks):
        ctx.args = (dim, rank, ranks)
        return _gather(x, dim, group, ranks)

    @staticmethod
    def backward(ctx, g):
        dim, rank, ranks = ctx.args
        return _chunk(g, dim, rank, ranks), None, None, None, None


# op types that act element by element on one input and keep its layout
# (`cast` as the JAX package's, for when its lowering is ported)
_UNARY = frozenset({"relu", "gelu", "tanh", "sigmoid", "sign", "sqrt", "square", "scale",
                    "cast", "assign", "clip", "dropout"})
_BINARY = frozenset({"elementwise_add", "elementwise_sub", "elementwise_mul",
                     "elementwise_div", "elementwise_max"})
# the ops that may read a whole sequence feed, cut to the rank's chunk there
_SEQ_FEED_READERS = _UNARY | _BINARY | {"lookup_table", "mul", "matmul", "layer_norm"}
# optimizer updates that are element-wise given the trust ratio's norms
_OPTIMIZERS = frozenset({"sgd", "momentum", "adam", "adamw", "lamb", "fused_sgd",
                         "fused_momentum", "fused_adam", "fused_adamw", "fused_lamb"})


def _grad_base(name):
    """`x` of a grad name `x@GRAD` or `x@GRAD@...` (a rename or a partial);
    None for any other name (`x@GRAD_sq_0`, a clip's square, is not)."""
    i = name.find(GRAD_SUFFIX)
    rest = name[i + len(GRAD_SUFFIX):] if i > 0 else None
    return name[:i] if rest is not None and (not rest or rest.startswith("@")) else None


def _sequence_mode(block, m):
    """(mode, sequence length) of the sequence layout on a model axis of m
    ranks: the mode `sequence_parallel_mode` gives the Program's attention
    ops ("ring", "ulysses"; None: the tensor-parallel layout). Raises
    ValueError where the attention ops disagree."""
    from ..ops.fused_ops import sequence_parallel_mode

    found = set()
    for op in block.ops:
        if op.type != "fused_multihead_attention":
            continue
        sd = 1 if (op.attr("layout", "bhsd") or "bhsd") == "bshd" else 2
        q = block._find_var_recursive(op.input("Q")[0])
        k = block._find_var_recursive(op.input("K")[0])
        sq, sk = int(q.shape[sd]), int(k.shape[sd])
        found.add((sequence_parallel_mode(sq, sk, m), sq))
    modes = {mode for mode, _ in found}
    if len(modes) > 1:
        raise ValueError(f"the attention ops of one Program take different sequence-parallel "
                         f"modes {sorted(map(str, modes))}: give PADDLE_TPU_SP_MODE")
    if not found or not modes - {None}:
        return None, None
    lengths = {sq for _, sq in found}
    if len(lengths) > 1:
        raise NotImplementedError(f"sequence parallelism over attention ops of sequence "
                                  f"lengths {sorted(lengths)}")
    return modes.pop(), lengths.pop()


class _Rule:
    """One op's rule: `kind`, the input transforms (name -> ("copy",),
    ("gather", dim) or ("chunk", dim)), the outputs all-reduced after the
    op, and the outputs cut to the rank's chunk after it (name -> dim)."""

    __slots__ = ("kind", "inputs", "reduce_out", "chunk_out")

    def __init__(self, kind):
        self.kind = kind
        self.inputs = {}
        self.reduce_out = []
        self.chunk_out = {}


class TensorParallelPlan:
    """The layout plan of `program` (post-pass) on a mesh whose model axis
    is larger than 1. `program` is the clone this plan rewrote and the
    walk runs; `dims` maps each sharded var to its dim."""

    def __init__(self, mesh, program):
        from ..passes import _clone_for_passes

        self.ranks = mesh.shape["model"]
        self.sequence, self.seq_len = _sequence_mode(program.global_block(), self.ranks)
        self.whole_seq = {}  # feeds with the sequence dim, cut where a rule needs them
        self.group = mesh.group("model")
        self.rank = mesh.local_rank("model")
        clone = _clone_for_passes(program)
        for a in ("_autoshard_specs", "_autoshard_plan"):
            if hasattr(program, a):
                setattr(clone, a, getattr(program, a))
        self.program = clone
        block = clone.global_block()
        self.block = block
        self.dims = {}
        self.state = {}  # persistable -> dim, the layouts the scope keeps
        self._annotate_state(clone, block)
        self.rules = {}
        for op in block.ops:
            rule = self._rule(op)
            if rule is not None:
                self.rules[id(op)] = rule

    # -- layouts ------------------------------------------------------------
    def _shape(self, name):
        v = self.block._find_var_recursive(name)
        return tuple(v.shape) if v is not None and v.shape is not None else None

    def dim(self, name):
        return self.dims.get(name) if name else None

    def _annotate_state(self, program, block):
        m = self.ranks
        experts = {n for op in block.ops if op.type == "moe_ffn"
                   for slot in ("W1", "B1", "W2", "B2") for n in op.input(slot)}
        if self.sequence:
            for v in block.vars.values():
                shape = tuple(v.shape or ())
                if getattr(v, "is_data", False) and len(shape) >= 2 and shape[1] == self.seq_len:
                    self.whole_seq[v.name] = 1
        for name, spec in (program._sharding_specs or {}).items():
            v = block._find_var_recursive(name)
            if v is None or not v.persistable or (self.sequence and name not in experts):
                continue
            for d, el in enumerate(canonicalize_spec(spec)):
                axes = el if isinstance(el, tuple) else (el,)
                shape = self._shape(name) or ()
                if "model" in axes and d < len(shape) and isinstance(shape[d], int) \
                        and shape[d] > 0 and shape[d] % m == 0:
                    self.state[name] = d
                    break
        # optimizer accumulators ride with their parameter: the optimizer
        # op's other persistable inputs of the parameter's shape
        for op in block.ops:
            if op.type not in _OPTIMIZERS:
                continue
            for i, p in enumerate(op.input("Param")):
                if p not in self.state:
                    continue
                for slot, names in op.inputs.items():
                    if slot in ("Param", "Grad") or i >= len(names):
                        continue
                    n = names[i]
                    v = block._find_var_recursive(n)
                    if v is not None and v.persistable and self._shape(n) == self._shape(p):
                        self.state[n] = self.state[p]
        self.dims.update(self.state)

    def _target(self, name):
        """The layout an output must have whatever produced it: a sharded
        state var's, or a sharded var's grad's; None: free."""
        if name in self.state:
            return self.state[name]
        base = _grad_base(name)
        if base is not None:
            return self.dims.get(base)
        return None

    # -- rules --------------------------------------------------------------
    def _rule(self, op):
        ins = [n for n in op.input_arg_names() if n]
        sharded_in = {n: self.dims[n] for n in ins if n in self.dims}
        cut = {}
        if self.sequence and op.type in _SEQ_FEED_READERS:
            cut = {n: self.whole_seq[n] for n in ins if n in self.whole_seq}
            sharded_in.update(cut)
            self.dims.update(cut)
        if op.type == "__auto_grad__":
            rule = self._auto_grad(op)
        elif not sharded_in:
            rule = _Rule("plain")
            self._set_outputs(op, None)
        else:
            rule = self._sharded_rule(op, sharded_in)
        # an output whose layout is fixed (a sharded state var, the grad of
        # a sharded var) is cut to the rank's chunk when computed whole
        for n in op.output_arg_names():
            if not n:
                continue
            want = self._target(n)
            got = self.dims.get(n)
            if want is not None and got is None and rule.kind != "auto_grad":
                rule.chunk_out[n] = want
                self.dims[n] = want
        for n, d in cut.items():
            # a whole feed: cut to the rank's chunk for a local rule, read
            # as it is where the rule gathers
            self.dims.pop(n, None)
            if rule.kind == "gather" or rule.inputs.get(n, ("chunk",))[0] != "chunk":
                rule.inputs.pop(n, None)
            else:
                rule.inputs[n] = ("chunk", d)
        if rule.kind in ("plain", "auto_grad") and not rule.chunk_out and not rule.inputs:
            return None
        return rule

    def _set_outputs(self, op, dim, slots=None):
        for slot, names in op.outputs.items():
            if slots is not None and slot not in slots:
                continue
            for n in names:
                if not n:
                    continue
                if dim is None:
                    self.dims.pop(n, None)
                else:
                    self.dims[n] = dim

    def _gather_rule(self, op, sharded_in):
        rule = _Rule("gather")
        rule.inputs = {n: ("gather", d) for n, d in sharded_in.items()}
        self._set_outputs(op, None)
        return rule

    def _auto_grad(self, op):
        """IGRAD_<slot> of an `__auto_grad__` takes the layout of the
        forward input it differentiates; a cotangent laid out otherwise
        than its forward output is conformed first."""
        rule = _Rule("auto_grad")
        fwd_inputs = op.attr("fwd_inputs") or {}
        fwd_outputs = op.attr("fwd_outputs") or {}
        for slot, names in op.outputs.items():
            if not slot.startswith("IGRAD_"):
                continue
            src = fwd_inputs.get(slot[len("IGRAD_"):], [])
            for i, g in enumerate(names):
                if not g:
                    continue
                d = self.dims.get(src[i]) if i < len(src) and src[i] else None
                if d is None:
                    self.dims.pop(g, None)
                else:
                    self.dims[g] = d
        for slot, names in op.inputs.items():
            if not slot.startswith("GRAD_"):
                continue
            outs = fwd_outputs.get(slot[len("GRAD_"):], [])
            for i, g in enumerate(names):
                if not g or i >= len(outs) or not outs[i]:
                    continue
                want, got = self.dims.get(outs[i]), self.dims.get(g)
                if want != got:
                    rule.inputs[g] = ("gather", got) if want is None else ("chunk", want)
        return rule

    def _sharded_rule(self, op, sharded_in):
        t = op.type
        x = op.input("X")[0] if op.input("X") else None
        dx = self.dim(x)
        if t == "moe_ffn":
            return self._expert(op, sharded_in)
        if self.sequence:
            rule = self._sequence_rule(op, sharded_in, x, dx)
            if rule is not None:
                return rule
        if t in ("mul", "matmul"):
            return self._product(op, sharded_in)
        if t in _UNARY and set(sharded_in) == {x}:
            rule = _Rule("local")
            self._set_outputs(op, dx)
            return rule
        if t == "dropout_grad":
            g = op.input("GRAD_Out")[0]
            rule = _Rule("local")
            self._set_outputs(op, self.dim(g))
            return rule
        if t in ("softmax", "softmax_grad"):
            src = x if t == "softmax" else op.input("Out")[0]
            d = self.dim(src)
            rank = len(self._shape(src) or ())
            axis = op.attr("axis", -1) % max(rank, 1)
            if d is not None and d != axis and all(v == d for v in sharded_in.values()):
                rule = _Rule("local")
                self._set_outputs(op, d)
                return rule
            return self._gather_rule(op, sharded_in)
        if t in _BINARY:
            return self._binary(op, sharded_in)
        if t in ("elementwise_add_grad", "elementwise_sub_grad"):
            return self._binary_grad(op, sharded_in)
        if t == "sum":
            dims = {self.dim(n) for n in op.input("X") if n}
            if len(dims) == 1:
                rule = _Rule("local")
                self._set_outputs(op, dims.pop())
                return rule
            return self._gather_rule(op, sharded_in)
        if t == "reshape2" and set(sharded_in) == {x}:
            return self._reshape(op, x, dx) or self._gather_rule(op, sharded_in)
        if t == "transpose2" and set(sharded_in) == {x}:
            rule = _Rule("local")
            self._set_outputs(op, list(op.attr("axis")).index(dx), slots=("Out",))
            return rule
        if t == "fused_multihead_attention":
            hd = 2 if (op.attr("layout", "bhsd") or "bhsd") == "bshd" else 1
            qkv = [op.input(s)[0] for s in ("Q", "K", "V")]
            if all(self.dim(n) == hd for n in qkv) and set(sharded_in) <= set(qkv):
                rule = _Rule("local")
                self._set_outputs(op, hd)
                return rule
            return self._gather_rule(op, sharded_in)
        if t in ("squared_l2_norm", "reduce_sum") and set(sharded_in) == {x} and (
                t == "squared_l2_norm" or op.attr("reduce_all", False)):
            rule = _Rule("partial")
            rule.reduce_out = [op.output("Out")[0]]
            self._set_outputs(op, None)
            return rule
        if t in _OPTIMIZERS:
            for i, p in enumerate(op.input("Param")):
                g = op.input("Grad")[i]
                if self.dim(p) != self.dim(g):
                    raise RuntimeError(f"tensor parallelism: {g!r} is laid out "
                                       f"{self.dim(g)}, its parameter {p!r} {self.dim(p)}")
            for slot, names in op.outputs.items():
                for n in names:
                    if n:
                        self.dims.pop(n, None)
                        if self._target(n) is not None:
                            self.dims[n] = self._target(n)
            return _Rule("local")
        return self._gather_rule(op, sharded_in)

    def _sequence_rule(self, op, sharded_in, x, dx):
        """The sequence layout's own rules (None: the shared rules decide)."""
        t = op.type
        if t == "lookup_table":
            ids, w = op.input("Ids")[0], op.input("W")[0]
            if set(sharded_in) == {ids}:
                rule = _Rule("local")
                rule.inputs = {w: ("copy",)}
                self._set_outputs(op, self.dim(ids))
                return rule
            return self._gather_rule(op, sharded_in)
        if t in ("layer_norm", "layer_norm_grad"):
            rows = [n for slot in ("X", "Mean", "Variance", "GRAD_Y") for n in op.input(slot)]
            d = dx
            if d is not None and d < op.attr("begin_norm_axis", 1) and \
                    set(sharded_in) <= set(rows) and all(self.dim(n) == d for n in rows):
                rule = _Rule("local")
                if t == "layer_norm":
                    rule.inputs = {n: ("copy",) for slot in ("Scale", "Bias")
                                   for n in op.input(slot) if n}
                    self._set_outputs(op, d)
                else:
                    self._set_outputs(op, d, slots=("IGRAD_X",))
                    rule.reduce_out = [n for slot in ("IGRAD_Scale", "IGRAD_Bias")
                                       for n in op.output(slot) if n]
                    for n in rule.reduce_out:
                        self.dims.pop(n, None)
                return rule
            return self._gather_rule(op, sharded_in)
        if t in ("mul", "matmul") and op.input("Y")[0] not in sharded_in and dx is not None:
            y = op.input("Y")[0]
            rx, ry = len(self._shape(x) or ()), len(self._shape(y) or ())
            if t == "mul":
                local = ry == 2 and op.attr("y_num_col_dims", 1) == 1 and \
                    dx < op.attr("x_num_col_dims", 1)
            else:
                local = ry == 2 and not op.attr("transpose_X", False) and dx <= rx - 2
            if local:
                rule = _Rule("local")
                rule.inputs = {y: ("copy",)}
                self._set_outputs(op, dx)
                return rule
            return self._gather_rule(op, sharded_in)
        if t == "fused_multihead_attention":
            sd = 1 if (op.attr("layout", "bhsd") or "bhsd") == "bshd" else 2
            qkv = [op.input(s_)[0] for s_ in ("Q", "K", "V")]
            if all(self.dim(n) == sd for n in qkv):
                rule = _Rule("local")
                for n in op.input("KeyBias"):
                    if n and self.dim(n) is None:
                        rule.inputs[n] = ("chunk", 1)
                    elif n and self.dim(n) != 1:
                        return self._gather_rule(op, sharded_in)
                self._set_outputs(op, sd)
                return rule
            return self._gather_rule(op, sharded_in)
        return None

    def _expert(self, op, sharded_in):
        """moe_ffn: the tokens whole (gathered when sequence-sharded), the
        expert params as they are laid out; outputs replicated."""
        rule = _Rule("expert")
        experts = [n for slot in ("W1", "B1", "W2", "B2") for n in op.input(slot)]
        for n, d in sharded_in.items():
            if n in experts and d == 0:
                continue
            rule.inputs[n] = ("gather", d)
        self._set_outputs(op, None)
        return rule

    def _product(self, op, sharded_in):
        x, y = op.input("X")[0], op.input("Y")[0]
        dx, dy = self.dim(x), self.dim(y)
        xs, ys = self._shape(x) or (), self._shape(y) or ()
        rx, ry = len(xs), len(ys)
        if op.type == "mul":
            xn = op.attr("x_num_col_dims", 1)
            yn = op.attr("y_num_col_dims", 1)
            if ry != 2 or yn != 1:
                return self._gather_rule(op, sharded_in)
            col_y, row_y, contract_x, out_last = 1, 0, (rx - 1 if xn == rx - 1 else None), xn
        else:
            tx, ty = op.attr("transpose_X", False), op.attr("transpose_Y", False)
            if rx >= 3 and rx == ry and dx is not None and dx == dy and dx < rx - 2:
                rule = _Rule("local")
                self._set_outputs(op, dx)
                return rule
            if ry != 2 or rx < 2:
                return self._gather_rule(op, sharded_in)
            col_y, row_y = (0, 1) if ty else (1, 0)
            contract_x = rx - 2 if tx else rx - 1
            out_last = rx - 1
        if dx is None and dy == col_y:
            rule = _Rule("column")
            rule.inputs = {x: ("copy",)}
            self._set_outputs(op, out_last)
            return rule
        if dx is not None and dx == contract_x and dy == row_y:
            rule = _Rule("row")
            rule.reduce_out = [op.output("Out")[0]]
            self._set_outputs(op, None)
            return rule
        return self._gather_rule(op, sharded_in)

    def _aligned(self, op, x, y):
        """The dim of Y aligned with each dim of X (None: Y broadcasts)."""
        xs, ys = self._shape(x) or (), self._shape(y) or ()
        if len(xs) == len(ys):
            return {i: i for i in range(len(xs))}, ys
        axis = op.attr("axis", -1)
        if axis is None or axis == -1:
            axis = len(xs) - len(ys)
        return {axis + j: j for j in range(len(ys))}, ys

    def _y_role(self, op, x, y, d):
        """How Y meets X sharded on `d`: "shard" (Y sharded alike),
        "broadcast" (replicated Y constant along d) or None (gather)."""
        align, ys = self._aligned(op, x, y)
        j = align.get(d)
        dy = self.dim(y)
        if j is not None and dy == j:
            return "shard"
        if dy is None and (j is None or ys[j] == 1):
            return "broadcast"
        return None

    def _binary(self, op, sharded_in):
        x, y = op.input("X")[0], op.input("Y")[0]
        dx = self.dim(x)
        role = self._y_role(op, x, y, dx) if dx is not None else None
        if role is None:
            return self._gather_rule(op, sharded_in)
        rule = _Rule("local")
        if role == "broadcast":
            rule.inputs = {y: ("copy",)}
        self._set_outputs(op, dx)
        return rule

    def _binary_grad(self, op, sharded_in):
        x, y = op.input("X")[0], op.input("Y")[0]
        g = op.input("GRAD_Out")[0]
        dx = self.dim(x)
        role = self._y_role(op, x, y, dx) if dx is not None else None
        if role is None or self.dim(g) != dx:
            return self._gather_rule(op, sharded_in)
        rule = _Rule("local")
        self._set_outputs(op, dx, slots=("IGRAD_X",))
        gy = op.output("IGRAD_Y")
        if gy and gy[0]:
            if role == "shard":
                self.dims[gy[0]] = self.dim(y)
            else:
                rule.reduce_out = [gy[0]]
                self.dims.pop(gy[0], None)
        return rule

    def _reshape(self, op, x, d):
        """A reshape that carries dim d of X onto one dim k of Out with the
        same chunking: the clone's shape attr gets Out's k-th size over
        the group. None if there is no such k."""
        m = self.ranks
        xs, os_ = self._shape(x), self._shape(op.output("Out")[0])
        if not xs or not os_ or any(not isinstance(s, int) or s <= 0 for s in xs[:d + 1]):
            return None
        if any(not isinstance(s, int) or s <= 0 for s in os_):
            return None
        lead = int(np.prod(xs[:d])) if d else 1
        k, acc = 0, 1
        # past the dims that hold the leading ones, and past size-1 dims there
        # (a batch of 1 reshaped [1, s, h] -> [1, s, nh, dh])
        while k < len(os_) and (acc < lead or (os_[k] == 1 and xs[d] != 1)):
            acc *= os_[k]
            k += 1
        if acc != lead or k >= len(os_):
            return None
        a, b = xs[d], os_[k]
        if a % m or b % m or (a % b and b % a):
            return None
        shape = list(op.attr("shape"))
        if k < len(shape) and shape[k] > 0:
            shape[k] = shape[k] // m
        op.attrs["shape"] = shape
        self._retarget_grad_attrs(op, shape)
        rule = _Rule("local")
        self._set_outputs(op, k, slots=("Out",))
        return rule

    def _retarget_grad_attrs(self, op, shape):
        """The reshape's `__auto_grad__` re-lowers the forward from its
        fwd_attrs where the forward recorded no graph: give it the new
        shape too."""
        out = op.output("Out")[0]
        for g in self.block.ops:
            if g.type == "__auto_grad__" and g.attr("fwd_type") == op.type and \
                    (g.attr("fwd_outputs") or {}).get("Out", [None])[0] == out:
                attrs = dict(g.attr("fwd_attrs") or {})
                attrs["shape"] = shape
                g.attrs["fwd_attrs"] = attrs

    # -- the walk -----------------------------------------------------------
    def run(self, ctx, op, lower):
        """Lower `op` under its rule: `lower(ctx, op)` with the inputs
        transformed, then the outputs reduced and cut."""
        rule = self.rules.get(id(op))
        if rule is None:
            lower(ctx, op)
            return
        saved = {}
        for n, how in rule.inputs.items():
            if n not in ctx.values:
                continue
            v = saved[n] = ctx.values[n]
            if how[0] == "copy":
                ctx.values[n] = CopyToModel.apply(v, self.group)
            elif how[0] == "gather":
                ctx.values[n] = GatherFromModel.apply(v, how[1], self.group, self.rank,
                                                      self.ranks)
            else:
                ctx.values[n] = _chunk(v, how[1], self.rank, self.ranks)
        produced = set(op.output_arg_names())
        try:
            lower(ctx, op)
        finally:
            for n, v in saved.items():
                if n not in produced:
                    ctx.values[n] = v
        for n in rule.reduce_out:
            if n in ctx.values:
                ctx.values[n] = AllReduceFromModel.apply(ctx.values[n], self.group)
        for n, d in rule.chunk_out.items():
            if n in ctx.values:
                ctx.values[n] = _chunk(ctx.values[n], d, self.rank, self.ranks)

    def wrap_lower(self, lower):
        """`lower` with this plan's rules around it (lower_forward_op's
        `lower=`)."""
        return lambda ctx, op: self.run(ctx, op, lower)

    # -- values -------------------------------------------------------------
    def chunk(self, name, value):
        """A whole value of `name` cut to this rank's chunk (as is when
        replicated)."""
        d = self.dims.get(name)
        return value if d is None else _chunk(value, d, self.rank, self.ranks)

    def gather(self, name, value):
        """This rank's chunk of `name` gathered whole (as is when
        replicated)."""
        d = self.dims.get(name)
        return value if d is None else _gather(value, d, self.group, self.ranks)
