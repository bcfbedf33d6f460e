"""Op registry + lowering context.

Each registered op provides a lowering: a function that reads torch
tensors from the LoweringContext and writes its outputs back. The
executor runs a Block by lowering its ops one after another, eagerly —
where the JAX package traces the same walk into one XLA computation. A
`layer_scan` op (ops/scan_ops.py) lowers its template ops once per layer
in a body context, whose `var_id` / `rng_for` see each template name as
that layer's own variable.

Backward ops come from `backward.append_backward`: custom grad ops where
the forward op's OpDef names a grad maker, and otherwise the generic
`__auto_grad__` op. In the JAX package `__auto_grad__` re-lowers the
forward inside `jax.vjp` and XLA CSE merges the two copies
(paddle_tpu/ops/registry.py:341-465). Eager torch has no CSE, so here it
pulls the cotangents through the autograd graph that the forward op
itself recorded (`lower_forward_op`, `_auto_grad_lower`). The graphs
are keyed by the crc32 of the forward's output names (`var_id`), which a
`layer_scan` body knows for each layer from its crc table: so a fused
backward layer finds the graph its forward recorded, fused or not.
"""

from __future__ import annotations

import functools
import zlib

import torch

from ..framework import convert_dtype
from . import prng

__all__ = [
    "OpDef",
    "register_op",
    "get_op",
    "LoweringContext",
    "SeedSlots",
    "TORCH_DTYPE",
    "lower_op",
    "lower_forward_op",
    "graph_users",
    "scan_crc_maps",
]

# int64 stays int64 (embedding lookups want long ids); float64 runs as
# float32 like the JAX package
_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def TORCH_DTYPE(dtype) -> torch.dtype:
    return _TORCH_DTYPES[convert_dtype(dtype)]


class OpDef:
    """A registered op: its lowering and what `append_backward` needs to
    know about its gradient (the same fields as the JAX package's OpDef)."""

    def __init__(self, type, lower, grad=None, no_grad_inputs=(),
                 stateful_outputs=(), differentiable=True, name_attrs=()):
        self.type = type
        self.lower = lower
        # grad: None -> __auto_grad__; callable -> custom grad maker
        # returning op descs; differentiable=False -> no grad at all
        self.grad = grad
        self.no_grad_inputs = frozenset(no_grad_inputs)
        # output slots that alias persistable state; never differentiated
        self.stateful_outputs = frozenset(stateful_outputs)
        self.differentiable = differentiable
        # attrs whose values are variable names (dropout_grad's rng_name)
        self.name_attrs = tuple(name_attrs)


_OP_REGISTRY: dict[str, OpDef] = {}


def register_op(type, **kwargs):
    """Decorator: @register_op("relu") def _(ctx, op): ...; keyword
    arguments are OpDef's (grad, no_grad_inputs, differentiable, ...)."""

    def deco(fn):
        _OP_REGISTRY[type] = OpDef(type, fn, **kwargs)
        return fn

    return deco


def get_op(type) -> OpDef:
    """The OpDef of op `type`."""
    if type not in _OP_REGISTRY:
        raise NotImplementedError(f"op {type!r} has no registered torch lowering")
    return _OP_REGISTRY[type]


_M32 = 0xFFFFFFFF


def int32_words(words):
    """uint32 words as the int32 values of the same bits."""
    return [w - (1 << 32) if w >= 1 << 31 else w for w in words]


class SeedSlots:
    """The random draws of a static step (`Executor.run_repeated`), as slots
    of a device table of int32 words.

    The walk computes each draw's seed on the host from the run key. A CUDA
    graph replays what it captured, so a host int would repeat the first
    step's masks at every replay. In a static lowering each draw instead
    registers a slot, which records how its word follows from the run key,
    and the lowering reads the word from `table`: the attention kernels
    through a pointer (the TPU kernels' seed_ref), the dropout op as a
    device scalar. `words(run_key)` computes every slot's words of one
    step on the host; the step writes them into the table before each
    replay. A slot is (kind, path): `path` the fold_in data from the run
    key to the draw's key (the context's own, then rng_for's var id or
    next_rng's counter); `kind` "attn" and a shift (the int32 seed
    prng.attention_seed, plus the mesh rank's shift, mod 2**32), "dropout"
    (prng.dropout_seed) or "key" (the key's two words, two entries).

    Slots register while `table` is None (the step's first, discovering
    lowering), each draw then getting a fresh scalar of its word under
    `discover_key`; `freeze()` allocates the table, and every later draw
    reads its slot there. A draw the discovering lowering did not make
    raises."""

    def __init__(self, device, discover_key):
        self.device = torch.device(device)
        self.discover_key = discover_key
        self.specs = []
        self._offset = {}
        self.size = 0
        self.table = None

    @staticmethod
    def _spec_words(spec, run_key):
        kind, path, shift = spec
        k = run_key
        for data in path:
            k = prng.fold_in(k, data)
        if kind == "attn":
            return [(prng.attention_seed(k) + shift) & _M32]
        if kind == "dropout":
            return [prng.dropout_seed(k)]
        return list(prng.key_data(k))

    def words(self, run_key):
        """Every slot's words under `run_key`, in table order."""
        return [w for spec in self.specs for w in self._spec_words(spec, run_key)]

    def freeze(self):
        """Allocate the table (one entry when there is no slot)."""
        self.table = torch.zeros(max(self.size, 1), dtype=torch.int32, device=self.device)

    def draw(self, kind, path, shift=0):
        """The int32 words of a draw: a 0-dim tensor ([2] for a key)."""
        spec = (kind, tuple(path), int(shift) & _M32)
        at = self._offset.get(spec)
        width = 2 if kind == "key" else 1
        if self.table is None:
            if at is None:
                at = self._offset[spec] = self.size
                self.specs.append(spec)
                self.size += width
            out = torch.tensor(int32_words(self._spec_words(spec, self.discover_key)),
                               dtype=torch.int32, device=self.device)
        elif at is None:
            raise RuntimeError(
                f"a random draw {spec} that the static step's first lowering did not make: "
                "the step's draws must not depend on its data")
        else:
            out = self.table[at:at + width]
        return out.reshape(()) if width == 1 else out


class LoweringContext:
    """Name -> tensor bindings while a Block runs, on one device.

    `generator` is the torch.Generator the startup program's initializers
    draw from. `rng_key` is the run's threefry key (ops/prng.py), from
    which dropout derives its masks exactly as the JAX package does.
    `tape` maps each forward op that recorded a graph (`_tape_key`: its
    type and the ids of its outputs) to the leaves its graph starts from
    and the outputs it ends in, both by id; `recomputed` collects the op
    types whose `__auto_grad__` had to re-run the forward because it had
    none, and `deferred` those whose forward op the dead-op pass removed,
    so that it runs once, in its `__auto_grad__`. `crcs` is None but in a
    `layer_scan` body, where it maps each template name to the crc32 of
    this layer's name for it. Under a CompiledProgram's mesh
    (parallel/step.py) `batch_group` is the process group of the mesh's
    batch axis, `batch_rank` this rank's place on it and `batch_ranks` its
    size: batch_norm sums its statistics over the group and dropout draws
    this rank's rows of the global mask; outside a mesh they are None, 0
    and 1. `seed_slots` is None but in a static step's lowering
    (`SeedSlots`), where `attention_seed`, `dropout_seed` and `next_rng`
    return device words read from the slot table, and `rng_path` is the
    fold_in data from the run key to this context's key. Under a mesh
    whose model axis is larger than 1 (parallel/tensor_parallel.py)
    `model_group`, `model_rank` and `model_ranks` describe the model group
    and `model_dims` maps each var sharded over it to its sharded dim:
    dropout draws its chunk's place in the global mask (`global_place`),
    attention hashes global heads (`head_shard`) and Lamb sums its norms
    over the group (`model_sum`); outside one they are None, 0, 1 and
    empty. `sequence_parallel` is the layout plan's sequence-parallel mode
    ("ring" or "ulysses"; None: the tensor-parallel layout), under which
    `model_dims` holds vars sharded on their sequence dim and attention on
    them runs across the model group."""

    def __init__(self, program=None, device=None, generator=None, rng_key=None,
                 is_test=False):
        self.program = program
        self.device = torch.device(device or "cpu")
        self.values: dict[str, torch.Tensor] = {}
        self.generator = generator
        self.rng_key = rng_key
        self._rng_counter = 0
        self.is_test = is_test
        self.tape: dict[tuple, tuple[dict, dict]] = {}
        self.recomputed: set[str] = set()
        self.deferred: set[str] = set()
        self.crcs = None
        self.batch_group = None
        self.batch_rank = 0
        self.batch_ranks = 1
        self.seed_slots = None
        self.rng_path = ()
        self.model_group = None
        self.model_rank = 0
        self.model_ranks = 1
        self.model_dims = {}
        self.sequence_parallel = None
        # the bf16 compute policy of contrib.mixed_precision, read from the
        # program as the JAX package reads it (registry.py:183-189 there):
        # the product ops cast their float inputs to amp_dtype unless
        # black-listed; custom white-listed op types get every float32
        # input pre-cast (_amp_precast)
        amp = getattr(program, "_amp_dtype", None)
        self.amp_dtype = TORCH_DTYPE(amp) if amp else None
        self.amp_black_list = getattr(program, "_amp_black_list", set())
        self.amp_white_list = getattr(program, "_amp_white_list", set())

    def get(self, name):
        if name not in self.values:
            raise KeyError(
                f"variable {name!r} used before it holds a value — "
                "did you run the startup program / feed it?"
            )
        return self.values[name]

    def has(self, name):
        return name in self.values

    def in_(self, op, slot, idx=0, default=None):
        names = op.input(slot)
        if len(names) <= idx:
            return default
        return self.get(names[idx])

    def ins(self, op, slot):
        return [self.get(n) for n in op.input(slot)]

    def out(self, op, slot, value, idx=0):
        names = op.output(slot)
        if names:
            self.values[names[idx]] = value

    def _key(self):
        if self.rng_key is None:
            raise RuntimeError(
                "op requires randomness but no rng key threaded — executor bug")
        return self.rng_key

    def next_rng(self):
        """The next key of the counter stream; in a static step, its two
        words as an int64 device tensor [2] (prng.key_tensor's form)."""
        self._rng_counter += 1
        if self.seed_slots is not None:
            words = self.seed_slots.draw("key", self.rng_path + (self._rng_counter,))
            return words.to(torch.int64) & _M32
        return prng.fold_in(self._key(), self._rng_counter)

    def var_id(self, name):
        """The crc32 of the variable `name` stands for, 31 bits: the name's
        own, or in a `layer_scan` body the current layer's name's."""
        return _var_id(self.crcs, name)

    def rng_for(self, name):
        """Key derived from a variable name, not the lowering order: a
        forward op and its grad op see the identical key
        (paddle_tpu/ops/registry.py:240-252; prng.name_key); in a
        `layer_scan` body, the key of the current layer's name
        (scan_ops.py:45-85 there)."""
        if self.seed_slots is not None:
            raise RuntimeError(
                f"rng_for({name!r}) would bake a host key into a static step: draw through "
                "attention_seed, dropout_seed or next_rng")
        return prng.fold_in(self._key(), self.var_id(name))

    def attention_seed(self, name, shift=0):
        """The attention kernels' int32 dropout seed for output `name`
        (prng.attention_seed of rng_for(name)) plus `shift`, mod 2**32: an
        int, or in a static step a 0-dim int32 device tensor."""
        if self.seed_slots is not None:
            return self.seed_slots.draw("attn", self.rng_path + (self.var_id(name),), shift)
        return (prng.attention_seed(self.rng_for(name)) + shift) & _M32

    def dropout_seed(self, name):
        """The dropout op's seed word for output `name` (prng.dropout_seed
        of rng_for(name)): an int, or in a static step a 0-dim int64 device
        tensor in [0, 2**32)."""
        if self.seed_slots is not None:
            words = self.seed_slots.draw("dropout", self.rng_path + (self.var_id(name),))
            return words.to(torch.int64) & _M32
        return prng.dropout_seed(self.rng_for(name))

    def global_place(self, name, shape):
        """(global shape, per-dim starts) of this rank's value of `name`,
        of local `shape`, in the tensor the whole mesh computes: dim 0
        split over the batch group (rank r's rows start at r times its
        rows), and a dim sharded over the model group its chunk."""
        shape = tuple(int(s) for s in shape)
        if not shape:
            return (), ()
        gshape, starts = list(shape), [0] * len(shape)
        gshape[0] *= self.batch_ranks
        starts[0] = self.batch_rank * shape[0]
        d = self.model_dims.get(name)
        if d is not None:
            gshape[d] *= self.model_ranks
            starts[d] += self.model_rank * shape[d]
        return tuple(gshape), tuple(starts)

    def head_shard(self, name, heads, head_dim):
        """(global head count, first head) of an attention input `name`
        holding `heads` heads on dim `head_dim`: this rank's chunk of the
        heads when `name` is sharded there over the model group, else all
        of them from 0."""
        if self.model_dims.get(name) == head_dim:
            return heads * self.model_ranks, self.model_rank * heads
        return heads, 0

    def model_sum(self, name, value):
        """`value`, a sum over the elements of `name`, summed over the model
        group when `name` is sharded over it (a new tensor), else as it
        is."""
        if name not in self.model_dims:
            return value
        import torch.distributed as dist

        out = value.detach().clone()
        dist.all_reduce(out, group=self.model_group)
        return out

    def derived(self, data, program=None):
        """A context on the key fold_in(this key, data), with this one's
        device, generator and seed slots (the recompute step's optimizer
        context)."""
        sub = LoweringContext(program or self.program, self.device, self.generator,
                              prng.fold_in(self.rng_key, data) if self.rng_key else None,
                              self.is_test)
        sub.seed_slots, sub.rng_path = self.seed_slots, self.rng_path + (data,)
        sub._copy_mesh(self)
        return sub

    def _copy_mesh(self, other):
        self.batch_group, self.batch_rank, self.batch_ranks = (
            other.batch_group, other.batch_rank, other.batch_ranks)
        self.model_group, self.model_rank, self.model_ranks, self.model_dims = (
            other.model_group, other.model_rank, other.model_ranks, other.model_dims)
        self.sequence_parallel = other.sequence_parallel

    def amp_dtype_for(self, op):
        """The AMP compute dtype of this op, or None (fp32)."""
        if self.amp_dtype is None or op.type in self.amp_black_list:
            return None
        return self.amp_dtype

    def amp_cast(self, op, *vals):
        """The float inputs of a product op cast to the AMP dtype, unless
        AMP is off or the op type is black-listed back to fp32."""
        dtype = self.amp_dtype_for(op)
        if dtype is None:
            return vals
        return [v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                else v for v in vals]

    def child(self):
        """A context for re-running ops inside this one: the same key and
        name ids, counter draws 1000 further on."""
        sub = LoweringContext(self.program, self.device, self.generator,
                              self.rng_key, self.is_test)
        sub._rng_counter = self._rng_counter + 1000
        sub.recomputed = self.recomputed
        sub.deferred = self.deferred
        sub.crcs = self.crcs
        sub._copy_mesh(self)
        sub.seed_slots, sub.rng_path = self.seed_slots, self.rng_path
        return sub

    def scan_body(self, crcs):
        """The context of one `layer_scan` iteration: `crcs` maps template
        names to this layer's crcs; the tape is this context's, so a
        layer's forward records where its backward looks."""
        sub = self.child()
        sub.crcs = crcs
        sub.tape = self.tape
        return sub


def _amp_precast(ctx, op):
    """Custom white list: the op's float32 input bindings cast to the AMP
    dtype before it lowers (registry.py:282-300 there). Returns the
    shadowed originals."""
    saved = {}
    if op.type not in ctx.amp_white_list or ctx.amp_dtype_for(op) is None:
        return saved
    for n in op.input_arg_names():
        v = ctx.values.get(n) if n else None
        if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
            saved[n] = v
            ctx.values[n] = v.to(ctx.amp_dtype)
    return saved


def lower_op(ctx: LoweringContext, op):
    try:
        saved = _amp_precast(ctx, op)
        try:
            get_op(op.type).lower(ctx, op)
        finally:
            ctx.values.update(saved)
    except Exception as e:
        # a failing lowering names the op and the user's layer call that
        # created it
        site = getattr(op, "callsite", None)
        note = f"[paddle_tpu_torch] while lowering op {op.type!r}"
        if site:
            note += f" created at {site}"
        outs = [n for n in op.output_arg_names() if n][:3]
        if outs:
            note += f" (outputs: {', '.join(outs)})"
        if note not in (getattr(e, "__notes__", None) or ()):
            e.add_note(note)
        raise


# ---------------------------------------------------------------------------
# the generic grad op
# ---------------------------------------------------------------------------
#
# append_backward (backward.py) emits for forward op F an op
#   type:    "__auto_grad__"
#   attrs:   fwd_type, fwd_inputs, fwd_outputs, fwd_attrs
#   inputs:  F's inputs under their slots prefixed "FWD_", and the grads
#            of F's outputs under "GRAD_<slot>" ("" marks a missing one)
#   outputs: input grads under "IGRAD_<slot>"


class _FwdOpView:
    """Duck-typed Operator for re-running a forward lowering."""

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]


def _is_float(v):
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _var_id(crcs, name):
    """`name`'s crc from a layer's crc map, else the crc32 of the name
    itself, 31 bits (what `rng_for` folds into the run key)."""
    if crcs is not None and name in crcs:
        return crcs[name]
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def _tape_key(var_id, fwd_type, outputs):
    """A forward op's graph's key: its type and the ids of its outputs."""
    return (fwd_type, tuple((slot, tuple(var_id(n) if n else "" for n in names))
                            for slot, names in sorted(outputs.items())))


def scan_crc_maps(op):
    """A `layer_scan` op's template name -> crc maps, one per layer."""
    names, rows = op.attr("crc_names") or [], op.attr("crc_rows") or []
    return [{nm: row[k] for nm, row in zip(names, rows)}
            for k in range(int(op.attr("num_iters")))]


def graph_users(block):
    """Tape keys of the forward ops whose grads an `__auto_grad__` op of
    `block` pulls through the forward's graph, those inside a
    `layer_scan`'s template ops too, once per layer."""
    users = set()
    for op in block.ops:
        if op.type == "__auto_grad__":
            users.add(_tape_key(functools.partial(_var_id, None), op.attr("fwd_type"),
                                op.attr("fwd_outputs")))
        elif op.type == "layer_scan":
            grads = [t for t in op.attr("template_ops") if t.type == "__auto_grad__"]
            for crcs in scan_crc_maps(op) if grads else ():
                users.update(_tape_key(functools.partial(_var_id, crcs), t.attr("fwd_type"),
                                       t.attr("fwd_outputs")) for t in grads)
    return users


def lower_forward_op(ctx: LoweringContext, op, users, lower=lower_op):
    """Lower a forward op of a training step. If its grad is an
    `__auto_grad__` (its tape key is in `users`), it runs under
    enable_grad, with each input that requires grad cut from the graph of
    the op that produced it: the op reads a fresh detached leaf, and the
    tape keeps the leaves. So the op's graph is its own, from its leaves
    to its outputs, and its `__auto_grad__` computes exactly this op's
    vector-Jacobian product: without the cut, `torch.autograd.grad` to a
    parameter would also follow every earlier op's path to that parameter.
    An op whose grad op recomputes from saved values (batch_norm,
    layer_norm, dropout, softmax, ...) records no graph, whose saved
    tensors would live until the end of the step: it runs under no_grad,
    and its float outputs become fresh requires-grad leaves when an input
    required grad, so the ops after it still record theirs. A `layer_scan`
    lowers each template op of each layer through this function.

    `lower` lowers the op (a tensor-parallel plan passes `lower_op` with
    its collectives around it, so the graph records them).

    Within one step every forward op, and every layer of a scan body,
    records once, so a tape key that is already there can only be two
    ops whose output ids collide: that raises rather than let one
    `__auto_grad__` pull its grads through the other's graph."""
    if op.type == "layer_scan":
        from .scan_ops import lower_layer_scan  # scan_ops imports this module

        lower_layer_scan(ctx, op, users)
        return
    key = _tape_key(ctx.var_id, op.type, op.outputs)
    if key not in users:
        tracked = any(isinstance(t, torch.Tensor) and t.requires_grad
                      for t in (ctx.values.get(n) for n in op.input_arg_names() if n))
        with torch.no_grad():
            lower(ctx, op)
        if tracked:
            stateful = get_op(op.type).stateful_outputs
            for slot, names in op.outputs.items():
                for n in names:
                    t = ctx.values.get(n) if n and slot not in stateful else None
                    if isinstance(t, torch.Tensor) and t.is_floating_point():
                        ctx.values[n] = t.detach().requires_grad_(True)
        return
    leaves = {}
    for n in op.input_arg_names():
        t = ctx.values.get(n) if n else None
        if n not in leaves and isinstance(t, torch.Tensor) and t.requires_grad:
            leaves[n] = t.detach().requires_grad_(True)
    produced = set(op.output_arg_names())
    saved = {n: ctx.values[n] for n in leaves}
    ctx.values.update(leaves)
    try:
        with torch.enable_grad():
            lower(ctx, op)
    finally:
        for n, t in saved.items():
            if n not in produced:
                ctx.values[n] = t
    if leaves:
        if key in ctx.tape:
            raise RuntimeError(f"two {op.type!r} ops share the tape key {key}: their "
                               f"output ids collide ({sorted(produced)})")
        outs = {ctx.var_id(n): ctx.values[n] for n in produced if n and n in ctx.values}
        ctx.tape[key] = ({ctx.var_id(n): t for n, t in leaves.items()}, outs)


@register_op("__auto_grad__", differentiable=False)
def _auto_grad_lower(ctx, op):
    """Input grads of one forward op by `torch.autograd.grad` from the
    op's outputs (as bound in the context) to its differentiable inputs,
    with the cotangents the op names. The executor ran the forward under
    `torch.enable_grad()`, so the graph is the one the forward recorded:
    nothing is computed twice. Each op's graph is its own (its inputs are
    where the traversal stops), so no traversal shares a node with
    another's and the graph needs no retaining. Outputs without a
    cotangent contribute nothing; an input the graph does not reach gets
    zeros. If the forward ran without a graph, or did not run (the
    dead-op pass removed it), this op re-runs that one forward under
    enable_grad, as the JAX package re-lowers it."""
    fwd_type = op.attr("fwd_type")
    fwd_inputs = op.attr("fwd_inputs")
    fwd_outputs = op.attr("fwd_outputs")
    opdef = get_op(fwd_type)

    diff_in = []
    for slot, names in fwd_inputs.items():
        gnames = op.outputs.get(f"IGRAD_{slot}", [])
        for i, n in enumerate(names):
            if (n and i < len(gnames) and gnames[i]
                    and slot not in opdef.no_grad_inputs and _is_float(ctx.get(n))):
                diff_in.append((slot, i, n))
    out_order = [(slot, i, n) for slot, names in fwd_outputs.items()
                 if slot not in opdef.stateful_outputs
                 for i, n in enumerate(names) if n]

    entry = ctx.tape.get(_tape_key(ctx.var_id, fwd_type, fwd_outputs))
    if entry is not None:
        leaves, recorded = entry
        ins = [leaves.get(ctx.var_id(n)) for _, _, n in diff_in]
        outs = [recorded.get(ctx.var_id(n)) for _, _, n in out_order]
    else:
        # an output is unbound where the dead-op pass dropped the forward
        # op (passes/dce.py: an unfetched loss reaches no other op)
        ins = [None] * len(diff_in)
        outs = [ctx.values.get(n) for _, _, n in out_order]
    unbound = any(t is None for t in outs)
    if unbound or any(t is None for t in ins) or not any(
            _is_float(t) and t.requires_grad for t in outs):
        ins = [ctx.get(n).detach().requires_grad_(True) for _, _, n in diff_in]
        sub = ctx.child()
        for names in fwd_inputs.values():
            for n in names:
                if n:
                    sub.values[n] = ctx.get(n)
        for (_, _, n), t in zip(diff_in, ins):
            sub.values[n] = t
        with torch.enable_grad():
            opdef.lower(sub, _FwdOpView(fwd_type, fwd_inputs, fwd_outputs,
                                        dict(op.attr("fwd_attrs") or {})))
        (ctx.deferred if unbound else ctx.recomputed).add(fwd_type)
        outs = [sub.get(n) for _, _, n in out_order]

    ys, cts = [], []
    for (slot, i, _), y in zip(out_order, outs):
        gnames = op.inputs.get(f"GRAD_{slot}", [])
        gname = gnames[i] if i < len(gnames) else ""
        if gname and ctx.has(gname) and _is_float(y) and y.requires_grad:
            ys.append(y)
            cts.append(ctx.get(gname).to(y.dtype).reshape(y.shape))
    # a name in two input slots (add(x, x)) is one tensor: its whole grad
    # goes to the last slot and the others get zeros, as in the JAX
    # package, where the last binding of the name wins inside jax.vjp
    last = {n: k for k, (_, _, n) in enumerate(diff_in)}
    uniq = sorted(last.values())
    grads = [None] * len(uniq)
    if ys and uniq:
        grads = torch.autograd.grad(ys, [ins[k] for k in uniq], cts,
                                    allow_unused=True)
    by_pos = dict(zip(uniq, grads))
    for k, ((slot, i, _), x) in enumerate(zip(diff_in, ins)):
        g = by_pos.get(k)
        ctx.values[op.outputs[f"IGRAD_{slot}"][i]] = (
            torch.zeros_like(x) if g is None else g)
