"""Core IR: Program / Block / Operator / Variable.

PyTorch counterpart of `paddle_tpu/framework.py`. The IR itself is
framework-neutral Python, so this module keeps the same classes, the same
`__model__.json` schema (version 1) and the same op/var dictionaries; an
export written by either package loads in the other. What differs is what
runs it: `executor.Executor` walks a Block op by op eagerly on torch
tensors instead of tracing it into one XLA computation.
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys
import threading

import numpy as np

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "recompute_scope",
    "unique_name",
    "convert_dtype",
    "is_float_dtype",
    "grad_var_name",
    "core_op_role",
    "op_reads",
    "op_has_sub_block",
    "block_external_reads",
    "name_scope",
    "cpu_places",
    "cuda_places",
    "cuda_pinned_places",
]

# ---------------------------------------------------------------------------
# dtype handling
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32",
    "fp32": "float32",
    "float": "float32",
    "float64": "float64",
    "fp64": "float64",
    "double": "float64",
    "float16": "float16",
    "fp16": "float16",
    "half": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "bool": "bool",
}


def convert_dtype(dtype) -> str:
    """Normalise a dtype spec (str / numpy dtype / torch dtype) to the IR's
    canonical string."""
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    name = str(dtype).replace("torch.", "")
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = getattr(dtype, "name", None) or name
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    raise ValueError(f"unsupported dtype: {dtype!r}")


FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def is_float_dtype(dtype) -> bool:
    return convert_dtype(dtype) in FLOAT_DTYPES


class core_op_role:
    Forward = 0
    Backward = 1
    Optimize = 2
    LRSched = 16
    Loss = 256


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------


class _UniqueNameGenerator:
    def __init__(self):
        self.ids = {}
        self.prefix = ""

    def __call__(self, key: str) -> str:
        key = self.prefix + key
        self.ids.setdefault(key, 0)
        name = f"{key}_{self.ids[key]}"
        self.ids[key] += 1
        return name


class _UniqueNameModule:
    """fluid.unique_name: `generate`, `guard` and `switch`."""

    def __init__(self):
        self._generator = _UniqueNameGenerator()

    def generate(self, key: str) -> str:
        return self._generator(key)

    def __call__(self, key: str) -> str:
        return self.generate(key)

    @contextlib.contextmanager
    def guard(self, new_prefix: str = ""):
        old = self._generator
        self._generator = _UniqueNameGenerator()
        self._generator.prefix = new_prefix
        try:
            yield
        finally:
            self._generator = old

    def switch(self):
        self._generator = _UniqueNameGenerator()


unique_name = _UniqueNameModule()

_name_scope_stack = threading.local()


@contextlib.contextmanager
def name_scope(prefix: str):
    """A name scope for the ops built inside it (reference: framework.py
    name_scope). As in the JAX package it is a per-thread stack of
    prefixes that names nothing yet."""
    stack = getattr(_name_scope_stack, "stack", [])
    stack.append(prefix)
    _name_scope_stack.stack = stack
    try:
        yield
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------


class Variable:
    """A named tensor slot in a Block. At run time its value is a torch
    tensor held by a Scope (persistables) or by the executor (temporaries)."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape=None,
        dtype="float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        type: str = "lod_tensor",
        lod_level: int = 0,
        **kwargs,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.lod_level = lod_level

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "type": self.type,
        }

    def numel(self):
        """The element count of the declared shape, a -1 / None dim
        counting as 1 (None without a shape)."""
        if self.shape is None:
            return None
        n = 1
        for d in self.shape:
            n *= abs(d) if d is not None else 1
        return n

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype}, "
            f"persistable={self.persistable})"
        )

    __str__ = __repr__


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, name, shape, dtype="float32", **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        # weight decay is a later slice (optimizer.apply_gradients raises)
        self.regularizer = kwargs.pop("regularizer", None)
        kwargs.pop("persistable", None)
        super().__init__(
            block, name, shape=shape, dtype=dtype, persistable=True, **kwargs
        )
        self.stop_gradient = not self.trainable

    def to_dict(self):
        d = super().to_dict()
        d["is_parameter"] = True
        d["trainable"] = self.trainable
        return d


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

_FRAMEWORK_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep


def _caller_outside_framework():
    """`file:line` of the nearest stack frame outside this package: the
    user's layer call that created the op, named again when its lowering
    fails (ops/registry.lower_op)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_FRAMEWORK_DIR):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


class Operator:
    """One op node. `inputs` / `outputs` map slot name -> list of variable
    names; attrs is a plain dict (JSON-able values, numpy arrays, nested
    Blocks)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}
        self.outputs = {}
        self.attrs = dict(attrs or {})
        for slot, vars_ in (inputs or {}).items():
            self.inputs[slot] = [_var_name(v) for v in _as_list(vars_)]
        for slot, vars_ in (outputs or {}).items():
            self.outputs[slot] = [_var_name(v) for v in _as_list(vars_)]
        if "op_role" not in self.attrs:
            self.attrs["op_role"] = core_op_role.Forward
        # the segment of an enclosing recompute_scope
        seg = getattr(getattr(block, "program", None), "_current_recompute_segment", None)
        if seg is not None and "recompute_segment" not in self.attrs:
            self.attrs["recompute_segment"] = seg
        self.callsite = _caller_outside_framework()

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_attr(self, name, val):
        self.attrs[name] = val

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, Block):
                attrs[k] = {"__block__": v.idx}
            elif isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            else:
                attrs[k] = v
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": attrs,
        }

    def __repr__(self):
        return f"Operator({self.type}, inputs={self.inputs}, outputs={self.outputs})"


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _is_block_like(attr):
    return hasattr(attr, "ops") and hasattr(attr, "vars")


def op_has_sub_block(op) -> bool:
    """True when an op carries a control-flow sub-block attr (while / cond
    bodies): the IR passes treat such ops conservatively."""
    return any(_is_block_like(a) for a in op.attrs.values())


def block_external_reads(sub_blk, acc=None):
    """Names a (sub-)block reads that it did not itself define."""
    if acc is None:
        acc = set()
    defined = set()
    for op in sub_blk.ops:
        for n in op.input_arg_names():
            if n and n not in defined:
                acc.add(n)
        for attr in op.attrs.values():
            if _is_block_like(attr):
                block_external_reads(attr, acc)
        defined.update(n for n in op.output_arg_names() if n)
    return acc


def op_reads(op):
    """Every name an op reads, including its sub-blocks' external reads."""
    reads = set(n for n in op.input_arg_names() if n)
    for attr in op.attrs.values():
        if _is_block_like(attr):
            block_external_reads(attr, reads)
    return reads


def _var_name(v):
    if isinstance(v, Variable):
        return v.name
    if isinstance(v, str):
        return v
    raise TypeError(f"expected Variable or str, got {type(v)}")


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


class Block:
    """Ordered op list + var map, possibly nested."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: dict[str, Variable] = {}
        self.ops: list[Operator] = []

    def create_var(self, name=None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype="float32", **kwargs) -> Parameter:
        # parameters always live in the global (root) block
        global_block = self.program.global_block()
        if name in global_block.vars:
            return global_block.vars[name]
        p = Parameter(global_block, name, shape, dtype=dtype, **kwargs)
        global_block.vars[name] = p
        return p

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name) -> bool:
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name) -> bool:
        return name in self.vars

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _find_var_recursive(self, name):
        blk = self
        while True:
            if name in blk.vars:
                return blk.vars[name]
            if blk.parent_idx < 0:
                return None
            blk = self.program.block(blk.parent_idx)

    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        return self._insert_op(0, type, inputs, outputs, attrs)

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        lines = [f"Block(idx={self.idx}, parent={self.parent_idx})"]
        lines += ["  " + repr(op) for op in self.ops]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


class Program:
    """The whole IR: a list of Blocks."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0  # bumped by every mutation of the op list
        # PartitionSpec-style annotations (tuples of axis names) recorded
        # by models/bert.py; nothing reads them until a sharded slice
        self._sharding_specs: dict[str, tuple] = {}
        self._amp_dtype: str | None = None

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def bump_version(self):
        self._version += 1

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy. With for_test=True, backward/optimize ops are dropped
        and every op carrying an `is_test` attr gets it set."""
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p.random_seed = self.random_seed
        p._version = 0
        p._sharding_specs = dict(self._sharding_specs)
        p._amp_dtype = self._amp_dtype
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for name, v in blk.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            p.blocks.append(nb)
        for bi, blk in enumerate(self.blocks):
            nb = p.blocks[bi]
            for op in blk.ops:
                role = op.attrs.get("op_role") or 0
                if for_test and role & (
                    core_op_role.Backward | core_op_role.Optimize
                ):
                    continue
                attrs = {}
                for k, v in op.attrs.items():
                    if isinstance(v, Block):
                        attrs[k] = p.blocks[v.idx]
                    else:
                        attrs[k] = copy.copy(v)
                if for_test and "is_test" in attrs:
                    attrs["is_test"] = True
                nop = nb.append_op(op.type, dict(op.inputs), dict(op.outputs),
                                   attrs)
                nop.callsite = op.callsite
        return p

    def _prune(self, targets) -> "Program":
        """The sub-program needed to compute `targets`."""
        target_names = {_var_name(t) for t in _as_list(targets)}
        p = self.clone()
        blk = p.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(blk.ops):
            if any(n in needed for n in op.output_arg_names()) or op.type in (
                "feed",
                "fetch",
            ):
                kept.append(op)
                needed.update(op_reads(op))
        blk.ops = list(reversed(kept))
        live = set()
        for op in blk.ops:
            live.update(op_reads(op))
            live.update(op.output_arg_names())
        blk.vars = {k: v for k, v in blk.vars.items() if k in live or v.persistable}
        return p

    # -- serialization: the `__model__.json` schema, version 1 -------------
    def to_dict(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "amp_dtype": self._amp_dtype,
            "pipeline_microbatches": 1,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    @staticmethod
    def from_dict(d) -> "Program":
        if d.get("pipeline_microbatches", 1) > 1:
            raise NotImplementedError(
                "pipeline-microbatched programs are not ported yet")
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p.random_seed = d.get("random_seed", 0)
        p._version = 0
        p._sharding_specs = {}
        p._amp_dtype = d.get("amp_dtype")
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                vd = dict(vd)
                is_param = vd.pop("is_parameter", False)
                trainable = vd.pop("trainable", True)
                name = vd.pop("name")
                shape = vd.pop("shape")
                if is_param:
                    v = Parameter(blk, name, shape, trainable=trainable, **vd)
                else:
                    v = Variable(blk, name, shape=shape, **vd)
                blk.vars[name] = v
            p.blocks.append(blk)
        for bd in d["blocks"]:
            blk = p.blocks[bd["idx"]]
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__block__" in v:
                        attrs[k] = p.blocks[v["__block__"]]
                    elif isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    else:
                        attrs[k] = v
                blk.append_op(od["type"], od["inputs"], od["outputs"], attrs)
        return p

    def fingerprint(self) -> str:
        """sha1 of the Program's `to_dict()` as sorted-key JSON: the JAX
        package's structural hash (framework.py:701 there), equal for
        Programs that serialize alike."""
        import hashlib
        import json

        def _default(o):
            if isinstance(o, Block):
                return {"__block__": o.idx}
            if isinstance(o, np.ndarray):
                return o.tolist()
            return str(o)

        payload = json.dumps(self.to_dict(), sort_keys=True, default=_default)
        return hashlib.sha1(payload.encode()).hexdigest()

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


# ---------------------------------------------------------------------------
# default programs + guards
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Program = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


@contextlib.contextmanager
def recompute_scope(segment):
    """Tag the ops created in this scope as one recomputation segment
    (`attrs["recompute_segment"]`). Under optimizer.RecomputeOptimizer the
    Executor runs each segment in torch.utils.checkpoint: its activations
    are recomputed in the backward instead of held across the step."""
    prog = default_main_program()
    old = getattr(prog, "_current_recompute_segment", None)
    prog._current_recompute_segment = segment
    try:
        yield
    finally:
        prog._current_recompute_segment = old


def cpu_places(device_count=None):
    """`device_count` CPUPlaces (default: the CPU_NUM variable, else 1)."""
    from .place import CPUPlace

    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_pinned_places(device_count=None):
    """`device_count` CUDAPinnedPlaces (default 1): host staging places."""
    from .place import CUDAPinnedPlace

    return [CUDAPinnedPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    """One CUDAPlace per visible card (torch.cuda.device_count())."""
    import torch

    from .place import CUDAPlace

    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def in_dygraph_mode():
    """True inside fluid.dygraph.guard() (reference: framework.py
    in_dygraph_mode)."""
    from . import dygraph

    return dygraph.enabled()
