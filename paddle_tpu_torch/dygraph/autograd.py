"""Define-by-run autograd for dygraph mode, over torch autograd
(paddle_tpu/dygraph/autograd.py; reference paddle/fluid/imperative/ —
`Tracer::TraceOp` records grad nodes while running kernels eagerly,
`BasicEngine` runs the reverse sweep, VarBase holds `grad_var_`).

A VarBase holds a torch tensor on the dygraph guard's device;
`stop_gradient=False` is `requires_grad`. `record(fn, *inputs)` runs a
torch closure on the inputs' tensors, each input whose `stop_gradient`
is set detached first, and tapes a node (the input VarBases) when an
input requires grad: torch records the graph itself. `backward()` walks
the tape to the leaves it reaches and takes their grads with
`torch.autograd.grad`, accumulated into each leaf's `.grad` across calls.
As in the JAX package a second `backward()` without `retain_graph` finds
no nodes and does nothing (torch would raise there).

`functional_trace` is what the JIT bridge (jit.py) runs a step under:
values derived from the bound state and inputs are "traced", and a host
read of one (`.numpy()`, `.gradient()`) or of a pre-existing tensor the
bridge never bound raises `UncapturableError`, before a CUDA graph
capture could report a device error. Host data turned into a device
tensor inside the step is staged: the bridge's first run records each
tensor in call order and its later runs (a CUDA graph capture, where a
host-to-device copy is illegal) get the same tensors back."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["VarBase", "record", "no_grad", "is_tracing", "Tracer",
           "UncapturableError", "functional_trace", "in_functional_trace",
           "tape_rng"]

_grad_enabled = True

_functional_trace_depth = 0
_rng_provider = None  # (seed, step) -> key tensor while a step is traced
_grad_write_log = None  # the live functional_trace's grad-write audit list
_active_trace = None  # the live functional_trace (concrete-read audit)
_vb_seq = 0  # global VarBase creation counter

# numpy dtypes as a JAX array holds them with 64-bit mode off
_CANONICAL = {np.dtype("float64"): np.float32, np.dtype("int64"): np.int32,
              np.dtype("uint64"): np.uint32, np.dtype("complex128"): np.complex64}

_TORCH_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64", torch.int16: "int16",
                torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


class UncapturableError(RuntimeError):
    """A Python side effect inside a traced dygraph function cannot be
    captured into the compiled step (host .numpy()/.gradient() reads,
    data-dependent control flow)."""


def in_functional_trace() -> bool:
    return _functional_trace_depth > 0


def current_device() -> torch.device:
    """The active dygraph guard's device; outside any guard, cuda:0 (which
    raises without a card)."""
    from . import _current_place
    from ..place import CUDAPlace

    place = _current_place()
    return (place if place is not None else CUDAPlace(0)).torch_device()


def _host_to_tensor(value, device=None) -> torch.Tensor:
    """numpy / python data -> a tensor on `device` (the guard's), in the
    dtype a JAX array would hold it; staged under a functional trace."""
    arr = np.asarray(value)
    arr = arr.astype(_CANONICAL.get(arr.dtype, arr.dtype), copy=False)
    trace = _active_trace
    if trace is not None and trace.stage is not None:
        return trace.stage(arr, device)
    return torch.tensor(arr, device=device or current_device())


class functional_trace:
    """Marks that dygraph execution is being traced by the JIT bridge.
    `rng_provider(seed, step) -> key tensor`, when given, overrides
    tape_rng so stochastic layers draw the bridge's per-call key. `stage`,
    when given, converts host data to device tensors (and hands staged
    ones back in call order). `traced` holds the tensors the bridge bound,
    by id; record() adds every output computed from one of them."""

    def __init__(self, rng_provider=None, stage=None):
        self._provider = rng_provider
        self.stage = stage
        # every leaf VarBase backward() writes a grad to while this trace
        # is live: the bridge audits it for external state it never bound
        self.grad_writes: list = []
        # every PRE-EXISTING VarBase whose concrete (untraced) value fed a
        # record() during the trace: external state the compiled step would
        # freeze
        self.concrete_reads: list = []
        self._read_ids: set = set()
        self._traced: dict = {}

    def mark(self, tensor):
        if isinstance(tensor, torch.Tensor):
            self._traced[id(tensor)] = tensor

    def is_traced(self, tensor) -> bool:
        return id(tensor) in self._traced and self._traced[id(tensor)] is tensor

    def _note_read(self, vb):
        if (vb._seq <= self._entry_seq and id(vb) not in self._read_ids
                and not self.is_traced(vb.value)):
            self._read_ids.add(id(vb))
            self.concrete_reads.append(vb)

    def __enter__(self):
        global _functional_trace_depth, _rng_provider, _grad_write_log
        global _active_trace
        _functional_trace_depth += 1
        self._old = (_rng_provider, _grad_write_log, _active_trace)
        self._entry_seq = _vb_seq
        if self._provider is not None:
            _rng_provider = self._provider
        _grad_write_log = self.grad_writes
        _active_trace = self
        return self

    def __exit__(self, *exc):
        global _functional_trace_depth, _rng_provider, _grad_write_log
        global _active_trace
        _functional_trace_depth -= 1
        _rng_provider, _grad_write_log, _active_trace = self._old
        if exc and exc[0] is not None:
            # an aborted trace: grads it accumulated onto leaves were
            # computed from bound values the bridge throws away
            for vb in self.grad_writes:
                if vb.grad is not None and self.is_traced(vb.grad):
                    vb.grad = None
        # let the step's activations and their autograd graph go now: a
        # graph that outlives its run keeps its leaves' AccumulateGrad
        # nodes, with the stream they were made on, into the next run, and
        # a CUDA graph capture that meets one made on another stream fails
        self._traced.clear()
        self._provider = self.stage = None
        return False


def _is_traced(value) -> bool:
    return _active_trace is not None and _active_trace.is_traced(value)


def tape_rng(seed, step, device=None):
    """PRNG key of a stochastic eager layer (dropout), as an int64 tensor
    of two words on `device`: fold_in(key(seed), step) on the host in
    eager mode; under the JIT bridge, the bridge's per-call key."""
    if _rng_provider is not None:
        return _rng_provider(seed, step)
    from ..ops import prng

    return prng.key_tensor(prng.fold_in(prng.key(seed), step),
                           device=device or current_device())


class no_grad:
    """Context manager + decorator disabling tape recording (reference
    dygraph/base.py no_grad): `with no_grad():`, `@no_grad` and
    `@no_grad()`."""

    def __init__(self, func=None):
        self._func = func

    def __enter__(self):
        global _grad_enabled
        self._old = _grad_enabled
        _grad_enabled = False
        return self

    def __exit__(self, *exc):
        global _grad_enabled
        _grad_enabled = self._old
        return False

    def __call__(self, *args, **kwargs):
        if self._func is None:  # @no_grad() usage: called with the fn
            return no_grad(args[0])
        with no_grad():  # @no_grad usage: called with the fn's args
            return self._func(*args, **kwargs)


def is_tracing() -> bool:
    return _grad_enabled


class _Node:
    __slots__ = ("inputs",)

    def __init__(self, inputs):
        self.inputs = inputs


class VarBase:
    """Eager tensor: a torch tensor + optional grad + tape node."""

    def __init__(self, value, stop_gradient=True, name=None):
        global _vb_seq
        self._stop_gradient = bool(stop_gradient)
        self._value = None
        self.value = value if isinstance(value, torch.Tensor) else _host_to_tensor(value)
        self.name = name
        self.grad = None
        self._node: _Node | None = None
        self.persistable = False
        _vb_seq += 1
        self._seq = _vb_seq  # creation order: the trace audits tell
        # pre-existing external tensors from trace-local temporaries by it

    # a trainable leaf's tensor requires grad, whoever assigns it (an
    # optimizer's out-of-place update, set_value, the JIT bridge's binding)
    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, t):
        if (not self._stop_gradient and t.grad_fn is None and not t.requires_grad
                and t.is_floating_point()):
            t.requires_grad_(True)
        self._value = t

    @property
    def stop_gradient(self):
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag):
        self._stop_gradient = bool(flag)
        if not flag:
            self.value = self._value

    # -- reference VarBase surface --------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return _TORCH_NAMES.get(self.value.dtype, str(self.value.dtype))

    def numpy(self):
        if in_functional_trace():
            if _is_traced(self.value):
                raise UncapturableError(
                    "VarBase.numpy() inside a traced dygraph function "
                    "reads a device value back to the host — that cannot "
                    "be captured into a compiled step. Move the host read "
                    "outside the traced function, or run this layer "
                    "eagerly."
                )
            if (_active_trace is not None
                    and self._seq <= _active_trace._entry_seq):
                raise UncapturableError(
                    "VarBase.numpy() inside a traced dygraph function "
                    "read a tensor the compiled step does not thread — "
                    "its value would be frozen into the executable. "
                    "Pass it as an argument or close over it so the "
                    "bridge binds it."
                )
        return _to_numpy(self.value)

    def detach(self):
        return VarBase(self.value.detach(), stop_gradient=True, name=self.name)

    def gradient(self):
        if in_functional_trace() and self.grad is not None:
            if _is_traced(self.grad):
                raise UncapturableError(
                    "VarBase.gradient() inside a traced dygraph function "
                    "reads a device gradient back to the host — fetch "
                    "gradients outside the traced function (the JIT "
                    "bridge writes them back to .grad after each "
                    "compiled call)."
                )
            if (_active_trace is not None
                    and self._seq <= _active_trace._entry_seq):
                raise UncapturableError(
                    "VarBase.gradient() inside a traced dygraph function "
                    "read a gradient the compiled step does not thread — "
                    "its value would be frozen into the executable. "
                    "Fetch gradients outside the traced function."
                )
        return None if self.grad is None else _to_numpy(self.grad)

    def clear_gradient(self):
        self.grad = None

    def set_value(self, value):
        """In place (a captured CUDA graph reads the same tensor) when the
        shape and dtype match; otherwise the VarBase takes a new tensor."""
        src = value.value if isinstance(value, VarBase) else value
        if not isinstance(src, torch.Tensor):
            src = _host_to_tensor(src, self.value.device)
        if src.shape == self.value.shape and src.dtype == self.value.dtype:
            with torch.no_grad():
                self.value.copy_(src)
        else:
            self.value = src.detach().to(self.value.device).clone()

    def astype(self, dtype):
        from ..ops.registry import TORCH_DTYPE

        td = TORCH_DTYPE(dtype)
        return record(lambda x: x.to(td), self)

    # -- backward -------------------------------------------------------
    def backward(self, grad=None, retain_graph=False):
        """Reverse sweep: the leaves this output's tape reaches get their
        grads from torch.autograd, added to what they hold."""
        if self._node is None:
            return
        topo, leaves, seen = [], [], set()
        stack = [self]
        while stack:
            var = stack.pop()
            if id(var) in seen:
                continue
            seen.add(id(var))
            if var._node is None:
                if var.value.requires_grad:
                    leaves.append(var)
                continue
            topo.append(var)
            stack.extend(i for i in var._node.inputs if not i.stop_gradient)
        if grad is None:
            seed = torch.ones_like(self.value)
        elif isinstance(grad, torch.Tensor):
            seed = grad.to(self.value.device, self.value.dtype)
        else:
            seed = torch.as_tensor(np.asarray(grad), dtype=self.value.dtype,
                                   device=self.value.device)
        grads = []
        if leaves:
            grads = torch.autograd.grad([self.value], [v.value for v in leaves], [seed],
                                        retain_graph=retain_graph, allow_unused=True)
        traced = _is_traced(self.value)
        for leaf, g in zip(leaves, grads):
            if g is None:  # taped but unused: jax.vjp gives zeros
                g = torch.zeros_like(leaf.value)
            leaf.grad = g if leaf.grad is None else leaf.grad + g
            if traced:
                _active_trace.mark(leaf.grad)
            if _grad_write_log is not None:
                _grad_write_log.append(leaf)
        if not retain_graph:
            for var in topo:
                var._node = None

    # -- python protocol -------------------------------------------------
    def __len__(self):
        return self.shape[0] if self.shape else 0

    def __repr__(self):
        return (f"VarBase(shape={self.shape}, dtype={self.dtype}, "
                f"stop_gradient={self.stop_gradient})")

    def __getitem__(self, idx):
        return record(lambda x: x[idx], self)

    def __neg__(self):
        return record(torch.negative, self)

    def _bin(self, other, fn, reverse=False):
        if isinstance(other, VarBase):
            if reverse:
                return record(lambda a, b: fn(b, a), self, other)
            return record(fn, self, other)
        c = other
        if reverse:
            return record(lambda a: fn(c, a), self)
        return record(lambda a: fn(a, c), self)

    def __add__(self, o):
        return self._bin(o, _add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, _sub)

    def __rsub__(self, o):
        return self._bin(o, _sub, reverse=True)

    def __mul__(self, o):
        return self._bin(o, _mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, _div)

    def __rtruediv__(self, o):
        return self._bin(o, _div, reverse=True)

    def __pow__(self, o):
        return self._bin(o, _pow)

    def __matmul__(self, o):
        return self._bin(o, torch.matmul)

    # -- numpy-style reductions (the reference's later VarBase API) ------
    def sum(self, axis=None, keepdim=False):
        return record(lambda x: _reduce(torch.sum, x, axis, keepdim), self)

    def mean(self, axis=None, keepdim=False):
        return record(lambda x: _reduce(torch.mean, x, axis, keepdim), self)

    def max(self, axis=None, keepdim=False):
        return record(lambda x: _reduce(torch.amax, x, axis, keepdim), self)

    def min(self, axis=None, keepdim=False):
        return record(lambda x: _reduce(torch.amin, x, axis, keepdim), self)


# the binary ops with python operands on either side, as jnp's are
def _add(a, b):
    return a + b


def _sub(a, b):
    return a - b


def _mul(a, b):
    return a * b


def _div(a, b):
    return a / b


def _pow(a, b):
    return a ** b


def _reduce(fn, x, axis, keepdim):
    if axis is None:
        out = fn(x)
        return out.reshape((1,) * x.ndim) if keepdim else out
    return fn(x, axis, keepdim=keepdim)


def _to_numpy(t):
    return t.detach().cpu().numpy()


def record(fn, *inputs: VarBase, **kw):
    """Run `fn` eagerly on the input tensors; tape a node when an input
    requires grad (reference Tracer::TraceOp + TraceBackward). An input
    whose stop_gradient is set enters detached."""
    if kw:
        base = fn
        fn = lambda *vals: base(*vals, **kw)  # noqa: E731
    trace = _active_trace
    if trace is not None:
        for i in inputs:
            trace._note_read(i)
    vals = [i.value.detach() if i.stop_gradient else i.value for i in inputs]
    needs_grad = _grad_enabled and any(not i.stop_gradient for i in inputs)
    with torch.set_grad_enabled(needs_grad):
        out_val = fn(*vals)
    needs_grad = needs_grad and out_val.requires_grad
    out = VarBase(out_val, stop_gradient=not needs_grad)
    if needs_grad:
        out._node = _Node(list(inputs))
    if trace is not None and any(trace.is_traced(i.value) for i in inputs):
        trace.mark(out_val)
    return out


class Tracer:
    """API-parity shim (reference imperative/tracer.h:31): tracing is
    implicit in `record`; the object carries train/eval mode."""

    def __init__(self):
        self._train_mode = True

    def train_mode(self):
        self._train_mode = True

    def eval_mode(self):
        self._train_mode = False
