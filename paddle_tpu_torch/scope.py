"""Scope: name -> value store, with the fluid surface of the JAX package's
(`paddle_tpu/scope.py`): a parent chain that `get` / `has` look through,
`var`, `find_var` with `get_tensor()` / `get_value()` views, `new_scope`,
`drop_kids`, `delete` and `local_names`.

Values are torch tensors on the device of the executor that wrote them
(numpy arrays are accepted too, and moved to the device on first use).
Under a ZeRO-1 mesh run (compiler.CompiledProgram) an optimizer
accumulator is a DTensor sharded on the mesh's `batch` axis; `to_numpy`
gives its whole value, which is a collective every rank of the mesh
takes part in."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Scope", "global_scope", "scope_guard", "to_numpy", "full_value"]


def full_value(value):
    """A DTensor's whole value; any other value as it is. Each sharded
    mesh dim is all-gathered through its c10d group, the innermost first
    (the inverse of DTensor's left-to-right sharding): DTensor.full_tensor
    goes through the functional collectives, which crash under gloo with
    CUDA tensors (torch 2.11)."""
    if not hasattr(value, "placements") or not hasattr(value, "to_local"):
        return value
    if not all(pl.is_shard() or pl.is_replicate() for pl in value.placements):
        return value.full_tensor()
    import torch.distributed as dist

    mesh = value.device_mesh
    out = value.to_local()
    for i in reversed(range(mesh.ndim)):
        pl = value.placements[i]
        if not pl.is_shard():
            continue
        group = mesh.get_group(i)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out.contiguous(), group=group)
        out = torch.cat(parts, dim=pl.dim)
    return out


def to_numpy(value) -> np.ndarray:
    """A scope value as a host numpy array (bf16 widens to float32, which
    numpy lacks)."""
    value = full_value(value)
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


class _TensorView:
    """Stand-in for fluid's LoDTensor handle, `find_var(name).get_tensor()`."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def __array__(self, dtype=None, copy=None):
        arr = to_numpy(self._scope.get(self._name))
        return arr.astype(dtype) if dtype is not None else arr

    def set(self, value, place=None):
        self._scope.set(self._name, value)

    def shape(self):
        return list(np.asarray(self).shape)


class _ScopeVar:
    def __init__(self, scope, name):
        self._scope = scope
        self.name = name

    def get_tensor(self):
        return _TensorView(self._scope, self.name)

    def get_value(self):
        return self._scope.get(self.name)


class Scope:
    def __init__(self, parent: "Scope" = None):
        self._values = {}
        self._parent = parent
        self._kids = []

    def get(self, name):
        s = self
        while s is not None:
            if name in s._values:
                return s._values[name]
            s = s._parent
        raise KeyError(f"variable {name!r} not found in scope")

    def set(self, name, value):
        self._values[name] = value

    def has(self, name) -> bool:
        s = self
        while s is not None:
            if name in s._values:
                return True
            s = s._parent
        return False

    def delete(self, name):
        self._values.pop(name, None)

    def local_names(self):
        return list(self._values.keys())

    # -- the fluid surface ---------------------------------------------------
    def var(self, name) -> _ScopeVar:
        if name not in self._values:
            self._values[name] = None
        return _ScopeVar(self, name)

    def find_var(self, name):
        return _ScopeVar(self, name) if self.has(name) else None

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()


_scope_stack = [Scope()]


def global_scope() -> Scope:
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scope_stack.pop()
