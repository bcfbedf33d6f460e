"""Dygraph Layer base (paddle_tpu/dygraph/layers.py; reference
python/paddle/fluid/dygraph/layers.py `Layer`): parameter / sublayer
registration by attribute assignment, state_dict / set_dict, train / eval.
Parameters live on the active guard's device, or on cuda:0 outside any
guard. `set_dict` takes numpy arrays, so it carries weights across from
the JAX package's `state_dict()`."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .autograd import VarBase, _host_to_tensor

__all__ = ["Layer"]


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = name_scope or self.__class__.__name__.lower()
        self._dtype = dtype
        self._parameters: "OrderedDict[str, VarBase]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self.training = True

    # -- registration by attribute assignment ---------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        bufs = self.__dict__.get("_buffers")
        subs = self.__dict__.get("_sub_layers")
        if params is not None and isinstance(value, VarBase) and value.persistable:
            # trainable -> parameter; non-trainable persistable state (BN
            # running stats) -> buffer: saved but not optimized
            if value.stop_gradient:
                bufs[name] = value
                params.pop(name, None)
            else:
                params[name] = value
                bufs.pop(name, None)
        elif subs is not None and isinstance(value, Layer):
            subs[name] = value
        object.__setattr__(self, name, value)

    def full_name(self):
        return self._full_name

    # -- construction helpers ------------------------------------------
    def create_parameter(self, shape, dtype="float32", is_bias=False,
                         default_initializer=None, attr=None):
        # the JAX package's initializers, value for value: the seed is the
        # hash of the layer's full name (the same within one process)
        rng = np.random.RandomState(abs(hash(self._full_name)) % (2**31))
        shape = tuple(int(s) for s in shape)
        if default_initializer is not None:
            val = default_initializer(shape, dtype)
        elif is_bias:
            val = np.zeros(shape, dtype)
        else:  # Xavier-uniform, the reference default for dygraph nn
            fan_in = shape[0] if shape else 1
            fan_out = shape[-1] if shape else 1
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            val = rng.uniform(-limit, limit, shape).astype(dtype)
        p = VarBase(_host_to_tensor(val), stop_gradient=False)
        p.persistable = True
        return p

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        object.__setattr__(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        object.__setattr__(self, name, sublayer)
        return sublayer

    # -- traversal ------------------------------------------------------
    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.parameters())
        return out

    def named_parameters(self, prefix=""):
        for name, p in self._parameters.items():
            yield (f"{prefix}{name}", p)
        for sname, sub in self._sub_layers.items():
            yield from sub.named_parameters(prefix=f"{prefix}{sname}.")

    def buffers(self, include_sublayers=True):
        out = list(self._buffers.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.buffers())
        return out

    def named_buffers(self, prefix=""):
        """Non-trainable persistable state (BN running stats, spectral-norm
        u/v) by qualified name: what the JIT bridge threads through a
        compiled step beside the parameters but never differentiates."""
        for name, b in self._buffers.items():
            yield (f"{prefix}{name}", b)
        for sname, sub in self._sub_layers.items():
            yield from sub.named_buffers(prefix=f"{prefix}{sname}.")

    def flattened_state(self):
        """(params, buffers) as name -> VarBase OrderedDicts, deduplicated
        by identity (a tied parameter appears once, under its first name):
        the JIT bridge's compiled step is a pure function of these."""
        params: "OrderedDict[str, VarBase]" = OrderedDict()
        bufs: "OrderedDict[str, VarBase]" = OrderedDict()
        seen: set[int] = set()
        for name, p in self.named_parameters():
            if id(p) not in seen:
                seen.add(id(p))
                params[name] = p
        for name, b in self.named_buffers():
            if id(b) not in seen:
                seen.add(id(b))
                bufs[name] = b
        return params, bufs

    def named_state(self, prefix=""):
        """Parameters + buffers: what state_dict persists."""
        for name, p in self._parameters.items():
            yield (f"{prefix}{name}", p)
        for name, b in self._buffers.items():
            yield (f"{prefix}{name}", b)
        for sname, sub in self._sub_layers.items():
            yield from sub.named_state(prefix=f"{prefix}{sname}.")

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.sublayers())
        return out

    # -- state ----------------------------------------------------------
    def state_dict(self):
        return OrderedDict((name, p.numpy()) for name, p in self.named_state())

    def set_dict(self, state):
        named = dict(self.named_state())
        missing = set(named) - set(state)
        if missing:
            raise KeyError(f"state dict missing parameters: {sorted(missing)}")
        for name, p in named.items():
            p.set_value(state[name])

    load_dict = set_dict

    def train(self):
        self.training = True
        for sub in self._sub_layers.values():
            sub.train()

    def eval(self):
        self.training = False
        for sub in self._sub_layers.values():
            sub.eval()

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # host-side Python state a forward advances (a dropout's step counter,
    # a sampler's generator): the JIT bridge restores it around a run of
    # the step that stands for no trace of the JAX package's
    def _host_state(self):
        return None

    def _set_host_state(self, state):
        pass

    # -- call -----------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)
