"""Dygraph JIT bridge (paddle_tpu/dygraph/jit.py; reference
python/paddle/fluid/dygraph/jit.py `TracedLayer`): a dygraph forward, or a
whole train step (forward + `loss.backward()` + `optimizer.minimize`),
run as one cached step per input signature. On the card that step is a
`torch.cuda.CUDAGraph`, replayed in one launch.

As in the JAX package the step is a pure function of

    (state, opt_state, grads, extras, inputs) ->
        (outputs, new_state, new_opt_state, new_grads, new_input_grads)

built by binding every parameter and buffer `.value` (and the bound
optimizer's accumulators, step and learning rate) to the step's inputs and
running the user's Python. The cache key is the same: the input
signature, the layers' training flags and state identities, which
parameters hold a grad, whether the tape records, and the current mesh's
signature (`parallel.mesh.mesh_signature`); `cache_info()`, the LRU cap
(PADDLE_TPU_JIT_CACHE_CAP, default 128) and the dygraph_jit_cache_hit /
_miss / _fallback / _evictions counters too.

Where the JAX bridge compiles the pure step with `jax.jit` and donates
the state's buffers, the port on the card captures it into a CUDA graph:

- the graph reads static buffers: the layers' and the optimizer's own
  tensors (each record of one CompiledFunction reads the same ones), the
  grads present, the inputs, the learning rate, the step counter and the
  dropout keys; at its end it copies the new state back into the
  layers' and the optimizer's own tensors. That copy is the donation: a
  reference to a pre-call `.value` sees the new value after the call.
- a miss runs the step once on a side stream into outputs it drops (the
  trace: it fixes the dropout slots and stages the host data the step
  turns into tensors), then captures it, which runs nothing; the first
  replay is the call's step. Nothing the live state holds changes before
  that replay.
- optimizer accumulators made lazily are found first by one run of the
  step whose outputs are dropped (the JAX package's eval_shape pass), and
  made as zeros before the capture, so the graph's pool allocates none
  and a second call captures nothing.
- each call copies its inputs, grads, learning rate, step and dropout
  keys in, replays, and hands back copies of the outputs and grads: the
  next replay overwrites the pool tensors they came from.
- the dropout key of a replay is the JAX bridge's per-call key
  fold_in(fold_in(fold_in(key(rng_seed), ncalls), seed), step), computed
  on the host and written into the key buffer, so each replay draws the
  JAX bridge's mask for that call, bit for bit.
- an evicted record frees its graph and pool.

On the CPU (a guard on CPUPlace) there is no graph: a record runs the
same pure step each call, with the same binding, audits, staged host
data, dropout keys and counters. A run of the step that stands for no
trace of the JAX bridge (a CPU hit, a capture) restores the host state
the layers keep (a dropout's step counter, a sampler's generator)
afterwards, so those advance as the JAX package's do.

Non-tensor Python state (momentum, a dropout rate) is a constant of a
cached step, and so is host data converted inside the traced function:
per-call data must arrive as arguments or through a closed-over tensor
updated with set_value. Fallback is loud, never silent: a host read of a
traced value, of an unbound tensor, or a second optimizer raises
`UncapturableError` in the trace, before any capture;
`to_compiled(fallback=True)` (the default) then warns once and runs
eagerly, `TracedLayer.trace` raises."""

from __future__ import annotations

import gc
import os
import warnings
from collections import OrderedDict

import numpy as np
import torch

from .. import profiler
from ..ops import prng
from . import autograd as _ag
from .autograd import UncapturableError, VarBase, functional_trace
from .layers import Layer
from .learning_rate_scheduler import LearningRateDecay

__all__ = ["TracedLayer", "to_compiled", "CompiledFunction"]

# trace failures that take the loud fallback path; anything else (shape
# errors, user bugs) propagates unchanged
_TRACE_ERRORS = (UncapturableError,)


class _Slot:
    """A leaf of the argument template: index into the flat input list and
    how to rebuild it (VarBase or raw tensor)."""

    __slots__ = ("idx", "is_var", "needs_grad")

    def __init__(self, idx, is_var, needs_grad):
        self.idx = idx
        self.is_var = is_var
        self.needs_grad = needs_grad


class _Static:
    """A non-tensor argument leaf, a constant of the cached step."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _flatten_args(args, kwargs):
    """Call arguments -> (tensor leaves, rebuild template, signature,
    {leaf index: VarBase})."""
    leaves, sig = [], []
    var_slots: dict = {}
    var_map: dict = {}

    def conv(x):
        if isinstance(x, VarBase):
            slot = var_slots.get(id(x))
            if slot is not None:
                # the same tensor passed again: one shared tape leaf, so
                # its grad contributions add up as they do eagerly
                sig.append(("dup", slot.idx))
                return slot
            leaves.append(x.value)
            sig.append(("var", tuple(x.value.shape), str(x.value.dtype),
                        bool(x.stop_gradient)))
            slot = _Slot(len(leaves) - 1, True, not x.stop_gradient)
            var_slots[id(x)] = slot
            var_map[slot.idx] = x
            return slot
        if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
            v = x.detach() if isinstance(x, torch.Tensor) else _ag._host_to_tensor(x)
            leaves.append(v)
            sig.append(("arr", tuple(v.shape), str(v.dtype)))
            return _Slot(len(leaves) - 1, False, False)
        if isinstance(x, (list, tuple)):
            # container markers keep step([x], [y]) and step([x, y], [])
            # (and step(a=x) against step(b=x)) on separate records
            sig.append(("seq", type(x).__name__, len(x)))
            return type(x)(conv(v) for v in x)
        if isinstance(x, dict):
            sig.append(("dict", tuple(sorted(x))))
            return {k: conv(v) for k, v in sorted(x.items())}
        # a non-tensor leaf keys the cache by value: an identity-hashed
        # object could be mutated and still hit a stale step. Callables
        # are exempt (keyed by identity, as jax.jit's static args).
        if not (x is None or callable(x)
                or isinstance(x, (bool, int, float, complex, str, bytes))):
            try:
                hash(x)
                identity_hashed = type(x).__hash__ is object.__hash__
            except TypeError:
                identity_hashed = True
            if identity_hashed:
                raise UncapturableError(
                    f"argument of type {type(x).__name__} hashes by "
                    "identity (or not at all), so it cannot key the "
                    "compiled-step cache: mutating it would silently "
                    "reuse a stale executable. Pass primitives, "
                    "tuples or arrays instead."
                )
        sig.append(("static", x))
        return _Static(x)

    t_args = conv(list(args))
    t_kwargs = conv(dict(kwargs))
    return leaves, (t_args, t_kwargs), tuple(sig), var_map


def _rebuild_args(template, vals, made):
    """Inverse of _flatten_args inside the step: leaf tensors -> fresh
    VarBases (one per distinct VarBase argument) or raw tensors."""

    def conv(t):
        if isinstance(t, _Slot):
            if not t.is_var:
                return vals[t.idx]
            if t.idx in made:
                return made[t.idx]
            vb = VarBase(vals[t.idx], stop_gradient=not t.needs_grad)
            made[t.idx] = vb
            return vb
        if isinstance(t, _Static):
            return t.value
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t

    t_args, t_kwargs = template
    return conv(t_args), conv(t_kwargs)


def _flatten_out(out):
    """A forward's return structure: VarBase / tensor leaves become step
    outputs, everything else a constant of the template."""
    leaves = []

    def conv(x):
        if isinstance(x, VarBase):
            leaves.append(x.value.detach())
            return _Slot(len(leaves) - 1, True, False)
        if isinstance(x, torch.Tensor):
            leaves.append(x.detach())
            return _Slot(len(leaves) - 1, False, False)
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _Static(x)

    return conv(out), leaves


def _rebuild_out(template, vals):
    def conv(t):
        if isinstance(t, _Slot):
            v = vals[t.idx]
            return VarBase(v, stop_gradient=True) if t.is_var else v
        if isinstance(t, _Static):
            return t.value
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t

    return conv(template)


def _closure_varbases(fn):
    """VarBases a traced function closes over (directly or in list / tuple
    / dict containers): threaded through the step as state, so their
    current values enter each call."""
    out = []
    seen: set = set()

    def walk(v):
        if id(v) in seen:
            return
        seen.add(id(v))
        if isinstance(v, VarBase):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    for cell in fn.__closure__ or ():
        try:
            walk(cell.cell_contents)
        except ValueError:
            continue
    return out


def _discover(fn):
    """Layers and an optimizer in a train-step function's closure."""
    from ..optimizer import Optimizer

    layers, opt = [], None
    for cell in fn.__closure__ or ():
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if isinstance(v, Layer) and all(v is not m for m in layers):
            layers.append(v)
        elif isinstance(v, Optimizer) and opt is None:
            opt = v
    if isinstance(getattr(fn, "__self__", None), Layer):
        layers.insert(0, fn.__self__)
    return tuple(layers), opt


def _jit_cache_cap(default):
    """The record cache's LRU bound from PADDLE_TPU_JIT_CACHE_CAP, at
    least 1."""
    raw = os.environ.get("PADDLE_TPU_JIT_CACHE_CAP", "")
    try:
        return max(int(raw), 1) if raw.strip() else max(int(default), 1)
    except ValueError:
        return max(int(default), 1)


def _slots(st):
    return st if isinstance(st, tuple) else (st,)


def _same_layout(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


class _Record:
    """One cached step: what its trace fixed (output template,
    minimize-call count, which grads it writes, the dropout slots, the
    staged host data) and, on the card, its CUDA graph with the static
    buffers it reads and the pool tensors it leaves its results in."""

    def __init__(self, template):
        self.template = template
        self.out_template = None
        self.minimize_calls = 0
        self.grad_touched = {}
        self.input_grad_touched = []
        self.rng_slots: list = []  # (seed, step) of each tape_rng call
        self.constants: list = []  # staged host data, in call order
        self.opt_popped: list = []
        self.graph = None
        self.result = None
        self.bufs = None

    def release(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.result = self.bufs = None


class CompiledFunction:
    """The bridge engine: the pure step over the flattened (params,
    buffers) of its Layers and the bound optimizer's state, one record per
    input signature. Accounting: `.cache_hits` / `.cache_misses` /
    `.fallbacks` / `.cache_evictions` and the global counters
    dygraph_jit_cache_hit / _miss / _fallback / _evictions;
    `.discovery_runs` counts the runs that found lazily made optimizer
    state."""

    def __init__(self, fn, layers=(), optimizer=None, fallback=True,
                 donate=True, rng_seed=0, name=None):
        self._fn = fn
        self._layers = tuple(layers)
        self._opt = optimizer
        self._fallback = fallback
        if not donate:
            # the graph's copy of the new state into the layers' own tensors
            # is how a replayed step updates them at all
            raise ValueError("to_compiled(donate=False): the port's compiled step always "
                             "writes the new state into the layers' own tensors")
        self._name = name or getattr(fn, "__name__", type(fn).__name__)
        self._cache: "OrderedDict[tuple, _Record]" = OrderedDict()
        self._cache_cap = _jit_cache_cap(128)
        self.cache_evictions = 0
        self._state_resolved = False
        self._params: "OrderedDict[str, VarBase]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
        self._rng_base = prng.key(rng_seed)
        self._zeros_cache: dict = {}
        self._closure_ids: list = []
        self._opt_stateless: dict = {}  # grad presence -> stateless names
        self._ncalls = 0
        self._device = None
        # on the card: the tensors every graph reads as state and writes
        # the new state into, by name
        self._live: dict = {}
        self._opt_live: dict = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.fallbacks = 0
        self.discovery_runs = 0
        self._fallen_back = False

    # -- state ----------------------------------------------------------
    def _zeros(self, like):
        key = (tuple(like.shape), like.dtype, like.device)
        z = self._zeros_cache.get(key)
        if z is None:
            z = torch.zeros(like.shape, dtype=like.dtype, device=like.device)
            self._zeros_cache[key] = z
        return z

    def _resolve_state(self):
        if self._state_resolved:
            return
        seen: set = set()
        for li, layer in enumerate(self._layers):
            prefix = "" if len(self._layers) == 1 else f"L{li}."
            params, bufs = layer.flattened_state()
            for n, p in params.items():
                if id(p) not in seen:
                    seen.add(id(p))
                    self._params[prefix + n] = p
            for n, b in bufs.items():
                if id(b) not in seen:
                    seen.add(id(b))
                    self._buffers[prefix + n] = b
        # optimizer params outside the layers: parameter_list is what
        # minimize updates
        if self._opt is not None:
            for i, p in enumerate(self._opt._parameter_list or []):
                if id(p) not in seen:
                    seen.add(id(p))
                    self._params[f"opt_param_{i}"] = p
        # closure VarBases: trainable ones join the params (grads flow),
        # the rest ride as buffers; their current values enter each call
        closure_vbs = _closure_varbases(self._fn)
        self._closure_ids = [id(v) for v in closure_vbs]
        for i, v in enumerate(closure_vbs):
            if id(v) in seen:
                continue
            seen.add(id(v))
            if v.stop_gradient:
                self._buffers[f"closure_{i}"] = v
            else:
                self._params[f"closure_{i}"] = v
        devices = {vb.value.device for vb in (*self._params.values(),
                                               *self._buffers.values())}
        if len(devices) > 1:
            raise RuntimeError(f"{self._name}: the bound state spans devices {devices}")
        self._device = devices.pop() if devices else _ag.current_device()
        self._state_resolved = True

    def _sublayers(self):
        for layer in self._layers:
            yield layer
            yield from layer.sublayers()

    def _training_sig(self):
        # (training, param ids, buffer ids) a sublayer: a sublayer added or
        # a parameter replaced after call 1 misses, and the retrace
        # refuses the new state loudly (_check_state_drift)
        return tuple((l.training,
                      tuple((id(p), p.stop_gradient) for p in l._parameters.values()),
                      tuple(map(id, l._buffers.values())))
                     for l in self._sublayers())

    def _check_state_drift(self):
        """State that appeared after _resolve_state froze the leaf set is
        not threaded: clear what the run left on it and refuse loudly."""
        known = {id(v) for v in self._params.values()}
        known |= {id(v) for v in self._buffers.values()}
        leaked = []
        for layer in self._layers:
            params, bufs = layer.flattened_state()
            for coll in (params, bufs):
                for n, vb in coll.items():
                    if id(vb) not in known:
                        leaked.append(n)
                        vb.grad = None
                        vb._node = None
        if leaked:
            raise UncapturableError(
                f"{self._name}: layer state changed after the first "
                f"compiled call (new parameters/buffers: {leaked}) — "
                "the frozen compiled step cannot thread them. Build a "
                "fresh to_compiled/TracedLayer wrapper for the mutated "
                "layer."
            )

    def _call_key(self, seq, seed, step):
        """The JAX bridge's per-call dropout key, as its two words."""
        k = prng.fold_in(prng.fold_in(prng.fold_in(self._rng_base, seq), seed), step)
        return prng.key_data(k)

    # -- binding --------------------------------------------------------
    class _bind:
        """Bind the live VarBases' values / grads (and the optimizer's
        state) to the step's inputs while the user's Python runs, under a
        functional_trace whose dropout keys and staged host data follow
        `mode`; restore the eager state unconditionally.

        mode "trace": the run that stands for the JAX bridge's jit trace:
        records each tape_rng call's (seed, step) and stages host data.
        "replay": a later run of a cached record (a CPU hit, a capture):
        hands them back in call order, and restores the layers' host state
        afterwards. "discover": the run that finds lazily made optimizer
        state (the JAX package's eval_shape): records nothing."""

        def __init__(self, eng, rec, mode, seq, state, opt_state, grads_in, extras):
            self.eng, self.rec, self.mode, self.seq = eng, rec, mode, seq
            self.state, self.opt_state = state, opt_state
            self.grads_in, self.extras = grads_in, extras
            self.minimize_calls = 0
            self._n_keys = 0
            self._n_consts = 0

        def _provider(self, seed, step):
            eng, rec = self.eng, self.rec
            if self.mode == "replay":
                k = self._n_keys
                self._n_keys += 1
                if k >= len(rec.rng_slots):
                    raise UncapturableError(
                        f"{eng._name}: the step drew more random keys than its "
                        "first run: its Python differs between runs")
                if self.extras.get("keys") is not None:
                    return self.extras["keys"][k]
                seed, step = rec.rng_slots[k]
            elif self.mode == "trace":
                rec.rng_slots.append((seed, step))
            return torch.tensor(eng._call_key(self.seq, seed, step), dtype=torch.int64,
                                device=eng._device)

        def _stage(self, arr, device):
            rec = self.rec
            device = device or self.eng._device
            if self.mode == "replay":
                k = self._n_consts
                self._n_consts += 1
                if k >= len(rec.constants) or tuple(rec.constants[k].shape) != arr.shape:
                    raise UncapturableError(
                        f"{self.eng._name}: the step turned other host data into "
                        "tensors than its first run did: its Python differs "
                        "between runs")
                return rec.constants[k]
            t = torch.tensor(arr, device=device)
            if self.mode == "trace":
                rec.constants.append(t)
            return t

        def __enter__(self):
            eng = self.eng
            self._saved = {}
            self._host = ([(l, l._host_state()) for l in eng._sublayers()]
                          if self.mode == "replay" else ())
            # on the card each run differentiates a fresh alias of each
            # parameter's tensor, so autograd makes its AccumulateGrad nodes
            # on this run's stream (see _capture)
            alias = eng._device.type == "cuda"
            for n, vb in eng._params.items():
                self._saved[n] = (vb.value, vb.grad, vb._node)
                value = self.state["params"][n]
                vb.value = value.detach() if alias else value
                vb.grad = self.grads_in["params"].get(n)
                vb._node = None
            for n, vb in eng._buffers.items():
                self._saved[n] = (vb.value, vb.grad, vb._node)
                vb.value = self.state["buffers"][n]
                vb.grad = None
                vb._node = None
            opt = eng._opt
            if opt is not None:
                opt._jit_bound = True
                self._opt_saved = (dict(opt._dy_state), opt._dy_step)
                for n, vb in eng._params.items():
                    st = self.opt_state.get(n)
                    if st is not None:
                        opt._dy_state[id(vb)] = st
                    else:
                        opt._dy_state.pop(id(vb), None)
                opt._dy_step = self.extras["step"]
                lr_val = self.extras["lr"]
                object.__setattr__(opt, "_dygraph_lr", lambda: lr_val)
                orig_min = type(opt).minimize.__get__(opt)

                def counted_minimize(*a, **k):
                    self.minimize_calls += 1
                    return orig_min(*a, **k)

                object.__setattr__(opt, "minimize", counted_minimize)
            self.ft = functional_trace(rng_provider=self._provider, stage=self._stage)
            self.ft.__enter__()
            for t in (*(vb.value for vb in eng._params.values()),
                      *(vb.value for vb in eng._buffers.values()),
                      *self.grads_in["params"].values(), self.extras["step"],
                      self.extras["lr"]):
                self.ft.mark(t)
            for st in self.opt_state.values():
                for t in _slots(st):
                    self.ft.mark(t)
            return self

        def __exit__(self, *exc):
            self.ft.__exit__(*exc)
            self.ft = None
            eng = self.eng
            for n, vb in list(eng._params.items()) + list(eng._buffers.items()):
                vb.value, vb.grad, vb._node = self._saved[n]
            opt = eng._opt
            if opt is not None:
                opt._jit_bound = False
                saved_state, saved_step = self._opt_saved
                opt._dy_state.clear()
                opt._dy_state.update(saved_state)
                opt._dy_step = saved_step
                opt.__dict__.pop("_dygraph_lr", None)
                opt.__dict__.pop("minimize", None)
            for layer, st in self._host:
                layer._set_host_state(st)
            return False

    # -- the pure step ---------------------------------------------------
    def _pure_step(self, rec, mode, seq, state, opt_state, grads_in, extras, input_vals,
                   copy_back=False):
        made: dict = {}
        if self._device.type == "cuda":  # fresh leaves, as the parameters' (_bind)
            input_vals = [t.detach() for t in input_vals]
        with self._bind(self, rec, mode, seq, state, opt_state, grads_in, extras) as b:
            args, kwargs = _rebuild_args(rec.template, input_vals, made)
            for t in input_vals:
                b.ft.mark(t)
            for i, vb in made.items():
                vb.grad = grads_in["inputs"][i]
                b.ft.mark(vb.grad)
            out = self._fn(*args, **kwargs)
            self._check_state_drift()
            # pre-existing tensors whose untraced values fed the step are
            # external state the bridge never bound: the step would freeze
            # them
            bound = {id(v) for v in self._params.values()}
            bound |= {id(v) for v in self._buffers.values()}
            bound |= {id(vb) for vb in made.values()}
            external = [vb for vb in b.ft.concrete_reads if id(vb) not in bound]
            if external:
                for vb in external:
                    if vb.grad is not None and b.ft.is_traced(vb.grad):
                        vb.grad = None
                raise UncapturableError(
                    f"{len(external)} tensor(s) outside the bound "
                    "layers/inputs fed the traced step with "
                    "concrete values — the executable would freeze "
                    "them. Pass their Layer via "
                    "to_compiled(layer=...) or close over the "
                    "tensors directly so discovery binds them."
                )
            rec.out_template, out_leaves = _flatten_out(out)
            rec.minimize_calls = b.minimize_calls
            # a grad the step never wrote is still the tensor bound on
            # entry: writeback keeps eager's `.grad is None` for it
            rec.grad_touched = {n: vb.grad is not grads_in["params"].get(n)
                                for n, vb in self._params.items()}
            rec.input_grad_touched = [
                i in made and made[i].grad is not grads_in["inputs"][i]
                for i in range(len(input_vals))]
            new_state = {"params": {n: vb.value for n, vb in self._params.items()},
                         "buffers": {n: vb.value for n, vb in self._buffers.items()}}
            new_grads = {n: (vb.grad if rec.grad_touched[n] else None)
                         for n, vb in self._params.items()}
            new_input_grads = [made[i].grad if i in made and rec.input_grad_touched[i]
                               else None for i in range(len(input_vals))]
            new_opt = {}
            if self._opt is not None:
                new_opt = {n: self._opt._dy_state.get(id(vb))
                           for n, vb in self._params.items()}
            if copy_back:
                self._copy_back(rec, new_state, new_opt)
        return out_leaves, new_state, new_opt, new_grads, new_input_grads

    def _copy_back(self, rec, new_state, new_opt):
        """Inside the capture: the new state into the live tensors."""
        with torch.no_grad():
            for group in ("params", "buffers"):
                for n, t in new_state[group].items():
                    live = self._live[n]
                    if t.data_ptr() != live.data_ptr():  # not the bound alias
                        live.copy_(t)
            rec.opt_popped = []
            for n, st in new_opt.items():
                live = self._opt_live.get(n)
                if st is None:
                    if live is not None:
                        rec.opt_popped.append(n)
                    continue
                for dst, src in zip(_slots(live), _slots(st)):
                    if src is not dst:
                        dst.copy_(src)

    def _ensure_opt_state(self, rec, presence, seq, state, opt_state, grads_in, extras,
                          input_vals):
        """Find the optimizer accumulators the step makes lazily, by one run
        of it with its outputs dropped, and make them as zeros (what
        `_dygraph_apply` starts from) before the step is compiled, so a
        second call with the same signature compiles nothing. Parameters
        that get no state under a grad-presence pattern are remembered, so
        a later signature does not run the step again to find out."""
        if self._opt is None:
            return opt_state
        stateless = self._opt_stateless.setdefault(presence, set())
        missing = [n for n in self._params if n not in opt_state and n not in stateless]
        if not missing:
            return opt_state
        self.discovery_runs += 1
        new_opt = self._pure_step(rec, "discover", seq, state, opt_state, grads_in, extras,
                                  input_vals)[2]
        for n in missing:
            st = new_opt.get(n)
            if st is None:
                if rec.minimize_calls:
                    stateless.add(n)
                continue
            zeros = tuple(torch.zeros_like(t) for t in st) if isinstance(st, tuple) \
                else torch.zeros_like(st)
            self._opt._dy_state[id(self._params[n])] = zeros
            opt_state[n] = zeros
        return opt_state

    # -- the card: live tensors, capture, replay ------------------------
    def _drop_records(self):
        for rec in self._cache.values():
            rec.release()
        self._cache.clear()

    def _sync_live(self):
        """Make the live tensors hold the current state: adopt each
        VarBase's tensor the first time, copy a value that eager code rebound
        since into the live tensor, and start over (no record survives)
        where a shape changed."""
        with torch.no_grad():
            for n, vb in (*self._params.items(), *self._buffers.items()):
                live, v = self._live.get(n), vb.value
                if live is None or not _same_layout(live, v):
                    if live is not None:
                        self._drop_records()
                    live = self._live[n] = v
                elif v is not live:
                    live.copy_(v)
                vb.value = live
            opt = self._opt
            if opt is None:
                return
            for n, vb in self._params.items():
                st, live = opt._dy_state.get(id(vb)), self._opt_live.get(n)
                if st is None:
                    continue
                if live is None or len(_slots(live)) != len(_slots(st)) or not all(
                        _same_layout(a, b) for a, b in zip(_slots(live), _slots(st))):
                    if live is not None:
                        self._drop_records()
                    live = self._opt_live[n] = st
                elif st is not live:
                    for dst, src in zip(_slots(live), _slots(st)):
                        dst.copy_(src)
                opt._dy_state[id(vb)] = live

    def _capture(self, rec, seq, state, opt_state, grads_in, step, lr, leaves):
        dev = self._device
        bufs = rec.bufs = {
            "leaves": [t.clone() for t in leaves],
            "pgrads": {n: g.clone() for n, g in grads_in["params"].items()},
            "igrads": [None if g is None else g.clone() for g in grads_in["inputs"]],
            "igrad_dirty": [False] * len(leaves),
            "lr": torch.tensor(lr, dtype=torch.float32, device=dev),
            "step": torch.tensor(step, dtype=torch.int32, device=dev),
        }
        g_in = {"params": bufs["pgrads"], "inputs": bufs["igrads"]}
        extras = {"lr": bufs["lr"], "step": bufs["step"]}
        # the trace, on a side stream, into outputs it drops: lazy library
        # state is made here, never inside the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = self._pure_step(rec, "trace", seq, state, opt_state, g_in, extras,
                                   bufs["leaves"])
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        bufs["keys"] = torch.zeros((max(len(rec.rng_slots), 1), 2), dtype=torch.int64,
                                   device=dev)
        extras["keys"] = bufs["keys"]
        # no autograd graph of an earlier run may live into the capture: its
        # AccumulateGrad nodes would make the capture stream wait on the
        # stream they were made on, which invalidates the capture
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                rec.result = self._pure_step(rec, "replay", seq, state, opt_state, g_in,
                                             extras, bufs["leaves"], copy_back=True)
        except UncapturableError:
            raise
        except RuntimeError as e:
            if "captur" not in str(e).lower():
                raise
            raise UncapturableError(
                f"{self._name}: the CUDA graph capture of the step failed — the "
                f"step does something a graph cannot hold (a host sync, a "
                f"host-to-device copy). Original error: {e}") from e
        rec.graph = graph

    def _replay(self, rec, seq, grads_in, step, lr, leaves):
        bufs = rec.bufs
        with torch.no_grad():
            for buf, t in zip(bufs["leaves"], leaves):
                if t is not buf:
                    buf.copy_(t)
            for n, g in grads_in["params"].items():
                bufs["pgrads"][n].copy_(g)
            for i, g in enumerate(grads_in["inputs"]):
                if g is None:
                    continue
                if g is self._zeros_cache.get((tuple(g.shape), g.dtype, g.device)):
                    if bufs["igrad_dirty"][i]:
                        bufs["igrads"][i].zero_()
                        bufs["igrad_dirty"][i] = False
                else:
                    bufs["igrads"][i].copy_(g)
                    bufs["igrad_dirty"][i] = True
            bufs["lr"].copy_(torch.tensor(lr, dtype=torch.float32))
            bufs["step"].copy_(torch.tensor(step, dtype=torch.int32))
            if rec.rng_slots:
                bufs["keys"].copy_(torch.tensor(
                    [self._call_key(seq, s, t) for s, t in rec.rng_slots], dtype=torch.int64))
        try:
            rec.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(
                f"{self._name}: the replay of the compiled step failed on the "
                "device; the live parameters and optimizer state may hold a "
                "partly written step. Rebuild or reload the model.") from e
        out_leaves, _, _, new_grads, new_input_grads = rec.result
        # copies: the next replay overwrites the pool tensors
        return ([t.clone() for t in out_leaves], None, None,
                {n: None if g is None else g.clone() for n, g in new_grads.items()},
                [None if g is None else g.clone() for g in new_input_grads])

    # -- call ------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if self._fallen_back:
            return self._fn(*args, **kwargs)
        try:
            flat = _flatten_args(args, kwargs)
        except UncapturableError as e:
            # a per-call argument problem, not a trace failure: this call
            # falls back or raises, the cached records stay
            profiler.bump_counter("dygraph_jit_fallback")
            self.fallbacks += 1
            if not self._fallback:
                raise
            warnings.warn(
                f"{self._name}: running THIS call eagerly — the "
                f"arguments cannot key the compiled-step cache: {e}",
                stacklevel=2,
            )
            return self._fn(*args, **kwargs)
        try:
            return self._compiled_call(flat)
        except _TRACE_ERRORS as e:
            profiler.bump_counter("dygraph_jit_fallback")
            self.fallbacks += 1
            if not self._fallback:
                raise UncapturableError(
                    f"{self._name}: dygraph trace capture failed — the "
                    "function performs a Python side effect jit cannot "
                    "record (host .numpy()/.gradient() read or data-"
                    "dependent control flow). Remove the side effect or "
                    "construct the bridge with fallback=True to run "
                    f"eagerly. Original error: {type(e).__name__}: {e}"
                ) from e
            self._fallen_back = True
            self._drop_records()
            warnings.warn(
                f"{self._name}: falling back to EAGER dygraph execution "
                f"(one dispatch per op) — trace capture failed with "
                f"{type(e).__name__}: {e}. The compiled fast path is "
                "disabled for this function.",
                stacklevel=2,
            )
            return self._fn(*args, **kwargs)

    def _compiled_call(self, flat):
        self._resolve_state()
        # closure tensors are threaded by object: a cell rebound to a new
        # VarBase would keep serving the old tensor
        if [id(v) for v in _closure_varbases(self._fn)] != self._closure_ids:
            raise UncapturableError(
                f"{self._name}: a closure-captured tensor changed "
                "identity after the first compiled call — update it in "
                "place with set_value(...), or build a fresh "
                "to_compiled wrapper."
            )
        leaves, template, arg_sig, var_leaf_map = flat
        # param grads enter with their presence (None stays None: eager
        # minimize skips grad-less params), which joins the key; input
        # grads only accumulate, so zeros stand for None there
        grads_in = {"params": {n: vb.grad for n, vb in self._params.items()
                               if vb.grad is not None},
                    "inputs": [None] * len(leaves)}
        for idx, vb in var_leaf_map.items():
            if not vb.stop_gradient:
                grads_in["inputs"][idx] = (vb.grad if vb.grad is not None
                                           else self._zeros(vb.value))
        grad_presence = tuple(n in grads_in["params"] for n in self._params)
        # the current mesh keys the cache too: flipping the global mesh
        # between calls records the step again instead of replaying a stale one
        from ..parallel.mesh import current_mesh, mesh_signature

        sig = (arg_sig, self._training_sig(), grad_presence, _ag.is_tracing(),
               mesh_signature(current_mesh()))
        opt = self._opt
        lr_sched = None
        step, lr = 0, 0.0
        if opt is not None:
            step = int(opt._dy_step)
            # a LearningRateDecay advances on __call__: read it without
            # advancing; the writeback advances it by the step's minimize
            # count
            lr_obj = opt._learning_rate
            if isinstance(lr_obj, LearningRateDecay):
                lr_sched = lr_obj
                lr = float(lr_obj.step())
            else:
                lr = opt._dygraph_lr()
        self._ncalls += 1
        seq = self._ncalls & 0xFFFFFFFF
        cuda = self._device.type == "cuda"
        if cuda:
            self._sync_live()

        def current_state():
            src = self._live if cuda else None
            return {"params": {n: src[n] if cuda else vb.value
                               for n, vb in self._params.items()},
                    "buffers": {n: src[n] if cuda else vb.value
                                for n, vb in self._buffers.items()}}

        def current_opt_state():
            if opt is None:
                return {}
            return {n: (self._opt_live[n] if cuda else opt._dy_state[id(vb)])
                    for n, vb in self._params.items() if id(vb) in opt._dy_state}

        def host_extras():
            return {"step": torch.tensor(step, dtype=torch.int32, device=self._device),
                    "lr": torch.tensor(lr, dtype=torch.float32, device=self._device)}

        state, opt_state = current_state(), current_opt_state()
        rec = self._cache.get(sig)
        if rec is None:
            profiler.bump_counter("dygraph_jit_cache_miss")
            self.cache_misses += 1
            rec = _Record(template)
            opt_state = self._ensure_opt_state(rec, grad_presence, seq, state, opt_state,
                                               grads_in, host_extras(), leaves)
            if cuda:
                self._sync_live()
                state, opt_state = current_state(), current_opt_state()
                self._capture(rec, seq, state, opt_state, grads_in, step, lr, leaves)
                result = self._replay(rec, seq, grads_in, step, lr, leaves)
            else:
                result = self._pure_step(rec, "trace", seq, state, opt_state, grads_in,
                                         host_extras(), leaves)
            self._cache[sig] = rec
            while len(self._cache) > self._cache_cap:
                # LRU eviction: the evicted signature compiles again on its
                # next call, and its graph and pool are freed now
                self._cache.popitem(last=False)[1].release()
                self.cache_evictions += 1
                profiler.bump_counter("dygraph_jit_cache_evictions")
        else:
            profiler.bump_counter("dygraph_jit_cache_hit")
            self.cache_hits += 1
            self._cache.move_to_end(sig)
            if cuda:
                result = self._replay(rec, seq, grads_in, step, lr, leaves)
            else:
                result = self._pure_step(rec, "replay", seq, state, opt_state, grads_in,
                                         host_extras(), leaves)

        out_leaves, new_state, new_opt, new_grads, new_input_grads = result
        for n, vb in self._params.items():
            if not cuda:  # on the card the graph wrote the live tensors
                vb.value = new_state["params"][n]
            # a grad the step never wrote keeps its eager state: `.grad is
            # None` after a forward-only step
            if rec.grad_touched.get(n, True):
                vb.grad = new_grads[n]
        for n, vb in self._buffers.items():
            if not cuda:
                vb.value = new_state["buffers"][n]
        if opt is not None:
            if cuda:
                for n in rec.opt_popped:
                    opt._dy_state.pop(id(self._params[n]), None)
                    self._opt_live.pop(n, None)
            else:
                for n, st in new_opt.items():
                    vb = self._params[n]
                    if st is None:
                        opt._dy_state.pop(id(vb), None)
                    else:
                        opt._dy_state[id(vb)] = st
            opt._dy_step += rec.minimize_calls
            if lr_sched is not None:
                lr_sched.step_num += rec.minimize_calls * lr_sched.step_size
        for i, vb in var_leaf_map.items():
            if rec.input_grad_touched[i]:
                vb.grad = new_input_grads[i]
        # the supervised trainer's heartbeat: a compiled dygraph loop is a
        # dispatch path too, or the watchdog reads a healthy job as hung;
        # tick only (no CheckpointManager counts dygraph steps)
        from ..executor import _trainer_heartbeat
        from ..resilience.faults import fault_point

        self._dispatch_count = getattr(self, "_dispatch_count", 0) + 1
        fault_point("trainer.step")
        _trainer_heartbeat(None, self._dispatch_count)
        return _rebuild_out(rec.out_template, out_leaves)

    # -- introspection ---------------------------------------------------
    def cache_info(self):
        return {
            "entries": len(self._cache),
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "fallbacks": self.fallbacks,
            "fallen_back": self._fallen_back,
            "evictions": self.cache_evictions,
            "cap": self._cache_cap,
        }


def to_compiled(fn_or_layer=None, *, layer=None, optimizer=None,
                fallback=True, donate=True, rng_seed=0):
    """Compile a dygraph callable into cached one-launch steps.

        compiled = to_compiled(model)              # a Layer directly

        @to_compiled                               # bare decorator:
        def train_step(x, y): ...                  # layers / optimizer
                                                   # found in the closure

        @to_compiled(layer=model, optimizer=opt)   # explicit
        def train_step(x, y): ...

    The wrapped callable takes VarBase / tensor / array arguments, runs the
    compiled step, leaves the new parameters, buffers, grads and optimizer
    accumulators on the live eager objects, and returns detached VarBase
    outputs. `fallback=True` (the default) drops to eager with a one-time
    warning when capture fails; `fallback=False` raises
    `UncapturableError`. On the card the step writes the new state into the
    layers' and the optimizer's own tensors (the donation; `donate=False`
    raises)."""
    def build(fn, layers, opt):
        # closure discovery merges with the explicit arguments: layer=model
        # must not drop a closure optimizer (or a second closure layer)
        closure_layers, closure_opt = _discover(fn)
        layers = list(layers)
        for lay in closure_layers:
            if all(lay is not m for m in layers):
                layers.append(lay)
        opt = opt or closure_opt
        if not layers:
            raise ValueError(
                "to_compiled could not find any dygraph Layer: pass "
                "layer= (or decorate a function that closes over the "
                "model)"
            )
        return CompiledFunction(fn, layers=tuple(layers), optimizer=opt,
                                fallback=fallback, donate=donate, rng_seed=rng_seed)

    if isinstance(fn_or_layer, Layer):
        lay = fn_or_layer
        return build(lambda *a, **k: lay(*a, **k), (lay,), optimizer)
    if callable(fn_or_layer):
        lays = (layer,) if layer is not None else ()
        return build(fn_or_layer, lays, optimizer)
    if fn_or_layer is not None:
        raise TypeError(
            f"to_compiled: expected a Layer or callable, got "
            f"{type(fn_or_layer).__name__}"
        )

    def deco(fn):
        lays = (layer,) if layer is not None else ()
        return build(fn, lays, optimizer)

    return deco


class TracedLayer:
    """reference: dygraph/jit.py TracedLayer — trace a dygraph Layer once
    with example inputs, then serve the cached step for every later call
    with the same input signature.

        out, traced = TracedLayer.trace(layer, inputs=[x])
        out2 = traced([x2])     # one graph replay on the card

    Unlike `to_compiled`, trace() is strict by default: uncapturable
    Python inside forward raises."""

    def __init__(self, engine):
        self._engine = engine

    @staticmethod
    def trace(layer, inputs, fallback=False):
        if not isinstance(layer, Layer):
            raise TypeError(
                f"TracedLayer.trace expects a dygraph Layer, got "
                f"{type(layer).__name__}"
            )
        engine = CompiledFunction(
            lambda *xs: layer(*xs), layers=(layer,), optimizer=None,
            fallback=fallback, name=f"TracedLayer[{layer.full_name()}]",
        )
        outs = engine(*inputs)
        return outs, TracedLayer(engine)

    def __call__(self, inputs):
        if isinstance(inputs, (list, tuple)):
            return self._engine(*inputs)
        return self._engine(inputs)

    def cache_info(self):
        return self._engine.cache_info()

    def set_strategy(self, build_strategy=None, exec_strategy=None):
        """Kept for the reference API: a BuildStrategy or
        ExecutionStrategy changes nothing in a CUDA graph replay."""
        del build_strategy, exec_strategy

    def save_inference_model(self, dirname, feed=None, fetch=None):
        raise NotImplementedError(
            "TracedLayer.save_inference_model: export the layer with "
            "dygraph.save_dygraph and rebuild a static Program for "
            "inference/ (the AnalysisPredictor path) — the traced "
            "step itself is a process-local CUDA graph"
        )
