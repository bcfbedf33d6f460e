"""Optimizers: `minimize` = append_backward + per-parameter optimizer ops
tagged with the Optimize role, as `paddle_tpu/optimizer.py` builds them:
the same learning-rate var, accumulator names and startup fill ops, so
both packages hold the same persistables under the same names.

Ported so far, in static-graph mode: SGD, Momentum, Adam, AdamW and Lamb,
with weight decay (`regularization=`, or a ParamAttr's `regularizer`,
regularizer.py) and gradient clipping (`grad_clip=`, or the program-wide
`clip.set_gradient_clip`); and RecomputeOptimizer around any of them.

In dygraph mode (inside `dygraph.guard()`, paddle_tpu/optimizer.py:
180-297 there) an optimizer built with `parameter_list=` updates each
parameter that holds a grad from `.grad`, out of place on `.value`, with
the update rules of SGD, Momentum and Adam (AdamW and Lamb inherit
Adam's, as they do in the JAX package), so the dygraph JIT bridge can
thread the new values and accumulators through a compiled step."""

from __future__ import annotations

from .backward import append_backward
from .clip import get_gradient_clip
from .framework import (
    Variable,
    core_op_role,
    default_main_program,
    default_startup_program,
    unique_name,
)
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "Adam", "AdamOptimizer", "AdamW", "Lamb", "LambOptimizer",
           "RecomputeOptimizer"]


class Optimizer:
    type = "optimizer"

    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None, parameter_list=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators = {}
        self._lr_var_cache = None
        # dygraph mode (reference: dygraph optimizers take parameter_list)
        self._parameter_list = parameter_list
        self._dy_state: dict = {}
        self._dy_step = 0

    def _create_lr_var(self, block):
        """One [1] float32 lr var per (optimizer, program), filled by a
        LRSched-role fill_constant in the main program."""
        if isinstance(self._learning_rate, Variable):
            return self._learning_rate
        if self._lr_var_cache is not None and self._lr_var_cache[0] is block.program:
            return self._lr_var_cache[1]
        helper = LayerHelper(self.type + "_lr")
        lr = helper.create_global_variable(
            shape=[1], dtype="float32", persistable=False,
            name=unique_name.generate("learning_rate"))
        block.append_op("fill_constant", {}, {"Out": [lr.name]}, {
            "shape": [1],
            "value": float(self._learning_rate),
            "dtype": "float32",
            "op_role": core_op_role.LRSched,
        })
        self._lr_var_cache = (block.program, lr)
        return lr

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype="float32"):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(self.type)
        shape = list(shape if shape is not None else param.shape)
        var_name = unique_name.generate(f"{param.name}_{name}")
        acc = helper.create_or_get_global_variable(var_name, shape, dtype)
        default_startup_program().global_block().append_op(
            "fill_constant", {}, {"Out": [var_name]},
            {"shape": shape, "value": float(fill_value), "dtype": dtype})
        default_startup_program().bump_version()
        self._accumulators[key] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    def accumulator_names(self):
        """The names of every accumulator var this optimizer appended
        (moments, velocities, beta_pow counters), sorted. They are
        persistables, so a CheckpointManager snapshot carries them with
        the parameters."""
        return sorted(v.name for v in self._accumulators.values())

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad, lr):
        raise NotImplementedError

    def _op(self, block, type, inputs, outputs, attrs=None):
        attrs = dict(attrs or {})
        attrs["op_role"] = core_op_role.Optimize
        return block.append_op(type, inputs, outputs, attrs)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        """Weight decay, then clipping (this optimizer's, else the one
        `set_gradient_clip` set), then one update op per parameter, in the
        JAX package's order (optimizer.py:150-166 there)."""
        program = default_main_program()
        block = program.global_block()
        if self.regularization is not None or any(
                p.regularizer is not None for p, _ in params_grads):
            params_grads = append_regularization_ops(params_grads, self.regularization)
        clip = self._grad_clip if self._grad_clip is not None else get_gradient_clip()
        if clip is not None:
            params_grads = clip(params_grads)
        lr = self._create_lr_var(block)
        self._create_accumulators(block, [p for p, _ in params_grads])
        for pg in params_grads:
            self._append_optimize_op(block, pg, lr)
        program.bump_version()
        return params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import dygraph

        if dygraph.enabled():
            return self._minimize_dygraph(loss, parameter_list)
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads

    # -- dygraph (eager) path -------------------------------------------
    def _dygraph_lr(self):
        lr = self._learning_rate
        return float(lr() if callable(lr) else lr)

    def _minimize_dygraph(self, loss, parameter_list=None):
        """Update each parameter that holds a grad set by loss.backward()
        (reference: dygraph optimizer.minimize applying per-param optimizer
        kernels)."""
        import torch

        from .dygraph.autograd import UncapturableError, in_functional_trace

        if in_functional_trace() and not getattr(self, "_jit_bound", False):
            # only the optimizer the JIT bridge bound has its step, lr and
            # accumulators threaded through the compiled step
            raise UncapturableError(
                f"{type(self).__name__}.minimize() inside a traced "
                "dygraph function, but this optimizer is not the one "
                "bound to the compiled step — its state cannot be "
                "captured. Pass it via to_compiled(optimizer=...) (one "
                "optimizer per compiled step) or split the step into "
                "one compiled function per optimizer."
            )
        params = parameter_list or self._parameter_list
        if params is None:
            raise ValueError(
                "dygraph minimize needs parameter_list (pass it to the "
                "optimizer constructor, reference dygraph behavior)"
            )
        self._dy_step += 1
        lr = self._dygraph_lr()
        updated = []
        with torch.no_grad():
            for p in params:
                if p.grad is None or p.stop_gradient:
                    continue
                self._dygraph_apply(p, p.grad, lr)
                updated.append(p)
        return None, [(p, p.grad) for p in updated]

    def _dygraph_apply(self, param, grad, lr):
        raise NotImplementedError(f"{type(self).__name__} has no dygraph update rule yet")

    def clear_gradients(self):
        for p in self._parameter_list or []:
            p.clear_gradient()

    def state_dict(self):
        """The dygraph state by name (the .pdopt side of a checkpoint):
        '<param name or @p<i>>#<slot>' per accumulator, '@step' the step
        count; keys and values as the JAX package writes them."""
        import numpy as np

        out = {"@step": np.asarray(self._dy_step, np.int64)}
        for pi, p in enumerate(self._parameter_list or []):
            st = self._dy_state.get(id(p))
            if st is None:
                continue
            key = p.name if p.name else f"@p{pi}"
            for i, v in enumerate(st if isinstance(st, tuple) else (st,)):
                out[f"{key}#{i}"] = v.detach().cpu().numpy()
        return out

    def set_state_dict(self, state, parameter_list=None):
        """Inverse of state_dict(): slots rebound to this instance's
        parameters by name, on each parameter's device; parameters absent
        from `state` keep fresh slots."""
        import numpy as np
        import torch

        params = parameter_list or self._parameter_list
        if params is None:
            raise ValueError(
                "set_state_dict needs parameter_list (pass it to the "
                "optimizer constructor, reference dygraph behavior)"
            )
        state = dict(state)
        step = state.pop("@step", None)
        if step is not None:
            self._dy_step = int(np.asarray(step).reshape(-1)[0])
        by_param: dict = {}
        for key, v in state.items():
            name, _, idx = key.rpartition("#")
            by_param.setdefault(name, {})[int(idx)] = v
        for pi, p in enumerate(params):
            slots = by_param.get(p.name if p.name else f"@p{pi}")
            if slots is None:
                continue
            vals = tuple(torch.as_tensor(np.asarray(slots[i]), device=p.value.device)
                         for i in sorted(slots))
            self._dy_state[id(p)] = vals[0] if len(vals) == 1 else vals


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _dygraph_apply(self, param, grad, lr):
        param.value = param.value - lr * grad

    def _append_optimize_op(self, block, pg, lr):
        p, g = pg
        self._op(block, "sgd", {"Param": [p], "Grad": [g], "LearningRate": [lr]},
                 {"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _dygraph_apply(self, param, grad, lr):
        import torch

        v = self._dy_state.get(id(param))
        if v is None:
            v = torch.zeros_like(param.value)
        v = self._momentum * v + grad
        if self._use_nesterov:
            param.value = param.value - (grad + self._momentum * v) * lr
        else:
            param.value = param.value - lr * v
        self._dy_state[id(param)] = v

    def _append_optimize_op(self, block, pg, lr):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        self._op(block, "momentum",
                 {"Param": [p], "Grad": [g], "Velocity": [v], "LearningRate": [lr]},
                 {"ParamOut": [p], "VelocityOut": [v]},
                 {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, self._beta1, shape=[1])
            self._add_accumulator("beta2_pow_acc", p, self._beta2, shape=[1])

    def _adam_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon}

    def _dygraph_apply(self, param, grad, lr):
        import torch

        st = self._dy_state.get(id(param))
        if st is None:
            st = (torch.zeros_like(param.value), torch.zeros_like(param.value))
        m1, m2 = st
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1 = b1 * m1 + (1 - b1) * grad
        m2 = b2 * m2 + (1 - b2) * grad * grad
        t = self._dy_step  # a device scalar inside a compiled step
        lr_t = lr * (1 - b2**t) ** 0.5 / (1 - b1**t)
        param.value = param.value - lr_t * m1 / (torch.sqrt(m2) + eps)
        self._dy_state[id(param)] = (m1, m2)

    def _append_optimize_op(self, block, pg, lr):
        p, g = pg
        acc = {n: self._get_accumulator(n, p)
               for n in ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc")}
        self._op(
            block, self.type,
            {"Param": [p], "Grad": [g], "Moment1": [acc["moment1"]],
             "Moment2": [acc["moment2"]], "Beta1Pow": [acc["beta1_pow_acc"]],
             "Beta2Pow": [acc["beta2_pow_acc"]], "LearningRate": [lr]},
            {"ParamOut": [p], "Moment1Out": [acc["moment1"]],
             "Moment2Out": [acc["moment2"]], "Beta1PowOut": [acc["beta1_pow_acc"]],
             "Beta2PowOut": [acc["beta2_pow_acc"]]},
            self._adam_attrs(),
        )


class AdamW(AdamOptimizer):
    """Adam with decoupled weight decay `weight_decay` (the `adamw` op's
    coeff); Adam's accumulators."""

    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _adam_attrs(self):
        return {**super()._adam_attrs(), "coeff": self._coeff}


class LambOptimizer(AdamOptimizer):
    """Lamb: Adam's moments with a layer-wise trust ratio and weight decay
    `lamb_weight_decay` inside the update; Adam's accumulators."""

    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _adam_attrs(self):
        return {**super()._adam_attrs(), "weight_decay": self._weight_decay}


class RecomputeOptimizer:
    """Activation recomputation (`paddle_tpu/optimizer.py:935-958`).
    Segments are declared when the model is built, with
    `recompute_scope(i)`; `minimize` delegates to the inner optimizer and
    names the loss on the program, and the Executor then takes the grads
    by autograd over the forward ops alone, each segment in
    torch.utils.checkpoint (executor.py `_run_recompute`)."""

    def __init__(self, inner_optimizer):
        self.inner_optimizer = inner_optimizer

    def _set_checkpoints(self, checkpoints):
        # the reference API's cut points by variable name; the segments
        # here come from recompute_scope's tags
        self._checkpoints = checkpoints

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self.inner_optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        loss.block.program._recompute_loss = loss.name
        return result


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Lamb = LambOptimizer
