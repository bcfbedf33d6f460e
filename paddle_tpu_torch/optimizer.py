"""Optimizers: `minimize` = append_backward + per-parameter optimizer ops
tagged with the Optimize role, as `paddle_tpu/optimizer.py` builds them:
the same learning-rate var, accumulator names and startup fill ops, so
both packages hold the same persistables under the same names.

Ported so far: SGD, Momentum and Adam in static-graph mode. Regularization and
gradient clipping come with a later slice and raise here."""

from __future__ import annotations

from .backward import append_backward
from .framework import (
    Variable,
    core_op_role,
    default_main_program,
    default_startup_program,
    unique_name,
)
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "Adam", "AdamOptimizer"]


class Optimizer:
    type = "optimizer"

    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None, parameter_list=None):
        if regularization is not None or grad_clip is not None:
            raise NotImplementedError(
                "regularization and gradient clipping (regularizer.py, clip.py) "
                "come with a later slice of the port")
        if parameter_list is not None:
            raise NotImplementedError("dygraph optimizers are not ported yet")
        self._learning_rate = learning_rate
        self._name = name
        self._accumulators = {}
        self._lr_var_cache = None

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
        program = default_main_program()
        block = program.global_block()
        if any(getattr(p, "regularizer", None) is not None for p, _ in params_grads):
            raise NotImplementedError(
                "parameter regularizers come with a later slice of the port")
        lr = self._create_lr_var(block)
        self._create_accumulators(block, [p for p, _ in params_grads])
        for pg in params_grads:
            self._append_optimize_op(block, pg, lr)
        program.bump_version()
        return params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

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

    def _append_optimize_op(self, block, pg, lr):
        p, g = pg
        acc = {n: self._get_accumulator(n, p)
               for n in ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc")}
        self._op(
            block, "adam",
            {"Param": [p], "Grad": [g], "Moment1": [acc["moment1"]],
             "Moment2": [acc["moment2"]], "Beta1Pow": [acc["beta1_pow_acc"]],
             "Beta2Pow": [acc["beta2_pow_acc"]], "LearningRate": [lr]},
            {"ParamOut": [p], "Moment1Out": [acc["moment1"]],
             "Moment2Out": [acc["moment2"]], "Beta1PowOut": [acc["beta1_pow_acc"]],
             "Beta2PowOut": [acc["beta2_pow_acc"]]},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
