"""Weight decay (paddle_tpu/regularizer.py): each regularizer appends the
decay term's ops for one parameter, and `append_regularization_ops`
adds it to the parameter's grad with a `sum` op, with the same op types,
var names and Backward role as the JAX package."""

from __future__ import annotations

from .framework import core_op_role, unique_name

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class _Regularizer:
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _scaled(self, src, param, block, suffix):
        out = block.create_var(name=unique_name.generate(param.name + suffix),
                               shape=param.shape, dtype=param.dtype)
        block.append_op("scale", {"X": [src]}, {"Out": [out.name]},
                        {"scale": self._coeff, "op_role": core_op_role.Backward})
        return out


class L2DecayRegularizer(_Regularizer):
    """decay = coeff * param."""

    def append(self, param, grad, block):
        return self._scaled(param.name, param, block, "_l2decay")


class L1DecayRegularizer(_Regularizer):
    """decay = coeff * sign(param)."""

    def append(self, param, grad, block):
        signv = block.create_var(name=unique_name.generate(param.name + "_sign"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("sign", {"X": [param.name]}, {"Out": [signv.name]},
                        {"op_role": core_op_role.Backward})
        return self._scaled(signv.name, param, block, "_l1decay")


def append_regularization_ops(params_grads, global_regularizer=None):
    """grad + decay for each parameter with a regularizer: its
    ParamAttr's first, else the optimizer's `global_regularizer`."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer or global_regularizer
        if reg is None or grad is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = reg.append(param, grad, block)
        new_grad = block.create_var(name=unique_name.generate(grad.name + "_regularized"),
                                    shape=grad.shape, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad.name, decay.name]}, {"Out": [new_grad.name]},
                        {"op_role": core_op_role.Backward})
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
