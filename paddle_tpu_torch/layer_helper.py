"""LayerHelper: shared plumbing for layers — creates parameters in the
startup and main programs, temporaries, bias and activation ops."""

from __future__ import annotations

from .framework import default_main_program, default_startup_program, unique_name
from .initializer import Constant, Xavier
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.prefix = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(
        self,
        attr,
        shape,
        dtype="float32",
        is_bias=False,
        default_initializer=None,
    ):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias else Xavier()
        initializer = attr.initializer or default_initializer
        name = attr.name or unique_name.generate(f"{self.prefix}.w")
        param = self.block.create_parameter(
            name, shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer)
        # mirrored in the startup program, with the op that fills it
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(
            name, shape, dtype=dtype, trainable=attr.trainable)
        initializer(sp, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype, shape=None, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(f"{self.prefix}.tmp"),
            dtype=dtype,
            shape=shape,
            stop_gradient=stop_gradient,
        )

    def create_global_variable(self, shape, dtype, persistable=False, name=None,
                               stop_gradient=True):
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(f"{self.prefix}.global"),
            shape=shape,
            dtype=dtype,
            persistable=persistable,
            stop_gradient=stop_gradient,
        )

    def create_or_get_global_variable(self, name, shape, dtype, initializer=None):
        """Persistable non-parameter state (optimizer accumulators, batch
        norm running stats), declared in both the main and the startup
        program; `initializer` appends its fill op to the startup program."""
        gb = self.main_program.global_block()
        if name in gb.vars:
            return gb.vars[name]
        v = gb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                          stop_gradient=True)
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                           stop_gradient=True)
        if initializer is not None:
            initializer(sv, sb)
            self.startup_program.bump_version()
        return v

    def append_op(self, **kwargs):
        op = self.block.append_op(
            kwargs["type"],
            kwargs.get("inputs"),
            kwargs.get("outputs"),
            kwargs.get("attrs"),
        )
        self.main_program.bump_version()
        return op

    def append_activation(self, input_var, act=None):
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return input_var
        act = {"type": act} if isinstance(act, str) else dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype, input_var.shape)
        self.append_op(
            type=act_type, inputs={"X": [input_var]}, outputs={"Out": [out]}, attrs=act
        )
        return out

    def append_bias_op(self, input_var, bias_attr, size, dim_start=1):
        attr = ParamAttr._to_attr(bias_attr)
        if attr is False:
            return input_var
        b = self.create_parameter(attr, [size], dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype, input_var.shape)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [out]},
            attrs={"axis": dim_start},
        )
        return out
