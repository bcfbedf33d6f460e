"""Gradient clipping (paddle_tpu/clip.py): each clip maps [(param, grad)]
to [(param, clipped grad)] by appending Backward-role ops, with the same
op types, var names and order as the JAX package. `set_gradient_clip`
sets the clip that optimizers without a `grad_clip` of their own use."""

from __future__ import annotations

from .framework import core_op_role, unique_name

__all__ = [
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "ErrorClipByValue",
    "set_gradient_clip",
    "get_gradient_clip",
]

_gradient_clip = None
_ROLE = {"op_role": core_op_role.Backward}


def set_gradient_clip(clip, param_list=None, program=None):
    global _gradient_clip
    _gradient_clip = clip


def get_gradient_clip():
    return _gradient_clip


def _new_grad(g, suffix):
    return g.block.create_var(name=unique_name.generate(g.name + suffix), shape=g.shape,
                              dtype=g.dtype)


class _ClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class _PerGradClip(_ClipBase):
    """One op per grad: `_op` -> (type, attrs)."""

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            ng = _new_grad(g, "_clipped")
            op_type, attrs = self._op()
            g.block.append_op(op_type, {"X": [g.name]}, {"Out": [ng.name]},
                              {**attrs, **_ROLE})
            out.append((p, ng))
        return out


class GradientClipByValue(_PerGradClip):
    """Each grad element clipped to [min, max]; min defaults to -max."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _op(self):
        return "clip", {"min": self.min, "max": self.max}


class GradientClipByNorm(_PerGradClip):
    """Each grad scaled to L2 norm clip_norm where its norm is larger."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _op(self):
        return "clip_by_norm", {"max_norm": self.clip_norm}


class GradientClipByGlobalNorm(_ClipBase):
    """Every grad times clip_norm / max(global_norm, clip_norm), the
    global norm over all grads together (clip.py:233 of the reference)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        live = [(p, g) for p, g in params_grads if g is not None]
        if not live:
            return params_grads
        block = live[0][1].block

        def scalar(name):
            return block.create_var(name=unique_name.generate(name), shape=(1,),
                                    dtype="float32")

        sq_names = []
        for _, g in live:
            sq = scalar(g.name + "_sq")
            block.append_op("squared_l2_norm", {"X": [g.name]}, {"Out": [sq.name]}, _ROLE)
            sq_names.append(sq.name)
        total = scalar("global_norm_sq")
        block.append_op("sum", {"X": sq_names}, {"Out": [total.name]}, _ROLE)
        gnorm = scalar("global_norm")
        block.append_op("sqrt", {"X": [total.name]}, {"Out": [gnorm.name]}, _ROLE)
        clipv = scalar("clip_norm_const")
        block.append_op("fill_constant", {}, {"Out": [clipv.name]},
                        {"shape": [1], "value": self.clip_norm, "dtype": "float32", **_ROLE})
        denom = scalar("clip_denom")
        block.append_op("elementwise_max", {"X": [gnorm.name], "Y": [clipv.name]},
                        {"Out": [denom.name]}, _ROLE)
        scale_v = scalar("clip_scale")
        block.append_op("elementwise_div", {"X": [clipv.name], "Y": [denom.name]},
                        {"Out": [scale_v.name]}, _ROLE)
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            ng = _new_grad(g, "_gclipped")
            block.append_op("elementwise_mul", {"X": [g.name], "Y": [scale_v.name]},
                            {"Out": [ng.name]}, {"axis": -1, **_ROLE})
            out.append((p, ng))
        return out


ErrorClipByValue = GradientClipByValue
