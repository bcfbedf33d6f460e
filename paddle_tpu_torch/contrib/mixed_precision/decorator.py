"""Automatic mixed precision: `decorate`, `AutoMixedPrecisionLists` and
loss scaling (paddle_tpu/contrib/mixed_precision/decorator.py).

As in the JAX package, the policy rides the lowering instead of rewriting
the program with cast ops: `minimize` tags the program with its AMP dtype,
and the product ops (conv2d, mul, matmul, fused_multihead_attention, the
gathered rows of lookup_table) cast their float inputs to it at lowering
(`LoweringContext.amp_cast`). Master weights stay float32; softmax, the
normalisations and the losses compute in float32 inside.

bf16 keeps float32's exponent range and needs no loss scaling, so it is
off by default there. fp16 does need it: with `amp_dtype="float16"` (or
`use_dynamic_loss_scaling=True`) the loss is multiplied by the scale
before the backward, one `check_finite_and_unscale` op divides every grad
by it (zeros on an overflow step, so the update is a no-op), and under
dynamic scaling an `update_loss_scaling` op grows or shrinks the scale
over windows of good and bad steps. The scale and FoundInfinite stay on
the device. bf16 and fp16 AMP both run on the card: the attention and
LayerNorm-backward kernels (#1-#8) take float32, bf16 and fp16. Only the
fused-block kernels (#9-#10), which no AMP path calls, take no fp16 and
raise TypeError for it."""

from __future__ import annotations

from ... import layers
from ...framework import unique_name

__all__ = ["decorate", "AutoMixedPrecisionLists"]


class AutoMixedPrecisionLists:
    """Custom white and black lists of op types: black-listed ops compute
    in fp32; white-listed ops get every float32 input cast to the AMP
    dtype."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(custom_white_list or ())
        self.black_list = set(custom_black_list or ())
        both = self.white_list & self.black_list
        if both:
            raise ValueError(f"op types in BOTH custom lists: {sorted(both)}")


def append_finite_gate(params_grads, scaling):
    """One `check_finite_and_unscale` over every grad: the grads divided
    by `scaling`, zeros when any grad is not finite, and the bool
    `found_infinite` var to fetch -> ([(param, gated grad)], found_inf)."""
    grads = [g for _, g in params_grads]
    block = grads[0].block
    gated = [block.create_var(name=unique_name.generate(g.name + "@UNSCALED"),
                              shape=g.shape, dtype=g.dtype, persistable=False)
             for g in grads]
    found_inf = block.create_var(name=unique_name.generate("found_infinite"), shape=[1],
                                 dtype="bool", persistable=False)
    block.append_op(
        "check_finite_and_unscale",
        {"X": [g.name for g in grads], "Scale": [scaling.name]},
        {"Out": [u.name for u in gated], "FoundInfinite": [found_inf.name]},
        {},
    )
    block.program.bump_version()
    return [(p, u) for (p, _), u in zip(params_grads, gated)], found_inf


class OptimizerWithMixedPrecision:
    """Wraps an optimizer. Without loss scaling `minimize` tags the loss's
    program and runs the wrapped `minimize`; with it, `backward` scales
    the loss and `apply_gradients` unscales the grads before the update."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
                 amp_dtype="bfloat16", incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = bool(use_dynamic_loss_scaling)
        self._amp_dtype = amp_dtype
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._loss_scaling_var = None
        self._found_inf_var = None

    def get_loss_scaling(self):
        """The loss-scaling Variable when the loss is scaled (fetch it to
        watch the scale), else the static float."""
        return self._loss_scaling_var or self._init_loss_scaling

    def _activate(self, program):
        program._amp_dtype = self._amp_dtype
        program._amp_black_list = set(self._amp_lists.black_list)
        program._amp_white_list = set(self._amp_lists.white_list)
        program.bump_version()

    def _needs_scaling(self):
        return self._use_dynamic or (
            self._amp_dtype == "float16" and self._init_loss_scaling != 1.0)

    def _ensure_scaling_var(self):
        if self._loss_scaling_var is None:
            self._loss_scaling_var = layers.create_global_var(
                [1], self._init_loss_scaling, "float32", persistable=True,
                name=unique_name.generate("loss_scaling"))
        return self._loss_scaling_var

    def backward(self, loss, **kw):
        """[(param, grad)] of the loss times the scale when it is scaled:
        pass them to this wrapper's `apply_gradients`, which unscales."""
        self._activate(loss.block.program)
        if self._needs_scaling():
            loss = layers.elementwise_mul(loss, self._ensure_scaling_var())
        return self._optimizer.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        if self._needs_scaling():
            params_grads = self._append_unscale_ops(params_grads)
        return self._optimizer.apply_gradients(params_grads)

    def _append_unscale_ops(self, params_grads):
        """check_finite_and_unscale, and under dynamic scaling the
        update_loss_scaling op with its two step counters."""
        block = params_grads[0][1].block
        scaling = self._ensure_scaling_var()
        gated, found_inf = append_finite_gate(params_grads, scaling)
        self._found_inf_var = found_inf
        if self._use_dynamic:
            good, bad = (layers.create_global_var([1], 0, "int32", persistable=True,
                                                  name=unique_name.generate(name))
                         for name in ("num_good_steps", "num_bad_steps"))
            block.append_op(
                "update_loss_scaling",
                {"FoundInfinite": [found_inf.name], "PrevLossScaling": [scaling.name],
                 "InGoodSteps": [good.name], "InBadSteps": [bad.name]},
                {"LossScalingOut": [scaling.name], "OutGoodSteps": [good.name],
                 "OutBadSteps": [bad.name]},
                {"incr_every_n_steps": self._incr_every_n_steps,
                 "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                 "incr_ratio": self._incr_ratio, "decr_ratio": self._decr_ratio},
            )
        block.program.bump_version()
        return gated

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        if not self._needs_scaling():
            self._activate(loss.block.program)
            return self._optimizer.minimize(loss, startup_program, parameter_list,
                                            no_grad_set)
        params_grads = self.backward(loss, startup_program=startup_program,
                                     parameter_list=parameter_list, no_grad_set=no_grad_set)
        params_grads = self._append_unscale_ops(params_grads)
        self._optimizer.apply_gradients(params_grads)
        return [], params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0**15, incr_every_n_steps=1000,
             decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=None, amp_dtype="bfloat16"):
    """The optimizer under AMP in `amp_dtype` ("bfloat16" or "float16").
    Dynamic loss scaling defaults on for fp16 and off for bf16; fp16 with
    `use_dynamic_loss_scaling=False` scales statically by
    init_loss_scaling."""
    if amp_dtype not in ("bfloat16", "float16"):
        raise ValueError(f"amp_dtype must be 'bfloat16' or 'float16', got {amp_dtype!r}")
    if use_dynamic_loss_scaling is None:
        use_dynamic_loss_scaling = amp_dtype == "float16"
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists or AutoMixedPrecisionLists(), init_loss_scaling,
        use_dynamic_loss_scaling, amp_dtype, incr_every_n_steps, decr_every_n_nan_or_inf,
        incr_ratio, decr_ratio)
