"""bf16 automatic mixed precision: `decorate` and `AutoMixedPrecisionLists`
(paddle_tpu/contrib/mixed_precision/decorator.py).

As in the JAX package, the policy rides the lowering instead of rewriting
the program with cast ops: `minimize` tags the program with its AMP dtype,
and the product ops (conv2d, mul, matmul, fused_multihead_attention, the
gathered rows of lookup_table) cast their float inputs to bf16 at
lowering (`LoweringContext.amp_cast`). Master weights stay float32;
softmax, the normalisations and the losses compute in float32 inside.
bf16 keeps float32's exponent range, so it needs no loss scaling.

fp16 and loss scaling (static or dynamic) need the
`check_finite_and_unscale` and `update_loss_scaling` ops, which are not
ported yet (ROADMAP Queue 1, "fp16 loss scaling"): asking for either
raises."""

from __future__ import annotations

__all__ = ["decorate", "AutoMixedPrecisionLists"]

_NOT_PORTED = ("{what} needs check_finite_and_unscale and update_loss_scaling, "
               "which are not ported yet (ROADMAP Queue 1: fp16 loss scaling); "
               "use amp_dtype='bfloat16' without loss scaling")


class AutoMixedPrecisionLists:
    """Custom white and black lists of op types: black-listed ops compute
    in fp32; white-listed ops get every float32 input cast to bf16."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(custom_white_list or ())
        self.black_list = set(custom_black_list or ())
        both = self.white_list & self.black_list
        if both:
            raise ValueError(f"op types in BOTH custom lists: {sorted(both)}")


class OptimizerWithMixedPrecision:
    """Wraps an optimizer: `minimize` tags the loss's program with the AMP
    dtype and lists, then runs the wrapped optimizer's `minimize`."""

    def __init__(self, optimizer, amp_lists, amp_dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._amp_dtype = amp_dtype

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        program = loss.block.program
        program._amp_dtype = self._amp_dtype
        program._amp_black_list = set(self._amp_lists.black_list)
        program._amp_white_list = set(self._amp_lists.white_list)
        program.bump_version()
        return self._optimizer.minimize(loss, startup_program, parameter_list, no_grad_set)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0**15, incr_every_n_steps=1000,
             decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=None, amp_dtype="bfloat16"):
    """The optimizer under bf16 AMP. `amp_dtype="float16"` or
    `use_dynamic_loss_scaling=True` raise NotImplementedError (see the
    module's docstring); the loss-scaling arguments are accepted for the
    JAX package's signature and unused under bf16."""
    if amp_dtype != "bfloat16":
        raise NotImplementedError(_NOT_PORTED.format(what=f"amp_dtype={amp_dtype!r}"))
    if use_dynamic_loss_scaling:
        raise NotImplementedError(_NOT_PORTED.format(what="use_dynamic_loss_scaling=True"))
    return OptimizerWithMixedPrecision(optimizer, amp_lists or AutoMixedPrecisionLists(),
                                       amp_dtype)
