"""NaN/Inf step guard: skip poisoned updates, roll back after a streak. The
port's copy of `paddle_tpu/resilience/guard.py`.

- `NanGuard.decorate(optimizer)` gates the gradient stream. An AMP
  optimizer with loss scaling already owns a `found_inf` var and passes
  through unchanged; any other is wrapped (GuardedOptimizer) so its grads
  go through `check_finite_and_unscale` with Scale=1 (the port's
  `append_finite_gate`): one all-finite check, the grads zeroed on a
  poisoned step, so the update ops apply a zero delta instead of NaN-ing
  the parameters. Moment decay still advances on a zeroed step, as on the
  AMP overflow branch.
- `NanGuard.check(...)` arbitrates on the host: a bad step bumps
  `nan_steps_skipped`, extends the streak and suspends the manager's
  autosave; `max_consecutive` bad steps in a row restore the newest finite
  snapshot (`restore(require_finite=True)`) and bump `nan_rollbacks`.
"""

from __future__ import annotations

import numpy as np

from ..scope import to_numpy

__all__ = ["NanGuard", "GuardedOptimizer"]


class GuardedOptimizer:
    """Optimizer wrapper that puts the AMP finite check (Scale=1) between
    backward and the update ops. Exposes `_found_inf_var` as the AMP
    decorator does."""

    def __init__(self, inner):
        self._inner = inner
        self._found_inf_var = None

    def __getattr__(self, name):  # the rest of the optimizer's surface
        return getattr(self._inner, name)

    def backward(self, loss, **kw):
        return self._inner.backward(loss, **kw)

    def _gate_gradients(self, params_grads):
        # the AMP unscale gate with a constant Scale=1: grads pass through
        # unchanged unless one is not finite, then all are zero
        from .. import layers
        from ..contrib.mixed_precision.decorator import append_finite_gate
        from ..framework import unique_name

        one = layers.create_global_var(
            [1], 1.0, "float32", persistable=True,
            name=unique_name.generate("nan_guard_scale"))
        gated, found_inf = append_finite_gate(params_grads, one)
        self._found_inf_var = found_inf
        return gated

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(self._gate_gradients(params_grads))

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .. import dygraph

        if dygraph.enabled():
            raise NotImplementedError(
                "NanGuard gates the static-graph gradient stream "
                "(check_finite_and_unscale ops); eager mode has no op "
                "stream to gate — check loss finiteness host-side with "
                "NanGuard.check(values=...) and use the ungated optimizer")
        if not hasattr(self._inner, "backward"):
            raise NotImplementedError(
                "NanGuard needs the wrapped optimizer's backward()/"
                f"apply_gradients() split, which {type(self._inner).__name__} "
                "does not expose — guard the inner optimizer instead")
        params_grads = self.backward(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads


class NanGuard:
    def __init__(self, manager=None, max_consecutive=3):
        self._manager = manager
        self._max = int(max_consecutive)
        self._streak = 0
        self._opt = None

    # -- build time ------------------------------------------------------
    def decorate(self, optimizer):
        """The optimizer whose minimize() builds a fetchable found_inf
        flag: an AMP decorator with loss scaling as it is, any other
        wrapped in GuardedOptimizer."""
        from ..contrib.mixed_precision.decorator import OptimizerWithMixedPrecision

        if (isinstance(optimizer, OptimizerWithMixedPrecision)
                and optimizer._needs_scaling()):
            self._opt = optimizer
            return optimizer
        self._opt = GuardedOptimizer(optimizer)
        return self._opt

    @property
    def found_inf_name(self):
        """Fetch this var each step and pass it to check(); there after
        minimize() ran on the decorated optimizer."""
        v = getattr(self._opt, "_found_inf_var", None)
        if v is None:
            raise RuntimeError(
                "found_inf var not built yet — call decorate(optimizer) "
                "and minimize(loss) first")
        return v.name

    # -- step time -------------------------------------------------------
    @property
    def bad_streak(self):
        return self._streak

    def check(self, values=None, found_inf=None, program=None, scope=None,
              executor=None):
        """Arbitrate one step. `found_inf`: the fetched gate flag; `values`:
        fetched tensors (the loss, grads) checked for finiteness on the
        host. True for a good step. A bad step returns False; after
        `max_consecutive` bad steps the manager restores the newest finite
        snapshot into `scope` and the streak resets."""
        bad = False
        if found_inf is not None:
            bad = bool(to_numpy(found_inf).reshape(-1).any())
        if not bad and values is not None:
            vals = values if isinstance(values, (list, tuple)) else [values]
            for v in vals:
                a = to_numpy(v)
                if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
                    bad = True
                    break
        if not bad:
            if self._streak and self._manager is not None:
                self._manager.resume_autosave()
            self._streak = 0
            return True
        from .. import profiler

        profiler.bump_counter("nan_steps_skipped")
        self._streak += 1
        if self._manager is not None:
            # a snapshot taken during a streak could poison the rollback
            self._manager.suspend_autosave()
        if self._manager is not None and self._streak >= self._max:
            # require_finite: the poisoned step may have been autosaved
            # before this check saw it
            restored = self._manager.restore(
                program=program, scope=scope, executor=executor,
                require_finite=True)
            if restored is None:
                raise RuntimeError(
                    f"{self._streak} consecutive non-finite steps and no "
                    "finite snapshot to roll back to")
            profiler.bump_counter("nan_rollbacks")
            self._streak = 0
            self._manager.resume_autosave()
        return False
