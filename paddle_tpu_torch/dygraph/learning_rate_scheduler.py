"""Dygraph learning-rate schedulers (paddle_tpu/dygraph/
learning_rate_scheduler.py, the JAX package's classes as they are;
reference python/paddle/fluid/dygraph/learning_rate_scheduler.py): objects
passed as `learning_rate` to an optimizer; each optimizer step calls the
object, which returns the current lr and advances its step counter
(reference LearningRateDecay.__call__, :41-46). The values are Python
floats: the optimizer's `_dygraph_lr` takes float() of them, and the JIT
bridge writes one into a device scalar before each compiled step."""

from __future__ import annotations

import math

__all__ = [
    "LearningRateDecay",
    "PiecewiseDecay",
    "NaturalExpDecay",
    "ExponentialDecay",
    "InverseTimeDecay",
    "PolynomialDecay",
    "CosineDecay",
    "NoamDecay",
]


class LearningRateDecay:
    """Base: __call__ returns the CURRENT lr then advances step_num by
    step_size (reference :36-46)."""

    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step
        self.dtype = dtype

    def __call__(self):
        lr = float(self.step())
        self.step_num += self.step_size
        return lr

    def step(self):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    """reference :70: values[i] while step_num < boundaries[i], last
    value after."""

    def __init__(self, boundaries, values, begin, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.boundaries = list(boundaries)
        self.vals = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.vals[i]
        return self.vals[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * math.exp(-self.decay_rate * div)


class ExponentialDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * (self.decay_rate ** div)


class InverseTimeDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate / (1.0 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_learning_rate = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        n = self.step_num
        steps = self.decay_steps
        if self.cycle:
            div = math.ceil(n / float(steps)) or 1.0
            steps = steps * div
        else:
            n = min(n, steps)
        return ((self.learning_rate - self.end_learning_rate)
                * (1 - n / steps) ** self.power + self.end_learning_rate)


class CosineDecay(LearningRateDecay):
    """reference :...: lr * 0.5 * (cos(epoch * pi / epochs) + 1),
    epoch = step_num // step_each_epoch."""

    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        epoch = self.step_num // self.step_each_epoch
        return (self.learning_rate * 0.5
                * (math.cos(epoch * math.pi / self.epochs) + 1))


class NoamDecay(LearningRateDecay):
    """reference: d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""

    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        n = max(self.step_num, 1)
        return (self.d_model ** -0.5) * min(
            n ** -0.5, n * self.warmup_steps ** -1.5)
