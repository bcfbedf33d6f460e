"""Executor: runs a Program's global block eagerly on torch tensors.

Counterpart of `paddle_tpu/executor.py` (`Executor.run`): the same
feed / fetch / scope contract and the same errors — a KeyError naming an
unknown fetch or a missing feed, and a RuntimeError saying "not
initialized" for a persistable the program reads before the startup
program wrote it. Where the JAX executor traces the block into one XLA
computation and caches it, this one walks the ops in order on the place's
device. Programs without backward or optimizer ops run under
`torch.inference_mode()`.

A training program (one with Backward- or Optimize-role ops) runs in two
modes. Its forward ops run under `torch.enable_grad()`, with every
trainable parameter and float feed bound as a detached
`requires_grad_(True)` alias of the scope's tensor, so each forward op
whose grad is an `__auto_grad__` records its own autograd graph, cut from
the graphs of the ops before it (`lower_forward_op`); a forward op with a
grad op of its own records none. The backward and optimizer ops run under
`torch.no_grad()`, and each `__auto_grad__` op pulls its cotangents
through the graph its forward op recorded (ops/registry.py). The graph is
dropped with the step: what the run writes back to the scope and returns
is detached.

Every run draws its randomness from the threefry key
`fold_in(key(program.random_seed or 42), runs so far + 1)`, the key the
JAX executor threads into the same run (executor.py:889-891 there), so
the dropout masks of the two packages agree.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the lowerings)
from .framework import Parameter, Program, Variable, core_op_role, default_main_program
from .ops import prng
from .ops.registry import (
    TORCH_DTYPE,
    LoweringContext,
    graph_users,
    lower_block,
    lower_forward_op,
    lower_op,
)
from .place import CUDAPlace, Place
from .scope import Scope, global_scope, to_numpy

__all__ = ["Executor", "as_tensor"]


def as_tensor(value, dtype, device) -> torch.Tensor:
    """A feed or scope value as a tensor of the IR dtype on `device`
    (int64 stays int64; float64 runs as float32). `dtype` None keeps the
    value's own dtype."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    want = TORCH_DTYPE(dtype) if dtype is not None else (
        torch.float32 if value.dtype == torch.float64 else value.dtype)
    return value.to(device=device, dtype=want)


_TRAIN_ROLES = core_op_role.Backward | core_op_role.Optimize


def _is_inference_program(program) -> bool:
    return not any((op.attrs.get("op_role") or 0) & _TRAIN_ROLES
                   for blk in program.blocks for op in blk.ops)


def _run_training(ctx, block):
    """Forward-role ops record their graphs on requires-grad aliases of the
    parameters and float feeds (those whose grads `__auto_grad__` pulls
    through the graph; the others record none); Backward / Optimize ops run
    under no_grad."""
    for name, t in list(ctx.values.items()):
        v = block._find_var_recursive(name)
        if v is not None and t.is_floating_point() and (
                v.is_data or (isinstance(v, Parameter) and v.trainable)):
            ctx.values[name] = t.detach().requires_grad_(True)
    users = graph_users(block)
    for op in block.ops:
        if (op.attrs.get("op_role") or 0) & _TRAIN_ROLES:
            with torch.no_grad():
                lower_op(ctx, op)
        else:
            lower_forward_op(ctx, op, users)


class Executor:
    def __init__(self, place: Place = None):
        """`place` defaults to CUDAPlace(0); with no card that raises
        rather than running on the CPU. Pass CPUPlace() for the CPU."""
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # exported programs are fp32 (save_inference_model carries no
            # AMP tag): keep the card's fp32 matmuls in full fp32, since
            # TF32 keeps ~3 decimal digits and would break parity with the
            # CPU run and with the JAX package
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._seed_counter = 0
        # op types whose __auto_grad__ re-ran the forward in the last run
        self.recomputed_forwards = []

    @staticmethod
    def _state_read(block, feed_names):
        """Persistables the block reads before writing them."""
        state_read = set()
        defined = set(feed_names)
        for op in block.ops:
            for n in op.input_arg_names():
                v = block._find_var_recursive(n) if n else None
                if v is not None and v.persistable and n not in defined:
                    state_read.add(n)
            defined.update(n for n in op.output_arg_names() if n)
        return state_read

    def run(
        self,
        program: Program = None,
        feed: dict = None,
        fetch_list=None,
        scope: Scope = None,
        return_numpy: bool = True,
    ):
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [
            v.name if isinstance(v, Variable) else str(v) for v in (fetch_list or [])
        ]
        block = program.global_block()

        generator = torch.Generator(device=self.device)
        generator.manual_seed((program.random_seed or 42) * 1_000_003
                              + self._seed_counter + 1)
        rng_key = prng.fold_in(prng.key(program.random_seed or 42),
                               self._seed_counter + 1)
        ctx = LoweringContext(program, device=self.device, generator=generator,
                              rng_key=rng_key)
        training = not _is_inference_program(program)
        for n in sorted(self._state_read(block, feed)):
            if not scope.has(n) or scope.get(n) is None:
                raise RuntimeError(
                    f"persistable var {n!r} is not initialized in scope — "
                    "run the startup program first "
                    "(reference behavior: executor.cc var-init check)"
                )
            val = scope.get(n)
            if not isinstance(val, torch.Tensor) or val.device != self.device:
                val = as_tensor(val, block.var(n).dtype, self.device)
                scope.set(n, val)
            if training and val.is_inference():
                # written by an inference-mode run (the startup program):
                # autograd cannot record or alias inference tensors
                val = val.clone()
                scope.set(n, val)
            ctx.values[n] = val
        for name, value in feed.items():
            v = block._find_var_recursive(name)
            ctx.values[name] = as_tensor(value, v.dtype if v is not None else None,
                                         self.device)

        if training:
            _run_training(ctx, block)
        else:
            with torch.inference_mode():
                lower_block(ctx, block)
        self._seed_counter += 1
        self.recomputed_forwards = sorted(ctx.recomputed)

        for op in block.ops:
            for n in op.output_arg_names():
                v = block._find_var_recursive(n) if n else None
                if v is not None and v.persistable:
                    scope.set(n, ctx.values[n].detach())
        fetches = [ctx.get(n).detach() for n in fetch_names]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches
