"""The mesh step's plan: what a CompiledProgram run adds to the Executor's
op walk so that each rank, walking the same Program on its own shard of
the batch, ends with what GSPMD gives the JAX package for the whole batch
(paddle_tpu/compiler.py). It is built once per post-pass Program, mesh
and fetch set, and read by `Executor._run_walk`:

- gradients: each `<param>@GRAD` is averaged over the batch group once
  its last writer ran and before the first op after that reads it (the
  reference's CoeffNumDevice). Grads due before one op go in one
  all-reduce per dtype (a bucket). Clip ops are Backward ops that read the
  grads, so a global-norm clip sees the averaged grads;
- fetches: a fetch whose IR leading dim is the batch (-1), or a ZeRO-1
  shard, is gathered along dim 0; any other is the mean over the group
  (an integer one: the group's sum over its size, floored; a bool one:
  true on any rank);
- batch_norm / batch_norm_grad and dropout read the group, the rank and
  the group's size from the LoweringContext (`batch_group`, `batch_rank`,
  `batch_ranks`);
- ZeRO-1: the accumulators `zero1_accumulators` names live as DTensors
  sharded on `batch`; an element-wise optimizer op (sgd, momentum, adam,
  adamw and their fused forms) updates the rank's rows of each such
  parameter from the grad's reduce-scattered rows (or the rows of the
  averaged grad, when a clip read it first) and all-gathers the new rows.
  Lamb's trust ratio needs the whole parameter: its accumulators stay
  replicated.

- autoshard: the shard_propagation pass's planned specs (the Program's
  `_autoshard_specs`) are merged over the ZeRO-1 flag's assignment; the
  planner's P('batch') accumulators go the ZeRO-1 way;
- tensor parallelism: on a mesh whose model axis is larger than 1, the
  layout plan of parallel/tensor_parallel.py rewrites a clone of the
  Program and runs every op under its rule. The startup's whole tensors
  are cut into each rank's chunks as the step first reads them; the scope
  keeps sharded state as DTensors (Shard(d) on `model`, with ZeRO-1's
  Shard(0) on `batch`: an accumulator whose model split is on dim 0
  keeps its model chunk whole); a fetch of a sharded var is gathered
  along its dim. The ranks of one model group feed the same rows. Under
  the sequence-parallel mode the plan's sequence layout shards vars on
  their sequence dim over `model` instead, and every parameter but the
  expert-sharded ones of `moe_ffn` stays replicated.

Without a DeviceMesh (the 1x1x1 mesh with no process group) the plan adds
nothing, and the walk is `Executor.run`'s. With a one-rank process group
every collective runs and changes no bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import GRAD_SUFFIX, Parameter
from ..ops.registry import lower_forward_op, lower_op
from ..scope import full_value
from .mesh import canonicalize_spec, named_sharding, zero1_accumulators

__all__ = ["MeshPlan"]

# optimizer ops whose update is element-wise, by their accumulator slots
_ELEMENTWISE = {
    "sgd": (), "fused_sgd": (),
    "momentum": ("Velocity",), "fused_momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2"), "fused_adam": ("Moment1", "Moment2"),
    "adamw": ("Moment1", "Moment2"), "fused_adamw": ("Moment1", "Moment2"),
}


def _is_dtensor(value) -> bool:
    return hasattr(value, "placements") and hasattr(value, "to_local")


class MeshPlan:
    def __init__(self, mesh, program, fetch_names, zero1=False, specs=None):
        """`specs`: planned PartitionSpecs (autoshard) merged over the
        zero1 flag's."""
        self.mesh = mesh
        self.tp = None
        if mesh.shape["model"] > 1 and mesh.device_mesh is not None:
            from .tensor_parallel import TensorParallelPlan

            self.tp = TensorParallelPlan(mesh, program)
            program = self.tp.program
        self.program = program
        self.fetch_names = list(fetch_names)
        self.group = mesh.group("batch")
        self.ranks = mesh.shape["batch"]
        self.rank = mesh.local_rank("batch")
        block = program.global_block()
        ops = block.ops

        def leading_batch(n):
            v = block._find_var_recursive(n)
            return v is not None and bool(v.shape) and v.shape[0] in (-1, None)

        self.batch_fetch = {n for n in self.fetch_names if leading_batch(n)}
        state = sorted({n for op in ops for n in op.input_arg_names() + op.output_arg_names()
                        if n and getattr(block._find_var_recursive(n), "persistable", False)})
        # ZeRO-1: the accumulators an element-wise optimizer op updates
        self.zero1 = {}
        self.zero1_ops = {}
        planned = {n: sp for n, sp in (specs or {}).items()
                   if tuple(canonicalize_spec(sp))[:1] == ("batch",)}
        if (zero1 or planned) and self.ranks > 1 and self.group is not None:
            specs = zero1_accumulators(block, state, self.ranks) if zero1 else {}
            specs.update(planned)
            model0 = {n for n, d in (self.tp.state if self.tp else {}).items() if d == 0}
            for op in ops:
                slots = _ELEMENTWISE.get(op.type)
                if slots is None:
                    continue
                entries = []
                for i, (p, g) in enumerate(zip(op.input("Param"), op.input("Grad"))):
                    accs = [op.input(s)[i] for s in slots if op.input(s)]
                    if accs and all(a in specs and a not in model0 for a in accs):
                        entries.append((p, g, op.output("ParamOut")[i]))
                        for a in accs:
                            shape = block._find_var_recursive(a).shape
                            self.zero1[a] = named_sharding(mesh, specs[a], tuple(shape))
                if entries:
                    self.zero1_ops[id(op)] = entries
        # every persistable laid out other than replicated: its placements
        self.placements = {}
        from torch.distributed.tensor import Replicate, Shard

        for n in set(self.zero1) | set(self.tp.state if self.tp else ()):
            pl = list(self.zero1.get(n, (Replicate(),) * 3))
            if self.tp is not None and n in self.tp.state:
                pl[1] = Shard(self.tp.state[n])
            self.placements[n] = tuple(pl)
        # each param grad's all-reduce (or reduce-scatter) point: before the
        # first op after its last writer that reads it, else at the end
        params = {v.name for v in block.vars.values()
                  if isinstance(v, Parameter) and v.trainable}
        last_write = {}
        for i, op in enumerate(ops):
            for n in op.output_arg_names():
                if n.endswith(GRAD_SUFFIX) and n[:-len(GRAD_SUFFIX)] in params:
                    last_write[n] = i
        zero1_reader = {g: id_ for id_, entries in self.zero1_ops.items()
                        for _, g, _ in entries}
        self.reduce_at = {}
        self.scatter = set()
        for g, w in last_write.items():
            at = next((j for j in range(w + 1, len(ops))
                       if g in ops[j].input_arg_names()), len(ops))
            self.reduce_at.setdefault(at, []).append(g)
            if at < len(ops) and zero1_reader.get(g) == id(ops[at]):
                self.scatter.add(g)

    @property
    def active(self) -> bool:
        """Whether collectives run (a process group is behind the mesh)."""
        return self.group is not None

    def bind(self, ctx):
        """The LoweringContext's view of the batch and model groups."""
        if self.active:
            ctx.batch_group, ctx.batch_rank, ctx.batch_ranks = self.group, self.rank, self.ranks
        if self.tp is not None:
            ctx.model_group, ctx.model_rank = self.tp.group, self.tp.rank
            ctx.model_ranks, ctx.model_dims = self.tp.ranks, self.tp.dims
            ctx.sequence_parallel = self.tp.sequence

    def is_sharded(self, name) -> bool:
        """Whether the scope keeps `name` as a DTensor of this rank's part."""
        return name in self.placements

    # -- the walk ------------------------------------------------------------
    def lower_forward(self, ctx, op, users):
        """A forward op of a training step (lower_forward_op), under its
        tensor-parallel rule."""
        if self.tp is None:
            lower_forward_op(ctx, op, users)
        else:
            lower_forward_op(ctx, op, users, lower=self.tp.wrap_lower(lower_op))

    def lower_plain(self, ctx, op):
        """An op of an inference walk, under its tensor-parallel rule."""
        if self.tp is None:
            lower_op(ctx, op)
        else:
            self.tp.run(ctx, op, lower_op)

    # -- gradients -----------------------------------------------------------
    def before_op(self, values, i):
        """The grads due before op `i` (len(ops): after the last op)."""
        names = self.reduce_at.get(i)
        if names and self.active:
            self.reduce(values, names)

    def reduce(self, values, names):
        """Average `names` over the group in place in `values`: one
        all-reduce per dtype, or a reduce-scatter of each ZeRO-1 grad."""
        import torch.distributed as dist

        buckets = {}
        for n in names:
            if n not in values:
                continue
            if n in self.scatter:
                t = values[n].contiguous()
                out = torch.empty((t.shape[0] // self.ranks,) + tuple(t.shape[1:]),
                                  dtype=t.dtype, device=t.device)
                dist.reduce_scatter_tensor(out, t, group=self.group)
                values[n] = out.div_(self.ranks)
            else:
                buckets.setdefault(values[n].dtype, []).append(n)
        for group_names in buckets.values():
            flat = torch.cat([values[n].reshape(-1) for n in group_names])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.ranks)
            for n, part in zip(group_names, flat.split([values[n].numel()
                                                        for n in group_names])):
                values[n] = part.view(values[n].shape)

    def reduce_all(self, grads):
        """The recompute step's grads, all final at once."""
        if self.active:
            self.reduce(grads, sorted(grads))
        return grads

    # -- ZeRO-1 --------------------------------------------------------------
    def _rows(self, t):
        rows = t.shape[0] // self.ranks
        return t.narrow(0, self.rank * rows, rows)

    def _gather_rows(self, t):
        import torch.distributed as dist

        t = t.contiguous()
        out = torch.empty((t.shape[0] * self.ranks,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def lower_optimizer(self, ctx, op, lower):
        """Run optimizer `op` through `lower(ctx, op)`; for its ZeRO-1
        parameters on the rank's rows, the new rows all-gathered."""
        if self.tp is not None:
            lower = self.tp.wrap_lower(lower)
        entries = self.zero1_ops.get(id(op))
        if entries is None:
            lower(ctx, op)
            return
        saved = {}
        for p, g, _ in entries:
            saved[p] = ctx.values[p]
            ctx.values[p] = self._rows(saved[p])
            if g not in self.scatter:  # averaged whole (a clip read it first)
                saved[g] = ctx.values[g]
                ctx.values[g] = self._rows(saved[g])
        lower(ctx, op)
        produced = set(op.output_arg_names())
        for p, _, p_out in entries:
            ctx.values[p_out] = self._gather_rows(ctx.values[p_out])
        for n, t in saved.items():
            if n not in produced:
                ctx.values[n] = t

    def local_state(self, name, value):
        """A scope value as this rank's step reads it: a sharded var's part
        (its model chunk, and of that its ZeRO-1 rows; a whole tensor left
        by the startup or an earlier run is cut here), any other DTensor's
        whole value."""
        pl = self.placements.get(name)
        if pl is not None:
            if _is_dtensor(value):
                if (value.device_mesh is self.mesh.device_mesh
                        and tuple(value.placements) == pl):
                    return value.to_local()
                value = full_value(value)
            elif not isinstance(value, torch.Tensor):  # a host array
                value = torch.as_tensor(np.asarray(value))
            if self.tp is not None:
                value = self.tp.chunk(name, value)
            if name in self.zero1:
                value = self._rows(value)
            return value.clone()
        if _is_dtensor(value):
            return full_value(value)
        return value

    def wrap_state(self, name, value):
        """A persistable as the scope keeps it: a sharded var as a DTensor
        of this rank's part."""
        pl = self.placements.get(name)
        if pl is None:
            return value
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(value, self.mesh.device_mesh, pl, run_check=False)

    # -- fetches -------------------------------------------------------------
    def fetch(self, name, value):
        import torch.distributed as dist

        if not self.active:
            return value
        if name in self.batch_fetch or name in self.zero1 or name in self.scatter:
            parts = [torch.empty_like(value) for _ in range(self.ranks)]
            dist.all_gather(parts, value.contiguous(), group=self.group)
            value = torch.cat(parts, dim=0)
            return value if self.tp is None else self.tp.gather(name, value)
        if self.tp is not None:
            value = self.tp.gather(name, value)
        out = value.detach().clone()
        if out.dtype == torch.bool:  # true on any rank
            out = out.to(torch.uint8)
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
            return out.bool()
        dist.all_reduce(out, group=self.group)
        if out.is_floating_point():
            return out.div_(self.ranks)
        return out.div_(self.ranks, rounding_mode="floor")
