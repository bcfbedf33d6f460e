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

Before the walk, the Program passes (passes/: the JAX package's default
set, const_fold, copy_prop, dce, fuse_conv_bn, layout_opt and
fuse_optimizer; PADDLE_TPU_PASSES overrides it) rewrite a clone of the
Program, as the JAX executor runs them before its trace
(executor.py:639-658 there). `run`'s `build_strategy` (compiler.py) sets
the pass knobs of a run, as a CompiledProgram's does. The rewritten clone
is cached per Executor, 256 entries at most, least recently used out
first, under what the passes read: the Program (its identity, `_version`
and op count), the sorted feed names (not their shapes: the decode loop
varies its batch), the fetch names, the scope, the AMP dtype and the
pass set's `cache_signature`, and for a CompiledProgram the mesh's
signature and its zero1 flag. An entry whose passes read scope values
(fuse_conv_bn folds the BN statistics and conv weights) holds only while
the scope holds those same values: a training step writes new ones, and
the next run of the eval clone folds again. `run(...,
use_program_cache=False)` runs the passes afresh and caches nothing;
`close()` empties the cache. A second run of the same
Program runs no pass. `last_pass_stats` holds the stats of the passes a
run ran (None when it found them cached), with their wall time.

A Program that `optimizer.RecomputeOptimizer` minimized (it names
`_recompute_loss`) trains as the JAX executor's recompute step does
(`_make_recompute_step`, executor.py:411-590 there): its explicit
backward ops are skipped; the forward ops run as one graph from the
trainable parameters to the loss, each run of consecutive ops with one
`recompute_segment` tag inside torch.utils.checkpoint, which returns the
names read after the segment and recomputes the other activations in the
backward instead of holding them; `torch.autograd.grad`
gives the `<param>@GRAD` each optimizer op reads, and the optimizer and
learning-rate ops run after it under no_grad (`_run_recompute`).

Resilience (resilience/, as in the JAX `Executor.run`): each run fires
the `executor.dispatch` chaos site before the step and advances the seed
counter only after it; after the state write-back it fires `trainer.step`,
publishes the supervised rank's heartbeat (`_trainer_heartbeat`, when
PADDLE_TPU_PROGRESS_FILE is set) and calls the attached CheckpointManager's
`_on_executor_step`, which snapshots on its cadence.

A `compiler.CompiledProgram` goes to its `_run`, which walks the Program
through the same `_run_walk` with a `parallel.step.MeshPlan`: the grad
averaging over the mesh's batch group, the fetch rule, the ZeRO-1
shards, the batch group that batch_norm and dropout read, and on a mesh
whose model axis is larger than 1 the tensor-parallel layout plan
(parallel/tensor_parallel.py). Each rank feeds its own rows: the ranks of
one model group (one batch coordinate) feed the same rows, the batch
group's shard. A Program minimized through
`incubate.fleet.collective.fleet.distributed_optimizer` carries its
DistributedStrategy, and `run` sends it through a cached
CompiledProgram over the strategy's mesh whenever a torch.distributed
process group is up (the JAX executor's fleet path, executor.py:866-876
there); without one it is the plain walk. The mesh run sets the gauges
`sharding_recompiles` (a Program planned again under another mesh shape
or spec assignment) and `collective_bytes_estimate` (each state var's
bytes once for the batch group's grad all-reduce of a training run, and
once more when it is sharded: an estimate, not a measurement).

`run_repeated` runs N steps of one feed as a static step
(static_step.py): on the card one captured CUDA graph replayed N times,
where the JAX executor runs a `lax.scan`; its numbers are N `run()`
calls' bit for bit.

Every run draws its randomness from the threefry key
`fold_in(key(program.random_seed or 42), runs so far + 1)`, the key the
JAX executor threads into the same run (executor.py:889-891 there), so
the dropout masks of the two packages agree.
"""

from __future__ import annotations

import json
import os
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch
import torch.utils.checkpoint

from . import ops  # noqa: F401  (registers the lowerings)
from .framework import (
    GRAD_SUFFIX,
    Parameter,
    Program,
    Variable,
    convert_dtype,
    core_op_role,
    default_main_program,
    op_reads,
)
from .ops import prng
from .ops.registry import (
    TORCH_DTYPE,
    LoweringContext,
    graph_users,
    lower_forward_op,
    lower_op,
)
from .passes import apply_program_passes, cache_signature, scope_reads_current
from .place import CUDAPlace, Place
from .resilience.faults import fault_point
from .scope import Scope, full_value, global_scope, to_numpy

__all__ = ["Executor", "as_tensor"]

# the elastic TrainSupervisor's (resilience/trainer_fleet.py) per-rank
# progress file; unset, the heartbeat is one dict lookup
_PROGRESS_ENV = "PADDLE_TPU_PROGRESS_FILE"


def _trainer_heartbeat(step, tick: int) -> None:
    """Publish {tick, pid, time, step} to the supervisor's progress file
    (temp file + os.replace: the watchdog never reads a torn JSON). `tick`
    counts every dispatch (liveness); `step` is the attached
    CheckpointManager's training step (None without one), so a startup
    dispatch never passes for training step N. A failure is swallowed: a
    lost heartbeat is the watchdog's business, never a crash."""
    path = os.environ.get(_PROGRESS_ENV)
    if not path:
        return
    try:
        # chaos site: a raise is a lost heartbeat
        fault_point("trainer.heartbeat")
        payload = {"tick": int(tick), "pid": os.getpid(), "time": time.time()}
        if step is not None:
            payload["step"] = int(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001
        pass


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
# the pass cache's size, the JAX executor's cap
_PASS_CACHE_CAP = 256
# the static steps an Executor keeps (each holds its state and, on the
# card, a CUDA graph and its memory pool)
_STATIC_CACHE_CAP = 8
# a pass-cache entry's program when the passes changed nothing: the entry
# then holds no strong reference to the user's Program
_UNCHANGED = object()


def _is_inference_program(program) -> bool:
    return not any((op.attrs.get("op_role") or 0) & _TRAIN_ROLES
                   for blk in program.blocks for op in blk.ops)


def _run_training(ctx, block, plan=None):
    """Forward-role ops record their graphs on requires-grad aliases of the
    parameters and float feeds (those whose grads `__auto_grad__` pulls
    through the graph; the others record none); Backward / Optimize ops run
    under no_grad. Under a mesh `plan` the param grads are averaged over
    the batch group where the plan puts it, every op runs under its
    tensor-parallel rule, and optimizer ops go through its ZeRO-1 rows."""
    for name, t in list(ctx.values.items()):
        v = block._find_var_recursive(name)
        if v is not None and t.is_floating_point() and (
                v.is_data or (isinstance(v, Parameter) and v.trainable)):
            ctx.values[name] = t.detach().requires_grad_(True)
    users = graph_users(block)
    for i, op in enumerate(block.ops):
        if plan is not None:
            plan.before_op(ctx.values, i)
        if (op.attrs.get("op_role") or 0) & _TRAIN_ROLES:
            with torch.no_grad():
                if plan is not None:
                    plan.lower_optimizer(ctx, op, lower_op)
                else:
                    lower_op(ctx, op)
        elif plan is not None:
            plan.lower_forward(ctx, op, users)
        else:
            lower_forward_op(ctx, op, users)
    if plan is not None:
        plan.before_op(ctx.values, len(block.ops))


def _segment_fn(ctx, ops, reads, out_names, counter):
    """The function torch.utils.checkpoint runs for one recompute segment:
    the segment's ops lowered in a child context that holds only the
    names it reads, returning the names it defines that are read after
    it. `counter` is the parent's rng counter when the segment first ran,
    so the recomputation draws what the first run drew."""

    def fn(*vals):
        sub = ctx.child()
        sub._rng_counter = counter + 1000
        sub.values = dict(zip(reads, vals))
        for op in ops:
            lower_op(sub, op)
        return tuple(sub.get(n) for n in out_names)

    return fn


def _run_recompute(ctx, program, block, feed_names, fetch_names, plan=None):
    """The RecomputeOptimizer step (`_make_recompute_step` in the JAX
    executor): the forward-role ops under enable_grad from requires-grad
    leaves of the parameters the optimizer updates, with no graph cut,
    each segment in non-reentrant checkpoint; the grads by autograd from
    the loss; then the Optimize / LRSched ops under no_grad in a context
    of the state and the grads, keyed `fold_in(run key, 7)`. Leaves each
    state name's new value in `ctx.values` and returns the fetches."""
    post_role = core_op_role.Optimize | core_op_role.LRSched
    roles = [op.attrs.get("op_role") or 0 for op in block.ops]
    fwd_ops = [op for op, r in zip(block.ops, roles)
               if not r & (post_role | core_op_role.Backward)]
    post_ops = [op for op, r in zip(block.ops, roles) if r & post_role]
    state_names = set()
    for op in block.ops:
        for n in op.input_arg_names() + op.output_arg_names():
            v = block._find_var_recursive(n) if n else None
            if v is not None and v.persistable:
                state_names.add(n)
    grad_names = sorted({n for op in post_ops for n in op.input_arg_names()
                         if n.endswith(GRAD_SUFFIX)})
    param_names = [n[:-len(GRAD_SUFFIX)] for n in grad_names]
    for p in param_names:
        if p not in state_names:
            raise RuntimeError(f"recompute: optimizer reads {p}@GRAD but {p} is not "
                               "persistable state")
    groups = []  # (segment or None, [ops]), consecutive ops of one tag
    for op in fwd_ops:
        seg = op.attrs.get("recompute_segment")
        if groups and groups[-1][0] == seg:
            groups[-1][1].append(op)
        else:
            groups.append((seg, [op]))
    # what each group's later ops, the fetches, the state and the loss
    # read: a segment returns only those of its names, and its other
    # activations die with it (the JAX step's unread checkpoint outputs
    # are dead code to XLA)
    read_after = []
    acc = set(fetch_names) | state_names | {program._recompute_loss}
    for _, ops in reversed(groups):
        read_after.append(set(acc))
        acc.update(n for op in ops for n in op_reads(op))
    read_after.reverse()
    fwd_produced = {n for op in fwd_ops for n in op.output_arg_names()} | set(feed_names)
    fwd_fetches = [n for n in fetch_names
                   if n in fwd_produced and not n.endswith(GRAD_SUFFIX)]
    post_outs = {n for op in post_ops for n in op.output_arg_names()}
    for n in fetch_names:
        if not (n in fwd_fetches or n in grad_names or n in state_names
                or n in post_outs):
            raise RuntimeError(
                f"fetch {n!r} is not available under RecomputeOptimizer (backward "
                "intermediates are rematerialized, not stored) — fetch it without "
                "recompute")

    params = [ctx.values[p].detach().requires_grad_(True) for p in param_names]
    ctx.values.update(zip(param_names, params))
    with torch.enable_grad():
        for gi, (seg, ops) in enumerate(groups):
            if seg is None:
                for op in ops:
                    lower_op(ctx, op)
                continue
            # each segment its own stream of counter draws, as in the JAX step
            ctx._rng_counter += 1000 * (gi + 1)
            reads, defined = [], set()
            for op in ops:
                for n in op.input_arg_names():
                    if n and n not in defined and ctx.has(n) and n not in reads:
                        reads.append(n)
                defined.update(n for n in op.output_arg_names() if n)
            out_names = sorted(defined & read_after[gi])
            outs = torch.utils.checkpoint.checkpoint(
                _segment_fn(ctx, ops, reads, out_names, ctx._rng_counter),
                *[ctx.get(n) for n in reads], use_reentrant=False)
            ctx.values.update(zip(out_names, outs))
        loss = ctx.get(program._recompute_loss).reshape(())
    fwd_vals = {n: ctx.get(n) for n in fwd_fetches}
    mid_state = {n: ctx.values.get(n) for n in state_names}
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {g: torch.zeros_like(p) if d is None else d
             for g, p, d in zip(grad_names, params, grads)}
    if plan is not None:
        grads = plan.reduce_all(grads)

    post = ctx.derived(7)
    post.values.update({n: v.detach() for n, v in mid_state.items() if v is not None})
    post.values.update(grads)
    with torch.no_grad():
        for op in post_ops:
            if plan is not None:
                plan.lower_optimizer(post, op, lower_op)
            else:
                lower_op(post, op)
    new_state = {n: post.values[n] if n in post.values else mid_state[n]
                 for n in state_names
                 if n in post.values or mid_state[n] is not None}
    ctx.values.update(new_state)
    fetches = []
    for n in fetch_names:
        if n in fwd_vals:
            fetches.append(fwd_vals[n])
        elif n in grads:
            fetches.append(grads[n])
        elif n in new_state:
            fetches.append(new_state[n])  # the value after the update
        else:
            fetches.append(post.get(n))
    return [f.detach() for f in fetches]


def _lower_step(ctx, program, block, feed_names, fetch_names, plan, training):
    """One step of `block` lowered in `ctx`, which holds the state and the
    feeds: the recompute step, the training walk or the inference walk.
    Leaves the new values in `ctx.values` and returns the fetches,
    detached, before a mesh plan's fetch rule."""
    if training and getattr(program, "_recompute_loss", None):
        if plan is not None and plan.tp is not None:
            raise NotImplementedError(
                "RecomputeOptimizer over a model axis larger than 1 is not ported yet "
                "(ROADMAP Queue 1 item 9d)")
        return _run_recompute(ctx, program, block, list(feed_names), fetch_names, plan)
    if training:
        _run_training(ctx, block, plan)
    else:
        with torch.inference_mode():
            for op in block.ops:
                if plan is not None:
                    plan.lower_plain(ctx, op)
                else:
                    lower_op(ctx, op)
    return [ctx.get(n).detach() for n in fetch_names]


def _state_written(block):
    """The persistables the block's ops write, in order, each once."""
    written = {}
    for op in block.ops:
        for n in op.output_arg_names():
            v = block._find_var_recursive(n) if n else None
            if v is not None and v.persistable:
                written.setdefault(n, None)
    return list(written)


def feed_signature(program, feed):
    """(name, shape, dtype) of each fed value, by name; the dtype is the
    Program's declared one where it declares the name."""
    block = program.global_block()
    out = []
    for name in sorted(feed or {}):
        value = feed[name]
        v = block._find_var_recursive(name)
        dtype = v.dtype if v is not None and v.dtype is not None else (
            getattr(value, "dtype", None) or np.asarray(value).dtype)
        shape = tuple(value.shape) if hasattr(value, "shape") else np.shape(value)
        out.append((name, tuple(int(d) for d in shape), convert_dtype(dtype)))
    return tuple(out)


def _fleet_compiled(program):
    """The cached CompiledProgram a fleet-minimized Program runs through
    when a process group is up (None otherwise): data parallel over
    `strategy.build_mesh()`, ZeRO-1 as `strategy.zero1` says, the
    strategy's build_strategy; rebuilt when the strategy's axes or zero1
    flag or the default process group change."""
    strategy = getattr(program, "_fleet_strategy", None)
    if strategy is None:
        return None
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from .compiler import CompiledProgram

    # the group itself, compared by identity: the entry holds it, so a new
    # group after destroy_process_group never passes for the old one
    group = dist.group.WORLD
    key = (bool(getattr(strategy, "zero1", False)), strategy.dp, strategy.tp, strategy.sp,
           strategy.pp)
    cached = program.__dict__.get("_fleet_compiled")
    if cached is None or cached[0] is not group or cached[1] != key:
        cp = CompiledProgram(program, getattr(strategy, "build_strategy", None))
        cp.with_data_parallel(zero1=key[0])
        cp._mesh = strategy.build_mesh()
        cached = program._fleet_compiled = (group, key, cp)
    return cached[2]


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
        self._dispatch_count = 0  # every run, startup included (heartbeat tick)
        # op types whose __auto_grad__ re-ran the forward in the last run,
        # and those whose forward the dead-op pass removed, so that their
        # __auto_grad__ ran it, once
        self.recomputed_forwards = []
        self.deferred_forwards = []
        # pass-cache key -> (program ref, scope ref, rewritten program or
        # _UNCHANGED), in order of use
        self._pass_cache = OrderedDict()
        self.last_pass_stats = None
        # run_repeated's static steps (static_step.py), keyed as the pass
        # cache is, and by feed shapes and dtypes: key -> (program ref,
        # scope ref, StaticStep), in order of use
        self._static_steps = OrderedDict()
        self.last_static_step = None
        # the mesh signature each Program was last planned under
        # (sharding_recompiles)
        self._sharding_sigs = {}

    def _passed_program(self, program, feed_names, fetch_names, scope,
                        build_strategy=None, mesh_key=(), use_cache=True, mesh=None,
                        feed_sig=None):
        """The program after the enabled passes, from the cache when this
        Program, feed / fetch names, scope, pass set, feed signature and
        `mesh_key` (a CompiledProgram's mesh signature and zero1 flag) were
        seen and the scope still holds the values the passes read.
        `use_cache=False` runs the passes and keeps nothing. `mesh` and
        `feed_sig` ((name, global shape, dtype) triples) go to the passes,
        for shard_propagation's planner."""
        key = (id(program), program._version, len(program.global_block().ops),
               tuple(sorted(feed_names)), tuple(fetch_names), id(scope),
               getattr(program, "_amp_dtype", None), cache_signature(build_strategy),
               feed_sig, mesh_key)
        hit = self._pass_cache.pop(key, None) if use_cache else None
        # the entry holds weak references: an id is only reused by a new
        # object after the old one died
        if hit is not None and hit[0]() is program and hit[1]() is scope:
            passed = program if hit[2] is _UNCHANGED else hit[2]
            if scope_reads_current(passed, scope):
                self._pass_cache[key] = hit
                self.last_pass_stats = None
                return passed
        t0 = time.perf_counter()
        passed, _, stats = apply_program_passes(
            program, tuple(sorted(feed_names)), tuple(fetch_names),
            build_strategy=build_strategy, scope=scope, mesh=mesh, feed_sig=feed_sig)
        if stats is not None:
            stats["ms"] = (time.perf_counter() - t0) * 1e3
        self.last_pass_stats = stats
        if use_cache:
            self._pass_cache[key] = (weakref.ref(program), weakref.ref(scope),
                                     _UNCHANGED if passed is program else passed)
            if len(self._pass_cache) > _PASS_CACHE_CAP:
                self._pass_cache.popitem(last=False)
        return passed

    def _prepare_mesh(self, program, mesh, feed_sig, fetch_names, scope,
                      build_strategy=None, zero1=False):
        """A CompiledProgram's post-pass Program and its MeshPlan
        (parallel/step.py), the plan kept on the post-pass Program per
        mesh signature, zero1 flag, fetch names and PADDLE_TPU_SP_MODE.
        `feed_sig`: this rank's (name, shape, dtype) feed triples; the
        passes see the global batch (dim 0 times the batch axis), as the
        JAX executor's do
        (executor.py:657 there). The shard_propagation pass's planned specs
        (`_autoshard_specs`, autoshard on) are merged over the zero1 flag's
        assignment (executor.py:733-743 in the JAX package)."""
        from .parallel.mesh import mesh_signature
        from .parallel.step import MeshPlan

        batch = int(dict(mesh.shape).get("batch", 1))
        feed_sig = tuple(sorted(
            (n, (tuple(shape[:1]) and (shape[0] * batch,)) + tuple(shape[1:]), dt)
            for n, shape, dt in feed_sig))
        sig = (mesh_signature(mesh, program._sharding_specs), bool(zero1))
        passed = self._passed_program(program, [n for n, _, _ in feed_sig], fetch_names,
                                      scope, build_strategy, mesh_key=sig, mesh=mesh,
                                      feed_sig=feed_sig)
        plans = passed.__dict__.setdefault("_mesh_plans", {})
        key = (sig, id(mesh.device_mesh), passed._version, len(passed.global_block().ops),
               tuple(fetch_names), os.environ.get("PADDLE_TPU_SP_MODE"))
        plan = plans.get(key)
        if plan is None:
            auto = dict(getattr(passed, "_autoshard_specs", None) or {})
            plan = plans[key] = MeshPlan(mesh, passed, fetch_names, zero1, specs=auto)
            self._mesh_gauges(program, mesh, plan, auto, scope)
        return plan

    def _mesh_gauges(self, program, mesh, plan, auto_specs, scope):
        """`sharding_recompiles`: bumped when a Program is planned under
        another (mesh shape, spec assignment) than the last time;
        `collective_bytes_estimate`: each state var's bytes once for the
        batch group's grad all-reduce of a training step, once more when
        it is sharded (an estimate for dashboards, not a measurement)."""
        from . import profiler
        from .parallel.mesh import P, mesh_signature

        specs = dict(program._sharding_specs or {})
        specs.update(auto_specs)
        specs.update({n: P("batch") for n in plan.zero1})
        sig = mesh_signature(mesh, specs)
        prev = self._sharding_sigs.get(id(program))
        if prev is not None and prev != sig:
            profiler.bump_counter("sharding_recompiles")
        self._sharding_sigs[id(program)] = sig
        block = plan.program.global_block()
        training = not _is_inference_program(plan.program)
        est = 0
        for n in sorted(set(_state_written(block)) | self._state_read(block, ())):
            live = scope.get(n) if scope.has(n) else None
            v = block._find_var_recursive(n)
            numel = (live.numel() if isinstance(live, torch.Tensor) else
                     int(np.prod(v.shape)) if v is not None and v.shape
                     and all(isinstance(d, int) and d > 0 for d in v.shape) else 0)
            item = TORCH_DTYPE(v.dtype).itemsize if v is not None else 4
            nbytes = numel * item
            if mesh.shape["batch"] > 1 and training:
                est += nbytes
            if plan.is_sharded(n):
                est += nbytes
        profiler.set_counter("collective_bytes_estimate", est)

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
        use_program_cache: bool = True,
        build_strategy=None,
    ):
        """`program`: a Program, or a compiler.CompiledProgram, which runs
        over its mesh. `use_program_cache=False` runs the passes afresh
        and keeps nothing in the pass cache. `build_strategy`: a
        compiler.BuildStrategy whose knobs choose the passes of this run
        (PADDLE_TPU_PASSES overrides them); None runs the default set."""
        from .compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope, return_numpy)
        program = program or default_main_program()
        fleet = _fleet_compiled(program)
        if fleet is not None:
            return fleet._run(self, feed, fetch_list, scope, return_numpy)
        fetch_names = [
            v.name if isinstance(v, Variable) else str(v) for v in (fetch_list or [])
        ]
        return self._run_walk(program, feed, fetch_names, scope, return_numpy,
                              build_strategy=build_strategy, use_cache=use_program_cache,
                              manager=getattr(program, "_ckpt_manager", None))

    def _run_walk(self, program, feed, fetch_names, scope, return_numpy,
                  build_strategy=None, use_cache=True, plan=None, manager=None):
        """One step of `program` (the user's; the walk runs its post-pass
        clone, or `plan.program` under a mesh), with the resilience hooks:
        `manager` is the attached CheckpointManager."""
        scope = scope or global_scope()
        feed = feed or {}
        # a CheckpointManager attached to the user's Program (the passes
        # run on a clone)
        user_program = program
        if plan is not None:
            program = plan.program
        else:
            program = self._passed_program(program, feed, fetch_names, scope,
                                           build_strategy, use_cache=use_cache)
        block = program.global_block()

        # chaos site: a failure at the dispatch boundary, before the step
        # touches the scope; the seed counter advances only after the step,
        # so a caught and retried failure replays the same dropout keys
        fault_point("executor.dispatch")
        generator = torch.Generator(device=self.device)
        generator.manual_seed((program.random_seed or 42) * 1_000_003
                              + self._seed_counter + 1)
        rng_key = prng.fold_in(prng.key(program.random_seed or 42),
                               self._seed_counter + 1)
        ctx = LoweringContext(program, device=self.device, generator=generator,
                              rng_key=rng_key)
        if plan is not None:
            plan.bind(ctx)
        training = not _is_inference_program(program)
        for n in sorted(self._state_read(block, feed)):
            if not scope.has(n) or scope.get(n) is None:
                raise RuntimeError(
                    f"persistable var {n!r} is not initialized in scope — "
                    "run the startup program first "
                    "(reference behavior: executor.cc var-init check)"
                )
            val = scope.get(n)
            # a DTensor (a ZeRO-1 shard of a mesh run) as this step lays it
            # out: its rows under a ZeRO-1 plan, else whole; the write-back
            # stores a ZeRO-1 accumulator as a DTensor again
            sharded = plan is not None and plan.is_sharded(n)
            val = plan.local_state(n, val) if plan is not None else full_value(val)
            if not isinstance(val, torch.Tensor) or val.device != self.device:
                val = as_tensor(val, block.var(n).dtype, self.device)
                if not sharded:
                    scope.set(n, val)
            if training and val.is_inference():
                # written by an inference-mode run (the startup program):
                # autograd cannot record or alias inference tensors
                val = val.clone()
                if not sharded:
                    scope.set(n, val)
            ctx.values[n] = val
        for name, value in feed.items():
            v = block._find_var_recursive(name)
            ctx.values[name] = as_tensor(value, v.dtype if v is not None else None,
                                         self.device)

        fetches = _lower_step(ctx, program, block, feed, fetch_names, plan, training)
        self._seed_counter += 1
        self.recomputed_forwards = sorted(ctx.recomputed)
        self.deferred_forwards = sorted(ctx.deferred)

        for n in _state_written(block):
            t = ctx.values[n].detach()
            scope.set(n, plan.wrap_state(n, t) if plan is not None else t)
        if plan is not None:
            fetches = [plan.fetch(n, f) for n, f in zip(fetch_names, fetches)]

        # the step boundary, state written back: trainer.step is the chaos
        # anchor for "crash or wedge at step N", then the heartbeat; both
        # before the checkpoint hook, so a crash here leaves the newest
        # snapshot at step N-1 and the respawned attempt retrains step N
        self._dispatch_count += 1
        fault_point("trainer.step")
        _trainer_heartbeat(None if manager is None else manager._auto_step,
                           self._dispatch_count)
        if manager is not None:
            manager._on_executor_step(user_program, scope, self)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    def run_repeated(
        self,
        program: Program = None,
        feed: dict = None,
        fetch_list=None,
        steps: int = 1,
        scope: Scope = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
    ):
        """Run the same Program `steps` times with the same feed, as the
        JAX `Executor.run_repeated` does (executor.py:1026-1141 there):
        each fetch comes back stacked [steps, ...], its last entry what
        the last of `steps` consecutive `run()` calls would fetch; the
        numbers are those `run()` calls' bit for bit, and interleaving is
        allowed (3 `run()` + `run_repeated(steps=3)` equals 6 `run()`).
        The seed counter advances by `steps`, and only on success.
        `trainer.step` and the heartbeat fire once, reporting the window's
        final step, before the attached CheckpointManager's cadence counts
        the whole window (`_on_executor_step(..., steps=steps)`: one
        snapshot of the final state if a boundary fell inside it).

        The one difference: where the JAX executor runs a `lax.scan` in
        one dispatch, this one records a static step (static_step.py) and
        on the card replays one captured CUDA graph `steps` times, the
        dropout and attention kernels reading each step's seeds from
        device memory; the host waits once, at the end. On the CPU the
        static step re-runs its lowering `steps` times. The step is cached
        like the pass cache (and by feed shapes and dtypes); `close()`
        drops the cached steps, and `use_program_cache=False` drops them and
        records this call's step afresh without keeping it. After the call
        the scope holds the step's own state tensors.

        Raises ValueError for `steps` < 1, RuntimeError under
        PADDLE_TPU_CHECK_NAN_INF=1, for a persistable without a value
        (run the startup program first), for a Program that draws from a
        torch.Generator, and on the card for a step the capture refuses;
        TypeError for a Program minimized through the fleet (as the JAX
        one). A CompiledProgram runs over its mesh (`_run_repeated`)."""
        from .compiler import CompiledProgram

        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if os.environ.get("PADDLE_TPU_CHECK_NAN_INF") == "1":
            raise RuntimeError(
                "run_repeated does not support PADDLE_TPU_CHECK_NAN_INF "
                "(per-op flag shapes vary per step); use run()")
        program = program or default_main_program()
        if isinstance(program, CompiledProgram):
            return program._run_repeated(self, feed, fetch_list, steps, scope, return_numpy)
        if getattr(program, "_fleet_strategy", None) is not None:
            raise TypeError("run_repeated does not route the fleet-collective mesh path; "
                            "run() dispatches fleet programs over the strategy mesh")
        fetch_names = [
            v.name if isinstance(v, Variable) else str(v) for v in (fetch_list or [])
        ]
        return self._run_static(program, feed, fetch_names, steps, scope, return_numpy,
                                use_cache=use_program_cache,
                                manager=getattr(program, "_ckpt_manager", None))

    def _run_static(self, program, feed, fetch_names, steps, scope, return_numpy,
                    use_cache=True, plan=None, manager=None):
        """`steps` steps of `program` through its static step (plan: a
        CompiledProgram's MeshPlan), with the resilience hooks."""
        from .static_step import StaticStep

        scope = scope or global_scope()
        feed = feed or {}
        user_program = program
        if plan is not None:
            if plan.tp is not None:
                raise NotImplementedError(
                    "run_repeated over a model axis larger than 1 is not ported yet "
                    "(ROADMAP Queue 1 item 9d): use run()")
            program = plan.program
        else:
            program = self._passed_program(program, feed, fetch_names, scope,
                                           use_cache=use_cache)
        block = program.global_block()
        read = self._state_read(block, feed)
        unsettled = sorted(n for n in read if not scope.has(n) or scope.get(n) is None)
        if unsettled:
            raise RuntimeError(
                f"persistable vars {unsettled} have no settled value yet — run the "
                "startup program before run_repeated (the static step needs stable "
                "shapes)")
        fault_point("executor.dispatch")
        feed_t = {}
        for name, value in feed.items():
            v = block._find_var_recursive(name)
            feed_t[name] = as_tensor(value, v.dtype if v is not None else None, self.device)
        key = (id(program), program._version, len(block.ops),
               tuple((n, tuple(x.shape), x.dtype) for n, x in sorted(feed_t.items())),
               tuple(fetch_names), str(self.device), id(scope), id(plan))
        if not use_cache:
            self._static_steps.clear()
        hit = self._static_steps.pop(key, None)
        step = None
        if hit is not None and hit[0]() is program and hit[1]() is scope:
            step = hit[2]
        if step is None:
            step = StaticStep(program, self.device, feed_t, fetch_names, plan,
                              not _is_inference_program(program), read,
                              _state_written(block), _lower_step)
        step.load(scope, feed_t)
        base = prng.key(program.random_seed or 42)
        run_keys = [prng.fold_in(base, self._seed_counter + 1 + i) for i in range(steps)]
        if step.slots is None:
            step.record(run_keys[0])
        stacked = step.run(run_keys)
        # advance only on success: a failed call replays the same keys
        self._seed_counter += steps
        step.bind(scope)
        self.recomputed_forwards, self.deferred_forwards = step.recomputed, step.deferred
        self.last_static_step = step
        if use_cache:
            self._static_steps[key] = (weakref.ref(program), weakref.ref(scope), step)
            if len(self._static_steps) > _STATIC_CACHE_CAP:
                self._static_steps.popitem(last=False)

        # trainer.step and the heartbeat before the snapshot hook, reporting
        # the window's final step (run_repeated's order in the JAX package)
        self._dispatch_count += 1
        fault_point("trainer.step")
        _trainer_heartbeat(None if manager is None else manager._auto_step + steps - 1,
                           self._dispatch_count)
        if manager is not None:
            manager._on_executor_step(user_program, scope, self, steps=steps)
        if return_numpy:
            return [to_numpy(s) for s in stacked]
        return stacked

    def close(self):
        """Drop the cached post-pass Programs and static steps (the JAX
        Executor's close empties its compile caches)."""
        self._pass_cache.clear()
        self._static_steps.clear()
        self.last_static_step = None

    # ------------------------------------------------------------------
    def _run_dataset(self, program, dataset, scope, thread, fetch_list, fetch_info,
                     print_period, debug):
        """The dataset loop of train_from_dataset / infer_from_dataset:
        the dataset's batches (parsed on `thread` host threads; 0 means the
        dataset's `thread_num`) go
        through a DeviceStager, which casts each array to its var's IR
        dtype and copies it onto this Executor's device on its own
        stream, so batch N+1's copy overlaps the step on batch N. Each step
        runs with return_numpy=False, so the host does not wait on the
        card between steps; the last fetch comes back as numpy. A
        CompiledProgram's steps run over its mesh: under a process group
        each rank feeds the batches of the dataset it was given, its shard
        of the job's data."""
        if dataset is None:
            raise ValueError("dataset is required")
        from .compiler import CompiledProgram
        from .reader.stager import DeviceStager, host_tensor

        num_threads = max(1, int(thread or 0) or int(getattr(dataset, "thread_num", 0) or 0))
        fetch_list = fetch_list or []
        fetch_info = fetch_info or [
            getattr(v, "name", str(v)) for v in fetch_list
        ]
        program = program or default_main_program()
        block = (program._program if isinstance(program, CompiledProgram)
                 else program).global_block()

        def _stage(feed):
            out = {}
            for k, v in feed.items():
                var = block._find_var_recursive(k)
                out[k] = host_tensor(v, TORCH_DTYPE(var.dtype) if var is not None else None)
            return out

        step = 0
        last = None
        stager = DeviceStager(dataset.batches(num_threads), _stage, depth=2,
                              device=self.device)
        try:
            for feed in stager:
                last = self.run(program, feed=feed, fetch_list=fetch_list,
                                scope=scope, return_numpy=False)
                step += 1
                if debug and fetch_list and step % print_period == 0:
                    msg = ", ".join(
                        f"{info}={to_numpy(v).reshape(-1)[0]:.6f}"
                        for info, v in zip(fetch_info, last)
                    )
                    print(f"step {step}: {msg}")
        finally:
            stager.close()  # unblock the stager whatever happened
        if last is not None:
            last = [to_numpy(v) for v in last]
        return last

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """File-driven training: each batch of `dataset` runs one step of
        `program`. `thread` parallelizes the host side (file shards parse
        on `thread` concurrent readers); 0 means the dataset's
        `thread_num` (set_thread)."""
        return self._run_dataset(program, dataset, scope, thread, fetch_list, fetch_info,
                                 print_period, debug)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """The train_from_dataset loop over an inference program."""
        return self._run_dataset(program, dataset, scope, thread, fetch_list, fetch_info,
                                 print_period, debug)
