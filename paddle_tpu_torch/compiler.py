"""CompiledProgram, BuildStrategy and ExecutionStrategy: the port's copy of
`paddle_tpu/compiler.py`.

`fluid.CompiledProgram(main).with_data_parallel(loss_name=...)` runs a
Program over the mesh (parallel/mesh.py): a torch.distributed DeviceMesh
over the ranks of the default process group, one device a rank, where the
JAX package shards one jitted step over every device of its process. Each
rank feeds its own shard of the batch, as the JAX package's
multi-process path does (compiler.py:416-444 there), and walks the same
Program on it; the mesh step (executor.py, `_MeshPlan`) adds what makes
the result the one GSPMD gives for the whole batch:

- each `<param>@GRAD`, once final and before any op reads it, is averaged
  over the batch group (an all-reduce a dtype bucket; the reference's
  CoeffNumDevice), so a global-norm clip sees the averaged grads;
- a fetch whose IR leading dim is the batch (-1) is gathered along dim 0;
  any other fetch is the mean over the group (a `mean` loss is the
  global mean);
- batch_norm and batch_norm_grad sum their per-channel statistics over
  the group when the batch axis is larger than 1;
- dropout draws rank r's rows of the global mask (its counter offset).

With `zero1=True` and a batch axis larger than 1, the accumulators that
`mesh.zero1_accumulators` names (and an element-wise optimizer updates:
sgd, momentum, adam, adamw, fused or not; Lamb's stay replicated) live in
the scope as DTensors sharded on `batch`; their update reduce-scatters
the grad's rows, updates the rank's slice and all-gathers the
parameter's new rows. With `BuildStrategy.auto_shard` (or
PADDLE_TPU_AUTOSHARD=1) the shard_propagation pass's planned assignment
is merged over that flag's.

A `model` axis larger than 1 (a mesh built by
`DistributedStrategy(tp=m).build_mesh()` or `make_mesh({"tp": m})`)
runs the Program's `shard_parameter` annotations as Megatron tensor
parallelism (parallel/tensor_parallel.py): the ranks of one model group
hold shards of the annotated parameters, walk the same feed rows, and
the plan adds the model group's collectives. The feeds are split over
`batch` alone.

Without a process group, with `places` None or 1, the mesh is the 1x1x1
mesh without one, and a run is the plain `Executor.run` walk, bit for
bit. `Executor.run_repeated` of a CompiledProgram (`_run_repeated`) runs
the mesh step's static step: on the card one captured CUDA graph, the
plan's collectives inside it, replayed N times. A `pipe` axis larger
than 1 and `with_pipeline` raise NotImplementedError naming ROADMAP
Queue 1 item 9d.
"""

from __future__ import annotations

from .framework import Program
from .scope import global_scope

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """Build-time knobs (reference: details/build_strategy.h). Each of
    these gates one pass of `passes/` (PADDLE_TPU_PASSES overrides them
    all):

      * constant_folding (default True): passes/const_fold.py
      * enable_inplace (default True): passes/copy_prop.py
      * memory_optimize (default True): passes/dce.py
      * fuse_conv_bn (default True): passes/fuse_conv_bn.py, inference
        programs only
      * enable_layout_opt (default True): passes/layout_opt.py
      * fuse_layer_scan (default False, opt-in; also
        PADDLE_TPU_FUSE_LAYER_SCAN=1): passes/fuse_layer_scan.py
      * fuse_all_optimizer_ops (default True): passes/fuse_optimizer.py
      * optimizer_overlap (default False, opt-in; also
        PADDLE_TPU_OPTIMIZER_OVERLAP=1): passes/optimizer_overlap.py

    Recorded for parity and read by nothing, as in the JAX package:
    reduce_strategy, gradient_scale_strategy (the mesh step averages,
    CoeffNumDevice), fuse_elewise_add_act_ops, fuse_all_reduce_ops (the
    mesh step buckets its all-reduces by dtype), num_trainers /
    trainer_id (the process group describes the job) and sync_batch_norm
    (the mesh step's batch norms sum over the batch group).

      * auto_shard (default False, opt-in; also PADDLE_TPU_AUTOSHARD=1,
        which wins): passes/shard_propagation.py, on a CompiledProgram's
        mesh run over more than one device"""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = (
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice)
        self.fuse_elewise_add_act_ops = False
        self.fuse_all_reduce_ops = True
        self.constant_folding = True
        self.enable_inplace = True
        self.memory_optimize = True
        self.fuse_conv_bn = True
        self.enable_layout_opt = True
        self.fuse_layer_scan = False
        self.fuse_all_optimizer_ops = True
        self.optimizer_overlap = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.sync_batch_norm = False
        self.auto_shard = False


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1  # kept for parity
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class CompiledProgram:
    """reference: python/paddle/fluid/compiler.py:65,143."""

    def __init__(self, program_or_graph, build_strategy=None):
        if not isinstance(program_or_graph, Program):
            raise TypeError("CompiledProgram expects a Program")
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = None
        self._loss_name = None
        self._is_data_parallel = False
        self._places = None
        self._mesh = None
        self._share_vars_from = None
        self._zero1 = False

    def with_data_parallel(
        self,
        loss_name=None,
        build_strategy=None,
        exec_strategy=None,
        share_vars_from=None,
        places=None,
        zero1=False,
    ):
        """`places`: None for every rank of the process group (this
        process's device alone without one), an int or a list for that
        many ranks. zero1=True also shards the optimizer accumulators
        along the mesh's 'batch' axis (ZeRO-1)."""
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._places = places
        self._share_vars_from = share_vars_from
        # on the handle, never on the shared Program: another
        # CompiledProgram over the same Program keeps its own setting
        self._zero1 = bool(zero1)
        return self

    def with_inference_optimize(self, config):
        return self

    def with_pipeline(self, loss_name=None, num_stages=2, places=None,
                      tensor_parallel=1):
        raise NotImplementedError(
            "CompiledProgram.with_pipeline: pipeline execution is not ported yet "
            "(ROADMAP Queue 1 item 9d)")

    def _get_mesh(self):
        if self._mesh is None:
            from .parallel.mesh import build_mesh

            places = self._places
            batch = None if places is None else (
                places if isinstance(places, int) else len(places))
            self._mesh = build_mesh(batch=batch)
        return self._mesh

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        """One step over the mesh: the Executor's walk with the mesh
        step's collectives, the chaos sites, the heartbeat and the attached
        CheckpointManager's cadence in the JAX package's order
        (compiler.py:211-257 there)."""
        scope = scope or global_scope()
        plan = self._prepare_mesh_run(executor, feed, fetch_list, scope)
        mgr = (getattr(self._program, "_ckpt_manager", None)
               or getattr(self, "_ckpt_manager", None))
        return executor._run_walk(self._program, feed, plan.fetch_names, scope,
                                  return_numpy, plan=plan, manager=mgr)

    def _run_repeated(self, executor, feed, fetch_list, steps, scope,
                      return_numpy):
        """`steps` mesh steps as one static step replayed `steps` times
        (Executor.run_repeated over the mesh; compiler.py:263-345 there):
        each rank's step with the plan's collectives, on the card captured
        in one CUDA graph; fetches stacked [steps, ...] after the plan's
        fetch rule; the hooks as in `_run`, once for the window."""
        scope = scope or global_scope()
        plan = self._prepare_mesh_run(executor, feed, fetch_list, scope)
        mgr = (getattr(self._program, "_ckpt_manager", None)
               or getattr(self, "_ckpt_manager", None))
        return executor._run_static(self._program, feed, plan.fetch_names, steps, scope,
                                    return_numpy, plan=plan, manager=mgr)

    def _prepare_mesh_run(self, executor, feed, fetch_list, scope):
        """The post-pass Program and its mesh plan for this feed / fetch
        set, from the Executor's pass cache (its key carries the mesh's
        signature and the zero1 flag, as the JAX key does)."""
        from .executor import feed_signature
        from .framework import Variable

        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        return executor._prepare_mesh(self._program, self._get_mesh(),
                                      feed_signature(self._program, feed), fetch_names, scope,
                                      build_strategy=self._build_strategy, zero1=self._zero1)
