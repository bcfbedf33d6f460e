"""fleet.collective: the port's copy of
`paddle_tpu/incubate/fleet/collective/__init__.py` (reference:
python/paddle/fluid/incubate/fleet/collective/__init__.py:41,139).

`fleet.init` starts the default torch.distributed process group when the
role maker names more than one worker, where the JAX package joins
`jax.distributed`: at `tcp://<worker 0's endpoint>`, rank
`worker_index()`, world `worker_num()`, over NCCL, or over gloo when the
caller passes `place=CPUPlace()`. A failing NCCL start raises; nothing
switches backend. `distributed_optimizer` returns a CollectiveOptimizer
whose `minimize` records the strategy on the Program, and
`Executor.run` then runs that Program over the strategy's mesh
(parallel/mesh.py) whenever a process group is up.
"""

from __future__ import annotations

from ..base.role_maker import PaddleCloudRoleMaker, RoleMakerBase
from ....compiler import BuildStrategy
from ....parallel import DistributedStrategy as _MeshStrategy

__all__ = ["fleet", "Fleet", "CollectiveOptimizer", "DistributedStrategy"]


# the reference's knobs the mesh step has no counterpart for: their
# defaults, and what the mesh step does instead
_FIXED_KNOBS = {
    "use_local_sgd": (False, "the mesh step all-reduces the gradients every step"),
    "nccl_comm_num": (1, "the mesh step runs on the process group's one communicator"),
    "use_hierarchical_allreduce": (False, "the mesh step issues one flat all-reduce a "
                                          "dtype bucket over the batch group"),
}


class DistributedStrategy(_MeshStrategy):
    """Extends the mesh strategy with the reference's knobs
    (incubate/fleet/collective/__init__.py:93): `build_strategy` sets the
    pass knobs of the fleet run; `use_amp` decorates the optimizer for
    AMP. `use_local_sgd`, `nccl_comm_num` and `use_hierarchical_allreduce`
    hold their defaults; any other value raises NotImplementedError naming
    what the mesh step does instead."""

    def __init__(self):
        super().__init__()
        self.build_strategy = BuildStrategy()
        self.use_amp = False
        for name, (default, _) in _FIXED_KNOBS.items():
            setattr(self, name, default)

    def __setattr__(self, name, value):
        fixed = _FIXED_KNOBS.get(name)
        if fixed is not None and value != fixed[0]:
            raise NotImplementedError(
                f"DistributedStrategy.{name}={value!r} is not supported: {fixed[1]}")
        super().__setattr__(name, value)


def _group_ready():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


class Fleet:
    def __init__(self):
        self._role_maker: RoleMakerBase | None = None
        self._initialized = False

    # -- lifecycle -----------------------------------------------------
    def init(self, role_maker=None, place=None):
        """Generate the role; with more than one worker and no process
        group yet, start the default group (NCCL; gloo for
        `place=CPUPlace()`) at worker 0's endpoint."""
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        self._initialized = True
        n = self._role_maker.worker_num()
        if n > 1 and not _group_ready():
            import torch.distributed as dist

            cpu = place is not None and place.torch_device().type == "cpu"
            coordinator = self._role_maker.get_trainer_endpoints()[0]
            dist.init_process_group("gloo" if cpu else "nccl",
                                    init_method=f"tcp://{coordinator}", world_size=n,
                                    rank=self._role_maker.worker_index())
        return self

    # -- role queries (reference Fleet surface) ------------------------
    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        if self.worker_num() > 1 and _group_ready():
            import torch.distributed as dist

            dist.barrier()

    # -- training ------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        self._strategy = strategy or DistributedStrategy()
        return CollectiveOptimizer(optimizer, self._strategy, self)

    def main_program(self):
        from ....framework import default_main_program

        return default_main_program()

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None):
        from .... import io

        if self.is_first_worker():
            io.save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from .... import io

        if self.is_first_worker():
            io.save_persistables(executor, dirname, main_program)

    def stop_worker(self):
        pass

    init_worker = stop_worker
    run_server = stop_worker
    init_server = stop_worker


class CollectiveOptimizer:
    """reference: incubate/fleet/collective/__init__.py:139
    CollectiveOptimizer: minimize(), then the Program carries the strategy
    and `Executor.run` runs it over the strategy's mesh."""

    def __init__(self, optimizer, strategy, fleet_inst):
        self._optimizer = optimizer
        self._strategy = strategy
        self._fleet = fleet_inst
        if strategy and strategy.use_amp:
            from ....contrib import mixed_precision as mp

            self._optimizer = mp.decorate(optimizer)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._optimizer.minimize(loss, startup_program, parameter_list, no_grad_set)
        loss.block.program._fleet_strategy = self._strategy
        return result

    def backward(self, loss, **kw):
        return self._optimizer.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)


fleet = Fleet()
