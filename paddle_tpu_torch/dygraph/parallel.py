"""Dygraph data parallel (paddle_tpu/dygraph/parallel.py; reference
python/paddle/fluid/dygraph/parallel.py:84,150,201,
imperative/nccl_context.h:61): one process a rank, one device a process.

`prepare_context` joins the torch.distributed process group of the
PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS
contract (rank 0's endpoint, `tcp://host:port`, is the rendezvous): gloo
when the dygraph guard is on the CPU, NCCL on the card. A
process group the caller initialized already is used as it is.
`DataParallel.scale_loss` divides the loss by the number of ranks, and
`apply_collective_grads` sums each parameter's grad over the ranks (one
all-reduce a dtype), so each rank ends with the grad of the mean over the
whole batch. With one rank the loss is left as it is, and the sum over a
one-rank group (if there is one) changes no bit."""

from __future__ import annotations

import os

import torch

from .layers import Layer

__all__ = ["DataParallel", "ParallelEnv", "prepare_context"]


class ParallelEnv:
    """reference: dygraph/parallel.py Env, the PADDLE_* environment."""

    def __init__(self):
        self._nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return self._local_rank

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


Env = ParallelEnv


def _group_ready():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def prepare_context(strategy=None):
    """reference: dygraph/parallel.py prepare_context -> NCCLParallelContext.
    Joins the process group of the PADDLE_* contract when it has more than
    one rank and none is initialized; returns the ParallelEnv."""
    import torch.distributed as dist

    from . import _current_place

    env = ParallelEnv()
    if env.nranks > 1 and not _group_ready():
        if not env.trainer_endpoints:
            raise RuntimeError(
                f"prepare_context: PADDLE_TRAINERS_NUM={env.nranks} but "
                "PADDLE_TRAINER_ENDPOINTS is empty")
        place = _current_place()
        cpu = place is not None and place.torch_device().type == "cpu"
        dist.init_process_group(
            "gloo" if cpu else "nccl", init_method=f"tcp://{env.trainer_endpoints[0]}",
            world_size=env.nranks, rank=env.local_rank)
    if _group_ready() and dist.get_world_size() != env.nranks:
        raise RuntimeError(
            f"prepare_context: the process group has {dist.get_world_size()} ranks, "
            f"PADDLE_TRAINERS_NUM says {env.nranks}")
    return env


class DataParallel(Layer):
    """Wraps a Layer for multi-process data parallel training."""

    def __init__(self, layers, strategy=None):
        super().__init__("data_parallel")
        self._layers = layers
        self._env = ParallelEnv()

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        """reference parallel.py:84: the loss over the number of ranks, so
        the grads' sum over the ranks is their mean."""
        n = self._env.nranks
        if n <= 1:
            return loss
        return loss * (1.0 / n)

    def apply_collective_grads(self):
        """reference parallel.py:201: each parameter's grad summed over the
        ranks of the process group, one all-reduce a dtype; nothing
        without a process group."""
        import torch.distributed as dist

        if not _group_ready():
            if self._env.nranks > 1:
                raise RuntimeError(
                    "apply_collective_grads with PADDLE_TRAINERS_NUM="
                    f"{self._env.nranks}: call prepare_context() first")
            return
        params = [p for p in self._layers.parameters() if p.grad is not None]
        buckets = {}
        for p in params:
            buckets.setdefault(p.grad.dtype, []).append(p)
        for group in buckets.values():
            flat = torch.cat([p.grad.reshape(-1) for p in group])
            dist.all_reduce(flat)
            for p, part in zip(group, flat.split([p.grad.numel() for p in group])):
                p.grad = part.view(p.grad.shape)

    # delegate the Layer surface
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self):
        return self._layers.state_dict()

    def set_dict(self, state):
        return self._layers.set_dict(state)

    load_dict = set_dict
