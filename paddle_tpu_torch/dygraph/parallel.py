"""Dygraph data parallel with one process (paddle_tpu/dygraph/parallel.py;
reference python/paddle/fluid/dygraph/parallel.py:84,150,201). With one
rank `scale_loss` and `apply_collective_grads` are the identity, as they
are in the JAX package. More ranks need the NCCL process group of ROADMAP
Queue 1 item 9: `prepare_context` and `DataParallel` raise for them
rather than train one rank alone."""

from __future__ import annotations

import os

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


def _single_rank(env, what):
    if env.nranks > 1:
        raise NotImplementedError(
            f"{what} with {env.nranks} ranks (PADDLE_TRAINERS_NUM): multi-process "
            "dygraph data parallel is not ported yet (ROADMAP Queue 1 item 9, the "
            "NCCL process group); run one process")


def prepare_context(strategy=None):
    """reference: dygraph/parallel.py prepare_context. One rank only."""
    env = ParallelEnv()
    _single_rank(env, "prepare_context")
    return env


class DataParallel(Layer):
    """Wraps a Layer for data parallel training; one rank only."""

    def __init__(self, layers, strategy=None):
        super().__init__("data_parallel")
        self._layers = layers
        self._env = ParallelEnv()
        _single_rank(self._env, "DataParallel")

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        """reference parallel.py:84: the identity with one rank."""
        return loss

    def apply_collective_grads(self):
        """reference parallel.py:201: the identity with one rank."""

    # delegate the Layer surface
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self):
        return self._layers.state_dict()

    def set_dict(self, state):
        return self._layers.set_dict(state)

    load_dict = set_dict
