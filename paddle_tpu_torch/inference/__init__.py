"""Inference engine: AnalysisConfig / AnalysisPredictor over an export
written by `save_inference_model` (either package's). The predictor runs
the pruned program through the port's Executor, with its own scope, on
the card unless the config asked for the CPU (`disable_gpu()`); so the
Executor's passes fold the export's eval batch norms into its convs
(passes/fuse_conv_bn.py) at the first run."""

from __future__ import annotations

import os

import numpy as np

from .. import io as _io
from ..executor import Executor, as_tensor
from ..place import CPUPlace, CUDAPlace
from ..scope import Scope, scope_guard, to_numpy

__all__ = [
    "AnalysisConfig",
    "AnalysisPredictor",
    "PaddleTensor",
    "ZeroCopyTensor",
    "create_paddle_predictor",
    "create_predictor",
]


class AnalysisConfig:
    """Predictor settings: the model directory (and a params file name,
    recorded) and the device (the GPU unless `disable_gpu()`). The
    deployment knobs (`switch_ir_optim`, `enable_memory_optim`,
    `enable_mkldnn`, `enable_tensorrt_engine`,
    `set_cpu_math_library_num_threads`, `enable_profile`,
    `switch_use_feed_fetch_ops`, `switch_specify_input_names`) are taken
    and recorded as the JAX package's config records them
    (inference/__init__.py:43-100 there), and change nothing: the
    Executor runs the Program passes on every program
    (PADDLE_TPU_PASSES=none turns them off)."""

    def __init__(self, model_dir=None, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True
        self._memory_optim = True
        self._cpu_math_threads = 1
        self._enable_profile = False

    def set_model(self, model_dir, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file

    def model_dir(self):
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = device_id

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self):
        self._memory_optim = True

    def enable_mkldnn(self):
        pass

    def enable_tensorrt_engine(self, *args, **kwargs):
        pass

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = n

    def enable_profile(self):
        self._enable_profile = True

    def switch_use_feed_fetch_ops(self, flag=True):
        pass

    def switch_specify_input_names(self, flag=True):
        pass


class PaddleTensor:
    """Feed/fetch value of the non-zero-copy API."""

    def __init__(self, data=None, name=None):
        self.name = name
        self.data = None if data is None else np.asarray(data)

    @property
    def shape(self):
        return None if self.data is None else list(self.data.shape)

    def as_ndarray(self):
        return self.data


class ZeroCopyTensor:
    """Device-resident input/output handle."""

    def __init__(self, name, predictor):
        self.name = name
        self._pred = predictor
        self._value = None  # torch tensor on the predictor's device

    def copy_from_cpu(self, arr):
        self._value = as_tensor(arr, None, self._pred._exe.device)

    def copy_to_cpu(self):
        return to_numpy(self._pred._outputs.get(self.name, self._value))

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def value(self):
        return self._pred._outputs.get(self.name, self._value)


class AnalysisPredictor:
    """Predictor over a saved inference model."""

    def __init__(self, config: AnalysisConfig):
        if config.model_dir() is None:
            raise ValueError("AnalysisConfig.set_model(dirname) first")
        if not os.path.isdir(config.model_dir()):
            raise FileNotFoundError(config.model_dir())
        self._config = config
        self._scope = Scope()
        place = CUDAPlace(config.gpu_device_id()) if config.use_gpu() else CPUPlace()
        self._exe = Executor(place)
        with scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_vars = (
                _io.load_inference_model(config.model_dir(), self._exe)
            )
        self._fetch_names = [v.name for v in self._fetch_vars]
        self._input_handles = {n: ZeroCopyTensor(n, self) for n in self._feed_names}
        self._outputs = {}

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_handle(self, name):
        return self._input_handles[name]

    get_input_tensor = get_input_handle

    def get_output_handle(self, name):
        return ZeroCopyTensor(name, self)

    get_output_tensor = get_output_handle

    def _run_feed(self, feed: dict):
        outs = self._exe.run(
            self._program,
            feed=feed,
            fetch_list=self._fetch_names,
            scope=self._scope,
            return_numpy=False,
        )
        self._outputs = dict(zip(self._fetch_names, outs))
        return outs

    def run(self, inputs=None):
        """PaddleTensor-list API, a {name: array} dict, or the zero-copy
        API when `inputs` is None."""
        if inputs is None:
            feed = {n: h._value for n, h in self._input_handles.items()
                    if h._value is not None}
            missing = set(self._feed_names) - set(feed)
            if missing:
                raise RuntimeError(f"zero-copy inputs not set: {sorted(missing)}")
            self._run_feed(feed)
            return None
        if isinstance(inputs, dict):
            return [to_numpy(o) for o in self._run_feed(inputs)]
        feed = {}
        for name, t in zip(self._feed_names, inputs):
            feed[t.name or name] = t.data
        outs = self._run_feed(feed)
        return [PaddleTensor(to_numpy(o), name=n)
                for n, o in zip(self._fetch_names, outs)]

    def zero_copy_run(self):
        return self.run(None)

    def close(self):
        """Drop every tensor this predictor holds (its scope's weights, the
        last outputs, the zero-copy inputs, the executor's rewritten
        Programs), so that their device memory is free at once rather than
        whenever the garbage collector finds the predictor. It runs no more
        after this."""
        self._scope = Scope()
        self._outputs = {}
        self._input_handles = {}
        self._exe._pass_cache.clear()

    def clone(self):
        """A second predictor over the same config: its own scope and
        Executor, the weights loaded again."""
        return AnalysisPredictor(self._config)

    def program(self):
        return self._program


def create_paddle_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    return AnalysisPredictor(config)


create_predictor = create_paddle_predictor
