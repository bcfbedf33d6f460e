"""High-level Inferencer (the JAX package's contrib/inferencer.py):
rebuilds the inference program from infer_func in its own scope, loads
params from param_path, and runs feeds through an Executor on CUDAPlace(0)
unless given a place."""

from __future__ import annotations

from .. import io as io_module
from ..executor import Executor
from ..framework import Program, program_guard, unique_name
from ..scope import Scope, scope_guard
from .trainer import check_and_get_place

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(self, infer_func, param_path, place=None, parallel=False):
        self.scope = Scope()
        self.place = check_and_get_place(place)
        self.inference_program = Program()
        startup = Program()
        with program_guard(self.inference_program, startup):
            with unique_name.guard():
                outs = infer_func()
                self.predict_vars = (
                    outs if isinstance(outs, list) else [outs]
                )
        self.exe = Executor(self.place)
        with scope_guard(self.scope):
            self.exe.run(startup)
            io_module.load_persistables(
                executor=self.exe, dirname=param_path,
                main_program=self.inference_program,
            )

    def infer(self, inputs, return_numpy=True):
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}"
            )
        with scope_guard(self.scope):
            return self.exe.run(
                self.inference_program,
                feed=inputs,
                fetch_list=[v.name for v in self.predict_vars],
                return_numpy=return_numpy,
            )
