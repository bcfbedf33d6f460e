"""High-level Trainer / event API (the JAX package's contrib/trainer.py,
Fluid's contrib-era API): Trainer(train_func, optimizer_func) builds the
train, test and startup programs in its own scope, runs epochs over a
reader with Begin/End Epoch/Step events, and has test(), save_params and
save_inference_model. It runs on CUDAPlace(0) unless given a place, and
raises without a card unless that place is CPUPlace()."""

from __future__ import annotations

import os

from .. import io as io_module
from .. import optimizer as opt_module
from ..data_feeder import DataFeeder
from ..executor import Executor
from ..framework import Program, program_guard, unique_name
from ..place import CUDAPlace
from ..scope import Scope, scope_guard

__all__ = [
    "BeginEpochEvent",
    "EndEpochEvent",
    "BeginStepEvent",
    "EndStepEvent",
    "Trainer",
]


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        # handlers set this to False to skip fetching the metrics
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


def check_and_get_place(place):
    """`place`, or CUDAPlace(0) when None."""
    return place if place is not None else CUDAPlace(0)


class Trainer:
    """train_func() -> loss var (or [loss, ...metrics]); optimizer_func()
    -> Optimizer. Programs live in this Trainer's own scope."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        self.__stop = False
        self.parallel = parallel
        self.trainer_id = 0
        self.scope = Scope()

        self.startup_program = Program()
        self.train_program = Program()
        with program_guard(self.train_program, self.startup_program):
            with unique_name.guard():
                outs = train_func()
                self.train_func_outputs = (
                    outs if isinstance(outs, list) else [outs]
                )
                self.test_program = self.train_program.clone(for_test=True)
                loss = self.train_func_outputs[0]
                optimizer = optimizer_func()
                if not isinstance(optimizer, opt_module.Optimizer):
                    raise TypeError(
                        "The optimizer should be an instance of Optimizer"
                    )
                optimizer.minimize(loss)

        self.place = check_and_get_place(place)
        self.exe = Executor(self.place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            if param_path and os.path.isdir(param_path):
                io_module.load_persistables(
                    executor=self.exe, dirname=param_path,
                    main_program=self.startup_program,
                )

    def stop(self):
        """Handlers call this to end training early."""
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None, feed_order=None):
        feeder = DataFeeder(
            feed_list=[
                self.train_program.global_block().var(n)
                for n in (feed_order or [])
            ],
            place=self.place,
        ) if feed_order else None
        with scope_guard(self.scope):
            for epoch_id in range(num_epochs):
                event_handler(BeginEpochEvent(epoch_id))
                for step_id, data in enumerate(reader()):
                    if self.__stop:
                        return
                    begin = BeginStepEvent(epoch_id, step_id)
                    event_handler(begin)
                    fetch = (
                        [v.name for v in self.train_func_outputs]
                        if begin.fetch_metrics else []
                    )
                    metrics = self.exe.run(
                        self.train_program,
                        feed=feeder.feed(data) if feeder else data,
                        fetch_list=fetch,
                    )
                    event_handler(EndStepEvent(epoch_id, step_id, metrics))
                event_handler(EndEpochEvent(epoch_id))

    def test(self, reader, feed_order):
        feeder = DataFeeder(
            feed_list=[
                self.test_program.global_block().var(n) for n in feed_order
            ],
            place=self.place,
        )
        accumulated = None
        count = 0
        with scope_guard(self.scope):
            for data in reader():
                outs = self.exe.run(
                    self.test_program,
                    feed=feeder.feed(data),
                    fetch_list=[v.name for v in self.train_func_outputs],
                )
                vals = [float(o.reshape(-1)[0]) for o in outs]
                accumulated = (
                    vals if accumulated is None
                    else [a + v for a, v in zip(accumulated, vals)]
                )
                count += 1
        return [a / max(count, 1) for a in (accumulated or [])]

    def save_params(self, param_path):
        with scope_guard(self.scope):
            io_module.save_persistables(
                self.exe, dirname=param_path,
                main_program=self.train_program,
            )

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        with scope_guard(self.scope):
            io_module.save_inference_model(
                param_path, feeded_var_names,
                [self.train_func_outputs[i] for i in target_var_indexes],
                self.exe, main_program=self.test_program,
            )
