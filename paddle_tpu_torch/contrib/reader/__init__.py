"""Multi-process reader decorator (the JAX package's contrib/reader):
each trainer keeps every PADDLE_TRAINERS_NUM-th batch, offset by its
PADDLE_TRAINER_ID, so data-parallel trainer processes read disjoint
streams from one shared reader definition."""

from __future__ import annotations

import os

__all__ = ["distributed_batch_reader"]


def distributed_batch_reader(batch_reader):
    trainers_num = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    trainer_id = int(os.getenv("PADDLE_TRAINER_ID", 0))
    assert trainer_id < trainers_num

    def decorate_for_multi_process():
        # yield only on COMPLETE groups of trainers_num batches: every
        # trainer sees the same number of batches, so lockstep
        # collectives can't hang on an uneven tail
        mine = None
        for batch_id, data in enumerate(batch_reader()):
            if trainers_num == 1:
                yield data
                continue
            if batch_id % trainers_num == trainer_id:
                mine = data
            if batch_id % trainers_num == trainers_num - 1:
                assert mine is not None, "train data should not be None."
                yield mine
                mine = None

    return decorate_for_multi_process
