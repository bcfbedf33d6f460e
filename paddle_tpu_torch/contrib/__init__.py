"""Contributed extensions: mixed precision, the event-driven Trainer and
Inferencer, and the distributed batch reader."""

from . import mixed_precision, reader  # noqa: F401
from .inferencer import Inferencer  # noqa: F401
from .trainer import (  # noqa: F401
    BeginEpochEvent,
    BeginStepEvent,
    EndEpochEvent,
    EndStepEvent,
    Trainer,
)
