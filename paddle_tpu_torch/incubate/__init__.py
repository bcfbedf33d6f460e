"""Incubating APIs: the MultiSlot data generator."""

from . import data_generator  # noqa: F401
