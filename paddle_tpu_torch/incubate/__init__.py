"""Incubating APIs: the MultiSlot data generator and fleet (its role
makers and the collective fleet, `incubate.fleet`)."""

from . import data_generator  # noqa: F401
