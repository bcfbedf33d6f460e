"""Contributed extensions: mixed precision."""

from . import mixed_precision  # noqa: F401
