"""Model zoo: the models ported so far."""

from . import bert, resnet, transformer  # noqa: F401
