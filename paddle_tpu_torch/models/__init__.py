"""Model zoo: the models ported so far."""

from . import bert, resnet  # noqa: F401
