"""Model zoo: the models ported so far."""

from . import bert, lenet, resnet, se_resnext, transformer, vgg  # noqa: F401
