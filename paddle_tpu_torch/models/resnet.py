"""ResNet (18/34/50/101/152), NCHW, bottleneck-v1: the same Program, op for
op, as `paddle_tpu/models/resnet.py`."""

from __future__ import annotations

import math

from .. import layers
from ..initializer import Uniform
from ..param_attr import ParamAttr

__all__ = ["resnet50", "resnet", "RESNET50_TRAIN_FLOPS_PER_IMG"]

# forward ~4.1 GFLOP at 224x224, x3 for forward and backward
RESNET50_TRAIN_FLOPS_PER_IMG = 3 * 4.1e9

# depth -> (blocks per stage, bottleneck blocks)
_DEPTH_CFG = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def _conv_bn(x, num_filters, filter_size, stride=1, act=None, name=None, groups=1):
    conv = layers.conv2d(x, num_filters=num_filters, filter_size=filter_size,
                         stride=stride, padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False, name=name)
    return layers.batch_norm(conv, act=act, name=name + "_bn" if name else None)


def _shortcut(x, num_filters, stride, name):
    if x.shape[1] != num_filters or stride != 1:
        return _conv_bn(x, num_filters, 1, stride, name=name + "_sc")
    return x


def _bottleneck(x, num_filters, stride, name):
    c1 = _conv_bn(x, num_filters, 1, act="relu", name=name + "_a")
    c2 = _conv_bn(c1, num_filters, 3, stride=stride, act="relu", name=name + "_b")
    c3 = _conv_bn(c2, num_filters * 4, 1, name=name + "_c")
    sc = _shortcut(x, num_filters * 4, stride, name)
    return layers.elementwise_add(sc, c3, act="relu")


def _basic(x, num_filters, stride, name):
    c1 = _conv_bn(x, num_filters, 3, stride=stride, act="relu", name=name + "_a")
    c2 = _conv_bn(c1, num_filters, 3, name=name + "_b")
    sc = _shortcut(x, num_filters, stride, name)
    return layers.elementwise_add(sc, c2, act="relu")


def resnet(img, label=None, depth=50, class_num=1000):
    """img [b, 3, h, w] -> softmax predictions; with `label` [b, 1] int64
    also the mean cross-entropy loss and the top-1 and top-5 accuracy."""
    blocks, use_bottleneck = _DEPTH_CFG[depth]
    x = _conv_bn(img, 64, 7, stride=2, act="relu", name="conv1")
    x = layers.pool2d(x, pool_size=3, pool_type="max", pool_stride=2, pool_padding=1)
    num_filters = [64, 128, 256, 512]
    for stage, n in enumerate(blocks):
        for blk in range(n):
            stride = 2 if blk == 0 and stage > 0 else 1
            name = f"res{stage + 2}{chr(ord('a') + blk)}"
            block = _bottleneck if use_bottleneck else _basic
            x = block(x, num_filters[stage], stride, name)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    stdv = 1.0 / math.sqrt(float(pool.shape[1]))
    pred = layers.fc(pool, class_num, act="softmax",
                     param_attr=ParamAttr(initializer=Uniform(-stdv, stdv)))
    if label is None:
        return pred
    loss = layers.mean(layers.cross_entropy(pred, label))
    acc1 = layers.accuracy(pred, label, k=1)
    acc5 = layers.accuracy(pred, label, k=5)
    return pred, loss, acc1, acc5


def resnet50(img, label=None, class_num=1000):
    return resnet(img, label, depth=50, class_num=class_num)
