"""SE-ResNeXt, NCHW: grouped-conv bottlenecks with squeeze-and-excitation
channel gates, the same Program, op for op, as
`paddle_tpu/models/se_resnext.py`."""

from __future__ import annotations

from .. import layers
from .resnet import _conv_bn, _shortcut

__all__ = ["se_resnext50", "se_resnext"]

# depth -> blocks a stage; all share the 7x7 stem built here, so the deep
# 3x(3x3) stem of SE-ResNeXt-152 is absent, as in the JAX package
_DEPTH_CFG = {
    26: [1, 1, 1, 1],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
}


def _squeeze_excite(x, num_channels, reduction_ratio, name):
    """Global avg pool -> bottleneck fc (relu) -> fc (sigmoid) -> channel
    scale of x."""
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, max(num_channels // reduction_ratio, 4), act="relu",
                        name=name + "_sq")
    excite = layers.fc(squeeze, num_channels, act="sigmoid", name=name + "_ex")
    excite = layers.reshape(excite, [-1, num_channels, 1, 1])
    return layers.elementwise_mul(x, excite)


def _bottleneck(x, num_filters, stride, cardinality, reduction_ratio, name):
    c1 = _conv_bn(x, num_filters, 1, act="relu", name=name + "_a")
    c2 = _conv_bn(c1, num_filters, 3, stride=stride, groups=cardinality, act="relu",
                  name=name + "_b")
    c3 = _conv_bn(c2, num_filters * 2, 1, name=name + "_c")
    se = _squeeze_excite(c3, num_filters * 2, reduction_ratio, name + "_se")
    short = _shortcut(x, num_filters * 2, stride, name)
    return layers.elementwise_add(short, se, act="relu")


def se_resnext(img, label=None, depth=50, cardinality=32, reduction_ratio=16,
               class_num=1000):
    """img [b, 3, h, w] -> softmax predictions; with `label` [b, 1] int64
    also the mean cross-entropy loss and the top-1 accuracy."""
    blocks = _DEPTH_CFG[depth]
    x = _conv_bn(img, 64, 7, stride=2, act="relu", name="sx_conv1")
    x = layers.pool2d(x, pool_size=3, pool_type="max", pool_stride=2, pool_padding=1)
    num_filters = [128, 256, 512, 1024]
    for stage, n in enumerate(blocks):
        for blk in range(n):
            stride = 2 if blk == 0 and stage > 0 else 1
            x = _bottleneck(x, num_filters[stage], stride, cardinality, reduction_ratio,
                            f"sx{stage + 2}{chr(ord('a') + blk)}")
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    pred = layers.fc(pool, class_num, act="softmax")
    if label is None:
        return pred
    loss = layers.mean(layers.cross_entropy(pred, label))
    acc = layers.accuracy(pred, label)
    return pred, loss, acc


def se_resnext50(img, label=None, **kw):
    return se_resnext(img, label, depth=50, **kw)
