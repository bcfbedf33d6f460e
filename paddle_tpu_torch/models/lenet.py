"""LeNet-5 (the reference's recognize_digits model): the same Program, op
for op, as `paddle_tpu/models/lenet.py`."""

from __future__ import annotations

from .. import layers, nets

__all__ = ["lenet5"]


def lenet5(img, label=None, class_num=10):
    """img [b, 1, 28, 28] -> softmax predictions; with `label` [b, 1]
    int64 also the mean cross-entropy loss and the top-1 accuracy."""
    conv1 = nets.simple_img_conv_pool(img, num_filters=6, filter_size=5, pool_size=2,
                                      pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(conv1, num_filters=16, filter_size=5, pool_size=2,
                                      pool_stride=2, act="relu")
    fc1 = layers.fc(conv2, 120, act="relu")
    fc2 = layers.fc(fc1, 84, act="relu")
    pred = layers.fc(fc2, class_num, act="softmax")
    if label is None:
        return pred
    loss = layers.mean(layers.cross_entropy(pred, label))
    acc = layers.accuracy(pred, label)
    return pred, loss, acc
