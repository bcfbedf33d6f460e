"""VGG with batch norm after every conv, NCHW: the same Program, op for
op, as `paddle_tpu/models/vgg.py`."""

from __future__ import annotations

from .. import layers

__all__ = ["vgg16", "vgg"]

# depth -> convs in each of the five blocks
_VGG_CFG = {
    11: [1, 1, 2, 2, 2],
    13: [2, 2, 2, 2, 2],
    16: [2, 2, 3, 3, 3],
    19: [2, 2, 4, 4, 4],
}


def _conv_block(x, num_filters, n_convs, name):
    for i in range(n_convs):
        x = layers.conv2d(x, num_filters=num_filters, filter_size=3, padding=1,
                          bias_attr=False, name=f"{name}_{i}")
        x = layers.batch_norm(x, act="relu", name=f"{name}_{i}_bn")
    return layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")


def vgg(img, label=None, depth=16, class_num=1000, fc_dim=4096, dropout=0.5,
        is_test=False):
    """img [b, 3, h, w] -> (logits,), or with `label` [b, 1] int64
    (logits, mean softmax cross-entropy, top-1 accuracy)."""
    if depth not in _VGG_CFG:
        raise ValueError(f"vgg depth {depth}: choose from {list(_VGG_CFG)}")
    x = img
    for bi, n_convs in enumerate(_VGG_CFG[depth]):
        x = _conv_block(x, 64 * min(2 ** bi, 8), n_convs, f"vgg_b{bi}")
    x = layers.fc(x, fc_dim, act="relu", name="vgg_fc6")
    if not is_test and dropout:
        x = layers.dropout(x, dropout_prob=dropout)
    x = layers.fc(x, fc_dim, act="relu", name="vgg_fc7")
    if not is_test and dropout:
        x = layers.dropout(x, dropout_prob=dropout)
    logits = layers.fc(x, class_num, name="vgg_fc8")
    if label is None:
        return (logits,)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc


def vgg16(img, label=None, class_num=1000, **kw):
    return vgg(img, label, depth=16, class_num=class_num, **kw)
