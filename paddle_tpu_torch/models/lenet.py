"""LeNet-style MNIST convnet (counterpart of `paddle_tpu/models/lenet.py`):
BASELINE config #1, two conv-pool stages and two fc layers; input NHWC
[B, 28, 28, 1] in slot "pixel"."""

from __future__ import annotations

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L


def lenet(num_classes: int = 10):
    """Returns (data_layer, label_layer, logits, cost)."""
    img = L.Data("pixel", shape=(28, 28, 1))
    label = L.Data("label", shape=())
    conv1 = L.Conv2D(img, num_filters=32, filter_size=5, padding=2, act="relu",
                     name="conv1")
    pool1 = L.Pool2D(conv1, 2, "max", name="pool1")
    conv2 = L.Conv2D(pool1, num_filters=64, filter_size=5, padding=2, act="relu",
                     name="conv2")
    pool2 = L.Pool2D(conv2, 2, "max", name="pool2")
    flat = L.Reshape(pool2, (7 * 7 * 64,), name="flatten")
    fc1 = L.Fc(flat, 128, act="relu", name="fc1")
    logits = L.Fc(fc1, num_classes, act=None, name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return img, label, logits, cost
