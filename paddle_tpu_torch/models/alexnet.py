"""AlexNet (counterpart of `paddle_tpu/models/alexnet.py`; the reference's
benchmark/paddle/image/alexnet.py, BASELINE.md rows 1 and 4): five convs
with relu, cross-map normalisation after the first two, three 3x3 / 2 max
pools, fc6 and fc7 of 4096 with relu and Dropout(0.5), then the logits.
NHWC input [B, S, S, 3] in slot "image", labels in "label". Layer names
are the JAX package's (`conv1` ... `conv5`, `norm1`, `fc6`, `drop6`,
`logits`), so parameters move across by name and Dropout draws its masks."""

from __future__ import annotations

from typing import Tuple

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.graph import Layer


def alexnet(num_classes: int = 1000,
            image_size: int = 224) -> Tuple[Layer, Layer, Layer, Layer]:
    """Returns (data, label, logits, cost)."""
    img = L.Data("image", shape=(image_size, image_size, 3))
    label = L.Data("label", shape=())
    x = L.Conv2D(img, 64, 11, stride=4, padding=2, act="relu", name="conv1")
    x = L.CrossMapNorm(x, size=5, name="norm1")
    x = L.Pool2D(x, 3, "max", stride=2, name="pool1")
    x = L.Conv2D(x, 192, 5, padding=2, act="relu", name="conv2")
    x = L.CrossMapNorm(x, size=5, name="norm2")
    x = L.Pool2D(x, 3, "max", stride=2, name="pool2")
    x = L.Conv2D(x, 384, 3, padding=1, act="relu", name="conv3")
    x = L.Conv2D(x, 256, 3, padding=1, act="relu", name="conv4")
    x = L.Conv2D(x, 256, 3, padding=1, act="relu", name="conv5")
    x = L.Pool2D(x, 3, "max", stride=2, name="pool5")
    x = L.Reshape(x, (-1,), name="flatten")
    x = L.Fc(x, 4096, act="relu", name="fc6")
    x = L.Dropout(x, 0.5, name="drop6")
    x = L.Fc(x, 4096, act="relu", name="fc7")
    x = L.Dropout(x, 0.5, name="drop7")
    logits = L.Fc(x, num_classes, act=None, name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return img, label, logits, cost
