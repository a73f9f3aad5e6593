"""VGG-16/19 (counterpart of `paddle_tpu/models/vgg.py`; the reference's
benchmark/paddle/image/vgg.py and vgg_16_network): blocks of 3x3 convs
with bias and relu, each closed by a 2x2 max pool, then fc6 and fc7 with
relu and Dropout(0.5), and the logits. NHWC input [B, S, S, 3] in slot
"image", labels in "label". Layer names are the reference's
(`b{i}.conv{j}`, `fc6`, `drop6`, `logits`), so parameters move across by
name and Dropout draws the reference's masks (its key folds in the layer
name)."""

from __future__ import annotations

from typing import Tuple

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.graph import Layer

BLOCKS = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
CHANNELS = (64, 128, 256, 512, 512)


def _block(x: Layer, n_convs: int, channels: int, name: str) -> Layer:
    for i in range(n_convs):
        x = L.Conv2D(x, channels, 3, padding=1, act="relu", bias=True,
                     name=f"{name}.conv{i}")
    return L.Pool2D(x, 2, "max", name=f"{name}.pool")


def vgg(depth: int, num_classes: int = 1000, image_size: int = 224,
        fc_dim: int = 4096) -> Tuple[Layer, Layer, Layer, Layer]:
    """Returns (data, label, logits, cost)."""
    img = L.Data("image", shape=(image_size, image_size, 3))
    label = L.Data("label", shape=())
    x = img
    for i, (n, ch) in enumerate(zip(BLOCKS[depth], CHANNELS)):
        x = _block(x, n, ch, f"b{i}")
    side = image_size // 32
    x = L.Reshape(x, (side * side * 512,), name="flatten")
    x = L.Fc(x, fc_dim, act="relu", name="fc6")
    x = L.Dropout(x, 0.5, name="drop6")
    x = L.Fc(x, fc_dim, act="relu", name="fc7")
    x = L.Dropout(x, 0.5, name="drop7")
    logits = L.Fc(x, num_classes, act=None, name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return img, label, logits, cost


def vgg16(num_classes: int = 1000, image_size: int = 224):
    return vgg(16, num_classes, image_size)


def vgg19(num_classes: int = 1000, image_size: int = 224):
    return vgg(19, num_classes, image_size)
