"""GoogLeNet, Inception-v1 (counterpart of `paddle_tpu/models/googlenet.py`;
the reference's benchmark/paddle/image/googlenet.py, BASELINE.md rows 2
and 5), with the benchmark script's single loss3 head. Each inception
block is four NHWC branches (1x1; 1x1 then 3x3; 1x1 then 5x5; a 3x3
stride-1 max pool then 1x1) joined by `Concat` on the channel axis, the
layout every branch already has: no transpose runs between them. Layer
names are the JAX package's (`i3a.1x1`, `i3a.cat`, `gap`, `logits`)."""

from __future__ import annotations

from typing import Tuple

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.graph import Layer


def _inception(x: Layer, name: str, o1: int, o3r: int, o3: int, o5r: int, o5: int,
               pool_proj: int) -> Layer:
    b1 = L.Conv2D(x, o1, 1, act="relu", name=f"{name}.1x1")
    b3 = L.Conv2D(x, o3r, 1, act="relu", name=f"{name}.3x3r")
    b3 = L.Conv2D(b3, o3, 3, padding=1, act="relu", name=f"{name}.3x3")
    b5 = L.Conv2D(x, o5r, 1, act="relu", name=f"{name}.5x5r")
    b5 = L.Conv2D(b5, o5, 5, padding=2, act="relu", name=f"{name}.5x5")
    bp = L.Pool2D(x, 3, "max", stride=1, padding=1, name=f"{name}.pool")
    bp = L.Conv2D(bp, pool_proj, 1, act="relu", name=f"{name}.poolp")
    return L.Concat([b1, b3, b5, bp], name=f"{name}.cat")


def googlenet(num_classes: int = 1000,
              image_size: int = 224) -> Tuple[Layer, Layer, Layer, Layer]:
    """Returns (data, label, logits, cost)."""
    img = L.Data("image", shape=(image_size, image_size, 3))
    label = L.Data("label", shape=())
    x = L.Conv2D(img, 64, 7, stride=2, padding=3, act="relu", name="conv1")
    x = L.Pool2D(x, 3, "max", stride=2, padding=1, name="pool1")
    x = L.Conv2D(x, 64, 1, act="relu", name="conv2r")
    x = L.Conv2D(x, 192, 3, padding=1, act="relu", name="conv2")
    x = L.Pool2D(x, 3, "max", stride=2, padding=1, name="pool2")
    x = _inception(x, "i3a", 64, 96, 128, 16, 32, 32)
    x = _inception(x, "i3b", 128, 128, 192, 32, 96, 64)
    x = L.Pool2D(x, 3, "max", stride=2, padding=1, name="pool3")
    x = _inception(x, "i4a", 192, 96, 208, 16, 48, 64)
    x = _inception(x, "i4b", 160, 112, 224, 24, 64, 64)
    x = _inception(x, "i4c", 128, 128, 256, 24, 64, 64)
    x = _inception(x, "i4d", 112, 144, 288, 32, 64, 64)
    x = _inception(x, "i4e", 256, 160, 320, 32, 128, 128)
    x = L.Pool2D(x, 3, "max", stride=2, padding=1, name="pool4")
    x = _inception(x, "i5a", 256, 160, 320, 32, 128, 128)
    x = _inception(x, "i5b", 384, 192, 384, 48, 128, 128)
    x = L.GlobalPool(x, "avg", name="gap")
    x = L.Dropout(x, 0.4, name="drop")
    logits = L.Fc(x, num_classes, act=None, name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return img, label, logits, cost
