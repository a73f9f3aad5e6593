"""ResNet for ImageNet (counterpart of `paddle_tpu/models/resnet.py`): BASELINE
config #2 and the reference's headline benchmark (`bench.py:656`
`run_bench`: resnet50, batch 256, 224x224, bf16).

Bottleneck blocks of conv -> batch norm -> relu (`conv_bn`, conv without
bias), a projection shortcut where the shape changes, and the residual
join as an `Addto` with relu. NHWC input [B, S, S, 3]. Layer names are the
reference's (`stem.conv`, `s0b0.a.bn`, `s0b0.proj.conv`, `gap`,
`logits`), so parameters and states move across by name. The conv
filters, batch norms and the head declare the reference's logical sharding
axes (`CONV_W_AXES`, `BN_AXES`, ("embed", "vocab")); the rules table
(`parallel/rules.py`) resolves them to replicated on the data-only mesh."""

from __future__ import annotations

from typing import Optional, Tuple

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.graph import Layer, ParamAttr

# logical axes: conv filters (HWIO) name their out-channel axis "mlp"; the
# rules table maps it to a 'model' axis on a tensor-parallel mesh and to
# replicated on the data-only one
CONV_W_AXES = (None, None, None, "mlp")
BN_AXES = ("mlp",)


def conv_bn(x: Layer, num_filters: int, filter_size: int, stride: int = 1,
            padding: Optional[int] = None, act: Optional[str] = "relu",
            name: str = "") -> Layer:
    """conv (no bias: batch norm has the shift) -> batch norm -> act."""
    if padding is None:
        padding = (filter_size - 1) // 2
    conv = L.Conv2D(x, num_filters=num_filters, filter_size=filter_size,
                    stride=stride, padding=padding, act=None, bias=False,
                    param_attr=ParamAttr(logical_axes=CONV_W_AXES), name=f"{name}.conv")
    return L.BatchNorm(conv, act=act, param_attr=ParamAttr(logical_axes=BN_AXES),
                       bias_attr=ParamAttr(logical_axes=BN_AXES), name=f"{name}.bn")


def bottleneck(x: Layer, mid: int, out: int, stride: int, name: str) -> Layer:
    """1x1 -> 3x3 -> 1x1, with a projection shortcut where the shape
    changes."""
    in_ch = _out_channels(x)
    a = conv_bn(x, mid, 1, stride, 0, "relu", f"{name}.a")
    b = conv_bn(a, mid, 3, 1, 1, "relu", f"{name}.b")
    c = conv_bn(b, out, 1, 1, 0, None, f"{name}.c")
    if stride != 1 or in_ch != out:
        shortcut = conv_bn(x, out, 1, stride, 0, None, f"{name}.proj")
    else:
        shortcut = x
    return L.Addto([c, shortcut], act="relu", name=f"{name}.add")


def _out_channels(layer: Layer) -> int:
    """The static channel count of a spec node."""
    if isinstance(layer, L.Data):
        return layer.shape[-1]
    if isinstance(layer, L.Conv2D):
        return layer.num_filters
    if isinstance(layer, (L.BatchNorm, L.Pool2D, L.Addto)):
        return _out_channels(layer.inputs[0])
    raise ValueError(f"cannot infer channels of {layer}")


DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet(depth: int = 50, num_classes: int = 1000,
           image_size: int = 224) -> Tuple[Layer, Layer, Layer, Layer]:
    """Returns (data, label, logits, cost); input slot "image" [B, S, S, 3],
    labels "label" [B]."""
    blocks = DEPTHS[depth]
    img = L.Data("image", shape=(image_size, image_size, 3))
    label = L.Data("label", shape=())
    x = conv_bn(img, 64, 7, 2, 3, "relu", "stem")
    x = L.Pool2D(x, 3, "max", stride=2, padding=1, name="stem.pool")
    widths = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
    for stage, (n_blocks, (mid, out)) in enumerate(zip(blocks, widths)):
        for blk in range(n_blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            x = bottleneck(x, mid, out, stride, f"s{stage}b{blk}")
    pooled = L.GlobalPool(x, "avg", name="gap")
    logits = L.Fc(pooled, num_classes, act=None,
                  param_attr=ParamAttr(logical_axes=("embed", "vocab")),
                  bias_attr=ParamAttr(logical_axes=("vocab",)), name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return img, label, logits, cost


def resnet50(num_classes: int = 1000, image_size: int = 224):
    return resnet(50, num_classes, image_size)
