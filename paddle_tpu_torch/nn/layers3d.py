"""3-D image layers (counterpart of `paddle_tpu/nn/layers3d.py`;
Conv3DLayer.cpp:21, DeConv3DLayer.cpp, Pool3DLayer.cpp): NDHWC activations
and DHWIO weights in the state dict, as in the JAX package; the ops
(`ops/conv.conv3d`, `conv3d_transpose`, `max_pool3d`, `avg_pool3d`)
permute to cuDNN's layout inside."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

from paddle_tpu_torch.nn import activations as act_mod
from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.nn.layers import _attr
from paddle_tpu_torch.ops import conv as conv_ops

Int3 = Union[int, Tuple[int, int, int]]


class Conv3D(Layer):
    """3-D convolution over [B, D, H, W, C]: weight `w` [kd, kh, kw,
    C/groups, num_filters] (`he_normal`), bias `b`, activation."""

    type_name = "conv3d"

    def __init__(self, input: Layer, num_filters: int, filter_size: Int3, stride: Int3 = 1,
                 padding: Int3 = 0, dilation: Int3 = 1, groups: int = 1, act: Any = None,
                 bias: bool = True, param_attr: Any = None, bias_attr: Any = None,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.num_filters = num_filters
        self.filter_size = filter_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.act = act
        self.bias = bias
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if x.dim() != 5:
            raise ValueError(f"conv3d {self.name}: expects NDHWC input, got {tuple(x.shape)}")
        kd, kh, kw = conv_ops._triple(self.filter_size)
        w = ctx.param(self, "w", (kd, kh, kw, x.shape[-1] // self.groups, self.num_filters),
                      init_mod.he_normal, self.param_attr)
        out = conv_ops.conv3d(x, w, self.stride, self.padding, self.dilation, self.groups,
                              ctx.policy)
        if self.bias:
            b = ctx.param(self, "b", (self.num_filters,), init_mod.zeros, self.bias_attr)
            out = out + b.to(out.dtype)
        return ins[0].with_value(act_mod.apply(self.act, out))


class Conv3DTranspose(Layer):
    """Transposed 3-D convolution (DeConv3DLayer.cpp): weight `w` [kd, kh,
    kw, num_filters, C], the DHWIO weight of the forward conv it
    transposes."""

    type_name = "deconv3d"

    def __init__(self, input: Layer, num_filters: int, filter_size: Int3, stride: Int3 = 1,
                 padding: Int3 = 0, act: Any = None, bias: bool = True, param_attr: Any = None,
                 bias_attr: Any = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.num_filters = num_filters
        self.filter_size = filter_size
        self.stride = stride
        self.padding = padding
        self.act = act
        self.bias = bias
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if x.dim() != 5:
            raise ValueError(f"deconv3d {self.name}: expects NDHWC input, got "
                             f"{tuple(x.shape)}")
        kd, kh, kw = conv_ops._triple(self.filter_size)
        w = ctx.param(self, "w", (kd, kh, kw, self.num_filters, x.shape[-1]),
                      init_mod.he_normal, self.param_attr)
        out = conv_ops.conv3d_transpose(x, w, self.stride, self.padding, ctx.policy)
        if self.bias:
            b = ctx.param(self, "b", (self.num_filters,), init_mod.zeros, self.bias_attr)
            out = out + b.to(out.dtype)
        return ins[0].with_value(act_mod.apply(self.act, out))


class Pool3D(Layer):
    """3-D max or average pooling over [B, D, H, W, C] (Pool3DLayer.cpp).
    `ceil_mode=True` pads the far side of each axis further so the partial
    windows at the edge survive (the v1 output size, as Pool2D's)."""

    type_name = "pool3d"

    def __init__(self, input: Layer, pool_size: Int3, pool_type: str = "max",
                 stride: Optional[Int3] = None, padding: Int3 = 0, ceil_mode: bool = False,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.pool_size = pool_size
        self.pool_type = pool_type
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def _pads(self, x):
        if not self.ceil_mode:
            return self.padding
        fs = conv_ops._triple(self.pool_size)
        ss = conv_ops._triple(self.stride if self.stride is not None else self.pool_size)
        ps = conv_ops._triple(self.padding)
        out = []
        for size, f, s, p in zip(x.shape[1:4], fs, ss, ps):
            n_out = -(-(size + 2 * p - f) // s) + 1
            out.append((p, p + max(0, (n_out - 1) * s + f - size - 2 * p)))
        return tuple(out)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if x.dim() != 5:
            raise ValueError(f"pool3d {self.name}: expects NDHWC input, got {tuple(x.shape)}")
        pads = self._pads(x)
        if self.pool_type == "max":
            out = conv_ops.max_pool3d(x, self.pool_size, self.stride, pads)
        elif self.pool_type in ("avg", "average"):
            out = conv_ops.avg_pool3d(x, self.pool_size, self.stride, pads)
        else:
            raise ValueError(f"pool3d {self.name}: unknown pool_type {self.pool_type!r}")
        return ins[0].with_value(out)
