"""Core layers (counterpart of `paddle_tpu/nn/layers.py`), every layer of
the JAX package's module: Data, Fc, Embedding, Concat, the image layers
(Conv2D, Conv2DTranspose, Pool2D, BatchNorm, Addto, GlobalPool, Reshape,
BlockExpand, CrossMapNorm, Maxout, SpatialPyramidPool, CrossChannelNorm,
BilinearInterp, Pad, Crop, Rotate, FeatureMapExpand, ParameterRelu),
Dropout (on jax's threefry bits), the v1 config pipeline's Mixed (the sum
of `nn/projections.py`) and Concat2, SwitchOrder (a flat CHW data slot
into NHWC), ErrorClip (a layer's error_clipping_threshold), the vector and
matrix layers (Scaling, SlopeIntercept, Interpolation, Power, DotProd,
CosSim, LinearComb, CosSimVecMat, Trans, RowL2Norm, DataNorm, Resize,
Clip, ScaleShift, Multiplex, OuterProd, ConvShift, SumToOneNorm,
TensorLayer, SelectiveFc) and the sequence and id layers (MaxId, RowConv,
SamplingId, EosIdCheck, PrintLayer). Image activations are NHWC, conv
weights HWIO."""

from __future__ import annotations

import contextlib
import sys
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.nn import activations as act_mod
from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer, ParamAttr, batch_rows
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import normalization as norm_ops


def _attr(a: Any) -> Optional[ParamAttr]:
    """A ParamAttr from None, a ParamAttr, a bool (a bias on/off toggle,
    which carries no attributes), a dict of its fields, or a list of those
    (one per input)."""
    if a is None or isinstance(a, ParamAttr):
        return a
    if isinstance(a, bool):
        return None
    if isinstance(a, (list, tuple)):
        return [_attr(x) for x in a]
    return ParamAttr(**a)


class Data(Layer):
    """Input slot. `shape` excludes the batch dim; sequence inputs carry
    `<name>.lengths` in the batch dict."""

    type_name = "data"

    def __init__(self, name: str, shape: Sequence[int] = (), is_seq: bool = False):
        super().__init__(None, name=name)
        self.shape = tuple(shape)
        self.is_seq = is_seq

    def forward(self, ctx, ins):  # data layers are fed by Network._run
        raise AssertionError("data layer forward should not be called")


class Fc(Layer):
    """Fully connected. Several inputs each get their own weight (`w.0`,
    `w.1`, ...; `param_attr` may be a list, one per input), summed before
    bias and activation. Sequence inputs apply per step; a flat input mixed
    with sequence inputs broadcasts over time; a non-sequence input of more
    than two axes (a feature map) is flattened to [B, -1] first."""

    type_name = "fc"

    def __init__(self, input: Union[Layer, Sequence[Layer]], size: int,
                 act: act_mod.ActLike = "tanh", bias: bool = True,
                 param_attr: Union[None, ParamAttr, List[Optional[ParamAttr]]] = None,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.act = act
        self.bias = bias
        self.param_attr = param_attr
        self.bias_attr = bias_attr

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        total = None
        any_seq = any(a.is_seq for a in ins)
        for i, arg in enumerate(ins):
            x = arg.value
            if not arg.is_seq and x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            suffix = "" if len(ins) == 1 else f".{i}"
            pa = self.param_attr
            if isinstance(pa, list):
                pa = pa[i] if i < len(pa) else None
            w = ctx.param(self, "w" + suffix, (x.shape[-1], self.size),
                          init_mod.smart_normal, pa)
            y = linalg.matmul(x, w, ctx.policy)
            if any_seq and y.dim() == 2:
                y = y[:, None]
            total = y if total is None else total + y
        if self.bias:
            total = total + ctx.param(self, "b", (self.size,), init_mod.zeros,
                                      self.bias_attr)
        return ins[0].with_value(act_mod.apply(self.act, total))


class Embedding(Layer):
    """Embedding lookup: integer ids [B] or [B, T] -> rows of the table.
    Without `vocab_size` the vocabulary is the input Data's `shape[0]`.

    Ids read as the JAX package's `jnp.take` reads them (its "fill" mode):
    an id in [-V, 0) counts from the end, as Python indexing does, and an
    id outside [-V, V) reads a row of NaN. The lookup reads a clamped index
    and puts the NaN in with `torch.where`, so a bad id raises no device
    assert and the op reads nothing back to the host (it stays capturable
    in the step graph); its rows get no gradient."""

    type_name = "embedding"

    def __init__(self, input: Layer, size: int, vocab_size: Optional[int] = None,
                 param_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.vocab_size = vocab_size
        self.param_attr = _attr(param_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        vocab = self.vocab_size
        if vocab is None:
            shape = getattr(self.inputs[0], "shape", ())
            vocab = shape[0] if shape else None
            if vocab is None:
                raise ValueError(f"embedding {self.name}: vocab_size not set and "
                                 f"input has no shape")
        table = ctx.param(self, "w", (vocab, self.size), init_mod.smart_normal,
                          self.param_attr)
        return ins[0].with_value(take_rows(table, ins[0].value))


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` with `jnp.take`'s fill mode: ids in [-V, 0) wrap, ids
    outside [-V, V) read NaN."""
    v = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    valid = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, v - 1)]
    return torch.where(valid[..., None], rows, rows.new_full((), float("nan")))


class Concat(Layer):
    """Feature-axis concat of N inputs, then the activation."""

    type_name = "concat"

    def __init__(self, input: Sequence[Layer], act: act_mod.ActLike = None,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.act = act

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        out = torch.cat([a.value for a in ins], dim=-1)
        return ins[0].with_value(act_mod.apply(self.act, out))


class Conv2D(Layer):
    """2-D convolution, NHWC input, HWIO weight (`he_normal`), optional bias
    and activation."""

    type_name = "conv"

    def __init__(self, input: Layer, num_filters: int,
                 filter_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 dilation: Union[int, Tuple[int, int]] = 1, groups: int = 1,
                 act: act_mod.ActLike = None, bias: bool = True,
                 param_attr: Optional[ParamAttr] = None,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
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
        if x.dim() != 4:
            raise ValueError(f"conv {self.name}: expects NHWC input, got "
                             f"{tuple(x.shape)}")
        kh, kw = conv_ops._pair(self.filter_size)
        w = ctx.param(self, "w", (kh, kw, x.shape[-1] // self.groups,
                                  self.num_filters),
                      init_mod.he_normal, self.param_attr)
        out = conv_ops.conv2d(x, w, self.stride, self.padding, self.dilation,
                              self.groups, ctx.policy)
        if self.bias:
            out = out + ctx.param(self, "b", (self.num_filters,), init_mod.zeros,
                                  self.bias_attr)
        return ins[0].with_value(act_mod.apply(self.act, out))


class Pool2D(Layer):
    """Max or average pooling, NHWC. `ceil_mode=True` (the v1 default output
    size, ceil((I + 2p - f) / s) + 1) pads the bottom and right further so
    the partial windows at the edge survive; average pooling divides by
    the cells inside the image."""

    type_name = "pool"

    def __init__(self, input: Layer, pool_size: Union[int, Tuple[int, int]],
                 pool_type: str = "max",
                 stride: Optional[Union[int, Tuple[int, int]]] = None,
                 padding: Union[int, Tuple[int, int]] = 0, ceil_mode: bool = False,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        if pool_type not in ("max", "avg"):
            raise ValueError(f"pool {name}: pool_type {pool_type!r} is not max/avg")
        self.pool_size = pool_size
        self.pool_type = pool_type
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def _pads(self, x: torch.Tensor):
        if not self.ceil_mode:
            return self.padding
        fh, fw = conv_ops._pair(self.pool_size)
        sh, sw = conv_ops._pair(self.stride if self.stride is not None
                                else self.pool_size)
        ph, pw = conv_ops._pair(self.padding)
        out = []
        for size, f, s, p in ((x.shape[1], fh, sh, ph), (x.shape[2], fw, sw, pw)):
            n_out = -(-(size + 2 * p - f) // s) + 1  # ceil division
            extra = max(0, (n_out - 1) * s + f - size - 2 * p)
            out.append((p, p + extra))
        return tuple(out)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        pool = conv_ops.max_pool2d if self.pool_type == "max" else conv_ops.avg_pool2d
        return ins[0].with_value(pool(x, self.pool_size, self.stride, self._pads(x)))


class BatchNorm(Layer):
    """Batch normalization over every axis but the last ([B, D] or NHWC).
    Parameters `scale` (ones) and `bias` (zeros); states `moving_mean` (0)
    and `moving_var` (1), moved by `moving_average_fraction` in train mode
    only. Batch statistics in train mode, the moving ones otherwise or
    with `use_global_stats=True`."""

    type_name = "batch_norm"

    def __init__(self, input: Layer, act: act_mod.ActLike = None,
                 epsilon: float = 1e-5, moving_average_fraction: float = 0.9,
                 use_global_stats: Optional[bool] = None,
                 param_attr: Optional[ParamAttr] = None,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.act = act
        self.epsilon = epsilon
        self.maf = moving_average_fraction
        self.use_global_stats = use_global_stats
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        c = x.shape[-1]
        gamma = ctx.param(self, "scale", (c,), init_mod.ones, self.param_attr)
        beta = ctx.param(self, "bias", (c,), init_mod.zeros, self.bias_attr)
        moving_mean = ctx.state(self, "moving_mean", (c,), 0.0)
        moving_var = ctx.state(self, "moving_var", (c,), 1.0)
        use_global = (self.use_global_stats if self.use_global_stats is not None
                      else not ctx.train)
        if use_global:
            out = norm_ops.batch_norm_inference(x, gamma, beta, moving_mean,
                                                moving_var, self.epsilon)
        else:
            out, mean, var = norm_ops.batch_norm_train(x, gamma, beta, self.epsilon,
                                                       mesh=getattr(ctx, "mesh", None))
            ctx.update_state(self, "moving_mean",
                             self.maf * moving_mean + (1 - self.maf) * mean)
            ctx.update_state(self, "moving_var",
                             self.maf * moving_var + (1 - self.maf) * var)
        return ins[0].with_value(act_mod.apply(self.act, out))


class _ClipGrad(torch.autograd.Function):
    """Identity forward; the backward clips the incoming error to ±t."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, t: float) -> torch.Tensor:
        ctx.t = t
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.clamp(-ctx.t, ctx.t), None


class ErrorClip(Layer):
    """ExtraLayerAttribute.error_clipping_threshold: identity forward, the
    backpropagated error clipped to ±t (Layer.cpp backwardActivation's
    errorClipping). Chained by the layer_attr seam like dropout."""

    type_name = "error_clip"

    def __init__(self, input: Layer, threshold: float, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.threshold = float(threshold)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value(_ClipGrad.apply(ins[0].value, self.threshold))


class Dropout(Layer):
    """Inverted dropout (the reference's Layer::forwardDropOut): at train
    time keep each value with probability 1 - rate and scale it by
    1 / (1 - rate); the identity at inference or for rate <= 0. The mask is
    `prng.bernoulli` of the context's next key, the JAX package's mask bit
    for bit."""

    type_name = "dropout"

    def __init__(self, input: Layer, rate: float, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.rate = rate

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if not ctx.train or self.rate <= 0.0:
            return ins[0]
        keep = 1.0 - self.rate
        key = ctx.next_rng(self.name)
        mask = batch_rows(ctx, lambda shape: prng.bernoulli(key, keep, shape), x.shape)
        # divide by keep rounded to x's dtype, as jax's weak-typed scalar is
        keep_x = torch.tensor(keep, dtype=x.dtype).item()
        return ins[0].with_value(torch.where(mask, x / keep_x, 0.0).to(x.dtype))


class Addto(Layer):
    """Elementwise sum of N inputs (+ optional bias), then the activation:
    ResNet's residual join."""

    type_name = "addto"

    def __init__(self, input: Sequence[Layer], act: act_mod.ActLike = None,
                 bias: bool = False, bias_attr: Optional[ParamAttr] = None,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.act = act
        self.bias = bias
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        out = ins[0].value
        for other in ins[1:]:
            out = out + other.value
        if self.bias:
            out = out + ctx.param(self, "b", (out.shape[-1],), init_mod.zeros,
                                  self.bias_attr)
        return ins[0].with_value(act_mod.apply(self.act, out))


class GlobalPool(Layer):
    """Global spatial pooling NHWC -> [B, C] (avg or max)."""

    type_name = "global_pool"

    def __init__(self, input: Layer, pool_type: str = "avg",
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        if pool_type not in ("avg", "max"):
            raise ValueError(f"global_pool {name}: pool_type {pool_type!r} "
                             f"is not avg/max")
        self.pool_type = pool_type

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if self.pool_type == "avg":
            return ins[0].with_value(conv_ops.global_avg_pool2d(x))
        return ins[0].with_value(x.amax(dim=(1, 2)))


class Reshape(Layer):
    """Reinterpret each example's features as `shape` (one entry may be
    -1); the result is a non-sequence batch."""

    type_name = "reshape"

    def __init__(self, input: Layer, shape: Sequence[int], name: Optional[str] = None):
        super().__init__(input, name=name)
        self.shape = tuple(shape)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        return Argument(x.reshape((x.shape[0],) + self.shape))


class BlockExpand(Layer):
    """Image -> sequence of flattened blocks (BlockExpandLayer, im2col as a
    layer; OCR's CRNN reads its feature map through it). NHWC [B, H, W, C]
    -> [B, T, C * block_y * block_x] with T = out_h * out_w in row-major
    order, every row of length T. Each step's features run channel
    slowest, (C, block_y, block_x), as the JAX package's
    `conv_general_dilated_patches` lays them out. The blocks are windows
    of `Tensor.unfold` over H and W (a view; the reshape is one copy and
    the backward one kernel), not `nn.functional.unfold`, whose CUDA path
    launches one im2col kernel per image."""

    type_name = "block_expand"

    def __init__(self, input: Layer, block_x: int, block_y: int,
                 stride_x: int = 0, stride_y: int = 0,
                 padding_x: int = 0, padding_y: int = 0, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.block = (block_y, block_x)
        self.stride = (stride_y or block_y, stride_x or block_x)
        self.padding = (padding_y, padding_x)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        (by, bx), (sy, sx), (py, px) = self.block, self.stride, self.padding
        x = torch.nn.functional.pad(x, (0, 0, px, px, py, py))
        blocks = x.unfold(1, by, sy).unfold(2, bx, sx)  # [B, oh, ow, C, by, bx]
        b, oh, ow = blocks.shape[:3]
        seq = blocks.reshape(b, oh * ow, -1)
        lengths = torch.full((b,), oh * ow, dtype=torch.int32, device=x.device)
        return Argument(seq, lengths)


class Mixed(Layer):
    """The sum of projections (MixedLayer.cpp), then bias and activation.
    Each projection claims one input slot for its first source in
    declaration order; an operator's second source appends at the end (the
    reference config's input layout, which the dump reads back)."""

    type_name = "mixed"

    def __init__(self, input: Sequence[Any], size: Optional[int] = None,
                 act: act_mod.ActLike = None, bias: bool = False,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        from paddle_tpu_torch.nn.projections import Projection

        self.projections = []
        for p in input:
            if not isinstance(p, Projection):
                raise TypeError("mixed layer inputs must be Projections")
            self.projections.append(p)
        super().__init__([], name=name)
        self._relayout()
        self.size = size
        self.act = act
        self.bias = bias
        self.bias_attr = _attr(bias_attr)

    def _relayout(self) -> None:
        slots: List[Layer] = []
        arg_slots: List[List[int]] = []
        for p in self.projections:
            arg_slots.append([len(slots)])
            slots.append(p.sources[0])
        for i, p in enumerate(self.projections):
            for extra in p.sources[1:]:
                arg_slots[i].append(len(slots))
                slots.append(extra)
        self.inputs = slots
        self._arg_slots = arg_slots

    # `with mixed_layer(size=N) as m: m += full_matrix_projection(x)`
    def __iadd__(self, proj):
        from paddle_tpu_torch.nn.projections import Projection

        if not isinstance(proj, Projection):
            raise TypeError("mixed layer inputs must be Projections")
        self.projections.append(proj)
        self._relayout()
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and not self.projections:
            raise ValueError(f"mixed layer {self.name!r} finalized with no projections")
        return False

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        out, first = None, None
        for proj, slots in zip(self.projections, self._arg_slots):
            args = [ins[j] for j in slots]
            if first is None:
                first = args[0]
            y = proj.apply(ctx, self, args, self.size)
            out = y if out is None else out + y
        if self.bias:
            out = out + ctx.param(self, "b", (out.shape[-1],), init_mod.zeros,
                                  self.bias_attr)
        return first.with_value(act_mod.apply(self.act, out))


class SwitchOrder(Layer):
    """NHWC <-> NCHW reorder (SwitchOrderLayer); the v1 path reads a flat
    CHW data slot into NHWC through Reshape + SwitchOrder("NHWC")."""

    type_name = "switch_order"

    _PERMS = {"NCHW": (0, 3, 1, 2), "NHWC": (0, 2, 3, 1),
              "NCDHW": (0, 4, 1, 2, 3), "NDHWC": (0, 2, 3, 4, 1)}

    def __init__(self, input: Layer, to: str = "NCHW", name: Optional[str] = None):
        super().__init__(input, name=name)
        if to not in self._PERMS:
            raise ValueError(f"switch_order {name}: unknown order {to!r}")
        self.to = to

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value(ins[0].value.permute(self._PERMS[self.to]))


class MaxId(Layer):
    """The argmax id of the last axis (MaxIdLayer); beam_size > 1 gives the
    top-k ids, ties in index order as `lax.top_k` keeps them."""

    type_name = "max_id"

    def __init__(self, input: Layer, beam_size: int = 1, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.beam_size = beam_size

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if self.beam_size <= 1:
            return ins[0].with_value(torch.argmax(x, dim=-1))
        order = torch.sort(x, dim=-1, descending=True, stable=True).indices
        return ins[0].with_value(order[..., :self.beam_size])


# -- the image layers of the v1 vocabulary ---------------------------------------


class Conv2DTranspose(Layer):
    """Transposed 2-D conv (ExpandConvLayer with trans=True), NHWC. Its
    weight `w` is [kh, kw, num_filters, Cin]: the HWIO weight of the
    forward conv it transposes, as the JAX package lays it out
    (`ops/conv.conv2d_transpose`). Output (H-1)*s + k - 2p."""

    type_name = "conv_transpose"

    def __init__(self, input: Layer, num_filters: int,
                 filter_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 act: act_mod.ActLike = None, bias: bool = True,
                 param_attr: Optional[ParamAttr] = None,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
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
        kh, kw = conv_ops._pair(self.filter_size)
        w = ctx.param(self, "w", (kh, kw, self.num_filters, x.shape[-1]),
                      init_mod.he_normal, self.param_attr)
        out = conv_ops.conv2d_transpose(x, w, self.stride, self.padding, ctx.policy)
        if self.bias:
            out = out + ctx.param(self, "b", (self.num_filters,), init_mod.zeros,
                                  self.bias_attr)
        return ins[0].with_value(act_mod.apply(self.act, out))


class CrossMapNorm(Layer):
    """Local response normalisation across channels (CrossMapNormal, the
    `img_cmrnorm` of AlexNet): x / (1 + scale * sum of x^2 over the `size`
    channels centred on each) ^ power, the window sum as `size` shifted
    slices of the zero-padded squares along NHWC's channel axis."""

    type_name = "lrn"

    def __init__(self, input: Layer, size: int = 5, scale: float = 1e-4,
                 power: float = 0.75, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.scale = scale
        self.power = power

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        half, c = self.size // 2, x.shape[-1]
        padded = torch.nn.functional.pad(torch.square(x), (half, half))
        acc = sum(padded[..., i:i + c] for i in range(self.size))
        return ins[0].with_value(x / torch.pow(1.0 + self.scale * acc, self.power))


class Maxout(Layer):
    """Maxout over channel groups (MaxOutLayer): the last axis viewed as
    [C / groups, groups], the max over each group of `groups` neighbours."""

    type_name = "maxout"

    def __init__(self, input: Layer, groups: int, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.groups = groups

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        c = x.shape[-1]
        out = x.reshape(x.shape[:-1] + (c // self.groups, self.groups)).amax(dim=-1)
        return ins[0].with_value(out)


class SpatialPyramidPool(Layer):
    """Spatial pyramid pooling (SpatialPyramidPoolLayer): levels of 1, 2,
    4, ... bins a side, each bin the max (or mean) of its h // bins x
    w // bins tile of the map's top-left part; a level finer than the map
    is skipped. -> [B, sum of bins^2 * C], each level's bins row-major with
    the channels fastest."""

    type_name = "spp"

    def __init__(self, input: Layer, pyramid_height: int = 3, pool_type: str = "max",
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.pyramid_height = pyramid_height
        self.pool_type = pool_type

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        b, h, w, c = x.shape
        outs = []
        for level in range(self.pyramid_height):
            bins = 2 ** level
            if bins > h or bins > w:
                continue
            bh, bw = h // bins, w // bins
            tiles = x[:, :bh * bins, :bw * bins, :].reshape(b, bins, bh, bins, bw, c)
            pooled = (tiles.amax(dim=(2, 4)) if self.pool_type == "max"
                      else tiles.mean(dim=(2, 4)))
            outs.append(pooled.reshape(b, bins * bins * c))
        return Argument(torch.cat(outs, dim=-1))


class CrossChannelNorm(Layer):
    """Each pixel's channel vector L2-normalised, times a learned
    per-channel `scale` (ones; CrossChannelNormLayer, SSD's)."""

    type_name = "cross_channel_norm"

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        scale = ctx.param(self, "scale", (x.shape[-1],), init_mod.ones, None)
        return ins[0].with_value(x / _l2_norm(x) * scale)


class BilinearInterp(Layer):
    """Bilinear resize of an NHWC map to `out_size` (h, w)
    (BilinearInterpLayer; `ops/conv.bilinear_resize`)."""

    type_name = "bilinear_interp"

    def __init__(self, input: Layer, out_size: Tuple[int, int], name: Optional[str] = None):
        super().__init__(input, name=name)
        self.out_size = out_size

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value(conv_ops.bilinear_resize(ins[0].value, *self.out_size))


class Pad(Layer):
    """Zero padding of an NHWC map on H, W and C, each (before, after)
    (PadLayer)."""

    type_name = "pad"

    def __init__(self, input: Layer, pad_h=(0, 0), pad_w=(0, 0), pad_c=(0, 0),
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.pads = (tuple(pad_h), tuple(pad_w), tuple(pad_c))

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        (h0, h1), (w0, w1), (c0, c1) = self.pads
        return ins[0].with_value(torch.nn.functional.pad(
            ins[0].value, (c0, c1, w0, w1, h0, h1)))


class Crop(Layer):
    """The out_h x out_w window at (offset_h, offset_w) of an NHWC map
    (CropLayer)."""

    type_name = "crop"

    def __init__(self, input: Layer, offset_h: int, offset_w: int, out_h: int,
                 out_w: int, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.offset = (offset_h, offset_w)
        self.out = (out_h, out_w)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        (oh, ow), (h, w) = self.offset, self.out
        return ins[0].with_value(ins[0].value[:, oh:oh + h, ow:ow + w, :])


class Rotate(Layer):
    """The map turned 90 degrees counter-clockwise over H and W
    (RotateLayer; `rot90` over NHWC's axes 1 and 2)."""

    type_name = "rotate"

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value(torch.rot90(ins[0].value, 1, dims=(1, 2)))


class FeatureMapExpand(Layer):
    """A [B, D] vector tiled `num_filters` times (FeatureMapExpandLayer):
    whole rows [a b c a b c] with `as_row_vector`, else each element
    repeated [a a b b c c]; then the activation."""

    type_name = "feature_map_expand"

    def __init__(self, input: Layer, num_filters: int, as_row_vector: bool = True,
                 act: act_mod.ActLike = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.num_filters = num_filters
        self.as_row_vector = as_row_vector
        self.act = act

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if self.as_row_vector:
            out = x[:, None, :].expand(x.shape[0], self.num_filters, x.shape[-1])
            out = out.reshape(x.shape[0], -1)
        else:
            out = torch.repeat_interleave(x, self.num_filters, dim=-1)
        return ins[0].with_value(act_mod.apply(self.act, out))


class ParameterRelu(Layer):
    """Parametric relu (ParameterReluLayer): x where x > 0, else x times a
    learned slope (0.25 at init), one slope for each `partial_sum`
    neighbouring features of the last axis."""

    type_name = "prelu"

    def __init__(self, input: Layer, partial_sum: int = 1,
                 param_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.partial_sum = partial_sum
        self.param_attr = _attr(param_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        w = ctx.param(self, "w", (x.shape[-1] // self.partial_sum,),
                      init_mod.constant(0.25), self.param_attr)
        slopes = torch.repeat_interleave(w, self.partial_sum)
        return ins[0].with_value(torch.where(x > 0, x, x * slopes))


# -- the vector and matrix layers ---------------------------------------------


def _l2_norm(x: torch.Tensor) -> torch.Tensor:
    """The last axis' L2 norm, kept as an axis and held at least 1e-12."""
    return torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def _rows_like(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row [B, 1] (or [B]) weight given x's number of axes."""
    while w.dim() < x.dim():
        w = w[..., None]
    return w


class Scaling(Layer):
    """Row-wise scale w[i] * x[i], the weight [B, 1] the first input
    (ScalingLayer)."""

    type_name = "scaling"

    def __init__(self, weight: Layer, input: Layer, name: Optional[str] = None):
        super().__init__([weight, input], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        w, x = ins[0].value, ins[1].value
        return ins[1].with_value(_rows_like(w, x) * x)


class SlopeIntercept(Layer):
    """slope * x + intercept (SlopeInterceptLayer)."""

    type_name = "slope_intercept"

    def __init__(self, input: Layer, slope: float = 1.0, intercept: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.slope = slope
        self.intercept = intercept

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value(self.slope * ins[0].value + self.intercept)


class Interpolation(Layer):
    """w * x + (1 - w) * y with a per-row weight, the inputs [weight [B, 1],
    x, y] (InterpolationLayer)."""

    type_name = "interpolation"

    def __init__(self, weight: Layer, input1: Layer, input2: Layer,
                 name: Optional[str] = None):
        super().__init__([weight, input1, input2], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x, y = ins[1].value, ins[2].value
        w = _rows_like(ins[0].value, x)
        return ins[1].with_value(w * x + (1.0 - w) * y)


class Power(Layer):
    """x[i] ** p[i], the per-row exponent the first input (PowerLayer)."""

    type_name = "power"

    def __init__(self, exponent: Layer, input: Layer, name: Optional[str] = None):
        super().__init__([exponent, input], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[1].value
        return ins[1].with_value(torch.pow(x, _rows_like(ins[0].value, x)))


class DotProd(Layer):
    """The row-wise dot product of two inputs -> [B, 1] (DotProdLayer)."""

    type_name = "dot_prod"

    def __init__(self, input1: Layer, input2: Layer, name: Optional[str] = None):
        super().__init__([input1, input2], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        out = torch.sum(ins[0].value * ins[1].value, dim=-1, keepdim=True)
        return ins[0].with_value(out)


class CosSim(Layer):
    """The row-wise cosine similarity times `scale` -> [B, 1] (CosSimLayer;
    the product of the norms held at least 1e-12)."""

    type_name = "cos_sim"

    def __init__(self, input1: Layer, input2: Layer, scale: float = 1.0,
                 name: Optional[str] = None):
        super().__init__([input1, input2], name=name)
        self.scale = scale

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        a, b = ins[0].value, ins[1].value
        num = torch.sum(a * b, dim=-1, keepdim=True)
        den = (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
               * torch.linalg.vector_norm(b, dim=-1, keepdim=True))
        return ins[0].with_value(self.scale * num / torch.clamp_min(den, 1e-12))


class LinearComb(Layer):
    """Per-example weighted sum of M vectors (linear_comb_layer /
    ConvexCombinationLayer): weights [B, M], vectors [B, M*N] -> [B, N]."""

    type_name = "convex_comb"

    def __init__(self, weights: Layer, vectors: Layer, size: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__([weights, vectors], name=name)
        self.size = size

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x, y = ins[0].value, ins[1].value
        b, m = x.shape
        n = self.size or y.shape[-1] // m
        if m * n != y.shape[-1]:
            raise ValueError(f"convex_comb {self.name}: vectors dim {y.shape[-1]} != "
                             f"weights dim {m} x size {n}")
        return ins[1].with_value(torch.einsum("bm,bmn->bn", x, y.reshape(b, m, n)))


class CosSimVecMat(Layer):
    """`scale` times the cosine of one vector [B, M] against each of the N
    rows of a per-example matrix [B, M*N] -> [B, N] (CosSimVecMatLayer)."""

    type_name = "cos_vm"

    def __init__(self, vec: Layer, mat: Layer, size: Optional[int] = None,
                 scale: float = 1.0, name: Optional[str] = None):
        super().__init__([vec, mat], name=name)
        self.size = size
        self.scale = scale

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        v, m_flat = ins[0].value, ins[1].value
        b, dim = v.shape
        n = self.size or m_flat.shape[-1] // dim
        if dim * n != m_flat.shape[-1]:
            raise ValueError(f"cos_vm {self.name}: mat dim {m_flat.shape[-1]} != "
                             f"vec dim {dim} x keys {n}")
        mat = m_flat.reshape(b, n, dim)
        num = torch.einsum("bd,bnd->bn", v, mat)
        den = (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
               * torch.linalg.vector_norm(mat, dim=-1))
        return ins[1].with_value(self.scale * num / torch.clamp_min(den, 1e-12))


class Concat2(Layer):
    """ConcatenateLayer2, the projection form of concat_layer: each input
    a Projection, their results concatenated on the feature axis, then an
    optional bias and the activation."""

    type_name = "concat2"

    def __init__(self, input: Sequence[Any], act: act_mod.ActLike = None,
                 bias: bool = False, bias_attr: Optional[ParamAttr] = None,
                 name: Optional[str] = None):
        from paddle_tpu_torch.nn.projections import Projection

        self.projections = []
        srcs: List[Layer] = []
        for p in input:
            if not isinstance(p, Projection):
                raise TypeError("concat2 inputs must be Projections")
            self.projections.append(p)
            srcs.extend(p.sources)
        super().__init__(srcs, name=name)
        self.act = act
        self.bias = bias
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        outs, pos = [], 0
        for proj in self.projections:
            args = ins[pos:pos + len(proj.sources)]
            pos += len(proj.sources)
            outs.append(proj.apply(ctx, self, args, None))
        out = torch.cat(outs, dim=-1)
        if self.bias:
            out = out + ctx.param(self, "b", (out.shape[-1],), init_mod.zeros,
                                  self.bias_attr)
        return ins[0].with_value(act_mod.apply(self.act, out))


class Trans(Layer):
    """TransLayer. With `height`: each row [M*N] viewed as M x N and
    transposed. Without: the whole batch matrix [B, D] -> [D, B] as the
    reference transposes it; shape inference (init mode) keeps [B, D], as
    the reference's config does."""

    type_name = "trans"

    def __init__(self, input: Layer, height: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.height = height

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if self.height is None:
            return ins[0] if ctx.mode == "init" else Argument(x.t())
        b, d = x.shape
        h = self.height
        return ins[0].with_value(x.reshape(b, h, d // h).transpose(1, 2).reshape(b, d))


class RowL2Norm(Layer):
    """Each row divided by its L2 norm, held at least 1e-12 (RowL2NormLayer)."""

    type_name = "row_l2_norm"

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        return ins[0].with_value(x / _l2_norm(x))


class DataNorm(Layer):
    """Feature standardisation with fixed statistics (DataNormLayer):
    z-score (states `mean` 0, `std` 1), min-max (`min` 0, `max` 1) or
    decimal-scaling (`scale` 1). The statistics are states, read and never
    updated: they move across by name and the optimizer never sees them."""

    type_name = "data_norm"

    def __init__(self, input: Layer, strategy: str = "z-score", name: Optional[str] = None):
        super().__init__(input, name=name)
        if strategy not in ("z-score", "min-max", "decimal-scaling"):
            raise ValueError(f"data_norm {name}: unknown strategy {strategy!r}")
        self.strategy = strategy

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        d = x.shape[-1]
        if self.strategy == "z-score":
            mean = ctx.state(self, "mean", (d,), 0.0)
            std = ctx.state(self, "std", (d,), 1.0)
            return ins[0].with_value((x - mean) / torch.clamp_min(std, 1e-12))
        if self.strategy == "min-max":
            mn = ctx.state(self, "min", (d,), 0.0)
            mx = ctx.state(self, "max", (d,), 1.0)
            return ins[0].with_value((x - mn) / torch.clamp_min(mx - mn, 1e-12))
        scale = ctx.state(self, "scale", (d,), 1.0)
        return ins[0].with_value(x / torch.clamp_min(scale, 1e-12))


class Resize(Layer):
    """ResizeLayer: the whole [B, D] buffer read as [B*D/size, size] (batch
    and features trade off); the result carries no lengths."""

    type_name = "resize"

    def __init__(self, input: Layer, size: int, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if x.numel() % self.size:
            raise ValueError(f"resize {self.name}: {tuple(x.shape)} has {x.numel()} "
                             f"elements, not divisible by size={self.size}")
        return Argument(x.reshape(-1, self.size))


class Clip(Layer):
    """Elementwise clip to [min, max] (ClipLayer)."""

    type_name = "clip"

    def __init__(self, input: Layer, min: float, max: float, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.lo, self.hi = min, max

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value(torch.clamp(ins[0].value, self.lo, self.hi))


class ScaleShift(Layer):
    """w * x + b with a learned scalar w (ones) and, with `bias`, a learned
    scalar b (zeros) (ScaleShiftLayer)."""

    type_name = "scale_shift"

    def __init__(self, input: Layer, bias: bool = True,
                 param_attr: Optional[ParamAttr] = None,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.bias = bias
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        y = ctx.param(self, "w", (1,), init_mod.ones, self.param_attr)[0] * ins[0].value
        if self.bias:
            y = y + ctx.param(self, "b", (1,), init_mod.zeros, self.bias_attr)[0]
        return ins[0].with_value(y)


class Multiplex(Layer):
    """Row i of candidate index[i] (MultiplexLayer): inputs [index [B], the
    N candidates [B, D]]. An index reads as `jnp.take_along_axis`' fill
    mode reads it: [-N, 0) counts from the end, anything else outside
    [0, N) gives a row of NaN (no device assert, nothing read back)."""

    type_name = "multiplex"

    def __init__(self, index: Layer, inputs: Sequence[Layer], name: Optional[str] = None):
        super().__init__([index] + list(inputs), name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        stacked = torch.stack([a.value for a in ins[1:]], dim=1)  # [B, N, D]
        n = stacked.shape[1]
        idx = ins[0].value.long().reshape(-1)
        idx = torch.where(idx < 0, idx + n, idx)
        valid = (idx >= 0) & (idx < n)
        rows = torch.gather(stacked, 1, idx.clamp(0, n - 1)[:, None, None]
                            .expand(-1, 1, stacked.shape[-1]))[:, 0]
        return ins[1].with_value(torch.where(valid[:, None], rows,
                                             rows.new_full((), float("nan"))))


class OuterProd(Layer):
    """The row-wise outer product, flattened -> [B, D1*D2] (OuterProdLayer)."""

    type_name = "outer_prod"

    def __init__(self, input1: Layer, input2: Layer, name: Optional[str] = None):
        super().__init__([input1, input2], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        a, b = ins[0].value, ins[1].value
        return ins[0].with_value(torch.einsum("bi,bj->bij", a, b).reshape(a.shape[0], -1))


class ConvShift(Layer):
    """Circular 1-D correlation of each row with a per-row kernel
    (ConvShiftLayer): out[i] = sum_j b[j] * a[(i + j - K//2) mod D]."""

    type_name = "conv_shift"

    def __init__(self, input1: Layer, input2: Layer, name: Optional[str] = None):
        super().__init__([input1, input2], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        a, b = ins[0].value, ins[1].value
        d, k = a.shape[-1], b.shape[-1]
        pos = torch.arange(d, device=a.device)[:, None] + torch.arange(k, device=a.device)
        idx = (pos - k // 2) % d
        return ins[0].with_value(torch.einsum("bdk,bk->bd", a[:, idx], b))


class SumToOneNorm(Layer):
    """Each row divided by its sum, held at least 1e-12 (SumToOneNormLayer)."""

    type_name = "sum_to_one_norm"

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        return ins[0].with_value(x / torch.clamp_min(x.sum(dim=-1, keepdim=True), 1e-12))


class TensorLayer(Layer):
    """The bilinear tensor product out_k = x W_k y^T (TensorLayer), `w`
    [size, Dx, Dy], then an optional bias and the activation."""

    type_name = "tensor"

    def __init__(self, input1: Layer, input2: Layer, size: int,
                 act: act_mod.ActLike = None, bias: bool = True,
                 param_attr: Optional[ParamAttr] = None,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__([input1, input2], name=name)
        self.size = size
        self.act = act
        self.bias = bias
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x, y = ins[0].value, ins[1].value
        w = ctx.param(self, "w", (self.size, x.shape[-1], y.shape[-1]),
                      init_mod.smart_normal, self.param_attr)
        out = torch.einsum("bi,kij,bj->bk", x, w, y)
        if self.bias:
            out = out + ctx.param(self, "b", (self.size,), init_mod.zeros, self.bias_attr)
        return ins[0].with_value(act_mod.apply(self.act, out))


class SelectiveFc(Layer):
    """SelectiveFullyConnectedLayer as the JAX package computes it: the
    whole fc, then only the selected columns kept. With a selection input
    (0/1 [B, size]) and a softmax, the unselected logits are set to -1e9
    first, so the softmax normalises over the selected columns; the output
    is then multiplied by the selection."""

    type_name = "selective_fc"

    def __init__(self, input: Union[Layer, Sequence[Layer]], size: int,
                 act: act_mod.ActLike = None, bias: bool = True,
                 param_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        ins = input if isinstance(input, (list, tuple)) else [input]
        super().__init__(list(ins), name=name)
        self.size = size
        self.act = act
        self.bias = bias
        self.param_attr = _attr(param_attr)
        self.has_select = len(self.inputs) > 1

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        w = ctx.param(self, "w", (x.shape[-1], self.size), init_mod.smart_normal,
                      self.param_attr)
        out = linalg.matmul(x, w, ctx.policy)
        if self.bias:
            out = out + ctx.param(self, "b", (self.size,), init_mod.zeros, None)
        sel = ins[1].value.to(out.dtype) if self.has_select else None
        act_name = self.act if isinstance(self.act, str) else getattr(self.act, "name",
                                                                      self.act)
        if sel is not None and act_name == "softmax":
            out = torch.where(sel > 0, out, torch.full((), -1e9, dtype=out.dtype,
                                                       device=out.device))
        out = act_mod.apply(self.act, out)
        return ins[0].with_value(out if sel is None else out * sel)


# -- the sequence and id layers -----------------------------------------------------


class RowConv(Layer):
    """Lookahead row convolution (RowConvLayer, DeepSpeech2): y[t] =
    sum_{i < context_len} x[t + i] * w[i], per feature, steps past a
    sequence's length read as zeros; then the activation."""

    type_name = "row_conv"

    def __init__(self, input: Layer, context_len: int, act: act_mod.ActLike = None,
                 param_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.context_len = context_len
        self.act = act
        self.param_attr = _attr(param_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        x = arg.value  # [B, T, D]
        t, d = x.shape[1], x.shape[2]
        w = ctx.param(self, "w", (self.context_len, d), init_mod.smart_normal,
                      self.param_attr)
        if arg.lengths is not None:
            x = x * arg.mask(x.dtype)[..., None]
        xp = torch.nn.functional.pad(x, (0, 0, 0, self.context_len - 1))
        windows = torch.stack([xp[:, i:i + t, :] for i in range(self.context_len)], dim=0)
        out = torch.einsum("cbtd,cd->btd", windows, w.to(x.dtype))
        return arg.with_value(act_mod.apply(self.act, out))


class SamplingId(Layer):
    """An id drawn from each row's distribution (SamplingIdLayer): the
    gumbel-max of log(max(p, 1e-30)), the noise -log(-log(u)) of
    `prng.uniform(ctx.next_rng(name), [B, V], tiny, 1)`, as
    `jax.random.categorical` draws it in its default ("low") mode, so the
    ids equal the JAX package's for the same key."""

    type_name = "sampling_id"

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        logits = torch.log(torch.clamp_min(x, 1e-30))
        tiny = torch.finfo(torch.float32).tiny
        key = ctx.next_rng(self.name)
        u = batch_rows(ctx, lambda shape: prng.uniform(key, shape, tiny, 1.0), x.shape)
        gumbel = -torch.log(-torch.log(u))
        ids = torch.argmax(gumbel.to(logits.dtype) + logits, dim=-1)
        return ins[0].with_value(ids.to(torch.int32))


class EosIdCheck(Layer):
    """1.0 where the input id equals `eos_id`, else 0.0 (EosIdCheckLayer)."""

    type_name = "eos_id"

    def __init__(self, input: Layer, eos_id: int, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.eos_id = eos_id

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value((ins[0].value == self.eos_id).to(torch.float32))


_print_sink: Optional[List[Tuple[str, torch.Tensor]]] = None


@contextlib.contextmanager
def captured_prints():
    """Collect the PrintLayer values of a CUDA graph capture: each forward
    under the block copies its value into a buffer of the graph's (a
    captured copy) and appends (format, buffer) to the yielded list;
    `emit_prints` prints them after every replay."""
    global _print_sink
    old, _print_sink = _print_sink, []
    try:
        yield _print_sink
    finally:
        _print_sink = old


def emit_prints(entries: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """Print captured PrintLayer values (after a replay: the copy to the host
    waits for it)."""
    for fmt, value in entries:
        _print_value(fmt, value)


def _print_value(fmt: str, value: torch.Tensor) -> None:
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:  # numpy has no bfloat16
        value = value.float()
    sys.stdout.write(fmt.format(x=value.numpy()) + "\n")


class PrintLayer(Layer):
    """Prints its input and passes it on unchanged (PrintLayer), in the JAX
    package's `jax.debug.print` format ("<message> <value>"), at every
    forward outside init mode (shape inference stays quiet). Eagerly it
    prints at once. Under a CUDA graph capture it cannot read the card, so
    the graph copies the value into a buffer of its own and the step graph
    prints it after each replay (`captured_prints`), once a step."""

    type_name = "print"

    def __init__(self, input: Layer, message: str = "", name: Optional[str] = None):
        super().__init__(input, name=name)
        self.message = message

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        if ctx.mode == "init":
            return ins[0]
        # only the {x} placeholder is a format field
        fmt = (self.message.replace("{", "{{").replace("}", "}}") + " {x}").lstrip()
        x = ins[0].value
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            if _print_sink is None:
                raise RuntimeError(f"print layer {self.name}: a CUDA graph capture "
                                   f"with no print sink (nn.layers.captured_prints)")
            _print_sink.append((fmt, x.detach().clone()))
        else:
            _print_value(fmt, x)
        return ins[0]
