"""Core layers (counterpart of `paddle_tpu/nn/layers.py`), the ones the
ported paths use: Data, Fc, Embedding, Concat (seq2seq, CTR), the image
layers of ResNet and LeNet: Conv2D, Pool2D, BatchNorm, Addto, GlobalPool,
Reshape, BlockExpand (OCR's image-to-sequence), Dropout (VGG, on jax's
threefry bits), and the v1 config pipeline's Mixed (the sum of
`nn/projections.py`), SwitchOrder (a flat CHW data slot into NHWC),
MaxId and ErrorClip (a layer's error_clipping_threshold). Image activations are NHWC, conv weights HWIO."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.nn import activations as act_mod
from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer, ParamAttr
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
            out, mean, var = norm_ops.batch_norm_train(x, gamma, beta, self.epsilon)
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
        mask = prng.bernoulli(ctx.next_rng(self.name), keep, x.shape)
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
