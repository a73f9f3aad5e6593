"""Projections and operators of the mixed layer (counterpart of
`paddle_tpu/nn/projections.py`).

A Projection is a parameterized transform of one source layer (an operator
takes two) whose results the owning `layers.Mixed` sums: `FullMatrix`
(x @ W), `TransposedFullMatrix` (x @ W^T), `Identity` (optionally an
offset slice), `DotMul` (x * w), `Scaling` (a learned scalar), `Table` (an
embedding lookup), `SliceProj` (feature ranges), `Context_` (the sliding
window of `ops/sequence.context_projection`, with learned boundary rows),
`DotMulOperator` (x1 * x2), `ConvProj` (a conv whose filter is a
parameter) and `ConvOperator` (a conv whose filter is another layer's
output, one filter per example), each also as the transposed conv
(`trans=True`). Parameters are named `{mixed}.proj{i}.w` as in the JAX
package, in the same layouts.

Everything here is capturable in the step graph: no host reads, no Python
number that changes between steps."""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import torch

from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer, ParamAttr
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import sequence as seq_ops


class Projection:
    is_operator = False  # operators (Operator.h) append after projections

    def __init__(self, sources: Sequence[Layer], param_attr: Any = None):
        self.sources: List[Layer] = list(sources)
        self.param_attr = (param_attr if isinstance(param_attr, (ParamAttr, type(None)))
                           else ParamAttr(**param_attr))
        self.tag: Optional[str] = None

    def apply(self, ctx: Context, owner: Layer, args: List[Argument], size):
        raise NotImplementedError

    def _pname(self, owner: Layer, base: str) -> str:
        return f"proj{owner.projections.index(self)}.{base}"


class FullMatrix(Projection):
    """x @ W. `size` comes from the projection (full_matrix_projection(
    size=N) inside a size-0 mixed) or from the owning mixed layer."""

    def __init__(self, input: Layer, param_attr: Any = None, size: int = 0):
        super().__init__([input], param_attr)
        self.size = size

    def apply(self, ctx, owner, args, size):
        x = args[0].value
        w = ctx.param(owner, self._pname(owner, "w"), (x.shape[-1], self.size or size),
                      init_mod.smart_normal, self.param_attr)
        return linalg.matmul(x, w, ctx.policy)


class TransposedFullMatrix(Projection):
    """x @ W^T, the weight stored [size, in]."""

    def __init__(self, input: Layer, param_attr: Any = None):
        super().__init__([input], param_attr)

    def apply(self, ctx, owner, args, size):
        x = args[0].value
        w = ctx.param(owner, self._pname(owner, "w"), (size, x.shape[-1]),
                      init_mod.smart_normal, self.param_attr)
        return linalg.matmul(x, w.t(), ctx.policy)


class Identity(Projection):
    """IdentityProjection / IdentityOffsetProjection."""

    def __init__(self, input: Layer, offset: int = 0, size: Optional[int] = None):
        super().__init__([input])
        self.offset = offset
        self.slice_size = size

    def apply(self, ctx, owner, args, size):
        x = args[0].value
        if self.offset or (self.slice_size and self.slice_size != x.shape[-1]):
            end = self.offset + (self.slice_size or size or x.shape[-1])
            return x[..., self.offset:end]
        return x


class DotMul(Projection):
    """Elementwise x * w with a learned w [D] (ones at init)."""

    def __init__(self, input: Layer, param_attr: Any = None):
        super().__init__([input], param_attr)

    def apply(self, ctx, owner, args, size):
        x = args[0].value
        w = ctx.param(owner, self._pname(owner, "w"), (x.shape[-1],), init_mod.ones,
                      self.param_attr)
        return x * w


class Scaling(Projection):
    """One learned scalar times x."""

    def __init__(self, input: Layer, param_attr: Any = None):
        super().__init__([input], param_attr)

    def apply(self, ctx, owner, args, size):
        w = ctx.param(owner, self._pname(owner, "w"), (1,), init_mod.ones,
                      self.param_attr)
        return args[0].value * w[0]


class Table(Projection):
    """Embedding lookup from integer ids, clamped into [0, vocab) as the
    JAX package clips them."""

    def __init__(self, input: Layer, vocab_size: Optional[int] = None,
                 param_attr: Any = None, size: int = 0):
        super().__init__([input], param_attr)
        self.vocab_size = vocab_size
        self.size = size

    def apply(self, ctx, owner, args, size):
        size = self.size or size
        v = args[0].value
        vocab = self.vocab_size
        if not vocab:
            # no id slot declared: the table is as wide as the input
            vocab = int(v.shape[-1]) if v.dim() > 1 else 2
        if v.dim() > 1 and v.is_floating_point():
            v = v[..., 0]  # a dense slot reused as ids: its first column
        ids = v.long().clamp(0, vocab - 1)
        table = ctx.param(owner, self._pname(owner, "w"), (vocab, size),
                          init_mod.smart_normal, self.param_attr)
        return table[ids]


class SliceProj(Projection):
    """Feature (channel) ranges of the input, flattened and concatenated."""

    def __init__(self, input: Layer, slices):
        super().__init__([input])
        self.slices = [tuple(s) for s in slices]

    def apply(self, ctx, owner, args, size):
        x = args[0].value
        out = torch.cat([x[..., s:e] for s, e in self.slices], dim=-1)
        if out.dim() > 2:
            out = out.reshape(out.shape[0], -1)
        return out


class Context_(Projection):
    """ContextProjection: the sliding-window concat over a sequence, with
    learned rows where the window runs off either end when
    `trainable_padding` (zeros otherwise)."""

    def __init__(self, input: Layer, context_start: int, context_len: int,
                 trainable_padding: bool = True, param_attr: Any = None):
        super().__init__([input], param_attr)
        self.context_start = context_start
        self.context_len = context_len
        self.left_pad = max(0, -context_start)
        self.right_pad = max(0, context_start + context_len - 1)
        self.trainable_padding = trainable_padding and (self.left_pad + self.right_pad > 0)

    def apply(self, ctx, owner, args, size):
        arg = args[0]
        if arg.is_seq:
            x, lengths = arg.value, arg.lengths
        else:  # a non-sequence slot reads as sequences of one step
            x = arg.value[:, None]
            lengths = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
        out = seq_ops.context_projection(x, lengths, self.context_start, self.context_len)
        if self.trainable_padding:
            out = out + self._pad_correction(ctx, owner, x, lengths)
        return out if arg.is_seq else out[:, 0]

    def _pad_correction(self, ctx, owner, x, lengths):
        """The learned boundary rows where the window runs off either end
        (the base projection reads zeros there)."""
        b, t, d = x.shape
        lp, rp = self.left_pad, self.right_pad
        w = ctx.param(owner, self._pname(owner, "w"), (lp + rp, d), init_mod.zeros,
                      self.param_attr)
        pos = torch.arange(t, device=x.device)
        zero = torch.zeros((b, t, d), dtype=x.dtype, device=x.device)
        cols = []
        for o in range(self.context_start, self.context_start + self.context_len):
            src = pos + o
            if o < 0 and lp:
                row = (src + lp).clamp(0, lp - 1)
                corr = torch.where((src < 0)[None, :, None], w[row][None], zero)
            elif o > 0 and rp:
                over = src[None, :] >= lengths[:, None]
                row = (lp + src[None, :] - lengths[:, None].long()).clamp(lp, lp + rp - 1)
                corr = torch.where(over[:, :, None], w[row], zero)
            else:
                corr = zero
            cols.append(corr)
        return torch.cat(cols, dim=-1)


class DotMulOperator(Projection):
    """Elementwise product of two inputs, times `scale` (no parameters)."""

    is_operator = True

    def __init__(self, input1: Layer, input2: Layer, scale: float = 1.0):
        super().__init__([input1, input2])
        self.scale = scale

    def apply(self, ctx, owner, args, size):
        return self.scale * args[0].value * args[1].value


def _as_nhwc(x: torch.Tensor, channels: Optional[int]) -> torch.Tensor:
    """A flat [B, c*h*w] CHW input viewed as NHWC (square maps); NHWC
    passes."""
    if x.dim() == 4:
        return x
    side = math.isqrt(x.shape[-1] // channels)
    return x.reshape(x.shape[0], channels, side, side).permute(0, 2, 3, 1)


class ConvProj(Projection):
    """A conv with a parameter filter (HWIO, he_normal) inside a mixed
    layer; the output flattens to [B, -1] in NHWC order, as the JAX
    package's does. With `trans` a transposed conv, its filter
    [kh, kw, num_filters, C] the forward conv's HWIO (as
    `layers.Conv2DTranspose`'s; the groups are not applied, as in the JAX
    package)."""

    def __init__(self, input: Layer, filter_size, num_filters: int,
                 num_channels=None, stride=1, padding=0, groups: int = 1,
                 param_attr: Any = None, trans: bool = False):
        super().__init__([input], param_attr)
        self.filter_size = filter_size
        self.num_filters = num_filters
        self.num_channels = num_channels
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.trans = trans

    def apply(self, ctx, owner, args, size):
        x = _as_nhwc(args[0].value, self.num_channels)
        kh, kw = conv_ops._pair(self.filter_size)
        cin = x.shape[-1]
        shape = ((kh, kw, self.num_filters, cin) if self.trans
                 else (kh, kw, cin // self.groups, self.num_filters))
        w = ctx.param(owner, self._pname(owner, "w"), shape, init_mod.he_normal,
                      self.param_attr)
        if self.trans:
            y = conv_ops.conv2d_transpose(x, w, self.stride, self.padding, ctx.policy)
        else:
            y = conv_ops.conv2d(x, w, self.stride, self.padding, 1, self.groups,
                                ctx.policy)
        return y.reshape(y.shape[0], -1)

    def build(self, name: str) -> Layer:
        """The projection as an img_conv layer (concat_layer's path)."""
        from paddle_tpu_torch.config.v1_layers import img_conv_layer

        return img_conv_layer(
            self.sources[0], self.filter_size, self.num_filters, name=name,
            num_channels=self.num_channels, act="linear", groups=self.groups,
            stride=self.stride, padding=self.padding, bias_attr=False,
            param_attr=self.param_attr, trans=self.trans)


class ConvOperator(Projection):
    """A conv whose filter is another layer's output: example i's image
    convolves with example i's filter [kh, kw, C, F] (one filter row
    broadcasts over the batch); with `trans` the transposed conv, the
    filter [kh, kw, F, C] the forward conv's HWIO. All B convolutions run
    as one grouped conv (groups = B), the batch folded into the channels."""

    is_operator = True

    def __init__(self, img: Layer, filt: Layer, filter_size, num_filters: int,
                 num_channels=None, stride=1, padding=0, trans: bool = False):
        super().__init__([img, filt], None)
        self.filter_size = filter_size
        self.num_filters = num_filters
        self.num_channels = num_channels
        self.stride = stride
        self.padding = padding
        self.trans = trans

    def apply(self, ctx, owner, args, size):
        x = _as_nhwc(args[0].value, self.num_channels)
        b, h, wd, cin = x.shape
        kh, kw = conv_ops._pair(self.filter_size)
        f = self.num_filters
        x_all = x.permute(1, 2, 0, 3).reshape(1, h, wd, b * cin)
        if self.trans:
            w = args[1].value.reshape(-1, kh, kw, f, cin).expand(b, kh, kw, f, cin)
            w_all = w.permute(1, 2, 3, 0, 4).reshape(kh, kw, f, b * cin)
            y = conv_ops.conv2d_transpose(x_all, w_all, self.stride, self.padding,
                                          ctx.policy, groups=b)
        else:
            w = args[1].value.reshape(-1, kh, kw, cin, f).expand(b, kh, kw, cin, f)
            w_all = w.permute(1, 2, 3, 0, 4).reshape(kh, kw, cin, b * f)
            y = conv_ops.conv2d(x_all, w_all, self.stride, self.padding, 1, b,
                                ctx.policy)
        oh, ow = y.shape[1], y.shape[2]
        y = y.reshape(oh, ow, b, f).permute(2, 0, 1, 3)
        return y.reshape(b, -1)
