"""Convolution, pooling and bilinear resizing, NHWC, and the 3-D convolution,
transposed convolution and pooling, NDHWC (counterpart of
`paddle_tpu/ops/conv.py`).

The JAX package computes a conv as one XLA conv HLO, pools with
`lax.reduce_window` and resizes with `jax.image.resize`; none is a Pallas
kernel. Here the conv and the transposed conv are cuDNN's (`F.conv2d`,
`F.conv_transpose2d`), pooling is torch's, and the resize is two small
weight-matrix products. Activations stay NHWC and conv
weights HWIO, as in the reference's state dict: `x.permute(0, 3, 1, 2)` of
a contiguous NHWC tensor is an NCHW view in channels_last strides (no
copy), the weight goes in as channels_last OIHW (one copy, fused with the
policy's cast), and cuDNN then runs NHWC kernels without transposing the
activation. The output comes back channels_last and is permuted to NHWC,
again a view.

Under the f32 policy the reference's convs are `Precision.HIGHEST`. With
TF32 off, cuDNN's forward and input gradient hold f32 on an H100, but for
some shapes its heuristics pick a weight-gradient algorithm that does not
(LeNet's first conv, one input channel: 4.8e-4 relative L2 from the CPU's
on an H100). So an f32 conv on the card takes its weight gradient
from `conv2d_weight_grad`: im2col (`F.unfold`) and an f32 matmul, which
cuBLAS computes in full f32 with TF32 off. The 3-D convs (`F.conv3d`,
`F.conv_transpose3d` on channels_last_3d views of NDHWC activations and
DHWIO weights) keep cuDNN's own gradients, which hold f32 with TF32 off
on an H100, one input channel included.

The 3-D pools take any padding, also asymmetric (the v1 `ceil_mode` output
size): the pad cells are written out (-inf for max, 0 for an average that
divides by the cells inside the volume)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import dtypes, remat

IntOr2 = Union[int, Tuple[int, int]]
IntOr3 = Union[int, Tuple[int, int, int]]
Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 2
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> the NCHW view cuDNN and torch's pools read as
    channels_last."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: IntOr2 = 1,
           padding: IntOr2 = 0, dilation: IntOr2 = 1,
           groups: int = 1, policy: Optional[dtypes.Policy] = None) -> torch.Tensor:
    """x [B, H, W, Cin], w [kh, kw, Cin/groups, Cout] -> [B, H', W', Cout], in
    the policy's compute dtype."""
    p = policy or dtypes.current()
    x = p.cast(x)
    w_oihw = w.permute(3, 2, 0, 1).to(p.compute_dtype,
                                      memory_format=torch.channels_last)
    args = (_pair(stride), _pair(padding), _pair(dilation), groups)
    with remat.name("conv_out"):  # the remat="conv_only" policy saves it
        if x.is_cuda and p.compute_dtype == torch.float32:
            return _nhwc(_Conv2dF32.apply(_nchw(x), w_oihw, *args))
        return _nhwc(F.conv2d(_nchw(x), w_oihw, None, *args))


def conv2d_weight_grad(x: torch.Tensor, dy: torch.Tensor, w_shape: Sequence[int],
                       stride: Tuple[int, int], padding: Tuple[int, int],
                       dilation: Tuple[int, int], groups: int) -> torch.Tensor:
    """The weight gradient of `F.conv2d` (NCHW x and dy, OIHW `w_shape`) as
    im2col and one batched matmul over the groups, in x's dtype."""
    o, cg, kh, kw = w_shape
    b = x.shape[0]
    cols = F.unfold(x, (kh, kw), dilation, padding, stride)  # [B, C*kh*kw, L]
    cols = cols.reshape(b, groups, cg * kh * kw, -1).permute(1, 2, 0, 3)
    dy = dy.reshape(b, groups, o // groups, -1).permute(1, 2, 0, 3)
    dw = torch.matmul(dy.reshape(groups, o // groups, -1),
                      cols.reshape(groups, cg * kh * kw, -1).transpose(1, 2))
    return dw.reshape(o, cg, kh, kw)


class _Conv2dF32(torch.autograd.Function):
    """cuDNN's conv and input gradient; the weight gradient in full f32."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, dilation, groups)
        return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.args
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, dy, stride, padding, dilation,
                                            groups)
        if ctx.needs_input_grad[1]:
            dw = conv2d_weight_grad(x, dy, w.shape, stride, padding, dilation, groups)
        return dx, dw, None, None, None, None


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, stride: IntOr2 = 1,
                     padding: IntOr2 = 0, policy: Optional[dtypes.Policy] = None,
                     groups: int = 1) -> torch.Tensor:
    """The transposed conv: x [B, H, W, Cin], w [kh, kw, Cout/groups, Cin],
    the HWIO weight of the forward conv it transposes (Cout -> Cin
    channels) -> [B, (H-1)*s + kh - 2p, (W-1)*s + kw - 2p, Cout]. The JAX
    package runs the flipped kernel over the input dilated by the stride,
    padded k-1-p; `F.conv_transpose2d` with the forward conv's OIHW weight
    is that same adjoint. `groups` (not in the JAX package's op) serves
    the transposed conv operator, one group an example. On the card in f32
    the weight gradient is im2col + matmul, as `conv2d`'s is."""
    p = policy or dtypes.current()
    x = p.cast(x)
    w_oihw = w.permute(3, 2, 0, 1).to(p.compute_dtype,
                                      memory_format=torch.channels_last)
    args = (_pair(stride), _pair(padding))
    with remat.name("conv_out"):
        if x.is_cuda and p.compute_dtype == torch.float32:
            return _nhwc(_ConvT2dF32.apply(_nchw(x), w_oihw, *args, groups))
        return _nhwc(F.conv_transpose2d(_nchw(x), w_oihw, None, *args, 0, groups))


class _ConvT2dF32(torch.autograd.Function):
    """cuDNN's transposed conv; its input gradient is the forward conv of
    the output gradient, its weight gradient the forward conv's weight
    gradient with the output gradient as the input, in full f32."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, groups)
        return F.conv_transpose2d(x, w, None, stride, padding, 0, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.args
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv2d(dy, w, None, stride, padding, 1, groups)
        if ctx.needs_input_grad[1]:
            dw = conv2d_weight_grad(dy, x, w.shape, stride, padding, (1, 1), groups)
        return dx, dw, None, None, None


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, out_h, out_w, C] as `jax.image.resize(...,
    method="bilinear")` computes it: half-pixel centres, a triangle kernel
    widened by in/out when scaling down (antialiased), each output's
    weights normalised to sum 1. Each resized axis is one weight matrix
    [out, in] built on x's device (no host copy: capturable), applied by
    `einsum`; an axis of unchanged size is left alone, as JAX skips it."""
    if out_h != x.shape[1]:
        x = torch.einsum("bhwc,oh->bowc", x, _resize_weights(x, x.shape[1], out_h))
    if out_w != x.shape[2]:
        x = torch.einsum("bhwc,ow->bhoc", x, _resize_weights(x, x.shape[2], out_w))
    return x


def _resize_weights(x: torch.Tensor, n_in: int, n_out: int) -> torch.Tensor:
    """jax.image's `compute_weight_mat` for the triangle kernel, transposed
    to [out, in], in f32 then cast to x's dtype."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=x.device)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    dist = (sample[:, None] - torch.arange(n_in, **f32)[None, :]).abs() / kernel_scale
    w = torch.clamp_min(1.0 - dist, 0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w)).to(x.dtype)


def pool_pads(padding) -> Pads:
    """padding: int | (ph, pw) | ((top, bottom), (left, right))."""
    if (isinstance(padding, (tuple, list)) and padding
            and isinstance(padding[0], (tuple, list))):
        (pt, pb), (pl, pr) = padding
        return (int(pt), int(pb)), (int(pl), int(pr))
    ph, pw = _pair(padding)
    return (ph, ph), (pw, pw)


def _native_pad(window: Tuple[int, int], pads: Pads) -> Optional[Tuple[int, int]]:
    """Symmetric pads torch's pools take themselves (at most half the
    window), else None: asymmetric pads are written out explicitly."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr and pt <= window[0] // 2 and pl <= window[1] // 2:
        return pt, pl
    return None


def max_pool2d(x: torch.Tensor, window: IntOr2, stride: Optional[IntOr2] = None,
               padding=0) -> torch.Tensor:
    """[B, H, W, C] max pooling; pad cells are -inf (they never win).
    `padding` may be asymmetric ((top, bottom), (left, right)), as the v1
    `ceil_mode` output size asks for."""
    k = _pair(window)
    s = _pair(stride if stride is not None else window)
    pads = pool_pads(padding)
    native = _native_pad(k, pads)
    xc = _nchw(x)
    if native is None:
        (pt, pb), (pl, pr) = pads
        xc = F.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
        native = (0, 0)
    return _nhwc(F.max_pool2d(xc, k, s, native))


def avg_pool2d(x: torch.Tensor, window: IntOr2, stride: Optional[IntOr2] = None,
               padding=0, exclusive: bool = True) -> torch.Tensor:
    """[B, H, W, C] average pooling. `exclusive` divides each window's sum
    by its count of cells inside the image (the reference kernel clips the
    window to the image), else by the window's size."""
    k = _pair(window)
    s = _pair(stride if stride is not None else window)
    pads = pool_pads(padding)
    native = _native_pad(k, pads)
    if native is not None:
        return _nhwc(F.avg_pool2d(_nchw(x), k, s, native,
                                  count_include_pad=not exclusive))
    (pt, pb), (pl, pr) = pads
    xc = F.pad(_nchw(x), (pl, pr, pt, pb))
    summed = F.avg_pool2d(xc, k, s, divisor_override=1)
    if not exclusive:
        return _nhwc(summed / float(k[0] * k[1]))
    ones = F.pad(x.new_ones((1, 1) + tuple(x.shape[1:3])), (pl, pr, pt, pb))
    counts = F.avg_pool2d(ones, k, s, divisor_override=1)
    return _nhwc(summed / counts)


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C]: the mean over H and W, summed in f32 and
    rounded once to x's dtype (as `jnp.mean` of a bf16 array does)."""
    n = x.shape[1] * x.shape[2]
    return (x.sum(dim=(1, 2), dtype=torch.float32) / n).to(x.dtype)


def conv_out_size(in_size: int, k: int, stride: int, pad: int,
                  dilation: int = 1) -> int:
    eff = (k - 1) * dilation + 1
    return (in_size + 2 * pad - eff) // stride + 1


# -- 3-D ------------------------------------------------------------------------


def _triple(v: IntOr3) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return int(v[0]), int(v[1]), int(v[2])
    return int(v), int(v), int(v)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """NDHWC -> the NCDHW view cuDNN reads as channels_last_3d."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1)


def _oidhw(w: torch.Tensor, p: dtypes.Policy) -> torch.Tensor:
    """DHWIO -> OIDHW in the policy's compute dtype, channels_last_3d."""
    return w.permute(4, 3, 0, 1, 2).to(p.compute_dtype, memory_format=torch.channels_last_3d)


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: IntOr3 = 1, padding: IntOr3 = 0,
           dilation: IntOr3 = 1, groups: int = 1,
           policy: Optional[dtypes.Policy] = None) -> torch.Tensor:
    """x [B, D, H, W, Cin], w [kd, kh, kw, Cin/groups, Cout] -> [B, D', H',
    W', Cout], in the policy's compute dtype."""
    p = policy or dtypes.current()
    x = p.cast(x)
    args = (_triple(stride), _triple(padding), _triple(dilation), groups)
    return _ndhwc(F.conv3d(_ncdhw(x), _oidhw(w, p), None, *args))


def conv3d_transpose(x: torch.Tensor, w: torch.Tensor, stride: IntOr3 = 1,
                     padding: IntOr3 = 0,
                     policy: Optional[dtypes.Policy] = None) -> torch.Tensor:
    """The transposed 3-D conv (DeConv3DLayer.cpp): x [B, D, H, W, Cin], w
    [kd, kh, kw, Cout, Cin], the DHWIO weight of the forward conv it
    transposes -> [B, (D-1)*s + kd - 2p, ..., Cout]."""
    p = policy or dtypes.current()
    x = p.cast(x)
    args = (_triple(stride), _triple(padding))
    return _ndhwc(F.conv_transpose3d(_ncdhw(x), _oidhw(w, p), None, *args))


def pool_pads3d(padding):
    """int | (pd, ph, pw) | ((lo, hi) x 3) -> ((lo, hi) x 3)."""
    if (isinstance(padding, (tuple, list)) and padding
            and isinstance(padding[0], (tuple, list))):
        return tuple((int(lo), int(hi)) for lo, hi in padding)
    pd, ph, pw = _triple(padding)
    return (pd, pd), (ph, ph), (pw, pw)


def _pad3d(xc: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (dl, dh), (hl, hh), (wl, wh) = pads
    return F.pad(xc, (wl, wh, hl, hh, dl, dh), value=value)


def max_pool3d(x: torch.Tensor, window: IntOr3, stride: Optional[IntOr3] = None,
               padding=0) -> torch.Tensor:
    """[B, D, H, W, C] max pooling; pad cells are -inf (they never win)."""
    k = _triple(window)
    s = _triple(stride if stride is not None else window)
    xc = _pad3d(_ncdhw(x), pool_pads3d(padding), float("-inf"))
    return _ndhwc(F.max_pool3d(xc, k, s))


def avg_pool3d(x: torch.Tensor, window: IntOr3, stride: Optional[IntOr3] = None,
               padding=0, exclusive: bool = True) -> torch.Tensor:
    """[B, D, H, W, C] average pooling: each window's sum over its cells
    inside the volume when padded (`exclusive`), else over the window."""
    k = _triple(window)
    s = _triple(stride if stride is not None else window)
    pads = pool_pads3d(padding)
    summed = F.avg_pool3d(_pad3d(_ncdhw(x), pads), k, s, divisor_override=1)
    if not (exclusive and any(lo or hi for lo, hi in pads)):
        return _ndhwc(summed / float(k[0] * k[1] * k[2]))
    ones = _pad3d(x.new_ones((1, 1) + tuple(x.shape[1:4])), pads)
    return _ndhwc(summed / F.avg_pool3d(ones, k, s, divisor_override=1))
