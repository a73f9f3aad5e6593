"""Convolution and pooling, NHWC (counterpart of `paddle_tpu/ops/conv.py`).

The JAX package computes a conv as one XLA conv HLO and pools with
`lax.reduce_window`; neither is a Pallas kernel. Here the conv is cuDNN's
(`F.conv2d`) and pooling is torch's. Activations stay NHWC and conv
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
cuBLAS computes in full f32 with TF32 off."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import dtypes, remat

IntOr2 = Union[int, Tuple[int, int]]
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
