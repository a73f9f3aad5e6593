"""The fluid operator registry (counterpart of `paddle_tpu/fluid/ops.py`;
the reference's paddle/operators REGISTER_OP triples). Each op is a
function `fn(ctx, ins, attrs) -> {slot: value}` over torch tensors, keyed
by the reference's op type names and slot names (X/Y/Out,
Input/Filter/Output, Param/Grad/ParamOut...), so programs written against
the reference's op vocabulary run unchanged. The same 102 names as the JAX
package's `OPS`.

No op has a backward of its own: `append_backward` (backward.py) appends
one `backward` op, and the Executor takes the gradient with autograd over
the ops it ran.

What keeps a run capturable as one CUDA graph: no op reads a device value
on the host (shapes only), random ops draw from the context's threefry key
(`core/prng.py`: jax's bits, so dropout masks and uniform draws equal the
JAX package's), `load` is read once per executor signature, and `save`
under a capture copies its value into a buffer of the graph's that the
Executor writes to disk after each replay. The exceptions are decided from
the program's ops (`executor.graphable`): `precision_recall` without a
`class_number` reads its ids' maximum on the host, and the `while` op
(executor.py) its condition."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import dtypes, prng
from paddle_tpu_torch.core.registry import Registry
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.fluid.lod import LoDTensor, SelectedRows

OPS = Registry("fluid op")

Ins = Dict[str, List[Any]]

# 64-bit host dtypes arrive as jax's 32-bit ones (x64 is off in the JAX
# package), so a fed or cast value has the same dtype in both packages
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def torch_dtype(dtype: Any) -> torch.dtype:
    """A numpy / jax / torch dtype (or its name) -> the torch dtype the
    value takes, 64-bit narrowed to 32 as in the JAX package."""
    if isinstance(dtype, torch.dtype):
        return _NARROW.get(dtype, dtype)
    t = torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype
    return _NARROW.get(t, t)


def as_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A fed or initial value (array, scalar or tensor) as a tensor on
    `device`, 64-bit dtypes narrowed to 32."""
    if not isinstance(value, torch.Tensor):
        a = np.asarray(value)
        value = torch.as_tensor(a if a.flags.writeable else a.copy())
    return value.to(device=device, dtype=_NARROW.get(value.dtype, value.dtype))


class OpContext:
    """Per-execution context: the threefry key, the training flag and the
    device new values are made on. `rng` is a [2] key tensor or a function
    that returns one at the first draw (so a run without random ops runs no
    threefry); None is PRNGKey(0). `device=None` means CUDA, resolved when
    an op first makes a tensor from nothing. `consts` holds what `load`
    read once for the Executor's signature; `saves` collects the values a
    `save` under a CUDA graph capture copies for the Executor to write;
    `leaves` holds the parameters' autograd leaves of a run with a
    `backward` op."""

    def __init__(self, rng: Union[None, torch.Tensor, Callable[[], torch.Tensor]] = None,
                 train: bool = True, device: DeviceLike = None,
                 consts: Optional[Dict[str, torch.Tensor]] = None,
                 saves: Optional[List[tuple]] = None):
        self._rng = rng
        self._count = 0
        self.train = train
        self._device = device
        self.consts = consts
        self.saves = saves
        self.leaves: Dict[str, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        if not isinstance(self._device, torch.device):
            self._device = resolve_device(self._device)
        return self._device

    @property
    def rng(self) -> torch.Tensor:
        if self._rng is None:
            self._rng = prng.PRNGKey(0, self.device)
        elif callable(self._rng):
            self._rng = self._rng()
        return self._rng

    def next_rng(self) -> torch.Tensor:
        self._count += 1
        return prng.fold_in(self.rng, self._count)


def op(name: str, **meta):
    def deco(fn):
        fn.op_meta = meta
        OPS.register(name)(fn)
        return fn

    return deco


def _one(ins: Ins, slot: str):
    v = ins.get(slot, [])
    return v[0] if v else None


def _bcast(x, y, axis: int):
    """The reference's elementwise broadcast: Y's shape must match a
    contiguous suffix/infix of X starting at `axis` (elementwise_op.h)."""
    if axis == -1 or x.ndim == y.ndim:
        return y
    shape = [1] * x.ndim
    for i, d in enumerate(y.shape):
        shape[axis + i] = d
    return y.reshape(shape)


def _float(x: torch.Tensor) -> torch.Tensor:
    """jnp's promotion of an integer input to a float op: float32."""
    return x if x.is_floating_point() else x.float()


# -- elementwise ------------------------------------------------------------

for _nm, _f in [
    ("elementwise_add", torch.add), ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul), ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum), ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
]:
    def _mk(f):
        def fn(ctx, ins, attrs):
            x, y = _one(ins, "X"), _one(ins, "Y")
            return {"Out": f(x, _bcast(x, y, attrs.get("axis", -1)))}
        return fn
    op(_nm)(_mk(_f))


# -- activations ------------------------------------------------------------

for _nm, _f in [
    ("relu", torch.relu), ("sigmoid", torch.sigmoid), ("tanh", torch.tanh),
    ("sqrt", torch.sqrt), ("abs", torch.abs), ("exp", torch.exp), ("log", torch.log),
    ("square", torch.square), ("reciprocal", lambda x: 1.0 / x),
    ("softsign", lambda x: x / (1 + torch.abs(x))),
    ("soft_relu", lambda x: torch.log1p(torch.exp(torch.clamp(x, -40, 40)))),
]:
    def _mka(f):
        def fn(ctx, ins, attrs):
            return {"Y": f(_one(ins, "X"))}
        return fn
    op(_nm)(_mka(_f))


@op("brelu")
def _brelu(ctx, ins, attrs):
    return {"Y": torch.clamp(_one(ins, "X"), attrs.get("t_min", 0.0),
                             attrs.get("t_max", 24.0))}


@op("leaky_relu")
def _leaky(ctx, ins, attrs):
    a = attrs.get("alpha", 0.02)
    x = _one(ins, "X")
    return {"Y": torch.where(x >= 0, x, a * x)}


# -- linear algebra ---------------------------------------------------------


@op("mul")
def _mul(ctx, ins, attrs):
    """X [flattened to 2D at x_num_col_dims] @ Y (mul_op.cc)."""
    x, y = _one(ins, "X"), _one(ins, "Y")
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xd])), -1)
    y2 = y.reshape(int(np.prod(ys[:yd])), -1)
    return {"Out": (x2 @ y2).reshape(xs[:xd] + ys[yd:])}


@op("matmul")
def _matmul(ctx, ins, attrs):
    x, y = _one(ins, "X"), _one(ins, "Y")
    if attrs.get("transpose_X"):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y"):
        y = y.transpose(-1, -2)
    return {"Out": x @ y}


# -- shape ops --------------------------------------------------------------


@op("reshape")
def _reshape(ctx, ins, attrs):
    return {"Out": _one(ins, "X").reshape(attrs["shape"])}


@op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": _one(ins, "X").permute(*attrs["axis"])}


@op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@op("split")
def _split(ctx, ins, attrs):
    x = _one(ins, "X")
    axis = attrs.get("axis", 0)
    if "sections" in attrs and attrs["sections"]:
        parts = torch.split(x, list(attrs["sections"]), dim=axis)
    else:
        num = attrs["num"]
        if x.shape[axis] % num:
            raise ValueError(f"split: axis {axis} of size {x.shape[axis]} does not "
                             f"divide into {num} equal parts")
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(parts)}


@op("slice")
def _slice(ctx, ins, attrs):
    x = _one(ins, "X")
    sl = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        sl[ax] = slice(st, en)
    return {"Out": x[tuple(sl)]}


@op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": _one(ins, "X").to(torch_dtype(attrs["dtype"]))}


@op("scale")
def _scale(ctx, ins, attrs):
    return {"Out": _one(ins, "X") * attrs.get("scale", 1.0)}


# -- reductions / metrics ---------------------------------------------------


@op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": torch.mean(_float(_one(ins, "X")))}


@op("sum")
def _sum(ctx, ins, attrs):
    out = ins["X"][0]
    for x in ins["X"][1:]:
        out = out + x
    return {"Out": out}


def _reduce(fn, x, attrs):
    dim = attrs.get("dim")
    keep = attrs.get("keep_dim", False)
    if dim is None:
        out = fn(x)
        return out.reshape((1,) * x.ndim) if keep else out
    return fn(x, dim=dim, keepdim=keep)


@op("reduce_sum")
def _rsum(ctx, ins, attrs):
    return {"Out": _reduce(torch.sum, _one(ins, "X"), attrs)}


@op("reduce_mean")
def _rmean(ctx, ins, attrs):
    return {"Out": _reduce(torch.mean, _float(_one(ins, "X")), attrs)}


def top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: values and int32 indices, the lower
    index first among equal values (a stable descending sort; torch.topk
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


@op("top_k")
def _topk(ctx, ins, attrs):
    vals, idx = top_k(_one(ins, "X"), attrs.get("k", 1))
    return {"Out": vals, "Indices": idx}


@op("accuracy")
def _accuracy(ctx, ins, attrs):
    """Top-k accuracy: label anywhere in the Indices columns counts
    (accuracy_op semantics)."""
    pred = _one(ins, "Indices")
    if pred is None:
        pred = _one(ins, "Out")
    label = _one(ins, "Label").reshape(-1)
    if pred.ndim == 1:
        pred = pred[:, None]
    hit = torch.any(pred == label[:, None], dim=-1)
    return {"Accuracy": torch.mean(hit.to(torch.float32))}


# -- nn ---------------------------------------------------------------------


@op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Y": torch.softmax(_one(ins, "X"), dim=-1)}


def _pick(x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """x[i, label[i]] as an [N, 1] column (take_along_axis)."""
    return torch.gather(x, -1, label.reshape(-1).long()[:, None])


@op("cross_entropy")
def _xent(ctx, ins, attrs):
    x = _one(ins, "X")  # probabilities [N, C] (the reference takes probs)
    label = _one(ins, "Label")
    if attrs.get("soft_label"):
        return {"Y": -torch.sum(label * torch.log(torch.clamp_min(x, 1e-20)), -1,
                                keepdim=True)}
    return {"Y": -torch.log(torch.clamp_min(_pick(x, label), 1e-20))}


@op("softmax_with_cross_entropy")
def _smxent(ctx, ins, attrs):
    logp = torch.log_softmax(_one(ins, "Logits"), dim=-1)
    return {"Loss": -_pick(logp, _one(ins, "Label")), "Softmax": torch.exp(logp)}


@op("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW conv with an OIHW filter (conv_op.cc), through the port's f32
    conv (`ops/conv.conv2d`, NHWC / HWIO inside: cuDNN's forward and input
    gradient, the weight gradient in full f32 on the card)."""
    from paddle_tpu_torch.ops import conv as conv_ops

    x = _one(ins, "Input")
    w = _one(ins, "Filter")  # [O, I/g, kH, kW]
    out = conv_ops.conv2d(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                          tuple(attrs.get("strides", [1, 1])),
                          tuple(attrs.get("paddings", [0, 0])),
                          tuple(attrs.get("dilations", [1, 1])),
                          attrs.get("groups", 1), policy=dtypes.f32_policy())
    return {"Output": out.permute(0, 3, 1, 2)}


@op("pool2d")
def _pool2d(ctx, ins, attrs):
    """reduce_window pooling, NCHW: max pads with -inf, the average divides
    every window by its full size (padding included)."""
    x = _one(ins, "X")
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", ksize))
    pads = list(attrs.get("paddings", [0, 0]))
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling"):
        ksize = list(x.shape[2:])
        strides, pads = ksize, [0, 0]
    spec = (pads[1], pads[1], pads[0], pads[0])
    if ptype == "max":
        out = F.max_pool2d(F.pad(x, spec, value=float("-inf")), ksize, strides)
    else:
        out = F.avg_pool2d(F.pad(x, spec), ksize, strides)
    return {"Out": out}


@op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    x = _one(ins, "X")  # NCHW or NC
    scale, bias = _one(ins, "Scale"), _one(ins, "Bias")
    mean, var = _one(ins, "Mean"), _one(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axes = tuple(i for i in range(x.ndim) if i != 1)
    shape = [1, -1] + [1] * (x.ndim - 2)
    if ctx.train and not attrs.get("is_test", False):
        bm = torch.mean(x, dim=axes)
        bv = torch.var(x, dim=axes, correction=0)
        y = (x - bm.reshape(shape)) / torch.sqrt(bv.reshape(shape) + eps)
        return {"Y": y * scale.reshape(shape) + bias.reshape(shape),
                "MeanOut": momentum * mean + (1 - momentum) * bm,
                "VarianceOut": momentum * var + (1 - momentum) * bv,
                "SavedMean": bm, "SavedVariance": bv}
    y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    return {"Y": y * scale.reshape(shape) + bias.reshape(shape),
            "MeanOut": mean, "VarianceOut": var,
            "SavedMean": mean, "SavedVariance": var}


@op("dropout")
def _dropout(ctx, ins, attrs):
    x = _one(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    if not ctx.train or attrs.get("is_test", False) or p == 0.0:
        return {"Out": x, "Mask": torch.ones_like(x)}
    keep = prng.bernoulli(ctx.next_rng(), 1.0 - p, tuple(x.shape))
    mask = keep.to(x.dtype) / (1.0 - p)
    return {"Out": x * mask, "Mask": mask}


@op("lookup_table")
def _lookup(ctx, ins, attrs):
    w = _one(ins, "W")
    ids = _one(ins, "Ids")
    # the reference feeds ids as [N, 1] (LoD column); squeeze only that case
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return {"Out": w[ids.long()]}


@op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    x = _one(ins, "X")
    scale, bias = _one(ins, "Scale"), _one(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) / torch.sqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return {"Y": y, "Mean": mu.squeeze(-1), "Variance": var.squeeze(-1)}


# -- fills / random ---------------------------------------------------------


@op("fill_constant")
def _fill(ctx, ins, attrs):
    return {"Out": torch.full(tuple(attrs["shape"]), attrs.get("value", 0.0),
                              dtype=torch_dtype(attrs.get("dtype", np.float32)),
                              device=ctx.device)}


@op("uniform_random")
def _uniform(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": prng.uniform(ctx.next_rng(), tuple(attrs["shape"]), lo, hi)}


@op("gaussian_random")
def _gauss(ctx, ins, attrs):
    return {"Out": attrs.get("mean", 0.0) + attrs.get("std", 1.0)
            * prng.normal(ctx.next_rng(), tuple(attrs["shape"]))}


# -- control-flow helpers ---------------------------------------------------


@op("less_than")
def _less(ctx, ins, attrs):
    return {"Out": _one(ins, "X") < _one(ins, "Y")}


@op("increment")
def _incr(ctx, ins, attrs):
    return {"Out": _one(ins, "X") + attrs.get("step", 1.0)}


# -- optimizer ops (sgd_op.cc, momentum_op.cc, adam_op.cc ...) --------------


@op("sgd")
def _sgd(ctx, ins, attrs):
    p, g, lr = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "LearningRate")
    return {"ParamOut": p - lr * g}


@op("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Velocity")
    lr = _one(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov"):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@op("adam")
def _adam(ctx, ins, attrs):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    m, v = _one(ins, "Moment1"), _one(ins, "Moment2")
    b1p, b2p = _one(ins, "Beta1Pow"), _one(ins, "Beta2Pow")
    lr = _one(ins, "LearningRate")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    mhat = m_new / (1 - b1p)
    vhat = v_new / (1 - b2p)
    p_new = p - lr * mhat / (torch.sqrt(vhat) + eps)
    return {"ParamOut": p_new, "Moment1Out": m_new, "Moment2Out": v_new,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@op("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, mom = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate")
    eps = attrs.get("epsilon", 1e-6)
    mom_new = mom + g * g
    return {"ParamOut": p - lr * g / (torch.sqrt(mom_new) + eps),
            "MomentOut": mom_new}


@op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    ms, mom = _one(ins, "MeanSquare"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate")
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new, "MomentOut": mom_new}


# -- the remaining reference operator families (paddle/operators/*.cc):
# elementwise/math, losses, sparse/sequence/LoD, rnn units, more
# optimizers. Control flow (cond/while/recurrent) lives in the Executor,
# which owns the sub-blocks.


@op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": _one(ins, "X") - _one(ins, "Y")}


@op("sign")
def _sign(ctx, ins, attrs):
    return {"Out": torch.sign(_one(ins, "X"))}


@op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": torch.clamp(_one(ins, "X"), attrs.get("min"), attrs.get("max"))}


@op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Y": torch.zeros_like(_one(ins, "X"))}


@op("fill_constant_batch_size_like")
def _fill_cbsl(ctx, ins, attrs):
    x = _one(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = x.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(shape, attrs.get("value", 0.0),
                              dtype=torch_dtype(attrs.get("dtype", np.float32)),
                              device=x.device)}


@op("gather")
def _gather(ctx, ins, attrs):
    return {"Out": _one(ins, "X")[_one(ins, "Index").long()]}


@op("scatter")
def _scatter(ctx, ins, attrs):
    ref, idx, upd = _one(ins, "Ref"), _one(ins, "Index"), _one(ins, "Updates")
    return {"Out": torch.index_put(ref, (idx.long(),), upd, accumulate=True)}


@op("multiplex")
def _multiplex(ctx, ins, attrs):
    idx = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)  # [N, B, D]
    return {"Out": stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]}


@op("pad")
def _pad(ctx, ins, attrs):
    x = _one(ins, "X")
    p = attrs["paddings"]  # flat [lo0, hi0, lo1, hi1, ...]
    spec = []
    for i in reversed(range(x.ndim)):  # F.pad takes the last axis first
        spec += [int(p[2 * i]), int(p[2 * i + 1])]
    return {"Out": F.pad(x, spec, value=attrs.get("pad_value", 0.0))}


@op("crop")
def _crop(ctx, ins, attrs):
    x = _one(ins, "X")
    offsets = attrs.get("offsets", [0] * x.ndim)
    shape = attrs.get("shape") or _one(ins, "Y").shape
    sl = tuple(slice(int(o), int(o) + int(s)) for o, s in zip(offsets, shape))
    return {"Out": x[sl]}


@op("prelu")
def _prelu(ctx, ins, attrs):
    x, alpha = _one(ins, "X"), _one(ins, "Alpha")
    return {"Out": torch.where(x > 0, x, alpha * x)}


@op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    x, y = _one(ins, "X"), _one(ins, "Y")  # [B, M], [B, N] (N odd, N<=M)
    n = y.shape[1]
    half = n // 2
    m = x.shape[1]
    dev = x.device
    idx = (torch.arange(m, device=dev)[:, None]
           + torch.arange(-half, half + 1, device=dev)[None, :]) % m
    return {"Out": torch.einsum("bmn,bn->bm", x[:, idx], y)}


@op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    x, y = _one(ins, "X"), _one(ins, "Y")
    nx = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    ny = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    out = torch.sum(x * y, -1, keepdim=True) / torch.clamp_min(nx * ny, 1e-12)
    return {"Out": out, "XNorm": nx, "YNorm": ny}


@op("lrn")
def _lrn(ctx, ins, attrs):
    x = _one(ins, "X")  # NCHW: channels on axis 1
    n = attrs.get("n", 5)
    alpha, beta, k = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75), attrs.get("k", 2.0)
    half = n // 2
    spec = [0, 0] * (x.ndim - 2) + [half, half]
    padded = F.pad(torch.square(x), spec)
    acc = sum(padded.narrow(1, i, x.shape[1]) for i in range(n))
    mid = k + alpha * acc
    return {"Out": x / torch.pow(mid, beta), "MidOut": mid}


@op("pool_with_index")
def _pool_with_index(ctx, ins, attrs):
    """Max pooling with the argmax's flat index (row * W + col) into each
    channel's input map, the first maximum of a window winning."""
    x = _one(ins, "X")  # NCHW
    ks, st = attrs["ksize"], attrs.get("strides", attrs["ksize"])
    b, c, h, w = x.shape
    oh = (h - ks[0]) // st[0] + 1
    ow = (w - ks[1]) // st[1] + 1
    dev = x.device
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    ii = (ar(oh) * st[0])[:, None, None, None] + ar(ks[0])[None, None, :, None]
    jj = (ar(ow) * st[1])[None, :, None, None] + ar(ks[1])[None, None, None, :]
    win = x[:, :, ii, jj]  # [B, C, oh, ow, kh, kw]
    flat = win.reshape(b, c, oh, ow, -1)
    arg = flat.argmax(-1)
    out = torch.gather(flat, -1, arg[..., None])[..., 0]
    ki, kj = arg // ks[1], arg % ks[1]
    rows = (ar(oh) * st[0])[None, None, :, None] + ki
    cols = (ar(ow) * st[1])[None, None, None, :] + kj
    return {"Out": out, "Mask": (rows * w + cols).to(torch.int32)}


# -- losses -----------------------------------------------------------------


@op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    x, y = _one(ins, "X"), _one(ins, "Y")
    d = attrs.get("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    return {"Out": torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d)), "Residual": r}


@op("modified_huber_loss")
def _modified_huber_loss(ctx, ins, attrs):
    x, y = _one(ins, "X"), _one(ins, "Y")  # y in {0,1}
    s = 2.0 * y - 1.0
    m = x.reshape(s.shape) * s
    out = torch.where(m < -1, -4.0 * m, torch.square(torch.clamp_min(1.0 - m, 0.0)))
    return {"Out": out.reshape(x.shape), "IntermediateVal": m.reshape(x.shape)}


def _softplus0(d: torch.Tensor) -> torch.Tensor:
    """logaddexp(0, d)."""
    return torch.logaddexp(torch.zeros_like(d), d)


@op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    lab = _one(ins, "Label")
    d = _one(ins, "Left") - _one(ins, "Right")
    return {"Out": _softplus0(d) - lab * d}


@op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    lab = _one(ins, "Label")
    x1, x2 = _one(ins, "X1"), _one(ins, "X2")
    margin = attrs.get("margin", 0.0)
    act = torch.clamp_min(-lab * (x1 - x2) + margin, 0.0)
    return {"Out": act, "Activated": (act > 0).to(x1.dtype)}


@op("smooth_l1_loss")
def _smooth_l1_loss(ctx, ins, attrs):
    x, y = _one(ins, "X"), _one(ins, "Y")
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    iw, ow = _one(ins, "InsideWeight"), _one(ins, "OutsideWeight")
    if iw is not None:
        d = d * iw
    a = torch.abs(d)
    val = torch.where(a < 1.0 / s2, 0.5 * s2 * d * d, a - 0.5 / s2)
    if ow is not None:
        val = val * ow
    return {"Out": val.reshape(x.shape[0], -1).sum(-1, keepdim=True), "Diff": d}


@op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    d = _one(ins, "X") - _one(ins, "Y")
    return {"Out": torch.sum(torch.square(d), -1, keepdim=True), "sub_result": d}


@op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": torch.sum(torch.square(_one(ins, "X"))).reshape(1)}


@op("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": torch.sum(torch.abs(_one(ins, "X"))).reshape(1)}


@op("sigmoid_cross_entropy_with_logits")
def _sce_logits(ctx, ins, attrs):
    x, lab = _one(ins, "X"), _one(ins, "Label")
    return {"Out": torch.clamp_min(x, 0) - x * lab + _softplus0(-torch.abs(x))}


@op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    """The negative log-likelihood of the label path (`ops/crf.crf_nll`,
    the packed [C+2, C] start / end / transition weights) in the
    `LogLikelihood` slot, as the reference's op emits it for a cost. The
    JAX package's op calls `crf_log_likelihood`, a name its `ops/crf.py`
    does not have (ROADMAP.md §3 fault 17)."""
    from paddle_tpu_torch.ops import crf as crf_ops

    emission, transition = _one(ins, "Emission"), _one(ins, "Transition")
    label = _one(ins, "Label")
    # packed single-sequence form: [T, n_tags] emission, [T] labels
    em = emission[None] if emission.ndim == 2 else emission
    lb = label.reshape(1, -1) if label.ndim <= 1 else label
    lengths = torch.full((em.shape[0],), em.shape[1], dtype=torch.int32, device=em.device)
    return {"LogLikelihood": crf_ops.crf_nll(em, lengths, lb, transition)}


# -- rnn units --------------------------------------------------------------


@op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    x, c_prev = _one(ins, "X"), _one(ins, "C_prev")  # x: [B, 4H]
    f_bias = attrs.get("forget_bias", 0.0)
    i, f, o, j = torch.chunk(x, 4, dim=-1)
    c = c_prev * torch.sigmoid(f + f_bias) + torch.sigmoid(i) * torch.tanh(j)
    h = torch.tanh(c) * torch.sigmoid(o)
    return {"C": c, "H": h}


@op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    from paddle_tpu_torch.ops import rnn as rnn_ops

    x, h_prev = _one(ins, "Input"), _one(ins, "HiddenPrev")  # x: [B, 3H]
    w, b = _one(ins, "Weight"), _one(ins, "Bias")
    hdim = h_prev.shape[-1]
    if b is not None:
        x = x + b.reshape(1, -1)
    p = rnn_ops.GruParams(w_hzr=w[:, : 2 * hdim], w_hc=w[:, 2 * hdim:],
                          bias=torch.zeros((3 * hdim,), dtype=x.dtype, device=x.device))
    return {"Hidden": rnn_ops.gru_step(x, h_prev, p)}


@op("lstm")
def _lstm(ctx, ins, attrs):
    """Whole-sequence LSTM over a padded [B, T, 4H] projection (lstm_op.cc).
    The reference's op emits the FULL cell-state sequence in 'Cell', so
    `lstm_scan(return_cell_seq=True)` takes the step loop, as the JAX
    package's `lax.scan`; no recurrent kernel runs."""
    from paddle_tpu_torch.ops import rnn as rnn_ops

    proj = _one(ins, "Input")
    w, b = _one(ins, "Weight"), _one(ins, "Bias")
    hdim = proj.shape[-1] // 4
    lengths = _one(ins, "SeqLengths")
    steps = torch.arange(proj.shape[1], device=proj.device)
    mask = (steps[None, :] < lengths[:, None] if lengths is not None
            else torch.ones(proj.shape[:2], device=proj.device)).to(proj.dtype)
    p = rnn_ops.LstmParams(w_hh=w, bias=b if b is not None else
                           torch.zeros((4 * hdim,), dtype=proj.dtype, device=proj.device))
    hs, cs, h_last = rnn_ops.lstm_scan(proj, mask, p, reverse=attrs.get("is_reverse", False),
                                       return_cell_seq=True)
    return {"Hidden": hs, "Cell": cs, "LastH": h_last}


@op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    from paddle_tpu_torch.ops import conv as conv_ops

    x, w = _one(ins, "Input"), _one(ins, "Filter")  # NCHW, [Cin, Cout, kh, kw]
    out = conv_ops.conv2d_transpose(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                                    tuple(attrs.get("strides", [1, 1])),
                                    tuple(attrs.get("paddings", [0, 0])),
                                    policy=dtypes.f32_policy())
    return {"Output": out.permute(0, 3, 1, 2)}


# -- sequence / LoD ops ------------------------------------------------------


def _lod_of(x) -> LoDTensor:
    if not isinstance(x, LoDTensor):
        raise TypeError(f"sequence op needs a LoDTensor input, got {type(x).__name__}")
    return x


def segment_sum(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """jax.ops.segment_sum: rows of `data` added into n segments."""
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, seg, data)


def segment_max(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """jax.ops.segment_max: an empty segment holds -inf."""
    out = torch.full((n,) + tuple(data.shape[1:]), float("-inf"), dtype=data.dtype,
                     device=data.device)
    idx = seg.reshape((-1,) + (1,) * (data.ndim - 1)).expand(data.shape)
    return out.scatter_reduce(0, idx, data, "amax")


@op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    x = _lod_of(_one(ins, "X"))
    seg = x.segment_ids()
    n_seq = x.num_sequences
    pt = attrs.get("pooltype", attrs.get("pool_type", "AVERAGE")).upper()
    data = x.data
    off = torch.as_tensor(x.lod[-1], device=data.device).long()
    if pt in ("SUM", "AVERAGE", "SQRT"):
        out = segment_sum(data, seg, n_seq)
        if pt != "SUM":
            cnt = segment_sum(torch.ones((data.shape[0],), device=data.device), seg, n_seq)
            cnt = torch.clamp_min(cnt, 1.0)
            out = out / (cnt if pt == "AVERAGE" else torch.sqrt(cnt))[:, None]
    elif pt == "MAX":
        out = segment_max(data, seg, n_seq)
    elif pt == "LAST":
        out = data[torch.clamp_min(off[1:] - 1, 0)]
    elif pt == "FIRST":
        out = data[off[:-1]]
    else:
        raise ValueError(f"sequence_pool: unknown pooltype {pt}")
    return {"Out": out}


@op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    x = _lod_of(_one(ins, "X"))
    seg = x.segment_ids()
    n = x.num_sequences
    v = x.data.reshape(-1)
    e = torch.exp(v - segment_max(v, seg, n)[seg])
    den = segment_sum(e, seg, n)
    return {"Out": LoDTensor((e / den[seg]).reshape(x.data.shape), x.lod)}


@op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    """Concat same-#sequences LoD tensors along time (sequence_concat_op.cc
    axis=0 level=0): result sequence i = concat of every input's sequence
    i. The output row of each input row is computed from the lod offsets
    and written with one scatter (the total row count is static)."""
    xs = [_lod_of(v) for v in ins["X"]]
    dev = xs[0].data.device
    lens = [x.seq_lengths().to(dev) for x in xs]  # each [S]
    new_lens = sum(lens[1:], lens[0])
    new_off = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(new_lens, 0).to(torch.int32)])
    total = sum(int(x.data.shape[0]) for x in xs)
    out = torch.zeros((total,) + tuple(xs[0].data.shape[1:]), dtype=xs[0].data.dtype,
                      device=dev)
    prior = torch.zeros_like(lens[0])  # lengths already placed per sequence
    for x, ln in zip(xs, lens):
        seg = x.segment_ids()
        off = torch.as_tensor(x.lod[-1], device=dev)
        local = torch.arange(x.data.shape[0], device=dev) - off[seg]
        target = (new_off[seg] + prior[seg] + local).long()
        out = out.index_put((target,), x.data)
        prior = prior + ln
    return {"Out": LoDTensor(out, (new_off,))}


@op("seq_expand")
def _seq_expand(ctx, ins, attrs):
    """seq_expand_op.cc: repeat each row/sequence of X to match Y's lod."""
    x, y = _one(ins, "X"), _lod_of(_one(ins, "Y"))
    data = x.data if isinstance(x, LoDTensor) else x
    return {"Out": LoDTensor(data[y.segment_ids()], y.lod)}


@op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window projection over each sequence (sequence_conv_op.cc):
    im2col with context_length rows around each position, then a GEMM."""
    x = _lod_of(_one(ins, "X"))
    w = _one(ins, "Filter")  # [ctx_len * D, M]
    ctx_len = attrs.get("contextLength", attrs.get("context_length", 3))
    start = attrs.get("contextStart", attrs.get("context_start", -(ctx_len // 2)))
    data = x.data
    n = data.shape[0]
    seg = x.segment_ids()
    idx = torch.arange(n, device=data.device)
    cols = []
    for o in range(ctx_len):
        j = idx + start + o
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        same = seg[jc] == seg  # stay inside the sequence
        cols.append(torch.where((valid & same)[:, None], data[jc], 0.0))
    return {"Out": LoDTensor(torch.cat(cols, -1) @ w, x.lod)}


# -- sparse (SelectedRows) ---------------------------------------------------


@op("sgd_sparse")
def _sgd_sparse(ctx, ins, attrs):
    """SGD taking a SelectedRows gradient (sgd_op.cc's SelectedRows
    branch): scatter-add the rows scaled by -lr, duplicates adding up."""
    p, g, lr = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "LearningRate")
    if not isinstance(g, SelectedRows):
        raise TypeError(f"sgd_sparse needs a SelectedRows gradient, got {type(g).__name__}")
    return {"ParamOut": torch.index_put(p, (g.rows.long(),), -lr * g.value,
                                        accumulate=True)}


# -- more optimizers ---------------------------------------------------------


@op("adamax")
def _adamax(ctx, ins, attrs):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    m, u = _one(ins, "Moment"), _one(ins, "InfNorm")
    lr, b1pow = _one(ins, "LearningRate"), _one(ins, "Beta1Pow")
    b1, b2, eps = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999), attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    u_new = torch.maximum(b2 * u, torch.abs(g))
    p_new = p - (lr / (1 - b1pow)) * m_new / (u_new + eps)
    return {"ParamOut": p_new, "MomentOut": m_new, "InfNormOut": u_new}


@op("adadelta")
def _adadelta(ctx, ins, attrs):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    avg_sq, avg_upd = _one(ins, "AvgSquaredGrad"), _one(ins, "AvgSquaredUpdate")
    rho, eps = attrs.get("rho", 0.95), attrs.get("epsilon", 1e-6)
    sq = rho * avg_sq + (1 - rho) * g * g
    upd = torch.sqrt(avg_upd + eps) / torch.sqrt(sq + eps) * g
    return {
        "ParamOut": p - upd,
        "AvgSquaredGradOut": sq,
        "AvgSquaredUpdateOut": rho * avg_upd + (1 - rho) * upd * upd,
    }


@op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g, m = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate")
    decay, eps = attrs.get("decay", 0.95), attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    return {"ParamOut": p - lr * g / (torch.sqrt(m_new) + eps), "MomentOut": m_new}


def _shrink(prox: torch.Tensor, t: torch.Tensor, l1: float, l2: float) -> torch.Tensor:
    return torch.sign(prox) * torch.clamp_min(torch.abs(prox) - t * l1, 0.0) / (1.0 + t * l2)


@op("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    p, g, lr = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "LearningRate")
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    return {"ParamOut": _shrink(p - lr * g, lr, l1, l2)}


@op("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    p, g, m = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate")
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    m_new = m + g * g
    alr = lr / torch.sqrt(m_new + 1e-12)
    return {"ParamOut": _shrink(p - alr * g, alr, l1, l2), "MomentOut": m_new}


@op("auc")
def _auc(ctx, ins, attrs):
    """Discretized AUC over 1024 bins, on the device (the reference op is
    batch-local too)."""
    out, lab = _one(ins, "Out"), _one(ins, "Label")
    p = out[:, 1] if out.ndim == 2 and out.shape[1] == 2 else out.reshape(-1)
    y = lab.reshape(-1)
    bins = 1024
    idx = torch.clamp((p * bins).to(torch.int32), 0, bins - 1).long()
    zeros = torch.zeros(bins, device=p.device)
    pos = zeros.index_add(0, idx, (y == 1).to(torch.float32))
    neg = zeros.index_add(0, idx, (y != 1).to(torch.float32))
    tp = torch.cumsum(pos.flip(0), 0)
    fp = torch.cumsum(neg.flip(0), 0)
    zero = torch.zeros(1, device=p.device)
    tpr = torch.cat([zero, tp / torch.clamp_min(tp[-1], 1.0)])
    fpr = torch.cat([zero, fp / torch.clamp_min(fp[-1], 1.0)])
    return {"AUC": torch.trapezoid(tpr, fpr).reshape(1)}


@op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    pred, lab = _one(ins, "MaxProbs"), _one(ins, "Labels")
    ids = _one(ins, "Indices")
    # without a class_number the class count is read on the host, as the
    # JAX package does (its jit path cannot run such a program at all)
    cls = attrs.get("class_number", int(ids.max()) + 1 if ids is not None else 2)
    p = (ids if ids is not None else pred.argmax(-1)).reshape(-1)
    y = lab.reshape(-1)
    onehot_p = F.one_hot(p.long(), cls).to(torch.float32)
    onehot_y = F.one_hot(y.long(), cls).to(torch.float32)
    tp = (onehot_p * onehot_y).sum(0)
    fp = (onehot_p * (1 - onehot_y)).sum(0)
    fn = ((1 - onehot_p) * onehot_y).sum(0)
    prec = tp / torch.clamp_min(tp + fp, 1e-12)
    rec = tp / torch.clamp_min(tp + fn, 1e-12)
    f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-12)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    return {"BatchMetrics": torch.cat([macro, prec, rec, f1]),
            "AccumStatesInfo": torch.stack([tp, fp, fn], 1)}


# -- IO ops (feed_op.cc / fetch_op.cc / save_op / load_op) -------------------
# The reference's executor prepends feed ops reading a FeedHolder vector and
# appends fetch ops writing a FetchHolder; save/load stream one variable
# to/from disk on the host. Here feed/fetch move values between a python-list
# holder and program vars. `save` writes at once eagerly; under a CUDA graph
# capture it copies the value into a buffer of the graph's and the Executor
# writes the file after each replay. `load` reads its file once per Executor
# signature (`ctx.consts`), the JAX package's "load once at startup".


@op("feed")
def _feed(ctx, ins, attrs):
    holder = _one(ins, "X")  # python list (FeedHolder role)
    return {"Out": holder[attrs.get("col", 0)]}


@op("fetch")
def _fetch(ctx, ins, attrs):
    x = _one(ins, "X")
    holder = _one(ins, "Holder")
    if isinstance(holder, list):  # FetchHolder role
        col = attrs.get("col", 0)
        while len(holder) <= col:
            holder.append(None)
        holder[col] = x
    return {"Out": x}


def save_array(path: str, value: Any, overwrite: bool = True) -> None:
    """np.save of a host copy of `value` to `path` (np.save appends '.npy'
    when the path lacks it), refusing an existing file unless `overwrite`."""
    disk_path = path if path.endswith(".npy") else path + ".npy"
    if not overwrite and os.path.exists(disk_path):
        raise RuntimeError(f"save op: {disk_path} exists and overwrite=False")
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    np.save(path, np.asarray(value))


@op("save")
def _save(ctx, ins, attrs):
    x = _one(ins, "X")
    path = attrs["file_path"]
    overwrite = attrs.get("overwrite", True)
    disk_path = path if path.endswith(".npy") else path + ".npy"
    if not overwrite and os.path.exists(disk_path):
        raise RuntimeError(f"save op: {disk_path} exists and overwrite=False")
    x_dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    if x_dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        if ctx.saves is None:
            raise RuntimeError("save op under a CUDA graph capture with no save list "
                               "(OpContext.saves)")
        ctx.saves.append((path, overwrite, x.detach().clone()))
    else:
        save_array(path, x, overwrite)
    return {"Out": torch.zeros((), dtype=torch.int32, device=x_dev)}


@op("load")
def _load(ctx, ins, attrs):
    path = attrs["file_path"]
    if not path.endswith(".npy"):
        path = path + ".npy"
    if ctx.consts is not None and path in ctx.consts:
        return {"Out": ctx.consts[path]}
    value = as_tensor(np.load(path), ctx.device)
    if ctx.consts is not None:
        ctx.consts[path] = value
    return {"Out": value}


# -- beam search ops (beam_search_op.cc / beam_search_decode_op.cc) ----------
# Dense-tensor redesign of the reference's LoD-based beams: a fixed beam
# width K per source sentence, so every step is a static [B, K*V] top-k on
# the device (beam_search_op.cc walks candidate lists on the host per step).


@op("beam_search")
def _beam_search(ctx, ins, attrs):
    """One expansion step. ins: pre_ids [B*K,1], pre_scores [B*K,1],
    scores [B*K,V]: accumulated log-probs when is_accumulated (the
    reference's default, beam_search_op.cc), else per-step probabilities
    that get log()ed and added to pre_scores here. outs:
    selected_ids/selected_scores [B*K,1], parent_idx [B*K] (absolute row
    into the pre-beam). Expansion and finished-EOS masking are
    nn/beam_core.expand_beams, the one beam engine."""
    from paddle_tpu_torch.nn.beam_core import expand_beams

    k = attrs["beam_size"]
    end_id = attrs.get("end_id", 1)
    pre_ids = _one(ins, "pre_ids").reshape(-1)
    pre_scores = _one(ins, "pre_scores").reshape(-1).to(torch.float32)
    scores = _one(ins, "scores").to(torch.float32)
    bk, v = scores.shape
    b = bk // k
    if attrs.get("is_accumulated", True):
        logp = scores
    else:
        logp = torch.log(torch.clamp_min(scores, 1e-20)) + pre_scores[:, None]
    top_scores, beam_idx, tok = expand_beams(
        logp.reshape(b, k, v), pre_scores.reshape(b, k),
        (pre_ids == end_id).reshape(b, k), end_id, k)
    parent = beam_idx + torch.arange(b, device=beam_idx.device)[:, None] * k
    return {
        "selected_ids": tok.reshape(-1, 1),
        "selected_scores": top_scores.reshape(-1, 1),
        "parent_idx": parent.reshape(-1).to(torch.int32),
    }


@op("beam_search_decode")
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack per-step selections into whole sequences. ins: Ids [T, B*K]
    (or [T, B*K, 1]), ParentIdx [T, B*K] absolute rows, Scores [B*K] final
    accumulated scores. outs: SentenceIds [B, K, T] (end_id-padded),
    SentenceScores [B, K]."""
    k = attrs["beam_size"]
    ids = _one(ins, "Ids")
    parents = _one(ins, "ParentIdx")
    scores = _one(ins, "Scores").reshape(-1)
    ids = ids.reshape(ids.shape[0], -1)  # [T, B*K]
    parents = parents.reshape(parents.shape[0], -1).long()
    t, bk = ids.shape
    b = bk // k
    ptr = torch.arange(bk, device=ids.device)
    toks: List[Optional[torch.Tensor]] = [None] * t
    for step in range(t - 1, -1, -1):
        toks[step] = ids[step][ptr]
        ptr = parents[step][ptr]
    seq = torch.stack(toks, 0).T  # [B*K, T]
    return {"SentenceIds": seq.reshape(b, k, t), "SentenceScores": scores.reshape(b, k)}
