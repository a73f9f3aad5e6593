"""Plain PyTorch reference of the `resnet50` configuration's training step,
and the arithmetic the benchmark counts it by.

Independent of the program: plain `torch` operations, written from the
architecture (He et al. 2015, ResNet-50 v1: the stride of a downsampling
block on its first 1x1 conv) and the training step the configuration
states: softmax cross-entropy averaged over the batch, batch norm with the
batch's biased statistics and moving averages `f * old + (1 - f) * new`,
momentum SGD `v <- mu v - lr g; p <- p + v`. Parameters are named as the
configuration's layers are named (`stem.conv.w` HWIO, `s0b0.a.bn.scale`,
`logits.w`), the one interface with the program.

The reference computes in float32 with TF32 off (`f32`), the truth the
program's bf16 is held against. The control (`fp8`) is the precision below
the configuration's bf16, in the places the configuration rounds to bf16:
every conv and matmul input and output, batch norm's output and the
residual sum are rounded to float8 e4m3 (per-tensor scale), and the
gradients flowing back through each of them to e5m2. The stem and the blocks are recomputed in the backward
(`torch.utils.checkpoint`) so that the global batch of a data-parallel
cell fits one card."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Shapes = Dict[str, Tuple[Tuple[int, ...], str]]


def _blocks(cfg: Mapping[str, Any]):
    """(name, in, mid, out, stride, has_proj) of every bottleneck block."""
    cin = cfg["stem"]["filters"]
    for stage, (n, (mid, out)) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        for blk in range(n):
            stride = 2 if (stage > 0 and blk == 0) else 1
            yield f"s{stage}b{blk}", cin, mid, out, stride, (stride != 1 or cin != out)
            cin = out


def param_shapes(cfg: Mapping[str, Any]) -> Shapes:
    """name -> (shape, init): conv filters HWIO (`he`: N(0, sqrt(2 / fan_in))),
    batch norm's scale (`ones`) and bias (`zeros`), the head (`smart`:
    N(0, 1 / sqrt(fan_in)); bias `zeros`)."""
    out: Shapes = {}

    def conv_bn(name, k, cin, cout):
        out[f"{name}.conv.w"] = ((k, k, cin, cout), "he")
        out[f"{name}.bn.scale"] = ((cout,), "ones")
        out[f"{name}.bn.bias"] = ((cout,), "zeros")

    st = cfg["stem"]
    conv_bn("stem", st["kernel"], cfg["channels"], st["filters"])
    for name, cin, mid, cout, _, proj in _blocks(cfg):
        conv_bn(f"{name}.a", 1, cin, mid)
        conv_bn(f"{name}.b", 3, mid, mid)
        conv_bn(f"{name}.c", 1, mid, cout)
        if proj:
            conv_bn(f"{name}.proj", 1, cin, cout)
    last = cfg["widths"][-1][1]
    out["logits.w"] = ((last, cfg["classes"]), "smart")
    out["logits.b"] = ((cfg["classes"],), "zeros")
    return out


def state_names(cfg: Mapping[str, Any]) -> List[str]:
    return [n[:-len(".scale")] + s for n in param_shapes(cfg) if n.endswith(".bn.scale")
            for s in (".moving_mean", ".moving_var")]


def initial_states(cfg: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """Batch norm's moving statistics as a model starts: mean 0, variance 1."""
    shapes = param_shapes(cfg)
    out = {}
    for name in state_names(cfg):
        c = shapes[name.rsplit(".", 1)[0] + ".scale"][0]
        out[name] = (torch.zeros if name.endswith("mean") else torch.ones)(c, device=device)
    return out


def make_params(cfg: Mapping[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from `seed`: one normal draw for all the random
    leaves on `device`, cut and scaled leaf by leaf."""
    shapes = param_shapes(cfg)
    rand = [(n, s, k) for n, (s, k) in shapes.items() if k in ("he", "smart")]
    total = sum(math.prod(s) for _, s, _ in rand)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in rand:
        n = math.prod(shape)
        fan_in = math.prod(shape[:-1])
        std = math.sqrt(2.0 / fan_in) if kind == "he" else 1.0 / math.sqrt(fan_in)
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    for name, (shape, kind) in shapes.items():
        if kind in ("ones", "zeros"):
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
    return {name: out[name] for name in shapes}


# -- arithmetic -----------------------------------------------------------------

def forward_flops_per_image(cfg: Mapping[str, Any]) -> float:
    """Multiply-adds x 2 of the convolutions and the head, one image."""
    def conv(hw, k, cin, cout):
        return 2.0 * hw * hw * k * k * cin * cout

    st = cfg["stem"]
    hw = cfg["image_size"] // st["stride"]
    total = conv(hw, st["kernel"], cfg["channels"], st["filters"])
    hw //= st["pool_stride"]
    for _, cin, mid, cout, stride, proj in _blocks(cfg):
        hw //= stride
        total += conv(hw, 1, cin, mid) + conv(hw, 3, mid, mid) + conv(hw, 1, mid, cout)
        if proj:
            total += conv(hw, 1, cin, cout)
    return total + 2.0 * cfg["widths"][-1][1] * cfg["classes"]


def step_flops(cfg: Mapping[str, Any], batch: Mapping[str, Any]) -> float:
    """Forward and backward (3 x the forward) of one step on `batch`."""
    return 3.0 * forward_flops_per_image(cfg) * len(batch["label"])


def work(cfg: Mapping[str, Any], batch: Mapping[str, Any]) -> int:
    """Images a step on `batch` trains on."""
    return len(batch["label"])


# -- the training step -----------------------------------------------------------

class _Fp8(torch.autograd.Function):
    """Round to float8 (e4m3 forward, e5m2 for the gradient), per-tensor
    scaled to the format's largest value."""

    @staticmethod
    def forward(ctx, x):
        return _q(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _q(g, torch.float8_e5m2, 57344.0)


def _q(x, fmt, top):
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _Step:
    """One forward at a precision ("f32" | "fp8"); batch-norm statistics of
    the step land in `stats`."""

    def __init__(self, cfg, params, precision):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"resnet50 reference: precision {precision!r} is not f32/fp8")
        self.cfg, self.p, self.fp8 = cfg, params, precision == "fp8"
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _in(self, x):
        return _Fp8.apply(x) if self.fp8 else x

    def conv_bn(self, x, name, stride, pad, act):
        w = self.p[f"{name}.conv.w"].permute(3, 2, 0, 1)
        y = self._in(F.conv2d(self._in(x),
                              self._in(w).contiguous(memory_format=torch.channels_last),
                              None, stride, pad))
        mean = y.mean(dim=(0, 2, 3))
        var = (y - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        self.stats[name] = (mean.detach(), var.detach())
        inv = torch.rsqrt(var + self.cfg["bn_epsilon"])
        scale = (self.p[f"{name}.bn.scale"] * inv)[None, :, None, None]
        out = self._in((y - mean[None, :, None, None]) * scale
                       + self.p[f"{name}.bn.bias"][None, :, None, None])
        return F.relu(out) if act else out

    def block(self, x, name, stride, proj):
        a = self.conv_bn(x, f"{name}.a", stride, 0, True)
        b = self.conv_bn(a, f"{name}.b", 1, 1, True)
        c = self.conv_bn(b, f"{name}.c", 1, 0, False)
        short = self.conv_bn(x, f"{name}.proj", stride, 0, False) if proj else x
        return F.relu(self._in(c + short))

    def stem(self, x):
        st = self.cfg["stem"]
        x = self.conv_bn(x, "stem", st["stride"], st["kernel"] // 2, True)
        return F.max_pool2d(x, st["pool"], st["pool_stride"], st["pool"] // 2)

    def loss(self, image, label):
        x = image.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = checkpoint(self.stem, x, use_reentrant=False)
        for name, _, _, _, stride, proj in _blocks(self.cfg):
            x = checkpoint(self.block, x, name, stride, proj, use_reentrant=False)
        pooled = self._in(x.mean(dim=(2, 3)))
        logits = (self._in(torch.matmul(pooled, self._in(self.p["logits.w"])))
                  + self.p["logits.b"])
        return F.cross_entropy(logits, label.long())


def train_steps(cfg: Mapping[str, Any], params: Mapping[str, torch.Tensor],
                states: Mapping[str, torch.Tensor], batches: List[Mapping[str, Any]],
                precision: str, device) -> Dict[str, Any]:
    """len(batches) training steps from `params` and `states` -> {"losses",
    "first_grad" (the step-1 gradients), "params", "states" (after the
    last step)}. `precision`: "f32" (the reference) or "fp8" (the
    control)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(cfg, params, states, batches, precision, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _train(cfg, params, states, batches, precision, device):
    opt = cfg["optimizer"]
    lr, mu = opt["learning_rate"], opt["momentum"]
    maf = cfg["bn_moving_average_fraction"]
    p = {k: v.detach().clone().float().to(device).requires_grad_(True) for k, v in params.items()}
    s = {k: v.detach().clone().float().to(device) for k, v in states.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for batch in batches:
        image = torch.as_tensor(batch["image"]).to(device)
        label = torch.as_tensor(batch["label"]).to(device)
        step = _Step(cfg, p, precision)
        loss = step.loss(image, label)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = dict(zip(p, grads))
            if first is None:
                first = {k: v.clone() for k, v in g.items()}
            for k in p:
                vel[k].mul_(mu).sub_(lr * g[k])
                p[k].add_(vel[k])
            for name, (mean, var) in step.stats.items():
                s[f"{name}.bn.moving_mean"].mul_(maf).add_((1 - maf) * mean)
                s[f"{name}.bn.moving_var"].mul_(maf).add_((1 - maf) * var)
        del step, loss, grads
    return {"losses": losses, "first_grad": first,
            "params": {k: v.detach() for k, v in p.items()}, "states": s}
