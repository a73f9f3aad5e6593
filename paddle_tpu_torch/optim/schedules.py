"""Learning-rate schedules (counterpart of `paddle_tpu/optim/schedules.py`;
the reference's LearningRateScheduler.cpp registrations): constant, poly,
caffe_poly, exp, discexp, linear / linear_decay, manual, and a linear
warmup over the first `warmup_samples` samples.

A schedule maps the number of samples processed so far, an f32 tensor, to
the lr, an f32 tensor of the same shape, with torch ops only: the trainer
calls it inside the captured training step on its device-resident samples
counter, so each replay reads the lr of that step."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Callable[[float, float, float], Schedule]] = {}


def _register(*names: str):
    def wrap(fn):
        for n in names:
            _REGISTRY[n] = fn
        return fn
    return wrap


def build(learning_rate: float, schedule: Optional[str] = None, decay_a: float = 0.0,
          decay_b: float = 0.0, warmup_samples: float = 0.0) -> Schedule:
    """lr(t), t the number of samples processed (v1 semantics)."""
    name = schedule or "constant"
    if name not in _REGISTRY:
        raise KeyError(f"unknown lr schedule {name!r}; registered: {sorted(_REGISTRY)}")
    base = _REGISTRY[name](learning_rate, decay_a, decay_b)
    if warmup_samples > 0:
        def warmed(t):
            return torch.clamp_max(t / warmup_samples, 1.0) * base(t)
        return warmed
    return base


@_register("constant")
def _constant(lr, a, b):
    return lambda t: torch.full_like(t, lr, dtype=torch.float32)


@_register("poly")
def _poly(lr, a, b):
    # lr * (1 + a*t)^(-b)
    return lambda t: lr * torch.pow(1.0 + a * t, -b)


@_register("caffe_poly")
def _caffe_poly(lr, a, b):
    # lr * (1 - t/a)^b, 0 once t >= a
    return lambda t: lr * torch.pow(torch.clamp_min(1.0 - t / a, 0.0), b)


@_register("exp")
def _exp(lr, a, b):
    # lr * a^(t/b)
    return lambda t: lr * torch.pow(a, t / b)


@_register("discexp")
def _discexp(lr, a, b):
    # lr * a^floor(t/b)
    return lambda t: lr * torch.pow(a, torch.floor(t / b))


@_register("linear", "linear_decay")
def _linear(lr, a, b):
    # max(lr - a*t, b)
    return lambda t: torch.clamp_min(lr - a * t, b)


def manual(lr: float, segments: Sequence[Tuple[float, float]]) -> Schedule:
    """'manual': (boundary_samples, lr_factor) segments (the reference's
    ManualLearningRate). The boundary and rate tables are made on t's device
    at the first call (the trainer's eager warm-up step, before a capture)."""
    tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def fn(t):
        if t.device not in tables:
            tables[t.device] = (
                torch.tensor([s[0] for s in segments], dtype=torch.float32, device=t.device),
                torch.tensor([s[1] for s in segments], dtype=torch.float32, device=t.device))
        bounds, rates = tables[t.device]
        idx = (t.unsqueeze(-1) >= bounds).to(torch.int64).sum(-1)
        return lr * rates[idx.clamp(0, len(segments) - 1)]

    return fn
