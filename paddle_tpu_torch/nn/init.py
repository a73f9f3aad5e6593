"""Parameter initializers (counterpart of `paddle_tpu/nn/init.py`).

An initializer is `init(generator, shape) -> f32 CPU tensor`. The draws come
from a `torch.Generator`, so they differ from jax.random's at the same
seed: parity with the JAX package always goes through `nn/convert.py`,
never through a shared seed. Draws are made on the CPU and moved to the
model's device afterwards, so one seed gives the same parameters on the CPU
and on the card."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Initializer = Callable[[torch.Generator, Sequence[int]], torch.Tensor]

_M64 = (1 << 64) - 1


def param_seed(seed: int, key: int) -> int:
    """Seed of one parameter's generator: splitmix64 of (seed, key), so both
    halves reach the low 32 bits torch's CPU generator keeps."""
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(key) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def zeros(g: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32)


def ones(g: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32)


def constant(value: float) -> Initializer:
    def init(g: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return torch.full(tuple(shape), float(value), dtype=torch.float32)

    return init


def normal(std: float = 1.0, mean: float = 0.0) -> Initializer:
    def init(g: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return mean + std * torch.randn(tuple(shape), generator=g)

    return init


def uniform(low: float, high: float) -> Initializer:
    """U(low, high): ParamAttr's initial_min / initial_max."""
    def init(g: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return low + (high - low) * torch.rand(tuple(shape), generator=g)

    return init


def _fan_in(shape: Sequence[int]) -> int:
    if len(shape) <= 2:
        return shape[0]
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return receptive * shape[-2]


def smart_normal(g: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """N(0, 1/sqrt(fan_in)) — the reference's 'initial_smart' default."""
    std = 1.0 / math.sqrt(max(1, _fan_in(shape)))
    return std * torch.randn(tuple(shape), generator=g)


def he_normal(g: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """N(0, sqrt(2/fan_in)), the conv layers' default (fan_in of an HWIO
    kernel is kh * kw * in)."""
    std = math.sqrt(2.0 / max(1, _fan_in(shape)))
    return std * torch.randn(tuple(shape), generator=g)
