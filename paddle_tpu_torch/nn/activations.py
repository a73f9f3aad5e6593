"""Activations (counterpart of `paddle_tpu/nn/activations.py`): the
reference's registered names (ActivationFunction.cpp:40-63) — linear,
sigmoid, softmax, relu, brelu, tanh, stanh, softrelu, abs, square,
exponential, log, sqrt, reciprocal — with the JAX package's clipping
constants. Backward is autograd, as it is autodiff there."""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

ActLike = Union[None, str, Callable[[torch.Tensor], torch.Tensor]]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTS = {
    "linear": _identity,
    "identity": _identity,
    "": _identity,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "relu": torch.relu,
    # bounded relu, clipped at 24 like the reference (BReluActivation)
    "brelu": lambda x: torch.clamp(x, 0.0, 24.0),
    "tanh": torch.tanh,
    # scaled tanh 1.7159 * tanh(2/3 x) (STanhActivation)
    "stanh": lambda x: 1.7159 * torch.tanh(2.0 / 3.0 * x),
    # log(1 + exp(x)) with the input clipped to +-40 like the reference
    "softrelu": lambda x: F.softplus(torch.clamp(x, -40.0, 40.0)),
    "abs": torch.abs,
    "square": torch.square,
    "exponential": torch.exp,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "reciprocal": torch.reciprocal,
}


def get(act: ActLike) -> Callable[[torch.Tensor], torch.Tensor]:
    if act is None:
        return _ACTS["linear"]
    if callable(act):
        return act
    if act not in _ACTS:
        raise KeyError(f"activation {act!r} is not ported; have {sorted(_ACTS)}")
    return _ACTS[act]


def apply(act: ActLike, x: torch.Tensor) -> torch.Tensor:
    return get(act)(x)
