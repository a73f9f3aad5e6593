"""Activations (counterpart of `paddle_tpu/nn/activations.py`), the ones the
seq2seq path uses: linear (None), tanh, sigmoid."""

from __future__ import annotations

from typing import Callable, Union

import torch

ActLike = Union[None, str, Callable[[torch.Tensor], torch.Tensor]]

_ACTS = {
    "linear": lambda x: x,
    "identity": lambda x: x,
    "": lambda x: x,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
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
