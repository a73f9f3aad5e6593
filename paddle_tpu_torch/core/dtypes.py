"""Dtype policy (counterpart of `paddle_tpu/core/dtypes.py`).

Parameters and optimizer state stay float32; a policy says which dtype the
dot and conv inputs are cast to. Under `bf16_policy()` those inputs are
bfloat16 and so are their outputs (the JAX package's `_BF16` has
accum_dtype = bfloat16: the tensor cores accumulate in f32 and round the
result), and everything downstream of them (batch norm's output, relu, the
residual adds) runs in bf16 too. Batch-norm statistics, the softmax and the
cost stay f32 whatever the policy.

This is not `torch.autocast`: autocast keeps batch norm, adds and relu in
f32, a different dtype flow from the reference's with twice the activation
bytes. The f32 policy is the reference's `Precision.HIGHEST`; on the card
that means TF32 off for cuBLAS and cuDNN (the trainer sets both at build
time, since autograd runs the backward's convs outside any context manager
around the forward)."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    @property
    def name(self) -> str:
        """"f32" or "bf16", for reports."""
        return "bf16" if self.compute_dtype == torch.bfloat16 else "f32"

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """The one cast boundary: floating tensors move to the compute dtype,
        everything else (ints, bools, tensors already there) passes."""
        if x.is_floating_point() and x.dtype != self.compute_dtype:
            return x.to(self.compute_dtype)
        return x


_F32 = Policy()
_BF16 = Policy(compute_dtype=torch.bfloat16, accum_dtype=torch.bfloat16)

# context-local like the reference's: a policy scope on one thread (a
# trainer's forward) must not leak into another (a serving engine)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_dtype_policy", default=_F32)


def current() -> Policy:
    return _current.get()


def set_policy(policy: Policy) -> None:
    """Set the ambient policy of this thread/context (contextvar semantics:
    other threads keep their own, f32 by default)."""
    _current.set(policy)


@contextlib.contextmanager
def policy_scope(policy: Policy):
    token = _current.set(policy)
    try:
        yield policy
    finally:
        _current.reset(token)


def f32_policy() -> Policy:
    return _F32


def bf16_policy() -> Policy:
    return _BF16


# names get() and SGDTrainer(precision=) accept
PRECISIONS = ("f32", "bf16")


def get(name: Optional[str]) -> Policy:
    if name is None or name in ("float32", "f32"):
        return _F32
    if name in ("bfloat16", "bf16", "mixed"):
        return _BF16
    raise ValueError(
        f"unknown dtype policy {name!r}; expected one of {PRECISIONS} "
        f"(or the long spellings float32/bfloat16)")
