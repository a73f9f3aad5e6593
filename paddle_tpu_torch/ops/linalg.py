"""Dense linear algebra of the port (counterpart of `paddle_tpu/ops/linalg.py`).

The JAX package casts dot inputs to its policy's compute dtype and
accumulates in f32 at `Precision.HIGHEST`. The port runs f32 only (the bf16
policy waits, ROADMAP.md): a float32 `torch.matmul`, which on the card is
full f32 as long as `torch.backends.cuda.matmul.allow_tf32` stays False."""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last axis of a and the first axis of b, in f32."""
    return torch.matmul(a.float(), b.float())
