"""Dense linear algebra of the port (counterpart of `paddle_tpu/ops/linalg.py`).

The inputs go through the policy's cast. Under the f32 policy that is a
float32 `torch.matmul`, full f32 on the card as long as TF32 stays off
(the trainer turns it off). Under the bf16 policy both inputs are bf16 and
so is the product, as in the JAX package (its `_BF16` accumulates into
bf16); a following f32 bias add promotes the result back to f32."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core import dtypes, remat


def matmul(a: torch.Tensor, b: torch.Tensor,
           policy: Optional[dtypes.Policy] = None) -> torch.Tensor:
    """a @ b over the last axis of a and the first axis of b."""
    p = policy or dtypes.current()
    a, b = p.cast(a), p.cast(b)
    with remat.name("conv_out"):  # the remat="conv_only" policy saves it
        return torch.matmul(a, b)
