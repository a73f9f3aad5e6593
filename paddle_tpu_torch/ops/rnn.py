"""GRU cell and whole-sequence scan (counterpart of `GruParams`, `gru_step`
and `gru_scan` in `paddle_tpu/ops/rnn.py`).

Gate order [update z, reset r, candidate c]; the reset gate multiplies the
RECURRENT candidate term, c = tanh(p_c + (r*h) W_c) (GruCompute /
hl_gpu_gru.cuh semantics). Masked steps carry h through.

`gru_scan` dispatches by device only: it always runs the fused whole-sequence
op (`ops/rnn_kernels.gru_seq_fused`), whose CUDA kernels run for CUDA
tensors and whose plain versions run for CPU tensors. The JAX package's
`_use_fused` size limit (`PADDLE_TPU_FUSED_RNN_MAX_BH`) bounds TPU VMEM and
has no counterpart here; its activation check has none either, because the
port's GRU takes only the reference defaults (sigmoid gates, tanh
candidate)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops.rnn_kernels import gru_seq_fused


class GruParams(NamedTuple):
    w_hzr: torch.Tensor  # [H, 2H] recurrent weights for update + reset gates
    w_hc: torch.Tensor   # [H, H] recurrent weight for the candidate
    bias: torch.Tensor   # [3H]


def gru_step(proj_t: torch.Tensor, h: torch.Tensor, p: GruParams) -> torch.Tensor:
    """One GRU step: proj_t [B, 3H] (x_t already projected), h [B, H]."""
    hdim = h.shape[-1]
    pz, pr, pc = torch.split(proj_t + p.bias, hdim, dim=-1)
    rz = linalg.matmul(h, p.w_hzr)
    z = torch.sigmoid(pz + rz[:, :hdim])
    r = torch.sigmoid(pr + rz[:, hdim:])
    c = torch.tanh(pc + linalg.matmul(r * h, p.w_hc))
    return (1.0 - z) * h + z * c


def gru_scan(
    proj: torch.Tensor,  # [B, T, 3H]
    mask: torch.Tensor,  # [B, T]
    p: GruParams,
    h0: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence GRU -> (h_seq [B, T, H], h_last [B, H]). Batch-major in
    and out, time-major inside the fused op."""
    b, _, h3 = proj.shape
    hdim = h3 // 3
    if h0 is None:
        h0 = torch.zeros((b, hdim), dtype=proj.dtype, device=proj.device)
    hs, h_last = gru_seq_fused(
        proj.transpose(0, 1), mask.transpose(0, 1), p.w_hzr, p.w_hc, p.bias,
        h0, reverse,
    )
    return hs.transpose(0, 1).to(proj.dtype), h_last.to(proj.dtype)
