"""Ragged paged-attention decode: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`. The serving
decode step attends, for every slot at once, over the slot's own pages of
the paged KV cache: block-table row s maps logical page j to a physical
page, and slot s sees logical tokens 0..positions[s] (sequence length is
data, never shape). The kernel (`csrc/paged_attention.cu`) walks each
slot's pages through its block-table row with an online f32 softmax and
never builds the dense [S, P*PS, KD] gather; the plain version below is
that dense gather + masked softmax, line for line the JAX package's oracle
(`paddle_tpu/serving/model.py:617-627`).

Dispatch is by where the tensors lie, nothing else: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. `LAUNCHES` counts
kernel launches (never plain-version calls), so a run can show that its
decode steps went through the kernel."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import build

# must equal serving/model.NEG_INF: masked tokens get weight exactly 0 and a
# fully masked row degrades to uniform weights, never NaN
NEG_INF = -1e9

MAX_HEAD_DIM = 256

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0

_SOURCE = "paged_attention"


def paged_attention_decode_ref(
    q: torch.Tensor,            # [S, KD]
    k_pages: torch.Tensor,      # [NP, PS, KD]
    v_pages: torch.Tensor,      # [NP, PS, KD]
    block_table: torch.Tensor,  # [S, P] integer
    positions: torch.Tensor,    # [S] integer
    *,
    scale: float,
    n_heads: int,
) -> torch.Tensor:
    """The plain version: dense gather of every table page, mask logical
    index <= position with NEG_INF, f32 softmax, weighted sum. Scores are
    scaled after the dot, as the JAX oracle does. Returns [S, KD]."""
    s, kd = q.shape
    ps = k_pages.shape[1]
    hd = kd // n_heads
    bt = block_table.long()
    qh = q.reshape(s, n_heads, hd)
    k_seq = k_pages[bt].reshape(s, -1, n_heads, hd)  # [S, P*PS, H, hd]
    v_seq = v_pages[bt].reshape(s, -1, n_heads, hd)
    ctx_idx = torch.arange(bt.shape[1] * ps, device=q.device)
    mask = ctx_idx[None, :] <= positions.long()[:, None]  # [S, T_ctx]
    sc = torch.einsum("shd,sthd->sht", qh, k_seq) * scale
    sc = torch.where(mask[:, None, :], sc, NEG_INF)
    w = torch.softmax(sc.float(), -1).to(q.dtype)
    return torch.einsum("sht,sthd->shd", w, v_seq).reshape(s, -1)


def check_inputs(q, k_pages, v_pages, block_table, positions, n_heads) -> None:
    """Raise on anything the kernel does not take: f32 q/pages, int32
    table/positions, matching shapes, contiguous, one device,
    head_dim <= 256."""
    if q.dim() != 2 or k_pages.dim() != 3:
        raise ValueError(
            f"want q [S, KD] and k_pages [NP, PS, KD], got {tuple(q.shape)} "
            f"and {tuple(k_pages.shape)}"
        )
    s, kd = q.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[2] != kd:
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)} / v_pages {tuple(v_pages.shape)} "
            f"must both be [NP, PS, {kd}]"
        )
    if block_table.dim() != 2 or block_table.shape[0] != s:
        raise ValueError(f"block_table must be [{s}, P], got {tuple(block_table.shape)}")
    if tuple(positions.shape) != (s,):
        raise ValueError(f"positions must be [{s}], got {tuple(positions.shape)}")
    if n_heads <= 0 or kd % n_heads:
        raise ValueError(f"KD={kd} is not a multiple of n_heads={n_heads}")
    if kd // n_heads > MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {kd // n_heads} > {MAX_HEAD_DIM}: the kernel keeps a "
            "head's query in 8 registers per lane"
        )
    for name, t, dt in (
        ("q", q, torch.float32), ("k_pages", k_pages, torch.float32),
        ("v_pages", v_pages, torch.float32),
        ("block_table", block_table, torch.int32),
        ("positions", positions, torch.int32),
    ):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def load_kernel():
    """The built, loaded kernel entry point (nvcc runs at the first call).
    Pointers and the stream are declared c_void_p: left undeclared, ctypes
    would pass them as 32-bit ints."""
    fn = build.load(_SOURCE).paged_attention_decode_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_decode(
    q: torch.Tensor,            # [S, KD] f32
    k_pages: torch.Tensor,      # [NP, PS, KD] f32 — one layer's pool
    v_pages: torch.Tensor,      # [NP, PS, KD] f32
    block_table: torch.Tensor,  # [S, P] int32
    positions: torch.Tensor,    # [S] int32
    *,
    scale: float,
    n_heads: int,
) -> torch.Tensor:
    """One decode step of ragged paged attention for all slots -> [S, KD]
    f32. CPU tensors: the plain version. CUDA tensors: the kernel, launched
    on the current stream, or an error — never the plain version."""
    global LAUNCHES
    if q.device.type == "cpu":
        return paged_attention_decode_ref(
            q, k_pages, v_pages, block_table, positions,
            scale=scale, n_heads=n_heads,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_attention_decode runs on CUDA (kernel) or CPU (plain "
            f"version); got tensors on {q.device}"
        )
    check_inputs(q, k_pages, v_pages, block_table, positions, n_heads)
    s, kd = q.shape
    out = torch.empty((s, kd), dtype=torch.float32, device=q.device)
    rc = load_kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        s, n_heads, kd // n_heads, k_pages.shape[1], block_table.shape[1],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged_attention_decode kernel launch failed: CUDA error {rc}"
        )
    LAUNCHES += 1
    return out
