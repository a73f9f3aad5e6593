"""Ragged paged-attention decode: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`. The serving
decode step attends, for every slot at once, over the slot's own pages of
the paged KV cache: block-table row s maps logical page j to a physical
page, and slot s sees logical tokens 0..positions[s] (sequence length is
data, never shape). The kernel (`csrc/paged_attention.cu`) splits each
slot's visible tokens over several blocks (flash-decoding): a block copies
its tiles' K/V rows for a group of heads into a shared-memory ring and
keeps an online f32 softmax, and a second small grid merges a slot's
splits in a fixed order. It never builds the dense [S, P*PS, KD] gather.
`split_plan` below lays the launch out from the shapes and the card's SM
count alone; the blocks read the positions on the device and deal each
slot's visible tiles among its splits (`split_tiles` is that rule in
Python: one tile a split for a short slot, runs of the plan's length
otherwise), so the host never waits on them. The plain
version below is that dense gather + masked softmax, line for line the JAX
package's oracle (`paddle_tpu/serving/model.py:617-627`).

Dispatch is by where the tensors lie, nothing else: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. `LAUNCHES` counts
kernel launches (never plain-version calls), so a run can show that its
decode steps went through the kernel (one per call, whatever the number
of grids). A call made while the current stream is capturing a CUDA graph
launches nothing: it records the kernel into the graph and counts it in
`CAPTURED` instead; whoever replays the graph adds the number of calls it
captured to `LAUNCHES` on each replay (`note_replay`), since a replay runs
no Python."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from paddle_tpu_torch.ops import build

# must equal serving/model.NEG_INF: masked tokens get weight exactly 0 and a
# fully masked row degrades to uniform weights, never NaN
NEG_INF = -1e9

MAX_HEAD_DIM = 256

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0
# calls recorded into CUDA graphs under capture (launched by their replays)
CAPTURED = 0

_SOURCE = "paged_attention"

# a block reads at most this many floats of a token's row (HG heads x hd)
MAX_BLOCK_WIDTH = 256
# tokens of a ring stage: about 32 KB of K and V rows, 8 to 64 tokens (the
# kernel's ring holds 2 stages: one in flight while the block computes the
# other; at hd=64 its 68 KB leave room for 3 blocks an SM)
_TILE_BYTES = 32 * 1024
# tokens a split walks at most (the kernel keeps their pool rows on chip)
_MAX_RUN = 2048
# split blocks aimed at per SM, counting every table tile as visible (about
# half are at a typical decode step, which leaves ~2 resident blocks an SM)
_BLOCKS_PER_SM = 4


class SplitPlan(NamedTuple):
    heads_per_block: int  # HG: a block's heads, a divisor of H
    tiles_per_split: int  # RT: tiles a split walks at most
    tile_tokens: int      # TT: tokens of a tile (a ring stage)
    n_splits: int         # NC: splits of a slot, NC * RT >= the table's tiles >= NC

    def scratch_floats(self, s: int, kd: int, n_heads: int) -> int:
        """Each run's partial accumulator [S, NC, KD] and (max, sum) [S, NC, H, 2]."""
        return s * self.n_splits * (kd + 2 * n_heads)


@functools.lru_cache(maxsize=256)
def split_plan(s: int, n_heads: int, head_dim: int, page_size: int,
               pages_per_seq: int, sms: int) -> SplitPlan:
    """How the kernel lays out S slots of H heads x hd over P pages of PS
    tokens on a card of `sms` SMs: the most heads a block can hold (its row
    of HG*hd floats at most 256), a tile of ~32 KB of K and V, and as many
    splits a slot as make S x head groups x splits about 4 blocks per SM
    (at most one a tile of the table: at S=1 a split walks one tile), each
    walking a run of at most RT tiles. That much is fixed by the shapes;
    which tiles a split walks, and how many splits are live, the blocks
    work out from the positions (`split_tiles`)."""
    hg = max(d for d in range(1, n_heads + 1)
             if n_heads % d == 0 and d * head_dim <= MAX_BLOCK_WIDTH)
    width = hg * head_dim
    tile = 1 << max(0, (_TILE_BYTES // (8 * width)).bit_length() - 1)
    tile = min(64, max(4, tile))
    tiles = math.ceil(pages_per_seq * page_size / tile)
    units = s * (n_heads // hg)
    splits = min(tiles, max(1, math.ceil(_BLOCKS_PER_SM * sms / units)))
    # a split's tokens keep their pool rows in shared memory: at most 2048
    per = min(math.ceil(tiles / splits), _MAX_RUN // tile)
    return SplitPlan(hg, per, tile, math.ceil(tiles / per))


def split_tiles(plan: SplitPlan, n_tok: int) -> List[List[Tuple[int, int]]]:
    """The kernel's rule, for a slot of `n_tok` visible tokens (1 up to the
    table's reach): the [first, end) tokens of each tile that split c walks,
    in its order. A short slot, of at most min(RT, NC) tiles of TT tokens,
    gives one tile to each of its first splits; a longer one gives split c
    the run of tiles c*RT .. c*RT + RT - 1. A split with no tile exits, and
    the merge sums the live ones in split order."""
    tt, rt, nc = plan.tile_tokens, plan.tiles_per_split, plan.n_splits
    tiles = -(-n_tok // tt)
    if tiles <= min(rt, nc):
        runs = [[c] for c in range(tiles)]
    else:
        runs = [list(range(c * rt, min((c + 1) * rt, tiles))) for c in range(-(-tiles // rt))]
    runs += [[] for _ in range(nc - len(runs))]
    return [[(i * tt, min((i + 1) * tt, n_tok)) for i in r] for r in runs]


_sm_counts: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    index = torch.cuda.current_device() if device.index is None else device.index
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


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
            f"head_dim {kd // n_heads} > {MAX_HEAD_DIM}: a kernel block reads "
            "at most 256 floats of a token's row"
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
        fn.argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float, p]
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
    on the current stream with `split_plan`'s layout for these shapes and
    this card, or an error — never the plain version. Under stream capture
    the same launch is recorded into the graph (the merge grid's
    programmatic dependency becomes a programmatic edge) and counted in
    `CAPTURED`, not `LAUNCHES`. The host work here — the checks, the plan,
    building the kernel — is cached or cheap, so a capture needs only one
    warm-up call first (the kernel's one-time attribute setup)."""
    global LAUNCHES, CAPTURED
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
    hd, ps, pmax = kd // n_heads, k_pages.shape[1], block_table.shape[1]
    plan = split_plan(s, n_heads, hd, ps, pmax, _sm_count(q.device))
    # one allocation: the output's S rows, then rows for the runs' partials
    # (16-byte aligned wherever the kernel copies 16 bytes: KD % 4 == 0)
    buf = torch.empty((s + -(-plan.scratch_floats(s, kd, n_heads) // kd), kd),
                      dtype=torch.float32, device=q.device)
    out = buf[:s]
    rc = load_kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        buf.data_ptr() + 4 * s * kd, s, n_heads, hd, ps, pmax, *plan, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged_attention_decode kernel launch failed: CUDA error {rc}"
        )
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return out


def note_replay(captured_calls: int) -> None:
    """A CUDA graph holding `captured_calls` calls of this kernel was
    replayed: each of them launched its kernel once."""
    global LAUNCHES
    LAUNCHES += captured_calls
