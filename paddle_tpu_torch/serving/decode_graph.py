"""The decode step's forward as one CUDA graph.

The port's counterpart of the JAX engine's single compiled decode
executable (`jax.jit(model.decode_step)` in `paddle_tpu/serving/session.py`).
`ServableLM.decode_logits` at the session's fixed [max_slots] shape — the L
layers' projections, the paged-attention kernel's split and merge grids, the
LM head — plus the greedy argmax is captured once with
`torch.cuda.CUDAGraph` and replayed every decode step, so a step costs the
host four small copies, one replay and the token fetch instead of a few
hundred kernel launches. The fixed shape (`decode_shape_signatures()` stays
1) is what makes the capture legal.

Per-step inputs (tokens, positions, the active mask, the block table) are
written into pinned host buffers and copied into static device buffers
before `replay()`; nothing is allocated between replays. The graph holds raw
pointers to the session's page pools, so whoever re-initialises the pools
does it in place (`zero_()`), never by re-allocating them. Sampling stays
outside the graph: it reads the temperatures on the host and draws from
per-(seed, step) generators, and runs on the graph's logits for sampled
slots only.

CUDA only: the CPU has no graphs, and the session runs the step eagerly
there. A failed capture raises; nothing drops back to eager on the card."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.ops import paged_attention as _paged_attention
from paddle_tpu_torch.parallel import mesh as _mesh


class DecodeGraph:
    """`model.decode_logits(k_pages, v_pages, ...)` and its argmax, captured
    on the calling thread (on torch's capture stream) and replayed on its
    current stream.

    The caller runs one eager decode step on these pools first: that step is
    the capture's warm-up (the kernel's build and one-time attribute setup,
    cuBLAS's handle and workspace), so the capture records kernels only.
    `kernel_calls` is the number of paged-attention calls recorded (one per
    layer); each `replay` adds it to the wrapper's launch count, since a
    replay runs no Python, and adds the mesh collectives a tensor-parallel
    step captured (`collective_calls`) to the mesh's counts."""

    def __init__(self, model, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 max_slots: int, pages_per_seq: int):
        if k_pages.device.type != "cuda":
            raise ValueError(
                f"DecodeGraph needs the pools on a CUDA device, got "
                f"{k_pages.device}"
            )
        dev = k_pages.device
        self.k_pages, self.v_pages = k_pages, v_pages
        self.tokens = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self.positions = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self.active = torch.zeros(max_slots, dtype=torch.bool, device=dev)
        self.block_table = torch.zeros(
            (max_slots, pages_per_seq), dtype=torch.int32, device=dev
        )
        self.inputs = (self.tokens, self.positions, self.active,
                       self.block_table)
        self._pinned = tuple(
            torch.zeros(t.shape, dtype=t.dtype).pin_memory()
            for t in self.inputs
        )
        self._host = tuple(t.numpy() for t in self._pinned)
        self.graph = torch.cuda.CUDAGraph()
        before = _paged_attention.CAPTURED
        collectives_before = dict(_mesh.CAPTURED)
        # thread_local: the engine thread captures while the server's other
        # threads run (they never touch CUDA)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.logits = model.decode_logits(k_pages, v_pages, *self.inputs)
            self.greedy = self.logits.argmax(-1)
        self.kernel_calls = _paged_attention.CAPTURED - before
        self.collective_calls = _mesh.captured_since(collectives_before)

    def replay(self, tokens: np.ndarray, positions: np.ndarray,
               active: np.ndarray, block_table: np.ndarray):
        """One decode step on these host inputs -> (logits [S, V], greedy
        [S]) in the graph's static output buffers (valid until the next
        replay). The pinned buffers are rewritten only after the previous
        step's token fetch, which synchronised their copies."""
        for host, arr in zip(self._host, (tokens, positions, active,
                                          block_table)):
            host[...] = arr
        for dst, src in zip(self.inputs, self._pinned):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        _paged_attention.note_replay(self.kernel_calls)
        _mesh.note_replay(self.collective_calls)
        return self.logits, self.greedy
