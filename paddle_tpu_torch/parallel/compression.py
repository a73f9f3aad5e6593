"""Compressed gradient collectives for the sharded (ZeRO-1/2/3) update
(counterpart of `paddle_tpu/parallel/compression.py`).

The sharded updaters decompose the gradient all-reduce into a scatter leg
(gradients to the rank that owns each flat row) and a gather leg (updated
parameters, or under ZeRO-3 the on-demand parameter gather). Each leg's
payload is encoded just before it crosses the collective and decoded just
after:

  none:  f32 on both legs; the gather leg carries the updated parameter
         itself, which keeps that path bitwise the replicated updater's.
  bf16:  both legs cross in bfloat16; the gather leg carries the parameter
         DELTA (new - old), added to every rank's f32 master.
  int8:  the scatter leg crosses as block-scaled int8 (one f32 scale per
         BLOCK elements) with an error-feedback residual in
         opt_state["ef"]; the gather leg crosses as a bf16 delta. Under
         ZeRO-3 the int8 + error-feedback budget moves to the parameter
         gather (each owner encodes its own rows, every rank decodes the
         same payload) and the gradient leg runs bf16.

How the port moves a compressed scatter leg: a sum of int8 payloads with
different block scales is not a sum a collective can form, so a compressed
gradient crosses as an all-to-all of its encoded rows (rank j receives
every rank's row j) and the owner decodes each rank's row and adds them up
in f32. The JAX package quantizes the reduced gradient once; the port
quantizes each rank's contribution before the crossing, and its
error-feedback residual is the rank's own (the canonical residual that a
checkpoint holds is their sum, the residual of the whole gradient). At one
rank the two are the same arithmetic. `none` crosses as a plain f32
reduce-scatter.

`scatter_itemsize` / `gather_itemsize` model the bytes at each leg's
boundary, as the JAX package's byte model counts them (ring convention,
`updaters.py`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# int8 block size: one f32 scale per 64 elements; flat chunks are aligned to
# it so a block never straddles two ranks' rows
BLOCK = 64

MODES = ("none", "bf16", "int8")


class GradCompression:
    """No-op transport: f32 on both legs; the gather carries the parameter
    itself (bitwise the replicated updater)."""

    name = "none"
    uses_error_feedback = False
    chunk_align = 1
    scatter_itemsize = 4.0  # effective bytes / element at the scatter boundary
    gather_itemsize = 4.0
    param_gather_itemsize = 4.0
    z3_scatter_itemsize = 4.0
    scatter_dtype = "f32"
    gather_dtype = "f32"
    param_gather_dtype = "f32"
    z3_scatter_dtype = "f32"
    # whether the scatter leg sums in a reduce-scatter (else an all-to-all
    # of encoded rows and a local f32 sum)
    reduces_in_collective = True
    z3_reduces_in_collective = True

    # -- scatter leg (gradients) ----------------------------------------------
    def encode_scatter(self, g2: torch.Tensor,
                       ef: Optional[torch.Tensor]) -> Tuple[Tuple[torch.Tensor, ...],
                                                           Optional[torch.Tensor]]:
        """[n, chunk] f32 gradient (+ error-feedback residual or None) ->
        ((payload arrays, each [n, w]), new residual)."""
        return (g2,), None

    def decode_scatter(self, payload: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return payload[0]

    # -- gather leg (updated parameters) --------------------------------------
    def encode_gather(self, new_p2: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        """Updated [1, chunk] row (+ the row before the update) -> payload."""
        return new_p2

    def decode_gather(self, payload: torch.Tensor, p_full2: torch.Tensor) -> torch.Tensor:
        """Gathered [n, chunk] payload (+ the full pre-update flat param) ->
        the new flat param."""
        return payload

    # -- ZeRO-3 parameter gather ---------------------------------------------
    def encode_param_gather(self, p2: torch.Tensor,
                            ef: Optional[torch.Tensor]) -> Tuple[Tuple[torch.Tensor, ...],
                                                                Optional[torch.Tensor]]:
        """The owned [1, chunk] row (+ its residual) -> (payload, new
        residual)."""
        return (p2,), None

    def decode_param_gather(self, payload: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return payload[0]

    # -- ZeRO-3 gradient leg --------------------------------------------------
    def encode_z3_scatter(self, g2: torch.Tensor) -> torch.Tensor:
        return g2

    def decode_z3_scatter(self, payload: torch.Tensor) -> torch.Tensor:
        return payload


class Bf16Compression(GradCompression):
    name = "bf16"
    scatter_itemsize = 2.0
    gather_itemsize = 2.0
    param_gather_itemsize = 2.0
    z3_scatter_itemsize = 2.0
    scatter_dtype = "bf16"
    gather_dtype = "bf16"
    param_gather_dtype = "bf16"
    z3_scatter_dtype = "bf16"
    reduces_in_collective = False
    z3_reduces_in_collective = False

    def encode_scatter(self, g2, ef):
        return (g2.to(torch.bfloat16),), None

    def decode_scatter(self, payload):
        return payload[0].float()

    def encode_gather(self, new_p2, p2):
        return (new_p2 - p2).to(torch.bfloat16)

    def decode_gather(self, payload, p_full2):
        return p_full2 + payload.float()

    def encode_param_gather(self, p2, ef):
        return (p2.to(torch.bfloat16),), None

    def decode_param_gather(self, payload):
        return payload[0].float()

    def encode_z3_scatter(self, g2):
        return g2.to(torch.bfloat16)

    def decode_z3_scatter(self, payload):
        return payload.float()


def _block_quantize(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, chunk] f32 -> (int8 [n, chunk], f32 scales [n, chunk / BLOCK]);
    chunk is BLOCK-aligned."""
    n, chunk = x2.shape
    blocks = x2.reshape(n, chunk // BLOCK, BLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-30)  # an all-zero block
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return q.reshape(n, chunk).to(torch.int8), scale


def _block_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    n, chunk = q.shape
    blocks = q.float().reshape(n, chunk // BLOCK, BLOCK)
    return (blocks * scale[..., None]).reshape(n, chunk)


class Int8Compression(GradCompression):
    """Block-scaled int8 gradients with error feedback; a bf16 delta on the
    gather leg. Under ZeRO-3 the int8 + residual budget moves to the
    parameter gather and the gradient crossing runs bf16."""

    name = "int8"
    uses_error_feedback = True
    chunk_align = BLOCK
    scatter_itemsize = 1.0 + 4.0 / BLOCK  # int8 payload + an f32 scale a block
    gather_itemsize = 2.0
    param_gather_itemsize = 1.0 + 4.0 / BLOCK
    z3_scatter_itemsize = 2.0
    scatter_dtype = "int8+f32scale"
    gather_dtype = "bf16"
    param_gather_dtype = "int8+f32scale"
    z3_scatter_dtype = "bf16"
    reduces_in_collective = False
    z3_reduces_in_collective = False

    def encode_scatter(self, g2, ef):
        corrected = g2 if ef is None else g2 + ef
        q, scale = _block_quantize(corrected)
        # this step's quantization residual, re-injected next step
        new_ef = corrected - _block_dequantize(q, scale)
        return (q, scale), new_ef

    def decode_scatter(self, payload):
        q, scale = payload
        return _block_dequantize(q, scale)

    def encode_gather(self, new_p2, p2):
        return (new_p2 - p2).to(torch.bfloat16)

    def decode_gather(self, payload, p_full2):
        return p_full2 + payload.float()

    def encode_param_gather(self, p2, ef):
        # quantize inside the gather with error feedback on the master: the
        # forward sees dequant(quant(p + ef)), and the residual returns
        corrected = p2 if ef is None else p2 + ef
        q, scale = _block_quantize(corrected)
        new_ef = corrected - _block_dequantize(q, scale)
        return (q, scale), new_ef

    def decode_param_gather(self, payload):
        q, scale = payload
        return _block_dequantize(q, scale)

    def encode_z3_scatter(self, g2):
        return g2.to(torch.bfloat16)

    def decode_z3_scatter(self, payload):
        return payload.float()


def make(mode: Optional[str]) -> GradCompression:
    mode = mode or "none"
    if mode == "none":
        return GradCompression()
    if mode == "bf16":
        return Bf16Compression()
    if mode == "int8":
        return Int8Compression()
    raise ValueError(f"grad_compression must be one of {MODES}, got {mode!r}")
