"""LoDTensor and SelectedRows, the fluid ragged and sparse value types
(counterpart of `paddle_tpu/fluid/lod.py`; lod_tensor.h:80 and
selected_rows.h).

The packed data stays packed ([sum_len, D] with int32 offset vectors per
level, the reference's Vector<size_t> lod), and the sequence ops work from
segment ids derived from the offsets on the device: shapes are static and
only values depend on the data, so nothing is read back to the host and a
run stays capturable. Plain dataclasses over torch tensors (the JAX package
registers them as pytrees). `to_padded` / `from_padded` convert to and from
the padded [B, T, ...] + lengths encoding of `paddle_tpu_torch.nn`."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class LoDTensor:
    """data: [N, ...] packed values; lod: tuple of offset vectors, coarsest
    level first (lod[-1] segments individual sequences of rows)."""

    data: torch.Tensor
    lod: Tuple[torch.Tensor, ...] = ()

    @property
    def num_sequences(self) -> int:
        return len(self.lod[-1]) - 1 if self.lod else self.data.shape[0]

    def seq_lengths(self) -> torch.Tensor:
        off = torch.as_tensor(self.lod[-1])
        return off[1:] - off[:-1]

    def segment_ids(self) -> torch.Tensor:
        """[N] int64: which (finest-level) sequence each row belongs to."""
        off = torch.as_tensor(self.lod[-1], device=self.data.device)
        rows = torch.arange(self.data.shape[0], device=self.data.device, dtype=off.dtype)
        return torch.searchsorted(off, rows, right=True) - 1

    def to(self, device) -> "LoDTensor":
        return LoDTensor(self.data.to(device),
                         tuple(torch.as_tensor(o).to(device) for o in self.lod))


def lod_from_lengths(lengths: Sequence[int], device=None) -> torch.Tensor:
    lengths = torch.as_tensor(np.asarray(lengths, np.int32), device=device)
    return torch.cat([torch.zeros((1,), dtype=torch.int32, device=device),
                      torch.cumsum(lengths, 0, dtype=torch.int32)])


def to_padded(t: LoDTensor, max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed -> ([B, T, ...] padded, [B] int32 lengths); max_len static."""
    off = torch.as_tensor(t.lod[-1], device=t.data.device).long()
    lengths = off[1:] - off[:-1]
    b = len(off) - 1
    idx = off[:-1, None] + torch.arange(max_len, device=off.device)[None, :]
    idx = torch.clamp(idx, max=t.data.shape[0] - 1)
    padded = t.data[idx.reshape(-1)].reshape((b, max_len) + tuple(t.data.shape[1:]))
    mask = torch.arange(max_len, device=off.device)[None, :] < lengths[:, None]
    padded = padded * mask.reshape(mask.shape + (1,) * (padded.ndim - 2)).to(padded.dtype)
    return padded, lengths.to(torch.int32)


def from_padded(padded: np.ndarray, lengths: np.ndarray) -> LoDTensor:
    """host-side: padded [B, T, ...] + lengths -> packed LoDTensor (CPU)."""
    rows = [np.asarray(padded)[i, : int(n)] for i, n in enumerate(np.asarray(lengths))]
    data = np.concatenate(rows, 0) if rows else np.zeros((0,) + padded.shape[2:])
    return LoDTensor(torch.as_tensor(data), (lod_from_lengths([len(r) for r in rows]),))


@dataclasses.dataclass
class SelectedRows:
    """Row-sparse value (selected_rows.h): `value[i]` belongs to row
    `rows[i]` of a dense [height, D] tensor. Duplicated rows allowed
    (gradient accumulation is a scatter-add)."""

    rows: torch.Tensor  # [K] int
    value: torch.Tensor  # [K, D]
    height: int

    def to_dense(self) -> torch.Tensor:
        value = torch.as_tensor(self.value)
        out = torch.zeros((self.height,) + tuple(value.shape[1:]), dtype=value.dtype,
                          device=value.device)
        rows = torch.as_tensor(self.rows, device=value.device).long()
        return out.index_put((rows,), value, accumulate=True)
