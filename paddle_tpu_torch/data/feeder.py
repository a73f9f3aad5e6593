"""DataFeeder: user samples → padded batches (the port's copy of
`paddle_tpu/data/feeder.py`).

Replaces py_paddle/dataprovider_converter.py (numpy/scipy → C++ Arguments) and
the PyDataProvider2 input-type system (python/paddle/trainer/PyDataProvider2.py:63-236:
dense_vector, integer_value, *_sequence variants, sparse_binary_vector).

Ragged sequences become padded [B, T, ...] + lengths, and batches are
padded/bucketed to a small set of shapes (`seq_bucket`, else the next power
of two), so the trainer captures few step graphs: one per batch signature."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass
class InputSpec:
    """Type descriptor for one input slot."""

    kind: str  # dense | index | dense_seq | index_seq | sparse_binary | sparse_value
    dim: Union[int, Sequence[int]] = 0
    dtype: Any = np.float32
    seq_bucket: Optional[Sequence[int]] = None  # pad-to-bucket lengths


def dense_vector(dim: int, dtype=np.float32) -> InputSpec:
    return InputSpec("dense", dim, dtype)


def dense_array(shape: Sequence[int], dtype=np.float32) -> InputSpec:
    return InputSpec("dense", tuple(shape), dtype)


def integer_value(value_range: int = 0) -> InputSpec:
    return InputSpec("index", value_range, np.int32)


def dense_vector_sequence(dim: int, dtype=np.float32) -> InputSpec:
    return InputSpec("dense_seq", dim, dtype)


def integer_value_sequence(value_range: int = 0) -> InputSpec:
    return InputSpec("index_seq", value_range, np.int32)


def dense_vector_sub_sequence(dim: int, dtype=np.float32) -> InputSpec:
    """Nested sequence of dense vectors (PyDataProvider2
    dense_vector_sub_sequence): each sample is a list of subsequences, each a
    list of dim-vectors → padded [B, S, T, dim] + lengths + sub_lengths."""
    return InputSpec("dense_subseq", dim, dtype)


def integer_value_sub_sequence(value_range: int = 0) -> InputSpec:
    return InputSpec("index_subseq", value_range, np.int32)


def sparse_binary_vector(dim: int) -> InputSpec:
    return InputSpec("sparse_binary", dim, np.float32)


def sparse_value_slot(dim: int) -> InputSpec:
    return InputSpec("sparse_value", dim, np.float32)


def _bucket_len(n: int, buckets: Optional[Sequence[int]]) -> int:
    if buckets:
        for b in buckets:
            if n <= b:
                return b
        # longer than the largest bucket: sequences get truncated to it
        return buckets[-1]
    # default: round up to next power of two (min 8) to bound the signatures
    return max(8, 1 << int(math.ceil(math.log2(max(n, 1)))))


class DataFeeder:
    """feeding: {slot_name: InputSpec}; converts a list of sample dicts or
    tuples (ordered like `feeding` keys, v1-style) into a batch dict for
    Network.apply."""

    def __init__(self, feeding: Dict[str, InputSpec]):
        self.feeding = feeding
        self.names = list(feeding.keys())

    def __call__(self, samples: List[Any]) -> Dict[str, np.ndarray]:
        return self.feed(samples)

    def feed(self, samples: List[Any]) -> Dict[str, np.ndarray]:
        cols: Dict[str, List[Any]] = {n: [] for n in self.names}
        for s in samples:
            if isinstance(s, dict):
                for n in self.names:
                    cols[n].append(s[n])
            else:
                if len(s) != len(self.names):
                    raise ValueError(
                        f"sample has {len(s)} fields, feeding expects {len(self.names)}"
                    )
                for n, v in zip(self.names, s):
                    cols[n].append(v)
        batch: Dict[str, np.ndarray] = {}
        for n in self.names:
            spec = self.feeding[n]
            vals = cols[n]
            if spec.kind == "dense":
                arr = np.asarray(vals, dtype=spec.dtype)
                if isinstance(spec.dim, tuple):
                    arr = arr.reshape((len(vals),) + tuple(spec.dim))
                batch[n] = arr
            elif spec.kind == "index":
                batch[n] = np.asarray(vals, dtype=np.int32)
            elif spec.kind in ("dense_seq", "index_seq"):
                lengths = np.asarray([len(v) for v in vals], np.int32)
                max_len = _bucket_len(int(lengths.max()) if len(vals) else 1, spec.seq_bucket)
                if spec.kind == "dense_seq":
                    dim = spec.dim if isinstance(spec.dim, tuple) else (spec.dim,)
                    out = np.zeros((len(vals), max_len) + dim, spec.dtype)
                else:
                    out = np.zeros((len(vals), max_len), np.int32)
                for i, v in enumerate(vals):
                    v = np.asarray(v, out.dtype)[:max_len]  # truncate outliers
                    out[i, : len(v)] = v.reshape((len(v),) + out.shape[2:])
                batch[n] = out
                batch[n + ".lengths"] = np.minimum(lengths, max_len)
            elif spec.kind in ("dense_subseq", "index_subseq"):
                # vals[i] = list of subsequences, each a list of tokens/vectors
                # → [B, S, T, ...] + lengths [B] (subseq counts) + sub_lengths
                # [B, S] (the padded encoding of subSequenceStartPositions)
                for i, subs in enumerate(vals):
                    if any(len(sub) == 0 for sub in subs):
                        raise ValueError(
                            f"{n}: sample {i} contains an empty subsequence; "
                            "the reference rejects zero-length subsequences "
                            "(subSequenceStartPositions must be strictly "
                            "increasing)"
                        )
                s_counts = np.asarray([len(v) for v in vals], np.int32)
                s_max = _bucket_len(
                    max(int(s_counts.max()) if len(vals) else 1, 1),
                    spec.seq_bucket,
                )
                t_raw = max(
                    (len(sub) for v in vals for sub in v), default=1
                )
                t_max = _bucket_len(t_raw, spec.seq_bucket)
                sub_lengths = np.ones((len(vals), s_max), np.int32)
                if spec.kind == "dense_subseq":
                    dim = spec.dim if isinstance(spec.dim, tuple) else (spec.dim,)
                    out = np.zeros((len(vals), s_max, t_max) + dim, spec.dtype)
                else:
                    out = np.zeros((len(vals), s_max, t_max), np.int32)
                for i, subs in enumerate(vals):
                    for s, sub in enumerate(subs[:s_max]):
                        sub = np.asarray(sub, out.dtype)[:t_max]
                        out[i, s, : len(sub)] = sub.reshape(
                            (len(sub),) + out.shape[3:]
                        )
                        sub_lengths[i, s] = max(len(sub), 1)
                batch[n] = out
                batch[n + ".lengths"] = np.minimum(s_counts, s_max)
                batch[n + ".sub_lengths"] = sub_lengths
            elif spec.kind == "sparse_binary":
                out = np.zeros((len(vals), spec.dim), np.float32)
                for i, idxs in enumerate(vals):
                    out[i, np.asarray(idxs, np.int64)] = 1.0
                batch[n] = out
            elif spec.kind == "sparse_binary_seq":
                # vals[i] is a list of per-timestep index lists
                lengths = np.asarray([len(v) for v in vals], np.int32)
                max_len = _bucket_len(int(lengths.max()) if len(vals) else 1, spec.seq_bucket)
                out = np.zeros((len(vals), max_len, spec.dim), np.float32)
                for i, steps in enumerate(vals):
                    for t, idxs in enumerate(steps[:max_len]):
                        out[i, t, np.asarray(idxs, np.int64)] = 1.0
                batch[n] = out
                batch[n + ".lengths"] = np.minimum(lengths, max_len)
            elif spec.kind == "sparse_value":
                out = np.zeros((len(vals), spec.dim), np.float32)
                for i, pairs in enumerate(vals):
                    for j, v in pairs:
                        out[i, j] = v
                batch[n] = out
            else:
                raise ValueError(f"unknown input kind {spec.kind}")
        return batch
