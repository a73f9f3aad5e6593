"""Readers and the feeder of the port (counterpart of `paddle_tpu/data/`):
the reader combinators (`reader.py`) and `DataFeeder` with its input specs
(`feeder.py`). The JAX package's device prefetcher has no counterpart yet
(ROADMAP.md)."""

from paddle_tpu_torch.data import reader as reader  # noqa: F401
from paddle_tpu_torch.data.feeder import (  # noqa: F401
    DataFeeder, InputSpec, dense_array, dense_vector, dense_vector_sequence,
    dense_vector_sub_sequence, integer_value, integer_value_sequence,
    integer_value_sub_sequence, sparse_binary_vector, sparse_value_slot,
)
