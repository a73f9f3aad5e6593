"""paddle.v2.data_type analog (counterpart of `paddle_tpu/v2/data_type.py`)
— input type declarations used by layer.data.

Maps to the PyDataProvider2 input-type system
(python/paddle/trainer/PyDataProvider2.py:63-236) via the port's
`data/feeder.py` InputSpec. Names follow the reference exactly so v2
scripts port verbatim.
"""

from __future__ import annotations

from paddle_tpu_torch.data.feeder import (  # noqa: F401
    InputSpec,
    dense_array,
    dense_vector,
    dense_vector_sequence,
    integer_value,
    integer_value_sequence,
    sparse_binary_vector,
    sparse_value_slot,
)

# reference aliases (PyDataProvider2.py)
sparse_float_vector = sparse_value_slot
sparse_vector = sparse_value_slot


def sparse_binary_vector_sequence(dim: int) -> InputSpec:
    # padded [B, T, dim] sequence of multi-hot rows (feeder kind sparse_binary_seq)
    return InputSpec("sparse_binary_seq", dim)
