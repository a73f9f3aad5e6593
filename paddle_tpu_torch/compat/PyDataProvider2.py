"""`paddle.trainer.PyDataProvider2` on the port: the @provider surface
(python/paddle/trainer/PyDataProvider2.py:365 @provider and the input types
:63-236), from `data/provider.py` and `data/feeder.py`."""

from paddle_tpu_torch.data.feeder import (  # noqa: F401
    dense_array,
    dense_vector,
    dense_vector_sequence,
    dense_vector_sub_sequence,
    integer_value,
    integer_value_sequence,
    integer_value_sub_sequence,
    sparse_binary_vector,
    sparse_value_slot,
)
from paddle_tpu_torch.data.provider import (  # noqa: F401
    CacheType,
    DataProviderWrapper,
    Settings,
    provider,
)

# sequence variants the reference exposes under several historical names
sparse_binary_vector_sequence = sparse_binary_vector
integer_sequence = integer_value_sequence

__all__ = [
    "provider", "CacheType", "DataProviderWrapper", "Settings",
    "dense_vector", "dense_array", "dense_vector_sequence", "integer_value",
    "integer_value_sequence", "integer_value_sub_sequence",
    "dense_vector_sub_sequence", "integer_sequence", "sparse_binary_vector",
    "sparse_binary_vector_sequence", "sparse_value_slot",
]
