"""Readers and the feeder of the port (counterpart of `paddle_tpu/data/`):
the reader combinators (`reader.py`), `DataFeeder` with its input specs
(`feeder.py`), the device prefetcher (`pipeline.py`), the
PyDataProvider2 surface (`provider.py`), the ProtoData shards and
providers (`proto_data.py`), the v2 dataset readers (`datasets/`), the
image helpers (`image.py`) and the sharded readers (`sharded_reader.py`)."""

from paddle_tpu_torch.data import reader as reader  # noqa: F401
from paddle_tpu_torch.data.feeder import (  # noqa: F401
    DataFeeder, InputSpec, dense_array, dense_vector, dense_vector_sequence,
    dense_vector_sub_sequence, integer_value, integer_value_sequence,
    integer_value_sub_sequence, sparse_binary_vector, sparse_value_slot,
)
from paddle_tpu_torch.data.pipeline import (  # noqa: F401
    DevicePrefetcher, StackedBatch, coerce_batch, is_device_batch, iter_async,
)
from paddle_tpu_torch.data.provider import (  # noqa: F401
    CacheType, DataProviderConverter, DataProviderWrapper, DoubleBuffer,
    MultiDataProvider, provider,
)
