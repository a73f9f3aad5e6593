"""paddle.v2.minibatch analog (counterpart of `paddle_tpu/v2/minibatch.py`)."""

from paddle_tpu_torch.data.reader import batch  # noqa: F401
