"""paddle_tpu_torch: the PyTorch/CUDA port of `paddle_tpu`, for one NVIDIA H100.

`paddle_tpu/` (JAX/XLA/Pallas) stays the reference; this package mirrors its
layout module by module (`paddle_tpu_torch/serving/model.py` is the
counterpart of `paddle_tpu/serving/model.py`, and so on) and imports neither
jax nor anything of `paddle_tpu`. Every Pallas kernel on a ported path is a
kernel written by hand for Hopper (`csrc/*.cu`, built with nvcc at first use
by `ops/build.py`), with its plain PyTorch version beside it in the same
module: the wrapper takes the plain version only for tensors on the CPU.

Device policy (`device.py`): entry points take `device=`; None means CUDA and
raises when no CUDA device is present — the CPU runs only when the caller
passes `device="cpu"`, as the tests do.

Ported so far: the paged-KV serving engine (`serving/`), in process
(`ServingSession.submit` + `run_until_idle`) or behind its RPC server
(`serving/server.py` over `runtime/`, `python -m paddle_tpu_torch serve`),
with speculative decoding and the supervised engine thread; seq2seq NMT, LSTM
text-classification, ResNet-50 and LeNet training (`nn/`, `optim/`,
`trainer/`, `models/`, with the bf16 policy of `core/dtypes.py`); the fused
attention op (`ops/attention.dot_product_attention`).
Every Pallas kernel of the JAX package has its CUDA counterpart."""

from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
