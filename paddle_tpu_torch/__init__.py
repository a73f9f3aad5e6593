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

Ported so far: the paged-KV serving engine (`serving/`), driven in process
through `ServingSession.submit` + `run_until_idle`."""

from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
