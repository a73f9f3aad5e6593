"""Device policy of the port.

The JAX package runs wherever jax's default backend is. The port is written
for one CUDA card, and its entry points (`ServableLM`, `ServingSession`,
`make_demo_session`) take `device=`:

  * None     -> the current CUDA device; raises when CUDA is absent — a
                serving engine that quietly fell back to the CPU would look
                healthy and be a thousand times slower;
  * "cpu"    -> the CPU, only when asked for (the tests, the CPU half of
                chip_smoke.py's reference check);
  * "cuda[:n]" -> that card, raising when CUDA is absent."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point runs on under the policy above."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"unsupported device {str(dev)!r}: the port runs on 'cuda' or "
            "'cpu'"
        )
    return dev
