"""The trainer of the port (counterpart of `paddle_tpu/trainer/`)."""

from paddle_tpu_torch.trainer.trainer import SGDTrainer

__all__ = ["SGDTrainer"]
