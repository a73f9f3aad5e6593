"""The trainer of the port (counterpart of `paddle_tpu/trainer/`):
`SGDTrainer` (`trainer.py`), the training step as one CUDA graph
(`step_graph.py`), checkpoints (`checkpoint.py`, `v1_format.py`) and the
events."""

from paddle_tpu_torch.trainer.trainer import SGDTrainer

__all__ = ["SGDTrainer"]
