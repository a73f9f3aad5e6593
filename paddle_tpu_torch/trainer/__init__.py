"""The trainer of the port (counterpart of `paddle_tpu/trainer/`):
`SGDTrainer` (`trainer.py`), the training step as one CUDA graph
(`step_graph.py`), checkpoints (`checkpoint.py`, `v1_format.py`), the
events and config-driven generation (`generation.py`)."""

from paddle_tpu_torch.trainer.events import BeginIteration, BeginPass, EndIteration, EndPass
from paddle_tpu_torch.trainer.trainer import DivergenceError, Preempted, SGDTrainer

__all__ = ["BeginIteration", "BeginPass", "DivergenceError", "EndIteration", "EndPass",
           "Preempted", "SGDTrainer"]
