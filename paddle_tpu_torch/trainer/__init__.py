"""The trainer of the port (counterpart of `paddle_tpu/trainer/`):
`SGDTrainer` (`trainer.py`), the training step as one CUDA graph
(`step_graph.py`), checkpoints (`checkpoint.py`, `v1_format.py`), the
events, config-driven generation (`generation.py`) and the GAN demo's
alternating phases (`multi_network.py`)."""

from paddle_tpu_torch.trainer.events import BeginIteration, BeginPass, EndIteration, EndPass
from paddle_tpu_torch.trainer.trainer import DivergenceError, Preempted, SGDTrainer
from paddle_tpu_torch.trainer.multi_network import MultiNetworkTrainer

__all__ = ["BeginIteration", "BeginPass", "DivergenceError", "EndIteration", "EndPass",
           "MultiNetworkTrainer", "Preempted", "SGDTrainer"]
