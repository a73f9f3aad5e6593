"""Optimizers and lr schedules of the port (counterpart of
`paddle_tpu/optim/`)."""

from paddle_tpu_torch.optim.optimizers import SGD, Adam, Optimizer

__all__ = ["Adam", "Optimizer", "SGD"]
