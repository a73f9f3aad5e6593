"""Optimizers, lr schedules and model averaging of the port (counterpart of
`paddle_tpu/optim/`)."""

from paddle_tpu_torch.optim import schedules as schedules  # noqa: F401
from paddle_tpu_torch.optim.average import ModelAverage
from paddle_tpu_torch.optim.optimizers import (
    SGD, AdaDelta, AdaGrad, Adam, AdaMax, DecayedAdaGrad, Momentum, Optimizer, RMSProp,
)

__all__ = ["AdaDelta", "AdaGrad", "AdaMax", "Adam", "DecayedAdaGrad", "ModelAverage",
           "Momentum", "Optimizer", "RMSProp", "SGD", "schedules"]
