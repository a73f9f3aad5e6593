"""paddle.v2.optimizer analog (counterpart of `paddle_tpu/v2/optimizer.py`;
python/paddle/v2/optimizer.py + trainer_config_helpers/optimizers.py
settings()).

Each class bundles the gradient rule (`optim/optimizers.py`) with the v1
`settings()` knobs: the lr decay schedule (learning_rate_decay_a/b + the
schedule's name, LearningRateScheduler.cpp:30, `optim/schedules.py`),
regularization, gradient clipping and model averaging
(`optim/average.py`), all of which run inside the training step.
"""

from __future__ import annotations

from typing import Any, Optional

from paddle_tpu_torch.optim import optimizers as opt_mod
from paddle_tpu_torch.optim import schedules as sched_mod
from paddle_tpu_torch.optim.average import ModelAverage


class _V2Optimizer:
    """Bundles an optim.Optimizer with schedule + averaging settings."""

    opt_cls = opt_mod.SGD
    opt_kwargs = ()

    def __init__(
        self,
        learning_rate: float = 1e-3,
        learning_rate_decay_a: float = 0.0,
        learning_rate_decay_b: float = 0.0,
        learning_rate_schedule: str = "constant",
        regularization: Optional[Any] = None,
        gradient_clipping_threshold: Optional[float] = None,
        model_average: Optional[Any] = None,
        batch_size: Optional[int] = None,  # accepted for settings() compat
        **extra,
    ):
        self.learning_rate = learning_rate
        kwargs = {k: extra.pop(k) for k in list(extra) if k in self.opt_kwargs}
        l1, l2 = None, None
        if regularization is not None:
            l1 = getattr(regularization, "l1", None)
            l2 = getattr(regularization, "l2", None)
        self.optimizer = self.opt_cls(
            learning_rate=learning_rate,
            l1_rate=l1 or 0.0,
            l2_rate=l2 or 0.0,
            gradient_clipping_threshold=gradient_clipping_threshold,
            **kwargs,
        )
        self.schedule = sched_mod.build(
            learning_rate,
            schedule=learning_rate_schedule,
            decay_a=learning_rate_decay_a,
            decay_b=learning_rate_decay_b,
        )
        avg_window = getattr(model_average, "average_window", model_average) or 0.0
        # the window's cap too: the JAX package's bundle drops it (ROADMAP.md
        # §3), which leaves the average uncapped
        max_window = getattr(model_average, "max_average_window", None) or 0
        self.model_average = ModelAverage(float(avg_window), int(max_window))


class Momentum(_V2Optimizer):
    opt_cls = opt_mod.SGD
    opt_kwargs = ("momentum", "nesterov")

    def __init__(self, momentum=0.0, sparse=False, **kw):
        # sparse-update flag is a pserver-era storage knob; row-sparse grads
        # are handled by the sharded-embedding path (paddle_tpu.parallel)
        super().__init__(momentum=momentum, **kw)


class Adam(_V2Optimizer):
    opt_cls = opt_mod.Adam
    opt_kwargs = ("beta1", "beta2", "epsilon")

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(beta1=beta1, beta2=beta2, epsilon=epsilon, **kw)


class AdaMax(_V2Optimizer):
    opt_cls = opt_mod.AdaMax
    opt_kwargs = ("beta1", "beta2")

    def __init__(self, beta1=0.9, beta2=0.999, **kw):
        super().__init__(beta1=beta1, beta2=beta2, **kw)


class AdaGrad(_V2Optimizer):
    opt_cls = opt_mod.AdaGrad
    opt_kwargs = ("epsilon",)


class DecayedAdaGrad(_V2Optimizer):
    opt_cls = opt_mod.DecayedAdaGrad
    opt_kwargs = ("rho", "epsilon")

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(rho=rho, epsilon=epsilon, **kw)


class AdaDelta(_V2Optimizer):
    opt_cls = opt_mod.AdaDelta
    opt_kwargs = ("rho", "epsilon")

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(rho=rho, epsilon=epsilon, **kw)


class RMSProp(_V2Optimizer):
    opt_cls = opt_mod.RMSProp
    opt_kwargs = ("rho", "epsilon")

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(rho=rho, epsilon=epsilon, **kw)


class L2Regularization:
    def __init__(self, rate: float):
        self.l1 = None
        self.l2 = rate


class L1Regularization:
    def __init__(self, rate: float):
        self.l1 = rate
        self.l2 = None


class ModelAverageCfg:
    def __init__(self, average_window: float, max_average_window: Optional[int] = None):
        self.average_window = average_window
        self.max_average_window = max_average_window
