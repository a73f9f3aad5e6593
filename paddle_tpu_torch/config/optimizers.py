"""v1 optimizer DSL (counterpart of `paddle_tpu/config/optimizers.py`):
`settings()` + the *Optimizer classes (trainer_config_helpers/optimizers.py;
settings() -> OptimizationConfig, config_parser.py `Settings`).

The classes are thin tags over the v2 optimizer bundles (`v2/optimizer.py`,
which fold the schedule, regularization, clipping and averaging into the
training step); `settings()` records the active OptimizationConfig into the
parsing context so parse_config can emit it, and `build_optimizer` turns it
into the port's optimizer, lr schedule and model average for the CLI.
"""

from __future__ import annotations

from typing import Any, Optional

from paddle_tpu_torch import proto
from paddle_tpu_torch.v2 import optimizer as v2opt

# re-exported v1 names
BaseSGDOptimizer = v2opt._V2Optimizer


class MomentumOptimizer(v2opt.Momentum):
    learning_method = "momentum"


class AdamOptimizer(v2opt.Adam):
    learning_method = "adam"


class AdamaxOptimizer(v2opt.AdaMax):
    learning_method = "adamax"


class AdaGradOptimizer(v2opt.AdaGrad):
    learning_method = "adagrad"


class DecayedAdaGradOptimizer(v2opt.DecayedAdaGrad):
    learning_method = "decayed_adagrad"


class AdaDeltaOptimizer(v2opt.AdaDelta):
    learning_method = "adadelta"


class RmsPropOptimizer(v2opt.RMSProp):
    learning_method = "rmsprop"


L2Regularization = v2opt.L2Regularization
L1Regularization = v2opt.L1Regularization
ModelAverage = v2opt.ModelAverageCfg


class GradientClippingThreshold:
    def __init__(self, threshold: float):
        self.threshold = threshold


_METHODS = {
    "momentum": MomentumOptimizer,
    "sgd": MomentumOptimizer,
    "adam": AdamOptimizer,
    "adamax": AdamaxOptimizer,
    "adagrad": AdaGradOptimizer,
    "decayed_adagrad": DecayedAdaGradOptimizer,
    "adadelta": AdaDeltaOptimizer,
    "rmsprop": RmsPropOptimizer,
}


def build_optimizer(oc: proto.OptimizationConfig) -> v2opt._V2Optimizer:
    """OptimizationConfig → v2 optimizer bundle (optimizer+schedule+avg)."""
    cls = _METHODS.get(oc.learning_method, MomentumOptimizer)
    reg = None
    if oc.l2_weight_decay:
        reg = L2Regularization(oc.l2_weight_decay)
    elif oc.l1_weight_decay:
        reg = L1Regularization(oc.l1_weight_decay)
    kwargs: dict = dict(oc.extra)
    if cls is MomentumOptimizer:
        kwargs.setdefault("momentum", oc.momentum)
    return cls(
        learning_rate=oc.learning_rate,
        learning_rate_decay_a=oc.learning_rate_decay_a,
        learning_rate_decay_b=oc.learning_rate_decay_b,
        learning_rate_schedule=oc.learning_rate_schedule,
        regularization=reg,
        gradient_clipping_threshold=oc.gradient_clipping_threshold or None,
        model_average=(
            ModelAverage(oc.average_window, oc.max_average_window or None)
            if oc.average_window
            else None
        ),
        **kwargs,
    )


def settings(
    batch_size: int = 1,
    learning_rate: float = 0.01,
    learning_method: Optional[Any] = None,
    regularization: Optional[Any] = None,
    gradient_clipping_threshold: Optional[float] = None,
    model_average: Optional[Any] = None,
    learning_rate_decay_a: float = 0.0,
    learning_rate_decay_b: float = 0.0,
    learning_rate_schedule: str = "constant",
    learning_rate_warmup_steps: int = 0,
    average_window: float = 0.0,
    max_average_window: int = 0,
    **extra,
) -> proto.OptimizationConfig:
    """The v1 `settings()` call. Records into the active parsing context
    (config_parser.g_context) and returns the OptimizationConfig."""
    from paddle_tpu_torch.config import config_parser as cp

    oc = proto.OptimizationConfig(
        batch_size=batch_size,
        learning_rate=learning_rate,
        learning_rate_decay_a=learning_rate_decay_a,
        learning_rate_decay_b=learning_rate_decay_b,
        learning_rate_schedule=learning_rate_schedule,
        learning_rate_warmup_steps=learning_rate_warmup_steps,
        average_window=average_window,
        max_average_window=max_average_window,
    )
    if learning_method is not None:
        oc.learning_method = getattr(
            learning_method, "learning_method",
            str(getattr(learning_method, "name", learning_method)),
        )
        for k in ("momentum", "beta1", "beta2", "epsilon", "rho", "nesterov"):
            if hasattr(learning_method, "optimizer") and hasattr(
                learning_method.optimizer, k
            ):
                v = getattr(learning_method.optimizer, k)
                if k == "momentum":
                    oc.momentum = v
                else:
                    oc.extra[k] = v
    if isinstance(regularization, (L1Regularization, L2Regularization)):
        oc.l1_weight_decay = regularization.l1 or 0.0
        oc.l2_weight_decay = regularization.l2 or 0.0
    if isinstance(model_average, ModelAverage):
        oc.average_window = model_average.average_window
        oc.max_average_window = model_average.max_average_window or 0
    if isinstance(gradient_clipping_threshold, GradientClippingThreshold):
        gradient_clipping_threshold = gradient_clipping_threshold.threshold
    if gradient_clipping_threshold:
        oc.gradient_clipping_threshold = float(gradient_clipping_threshold)
    oc.extra.update({k: v for k, v in extra.items() if isinstance(v, (int, float, str, bool))})
    cp.g_context().opt_config = oc
    return oc
