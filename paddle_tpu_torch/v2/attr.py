"""paddle.v2.attr analog (counterpart of `paddle_tpu/v2/attr.py`;
trainer_config_helpers/attrs.py: ParamAttr/ExtraAttr)."""

from __future__ import annotations

from typing import Any, Optional

from paddle_tpu_torch.nn.graph import ParamAttr as _GraphParamAttr


def Param(
    name: Optional[str] = None,
    is_static: bool = False,
    initial_std: Optional[float] = None,
    initial_mean: float = 0.0,
    learning_rate: float = 1.0,
    momentum: Optional[float] = None,
    l1_rate: Optional[float] = None,
    l2_rate: Optional[float] = None,
    sparse_update: bool = False,
    gradient_clipping_threshold: Optional[float] = None,
    sharding: Any = None,
    initializer: Any = None,
    initial_min: Optional[float] = None,
    initial_max: Optional[float] = None,
) -> _GraphParamAttr:
    """ParameterAttribute factory keeping the reference's knob names."""
    return _GraphParamAttr(
        name=name,
        initializer=initializer,
        initial_min=initial_min,
        initial_max=initial_max,
        initial_std=initial_std,
        initial_mean=initial_mean,
        learning_rate=learning_rate,
        momentum=momentum,
        l1_decay=l1_rate,
        l2_decay=l2_rate,
        is_static=is_static,
        is_sparse=sparse_update,
        gradient_clipping_threshold=gradient_clipping_threshold,
        sharding=tuple(sharding) if sharding is not None else None,
    )


ParamAttr = Param


class ExtraAttr:
    """ExtraLayerAttribute: drop_rate and error-clipping knobs."""

    def __init__(
        self,
        error_clipping_threshold: Optional[float] = None,
        drop_rate: Optional[float] = None,
        device: Optional[int] = None,
    ):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device  # accepted for compat; sharding replaces devices


ExtraLayerAttribute = ExtraAttr
