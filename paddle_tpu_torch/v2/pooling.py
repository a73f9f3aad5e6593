"""paddle.v2.pooling analog (counterpart of `paddle_tpu/v2/pooling.py`;
trainer_config_helpers/poolings.py)."""

from __future__ import annotations


class BasePoolingType:
    name = "max"


class Max(BasePoolingType):
    """poolings.py MaxPooling; output_max_index mirrors MaxLayer's
    argmax-output mode (accepted; the index output is maxid semantics)."""

    name = "max"

    def __init__(self, output_max_index=None):
        self.output_max_index = output_max_index


class Avg(BasePoolingType):
    STRATEGY_AVG = "average"
    STRATEGY_SUM = "sum"
    STRATEGY_SQROOTN = "squarerootn"

    name = "avg"

    def __init__(self, strategy=STRATEGY_AVG):
        self.name = {"average": "avg", "sum": "sum", "squarerootn": "sqrt"}[strategy]


class Sum(Avg):
    name = "sum"

    def __init__(self):
        super().__init__(Avg.STRATEGY_SUM)


class SquareRootN(Avg):
    name = "sqrt"

    def __init__(self):
        super().__init__(Avg.STRATEGY_SQROOTN)


# cuDNN variants in the reference are just kernels for the same math
CudnnMax = Max
CudnnAvg = Avg


def resolve(p) -> str:
    if p is None:
        return "max"
    if isinstance(p, str):
        return p
    if isinstance(p, BasePoolingType) or (
        isinstance(p, type) and issubclass(p, BasePoolingType)
    ):
        return p.name
    raise TypeError(f"not a pooling type: {p!r}")
