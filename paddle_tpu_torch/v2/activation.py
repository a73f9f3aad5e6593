"""paddle.v2.activation analog (counterpart of `paddle_tpu/v2/activation.py`;
trainer_config_helpers/activations.py).

Each class is a lightweight tag whose ``name`` matches a registry key of
`paddle_tpu_torch/nn/activations.py` (the ActivationFunction registry
analog, paddle/gserver/activations/ActivationFunction.cpp:40-63). Layer
wrappers accept either these tag instances or plain strings.
"""

from __future__ import annotations


class BaseActivation:
    name: str = "linear"

    def __repr__(self):
        return f"<activation {self.name}>"


def _make(nm: str):
    cls = type(nm.capitalize() + "Activation", (BaseActivation,), {"name": nm})
    return cls


Linear = _make("linear")
Sigmoid = _make("sigmoid")
Softmax = _make("softmax")
SequenceSoftmax = _make("softmax")  # sequence-aware variant resolved by the layer
Relu = _make("relu")
BRelu = _make("brelu")
Tanh = _make("tanh")
STanh = _make("stanh")
SoftRelu = _make("softrelu")
Abs = _make("abs")
Square = _make("square")
Exp = _make("exponential")
Log = _make("log")
Sqrt = _make("sqrt")
Reciprocal = _make("reciprocal")
Identity = Linear  # IdentityActivation is the reference's alias for linear


def resolve(act) -> str:
    """Activation tag | string | None → registry name or None."""
    if act is None:
        return None
    if isinstance(act, str):
        return act
    if isinstance(act, BaseActivation) or (
        isinstance(act, type) and issubclass(act, BaseActivation)
    ):
        return act.name
    raise TypeError(f"not an activation: {act!r}")
