"""`layer_math` DSL namespace + arithmetic operators on graph layers
(counterpart of `paddle_tpu/config/layer_math.py`;
trainer_config_helpers/layer_math.py): unary math as mixed layers with the
matching activation, and +,-,* overloads building slope_intercept / scaling /
identity-projection-sum subgraphs, so `1 + layer_math.exp(x) * z` in a config
script builds the same layer graph as the reference, its scalar forms
through slope_intercept, repeat and scaling."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.nn.graph import Layer, _auto_name

__all__ = []


def _helpers():
    from paddle_tpu_torch.config import helpers

    return helpers


def _size_of(node: Layer) -> Optional[int]:
    from paddle_tpu_torch.config.v1_layers import _size_of as sz

    return sz(node)


def _keep_size(node: Layer, src: Layer) -> Layer:
    s = _size_of(src)
    if s is not None:
        node._v1_size = s
    return node


def _unary(op_name: str, act_name: str):
    def op(input, name=None):
        h = _helpers()
        node = h.mixed_layer(
            input=[h.identity_projection(input=input)],
            name=name or _auto_name(op_name),
            act=act_name,
        )
        return _keep_size(node, input)

    op.__name__ = op_name
    globals()[op_name] = op
    __all__.append(op_name)


for _op, _act in (
    ("exp", "exponential"), ("log", "log"), ("abs", "abs"),
    ("sigmoid", "sigmoid"), ("tanh", "tanh"), ("square", "square"),
    ("relu", "relu"), ("sqrt", "sqrt"), ("reciprocal", "reciprocal"),
):
    _unary(_op, _act)


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def add(layer, other):
    h = _helpers()
    if _is_number(other):
        return _keep_size(
            h.slope_intercept_layer(input=layer, intercept=other), layer
        )
    if not isinstance(other, Layer):
        raise TypeError("a layer can only be added to another layer or a number")
    a, b = layer, other
    sa, sb = _size_of(a), _size_of(b)
    if sa != sb:
        if sb != 1 and sa != 1:
            raise ValueError(
                f"layer addition needs equal sizes or a size-1 side ({sa} vs {sb})"
            )
        if sa == 1:
            a, b, sa = b, a, sb
        b = _keep_size(h.repeat_layer(b, sa), a)
    return _keep_size(
        h.mixed_layer(
            input=[h.identity_projection(input=a), h.identity_projection(input=b)]
        ),
        a,
    )


def sub(layer, other):
    h = _helpers()
    if _is_number(other):
        # NOTE: reference layer_math.sub passes intercept=+other (its goldens
        # encode y-2 as intercept: 2); kept verbatim for config parity
        return _keep_size(
            h.slope_intercept_layer(input=layer, intercept=other), layer
        )
    if not isinstance(other, Layer):
        raise TypeError("a layer can only be subtracted by another layer or a number")
    return add(layer, _keep_size(
        h.slope_intercept_layer(input=other, slope=-1.0), other
    ))


def rsub(layer, other):
    h = _helpers()
    return add(_keep_size(
        h.slope_intercept_layer(input=layer, slope=-1.0), layer
    ), other)


def mul(layer, other):
    h = _helpers()
    if _is_number(other):
        return _keep_size(
            h.slope_intercept_layer(input=layer, slope=other), layer
        )
    if not isinstance(other, Layer):
        raise TypeError("a layer can only be multiplied by another layer or a number")
    if _size_of(layer) == 1:
        return _keep_size(h.scaling_layer(input=other, weight=layer), other)
    if _size_of(other) == 1:
        return _keep_size(h.scaling_layer(input=layer, weight=other), layer)
    raise ValueError("'*' needs a number or a size-1 layer on one side")


# the reference patches these straight onto LayerOutput; same move here
Layer.__add__ = add
Layer.__radd__ = add
Layer.__sub__ = sub
Layer.__rsub__ = rsub
Layer.__mul__ = mul
Layer.__rmul__ = mul

__all__ += ["add", "sub", "rsub", "mul"]
