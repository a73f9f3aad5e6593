"""Layer-name crash context — utils/CustomStackTrace.h parity (the port's
copy of `paddle_tpu/core/stack_trace.py`).

The reference pushes each layer's name while executing forward/backward
(NeuralNetwork.cpp:259-261) and dumps the stack from the glog failure handler
on crash (Logging.cpp:30). Here the same stack is kept per-thread and woven
into the exception chain, so a shape error deep in a forward reports WHICH
layer was being built."""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List

_tls = threading.local()


def _stack() -> List[str]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


@contextlib.contextmanager
def layer_frame(name: str) -> Iterator[None]:
    stack = _stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def current_stack() -> List[str]:
    return list(_stack())


def format_stack() -> str:
    s = _stack()
    if not s:
        return ""
    return " -> ".join(s)


class LayerError(RuntimeError):
    """Raised when a layer's forward fails; carries the layer stack."""

    def __init__(self, layer_name: str, stack: List[str], cause: BaseException):
        self.layer_name = layer_name
        self.layer_stack = stack
        super().__init__(
            f"error in layer {layer_name!r} "
            f"(layer stack: {' -> '.join(stack) or layer_name}): "
            f"{type(cause).__name__}: {cause}"
        )
