"""The native host optimizer (counterpart of `paddle_tpu/runtime/optimizer.py`;
paddle/optimizer parity: the C ABI the reference's Go pserver consumes).
In-place float32 updates of host parameter arrays by sgd (momentum,
nesterov), adagrad, adadelta or adam, under a constant or linear lr
policy, with checkpointable slot state (`serialize` / `deserialize`)."""

from __future__ import annotations

import ctypes as C

import numpy as np

from paddle_tpu_torch.runtime import native

_TYPES = {"sgd": 0, "adagrad": 1, "adadelta": 2, "adam": 3}
_LR_POLICIES = {"const": 0, "linear": 1}


class NativeOptimizer:
    def __init__(self, kind: str = "sgd", learning_rate: float = 0.01, momentum: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8,
                 rho: float = 0.95, weight_decay: float = 0.0, nesterov: bool = False,
                 lr_policy: str = "const", lr_decay_a: float = 0.0, lr_decay_b: float = 0.0):
        if kind not in _TYPES:
            raise ValueError(f"unknown optimizer kind {kind!r}; got {sorted(_TYPES)}")
        if lr_policy not in _LR_POLICIES:
            raise ValueError(f"unknown lr policy {lr_policy!r}; got {sorted(_LR_POLICIES)}")
        self._lib = native.lib()
        self.kind = kind
        self._h = self._lib.pt_opt_create(_TYPES[kind], learning_rate, momentum, beta1, beta2,
                                          epsilon, rho, weight_decay, int(nesterov))
        if lr_policy != "const":
            self._lib.pt_opt_set_lr_policy(self._h, _LR_POLICIES[lr_policy], lr_decay_a,
                                           lr_decay_b)

    def update(self, param: np.ndarray, grad: np.ndarray) -> np.ndarray:
        """Update a writeable contiguous float32 array in place and return
        it; raises TypeError rather than update a copy."""
        if not (isinstance(param, np.ndarray) and param.dtype == np.float32
                and param.flags["C_CONTIGUOUS"] and param.flags["WRITEABLE"]):
            raise TypeError("param must be a writeable contiguous float32 ndarray (in-place "
                            "update); convert with np.ascontiguousarray(p, np.float32)")
        g = np.ascontiguousarray(grad, np.float32)
        if param.shape != g.shape:
            raise ValueError(f"param {param.shape} vs grad {g.shape}")
        rc = self._lib.pt_opt_update(self._h, param.ctypes.data_as(C.POINTER(C.c_float)),
                                     g.ctypes.data_as(C.POINTER(C.c_float)), param.size)
        if rc != 0:
            raise ValueError("optimizer slot state sized for a different parameter "
                             f"(got {param.size} elements)")
        return param

    @property
    def current_lr(self) -> float:
        return float(self._lib.pt_opt_current_lr(self._h))

    def serialize(self) -> bytes:
        need = self._lib.pt_opt_serialize(self._h, None, 0)
        buf = C.create_string_buffer(need)
        if self._lib.pt_opt_serialize(self._h, buf, need) != need:
            raise RuntimeError("optimizer serialization failed")
        return buf.raw

    def deserialize(self, blob: bytes) -> None:
        if self._lib.pt_opt_deserialize(self._h, blob, len(blob)) != 0:
            raise ValueError("bad optimizer state blob (magic/type mismatch)")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.pt_opt_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
