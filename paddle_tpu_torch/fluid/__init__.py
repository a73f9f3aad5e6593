"""The fluid graph runtime of the port (counterpart of `paddle_tpu/fluid/`;
SURVEY §2.3): ProgramDesc / Block / OpDesc, Scope, the op registry, the
Executor (a run op by op, on the card one CUDA graph per feed signature),
append_backward, the layers API and the optimizers. `scope_from_arrays`
builds a Scope from host arrays by name (`Scope.numpy()` reads one back),
so a program can start from a JAX package Scope's values."""

from paddle_tpu_torch.fluid import layers, optimizer
from paddle_tpu_torch.fluid.backward import append_backward
from paddle_tpu_torch.fluid.executor import Executor, scope_from_arrays
from paddle_tpu_torch.fluid.framework import (
    Block,
    OpDesc,
    Program,
    Scope,
    VarDesc,
    Variable,
)
from paddle_tpu_torch.fluid.layers import default_main_program, reset_default_program
from paddle_tpu_torch.fluid.ops import OPS

__all__ = [
    "Program", "Block", "Variable", "VarDesc", "OpDesc", "Scope", "Executor",
    "append_backward", "layers", "optimizer", "OPS",
    "default_main_program", "reset_default_program", "scope_from_arrays",
]
