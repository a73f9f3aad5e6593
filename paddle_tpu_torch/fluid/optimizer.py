"""The fluid optimizers (counterpart of `paddle_tpu/fluid/optimizer.py`;
python/paddle/v2/framework/optimizer.py): `minimize(loss)` appends the
backward op and the per-parameter optimizer ops (sgd_op / momentum_op /
adam_op ...) with their slots to the program."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch.fluid.backward import append_backward
from paddle_tpu_torch.fluid.framework import Variable


class Optimizer:
    op_type = "sgd"

    def __init__(self, learning_rate: float = 0.01):
        self.learning_rate = learning_rate

    def _lr_var(self, block):
        name = f"{self.op_type}_lr"
        if name in block.vars:
            return block.vars[name]
        return block.create_parameter(
            name, shape=[], initializer=("constant", self.learning_rate),
            trainable=False,
        )

    def _slots(self, block, param: Variable) -> dict:
        return {}

    def _extra_attrs(self) -> dict:
        return {}

    def _io(self, param, grad, lr, slots) -> Tuple[dict, dict]:
        return (
            {"Param": param, "Grad": grad, "LearningRate": lr},
            {"ParamOut": param},
        )

    def minimize(
        self, loss: Variable, parameter_list: Optional[Sequence[Variable]] = None
    ) -> List[tuple]:
        block = loss.block.program.global_block()
        pg = append_backward(loss, parameter_list)
        lr = self._lr_var(block)
        for param, grad in pg:
            slots = self._slots(block, param)
            ins, outs = self._io(param, grad, lr, slots)
            block.append_op(self.op_type, ins, outs, self._extra_attrs())
        return pg


class SGDOptimizer(Optimizer):
    op_type = "sgd"


class MomentumOptimizer(Optimizer):
    op_type = "momentum"

    def __init__(self, learning_rate=0.01, momentum=0.9, use_nesterov=False):
        super().__init__(learning_rate)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _slots(self, block, param):
        v = block.create_parameter(
            f"{param.name}_velocity", shape=param.desc.shape,
            initializer=("constant", 0.0), trainable=False,
        )
        return {"Velocity": v}

    def _extra_attrs(self):
        return {"mu": self.momentum, "use_nesterov": self.use_nesterov}

    def _io(self, param, grad, lr, slots):
        return (
            {"Param": param, "Grad": grad, "LearningRate": lr,
             "Velocity": slots["Velocity"]},
            {"ParamOut": param, "VelocityOut": slots["Velocity"]},
        )


class AdagradOptimizer(Optimizer):
    op_type = "adagrad"

    def __init__(self, learning_rate=0.01, epsilon=1e-6):
        super().__init__(learning_rate)
        self.epsilon = epsilon

    def _slots(self, block, param):
        m = block.create_parameter(
            f"{param.name}_moment", shape=param.desc.shape,
            initializer=("constant", 0.0), trainable=False,
        )
        return {"Moment": m}

    def _extra_attrs(self):
        return {"epsilon": self.epsilon}

    def _io(self, param, grad, lr, slots):
        return (
            {"Param": param, "Grad": grad, "LearningRate": lr,
             "Moment": slots["Moment"]},
            {"ParamOut": param, "MomentOut": slots["Moment"]},
        )


class AdamOptimizer(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _slots(self, block, param):
        mk = lambda tag, val=0.0, shape=None: block.create_parameter(
            f"{param.name}_{tag}",
            shape=param.desc.shape if shape is None else shape,
            initializer=("constant", val), trainable=False,
        )
        return {
            "Moment1": mk("moment1"),
            "Moment2": mk("moment2"),
            "Beta1Pow": mk("beta1_pow", self.beta1, []),
            "Beta2Pow": mk("beta2_pow", self.beta2, []),
        }

    def _extra_attrs(self):
        return {"beta1": self.beta1, "beta2": self.beta2, "epsilon": self.epsilon}

    def _io(self, param, grad, lr, slots):
        ins = {"Param": param, "Grad": grad, "LearningRate": lr, **slots}
        outs = {
            "ParamOut": param,
            "Moment1Out": slots["Moment1"],
            "Moment2Out": slots["Moment2"],
            "Beta1PowOut": slots["Beta1Pow"],
            "Beta2PowOut": slots["Beta2Pow"],
        }
        return ins, outs
