"""First-order optimizers (counterpart of `paddle_tpu/optim/optimizers.py`):
the `Optimizer.update_one` semantics (static parameters, clipping, L2 decay
folded into the gradient, per-parameter lr scale, L1 shrinkage after the
step) with `SGD` (momentum / nesterov) and `Adam` (bias correction from the
step counter t).

Functional like the JAX package: `update(grads, state, params, lr)` returns
new parameter tensors and a new state and changes nothing it was given.
All math is f32."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from paddle_tpu_torch.nn.graph import ParamAttr

Params = Dict[str, torch.Tensor]
Slots = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class Optimizer:
    """Base: per-parameter lr scale, L1/L2 decay, clipping, static params.
    `learning_rate` is the base lr; the trainer's schedule scales it."""

    learning_rate: float = 0.01
    l1_rate: float = 0.0
    l2_rate: float = 0.0
    gradient_clipping_threshold: float = 0.0
    # set by the trainer from Network.param_attrs
    param_attrs: Dict[str, ParamAttr] = dataclasses.field(default_factory=dict)

    def init_param_state(self, p: torch.Tensor) -> Slots:
        return ()

    def apply_param(self, g: torch.Tensor, s: Slots, p: torch.Tensor, lr: float,
                    t: int) -> Tuple[torch.Tensor, Slots]:
        raise NotImplementedError

    def init_state(self, params: Params) -> Dict[str, Any]:
        return {"slots": {k: self.init_param_state(p) for k, p in params.items()},
                "t": 0}

    def update_one(self, name: str, g: torch.Tensor, s: Slots, p: torch.Tensor,
                   lr: float, t: int) -> Tuple[torch.Tensor, Slots]:
        """One parameter's update with its ParamAttr semantics; `t` is the
        1-based step counter (Adam's bias correction)."""
        attr = self.param_attrs.get(name) or ParamAttr()
        if attr.is_static:
            return p, s
        g = g.float()
        clip = attr.gradient_clipping_threshold or self.gradient_clipping_threshold
        if clip:
            g = g.clamp(-clip, clip)
        l2 = attr.l2_decay if attr.l2_decay is not None else self.l2_rate
        if l2:
            g = g + l2 * p
        plr = lr * attr.learning_rate
        new_p, new_s = self.apply_param(g, s, p, plr, t)
        l1 = attr.l1_decay if attr.l1_decay is not None else self.l1_rate
        if l1:
            new_p = torch.sign(new_p) * (new_p.abs() - plr * l1).clamp(min=0.0)
        return new_p, new_s

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any], params: Params,
               lr: float) -> Tuple[Params, Dict[str, Any]]:
        t = state["t"] + 1
        new_params: Params = {}
        new_slots: Dict[str, Slots] = {}
        for k, p in params.items():
            new_params[k], new_slots[k] = self.update_one(
                k, grads[k], state["slots"][k], p, lr, t)
        return new_params, {"slots": new_slots, "t": t}


@dataclasses.dataclass
class SGD(Optimizer):
    """Plain / momentum / nesterov SGD."""

    momentum: float = 0.0
    nesterov: bool = False

    def init_param_state(self, p):
        return (torch.zeros_like(p),) if self.momentum else ()

    def apply_param(self, g, s, p, lr, t):
        if not self.momentum:
            return p - lr * g, ()
        (v,) = s
        v = self.momentum * v - lr * g
        step = self.momentum * v - lr * g if self.nesterov else v
        return p + step, (v,)


@dataclasses.dataclass
class Adam(Optimizer):
    """Adam with bias correction (the reference's adamApply)."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_param_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    def apply_param(self, g, s, p, lr, t):
        m, v = s
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        return p - lr * mhat / (torch.sqrt(vhat) + self.epsilon), (m, v)
