"""First-order optimizers (counterpart of `paddle_tpu/optim/optimizers.py`):
the `Optimizer.update_one` semantics (static parameters, clipping, L2 decay
folded into the gradient, per-parameter lr scale, L1 shrinkage after the
step) with `SGD` (momentum / nesterov) and `Adam` (bias correction from the
step counter t).

The state is {"slots": {name: (tensor, ...)}, "t": 0-d int32 tensor}, laid
out as the JAX package lays it out, with `t` on the parameters' device.
`update(grads, state, params, lr)` writes the new values into the
parameters', the slots' and `t`'s own storage (`copy_` of the functional
result, so the numbers are those of `update_one`) and returns nothing: a
CUDA graph of the training step (`trainer/step_graph.py`) holds raw
pointers to that storage, and reads `t` and `lr` (a 0-d f32 tensor) as
tensors, where a Python number would be baked into the graph as a constant.
`update_one` stays functional and takes `lr` and `t` as numbers or 0-d
tensors. All math is f32; Adam's bias correction 1 - beta^t is computed in
f64 and rounded once to f32, as Python's float arithmetic rounds it."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from paddle_tpu_torch.nn.graph import ParamAttr

Params = Dict[str, torch.Tensor]
Slots = Tuple[torch.Tensor, ...]
Number = Union[float, int, torch.Tensor]


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

    def step_constants(self, t: torch.Tensor) -> Any:
        """What every parameter's update of one step shares, computed once
        a step from the new `t` (Adam: its two bias corrections)."""
        return None

    def apply_param(self, g: torch.Tensor, s: Slots, p: torch.Tensor, lr: Number,
                    t: Number) -> Tuple[torch.Tensor, Slots]:
        raise NotImplementedError

    def init_state(self, params: Params) -> Dict[str, Any]:
        dev = next(iter(params.values())).device if params else None
        return {"slots": {k: self.init_param_state(p) for k, p in params.items()},
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update_one(self, name: str, g: torch.Tensor, s: Slots, p: torch.Tensor,
                   lr: Number, t: Number) -> Tuple[torch.Tensor, Slots]:
        """One parameter's update with its ParamAttr semantics; `t` is the
        1-based step counter (Adam's bias correction). Functional: returns
        the new parameter and slots."""
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
        plr = lr if attr.learning_rate == 1.0 else lr * attr.learning_rate
        new_p, new_s = self.apply_param(g, s, p, plr, t)
        l1 = attr.l1_decay if attr.l1_decay is not None else self.l1_rate
        if l1:
            new_p = torch.sign(new_p) * (new_p.abs() - plr * l1).clamp(min=0.0)
        return new_p, new_s

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any], params: Params,
               lr: Number) -> None:
        """One step over every parameter, in place: `state["t"]` advances by
        one, then each parameter and its slots take their new values."""
        t = state["t"]
        t.add_(1)
        self._step_constants = self.step_constants(t)
        try:
            for k, p in params.items():
                new_p, new_s = self.update_one(k, grads[k], state["slots"][k], p, lr, t)
                if new_p is not p:
                    p.copy_(new_p)
                for own, new in zip(state["slots"][k], new_s):
                    if new is not own:
                        own.copy_(new)
        finally:
            self._step_constants = None


def _bias_correction(beta: float, t: Number, like: torch.Tensor) -> torch.Tensor:
    """1 - beta^t in f64, rounded once to f32 (0-d, on `like`'s device)."""
    t64 = torch.as_tensor(t, dtype=torch.float64, device=like.device)
    return (1.0 - torch.pow(beta, t64)).float()


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

    def step_constants(self, t):
        return _bias_correction(self.beta1, t, t), _bias_correction(self.beta2, t, t)

    def apply_param(self, g, s, p, lr, t):
        m, v = s
        bc1, bc2 = (getattr(self, "_step_constants", None)
                    or self.step_constants(torch.as_tensor(t, device=m.device)))
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        return p - lr * mhat / (torch.sqrt(vhat) + self.epsilon), (m, v)
