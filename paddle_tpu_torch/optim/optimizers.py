"""First-order optimizers (counterpart of `paddle_tpu/optim/optimizers.py`):
the `Optimizer.update_one` semantics (static parameters, clipping, L2 decay
folded into the gradient, per-parameter lr scale, L1 shrinkage after the
step) with `SGD` (momentum / nesterov; `Momentum` is the same class),
`AdaGrad`, `DecayedAdaGrad`, `AdaDelta`, `RMSProp` (the centred form the
reference keeps), `Adam` and `AdaMax` (bias correction from the step
counter t).

The state is {"slots": {name: (tensor, ...)}, "t": 0-d int32 tensor}, laid
out as the JAX package lays it out, with `t` on the parameters' device.
`update(grads, state, params, lr, ok=None)` writes the new values into the
parameters', the slots' and `t`'s own storage (`copy_` of the functional
result, so the numbers are those of `update_one`) and returns nothing: a
CUDA graph of the training step (`trainer/step_graph.py`) holds raw
pointers to that storage, and reads `t` and `lr` (a 0-d f32 tensor) as
tensors, where a Python number would be baked into the graph as a constant.
With `ok` (a 0-d bool tensor: the divergence guard's "the cost is finite")
every value is written as `where(ok, new, old)`, so a diverged step leaves
parameters, slots and `t` as they were, inside the same graph.
`update_one` stays functional and takes `lr` and `t` as numbers or 0-d
tensors. All math is f32, the bias corrections 1 - beta^t too, as the
JAX package's step computes them."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

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
               lr: Number, ok: Optional[torch.Tensor] = None) -> None:
        """One step over every parameter, in place: `state["t"]` advances by
        one, then each parameter and its slots take their new values; with
        `ok`, only where `ok` holds."""
        t = state["t"]
        t_new = t + 1
        self._step_constants = self.step_constants(t_new)
        try:
            for k, p in params.items():
                new_p, new_s = self.update_one(k, grads[k], state["slots"][k], p, lr,
                                               t_new)
                write_into(p, new_p, ok)
                for own, new in zip(state["slots"][k], new_s):
                    write_into(own, new, ok)
            write_into(t, t_new, ok)
        finally:
            self._step_constants = None


@torch.no_grad()
def write_into(own: torch.Tensor, new: torch.Tensor, ok: Optional[torch.Tensor] = None) -> None:
    """own <- new in own's storage; with `ok` (a 0-d bool tensor), only
    where it holds: the divergence guard's revert."""
    if new is own:
        return
    own.copy_(new if ok is None else torch.where(ok, new, own))


def _bias_correction(beta: float, t: Number, like: torch.Tensor) -> torch.Tensor:
    """1 - beta^t in f32, beta and t rounded to f32 first, as the JAX
    package's step computes it (0-d, on `like`'s device). In f64 it differs
    by up to 1.3e-5 relative at t = 1, beta = 0.999: the subtraction
    cancels all but the last bits of beta^t."""
    t32 = torch.as_tensor(t, device=like.device).to(torch.float32)
    return 1.0 - torch.pow(beta, t32)


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


Momentum = SGD


@dataclasses.dataclass
class AdaGrad(Optimizer):
    """AdaGrad (FirstOrderOptimizer.h:111): a growing sum of g^2."""

    epsilon: float = 1e-6

    def init_param_state(self, p):
        return (torch.zeros_like(p),)

    def apply_param(self, g, s, p, lr, t):
        (accum,) = s
        accum = accum + g * g
        return p - lr * g / (torch.sqrt(accum) + self.epsilon), (accum,)


@dataclasses.dataclass
class DecayedAdaGrad(Optimizer):
    """DecayedAdagrad (FirstOrderOptimizer.h:210): a leaky sum of g^2."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_param_state(self, p):
        return (torch.zeros_like(p),)

    def apply_param(self, g, s, p, lr, t):
        (accum,) = s
        accum = self.rho * accum + (1 - self.rho) * g * g
        return p - lr * g / (torch.sqrt(accum) + self.epsilon), (accum,)


@dataclasses.dataclass
class AdaDelta(Optimizer):
    """AdaDelta (FirstOrderOptimizer.h:141)."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_param_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    def apply_param(self, g, s, p, lr, t):
        accum_g, accum_x = s
        accum_g = self.rho * accum_g + (1 - self.rho) * g * g
        step = -torch.sqrt((accum_x + self.epsilon) / (accum_g + self.epsilon)) * g
        accum_x = self.rho * accum_x + (1 - self.rho) * step * step
        return p + lr * step, (accum_g, accum_x)


@dataclasses.dataclass
class RMSProp(Optimizer):
    """RMSProp (FirstOrderOptimizer.h:167), centred: E[g^2] and E[g]."""

    rho: float = 0.95
    epsilon: float = 1e-6
    momentum: float = 0.0

    def init_param_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p), torch.zeros_like(p))

    def apply_param(self, g, s, p, lr, t):
        ms, mg, mom = s
        ms = self.rho * ms + (1 - self.rho) * g * g
        mg = self.rho * mg + (1 - self.rho) * g
        denom = torch.sqrt(ms - mg * mg + self.epsilon)
        mom = self.momentum * mom + lr * g / denom
        return p - mom, (ms, mg, mom)


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


@dataclasses.dataclass
class AdaMax(Optimizer):
    """AdaMax (FirstOrderOptimizer.h:290): an infinity-norm second moment."""

    beta1: float = 0.9
    beta2: float = 0.999

    def init_param_state(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    def step_constants(self, t):
        return _bias_correction(self.beta1, t, t)

    def apply_param(self, g, s, p, lr, t):
        m, u = s
        bc1 = getattr(self, "_step_constants", None)
        if bc1 is None:
            bc1 = self.step_constants(torch.as_tensor(t, device=m.device))
        m = self.beta1 * m + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, g.abs())
        return p - (lr / bc1) * m / (u + 1e-12), (m, u)
