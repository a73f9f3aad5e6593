"""append_backward (counterpart of `paddle_tpu/fluid/backward.py`;
framework/backward.cc).

The reference walks the forward ops in reverse and appends each op's
registered grad op. Here, as in the JAX package, `append_backward` appends
ONE `backward` op that records the loss, the parameter list and the forward
op count, with the same desc. The Executor makes the listed parameters
autograd leaves for a run of a block that holds it and, at that op, takes
`torch.autograd.grad` of sum(loss), writing `<param>@GRAD` values: the
gradients of the JAX package's re-traced `jax.grad`, without a second
forward."""

from __future__ import annotations

from typing import List, Optional, Sequence

from paddle_tpu_torch.fluid.framework import Program, Variable


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[Variable]] = None,
) -> List[tuple]:
    """Returns [(param, grad_var)] like the reference's append_backward."""
    program: Program = loss.block.program
    block = program.global_block()
    params = list(parameter_list) if parameter_list else [
        v
        for v in block.vars.values()
        if v.persistable
        and v.desc.trainable  # explicit registry, not name-substring matching
        and not v.name.endswith("@GRAD")
    ]
    n_fwd = len(block.desc.ops)
    grad_vars = []
    for p in params:
        g = block.create_var(p.name + "@GRAD", shape=p.desc.shape, dtype=p.desc.dtype)
        grad_vars.append((p, g))
    block.append_op(
        "backward",
        inputs={"Loss": loss, "Params": [p for p, _ in grad_vars]},
        outputs={"Grads": [g for _, g in grad_vars]},
        attrs={
            "loss": loss.name,
            "params": [p.name for p, _ in grad_vars],
            "fwd_op_count": n_fwd,
        },
    )
    return grad_vars
