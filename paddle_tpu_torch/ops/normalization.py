"""Batch normalization (counterpart of `paddle_tpu/ops/normalization.py`).

The JAX package writes batch norm as an XLA `custom_vjp` with the fewest
passes over the activation, not as a Pallas kernel; this module keeps its
formulas as a `torch.autograd.Function`:

  forward   s1 = sum x, s2 = sum x^2 over every axis but the last, in f32
            (bf16 and f32 input; f64 input stays f64);
            mean = s1 / n, var = max(s2 / n - mean^2, 0) (biased, as the
            reference's moving statistics want it);
            a = gamma / sqrt(var + eps), b = beta - a * mean (f32 [C]);
            y = (x * a + b) rounded once to x's dtype.
  backward  dbeta = sum dy, dgamma = inv * (sum dy * x - mean * dbeta);
            dx = a' * dy + b' * x + c' with per-channel f32 constants,
            rounded once to x's dtype.

Not `F.batch_norm` / cuDNN's: its running variance is the unbiased one
(the moving statistics would drift from the reference's by n / (n - 1))
and it computes the variance by another algorithm. bf16 input is reduced
in f32 without an f32 copy of the activation where torch has such a
reduction (`sum(dtype=float32)`, `linalg.vector_norm(dtype=float32)`);
sum(dy * x) needs the product in f32, so it writes one f32 temporary.

Under a data-parallel mesh (`mesh=`, a `parallel.Mesh`) the statistics
cover the global batch, as the JAX package's do when jit reduces a
batch-sharded array: the forward all-reduces [s1, s2] (2 x C floats) and
divides by the global n, the backward all-reduces [sum dy, sum dy * x]
before it forms dx. dgamma and dbeta are returned from this rank's own
sums, so the updater's gradient reduction adds them up once. On one rank
the all-reduce is an exact copy and the result is bitwise the mesh-less
one's."""

from __future__ import annotations

from typing import Tuple

import torch


def _axes(x: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(x.dim() - 1))


def _count(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def _acc(x: torch.Tensor) -> torch.dtype:
    """The statistics' dtype: f32 for bf16 and f32 input (f64 stays f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def _row(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[C] -> [1, ..., 1, C] beside x: a shape that takes part in type
    promotion, so a bf16 x and an f32 row compute in f32."""
    return c.reshape((1,) * (x.dim() - 1) + (-1,))


def _all_sum(mesh, a: torch.Tensor, b: torch.Tensor):
    """(a, b) summed over the mesh's ranks in one all-reduce of [2, C]."""
    both = torch.stack([a, b])
    mesh.all_reduce_(both)
    return both[0], both[1]


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, mesh=None):
        axes, n, acc = _axes(x), _count(x), _acc(x)
        s1 = x.sum(dim=axes, dtype=acc)
        s2 = torch.linalg.vector_norm(x, 2, dim=axes, dtype=acc).square()
        if mesh is not None:
            s1, s2 = _all_sum(mesh, s1, s2)
            n = n * mesh.size
        ctx.mesh = mesh
        mean = s1 / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        inv = torch.rsqrt(var + eps)
        a = gamma.to(acc) * inv
        b = beta.to(acc) - a * mean
        y = torch.addcmul(_row(b, x), x, _row(a, x)).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the statistics feed the moving averages only: no gradient path
        x, gamma, mean, inv = ctx.saved_tensors
        axes, n, acc = _axes(x), _count(x), _acc(x)
        dbeta = dy.sum(dim=axes, dtype=acc)
        zero = x.new_zeros((1,) * x.dim(), dtype=acc)
        dgx = torch.addcmul(zero, dy, x).sum(dim=axes)  # products in acc
        dgamma = inv * (dgx - mean * dbeta)
        dgamma_own, dbeta_own = dgamma, dbeta
        if ctx.mesh is not None:
            # dx needs the global sums; the parameters' gradients stay this
            # rank's, which the updater's reduction adds up
            dbeta, dgx = _all_sum(ctx.mesh, dbeta, dgx)
            dgamma = inv * (dgx - mean * dbeta)
            n = n * ctx.mesh.size
        gi = gamma.to(acc) * inv
        c = gi * (dbeta + mean * inv * -dgamma) / -n
        bx = gi * inv * dgamma / -n
        dx = torch.addcmul(_row(c, x), dy, _row(gi, x))
        dx = dx.addcmul_(x, _row(bx, x)).to(x.dtype)
        return (dx, dgamma_own.to(gamma.dtype), dbeta_own.to(gamma.dtype), None,
                None)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float, mesh=None):
    """Training-mode batch norm over every axis but the last -> (y in x's
    dtype, mean f32 [C], biased var f32 [C]); with `mesh`, over the global
    batch."""
    return _BatchNormTrain.apply(x, gamma, beta, float(eps), mesh)


def batch_norm_inference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         mean: torch.Tensor, var: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """Inference-mode batch norm from given statistics: a per-channel affine
    map with a and b computed in f32 and applied in x's dtype."""
    acc = _acc(x)
    inv = torch.rsqrt(var.to(acc) + eps)
    a = gamma.to(acc) * inv
    b = beta.to(acc) - gamma.to(acc) * inv * mean.to(acc)
    return x * a.to(x.dtype) + b.to(x.dtype)
