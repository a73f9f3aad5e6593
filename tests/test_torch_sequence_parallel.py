"""Ring attention and Ulysses over the port's `seq` axis
(`paddle_tpu_torch/parallel/sequence_parallel.py`) against the port's
`reference_attention` on the whole sequence and against the JAX package's
functions on its forced 8-device CPU mesh: the twin of
`tests/test_sequence_parallel.py`.

Each port rank (a thread, `test_torch_parallel.run_ranks`) holds its
[B, T/n, H, D] block of q, k and v; the blocks' outputs and gradients are
concatenated in rank order. Tolerances are the JAX test's: outputs atol
2e-5, gradients atol 5e-4."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel.sequence_parallel import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)

from test_torch_parallel import run_ranks

SEQ = {"seq": 4}


def _qkv(seed=0, b=2, t=32, h=4, d=8):
    rs = np.random.RandomState(seed)
    return tuple((rs.randn(b, t, h, d) * 0.5).astype(np.float32) for _ in range(3))


def _blocks(fn, q, k, v, axes=SEQ, grads=False, **kw):
    """fn on every rank's blocks -> (output, [dq, dk, dv] of sum(out**2)),
    concatenated over the sequence (and the batch, on a data axis)."""
    def rank(r, mesh):
        n, i = mesh.extent("seq"), mesh.index("seq")
        nb, j = mesh.extent("data"), mesh.index("data")
        tl, bl = q.shape[1] // n, q.shape[0] // nb
        blk = [torch.tensor(x[j * bl:(j + 1) * bl, i * tl:(i + 1) * tl],
                            requires_grad=grads) for x in (q, k, v)]
        out = fn(*blk, mesh, **kw)
        g = None
        if grads:
            (out ** 2).sum().backward()
            g = [x.grad for x in blk]
        return out.detach(), g, mesh.counts("seq")

    res = run_ranks(int(np.prod(list(axes.values()))), rank, axes=axes)
    n_seq, n_data = axes.get("seq", 1), axes.get("data", 1)
    grid = [[res[j * n_seq + i] for i in range(n_seq)] for j in range(n_data)]
    out = torch.cat([torch.cat([c[0] for c in row], 1) for row in grid], 0)
    g = None
    if grads:
        g = [torch.cat([torch.cat([c[1][m] for c in row], 1) for row in grid], 0)
             for m in range(3)]
    return out, g, res[0][2]


def _jax(fn_name, q, k, v, axes=SEQ, **kw):
    import jax.numpy as jnp

    from paddle_tpu.parallel import sequence_parallel as jsp
    from paddle_tpu.parallel.mesh import make_mesh

    if "lengths" in kw:
        kw["lengths"] = jnp.asarray(kw["lengths"], jnp.int32)
    fn = getattr(jsp, fn_name)
    return np.asarray(fn(*(jnp.asarray(x) for x in (q, k, v)), make_mesh(axes), **kw))


def _ref(q, k, v, **kw):
    return reference_attention(*(torch.tensor(x) for x in (q, k, v)), **kw)


@pytest.mark.parametrize("kw", [{}, {"causal": True}, {"lengths": [20, 9]}],
                         ids=["full", "causal", "lengths"])
def test_ring_matches_reference_and_jax(kw):
    q, k, v = _qkv(seed=len(kw))
    got, _, counts = _blocks(ring_attention, q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), _ref(q, k, v, **kw).numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _jax("ring_attention", q, k, v, **kw), atol=2e-5)
    # n - 1 rotations of the packed K/V, one send/recv pair each
    assert counts["send_recv"] == 3 and counts["all_to_all"] == 0


def test_ring_grads_flow():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import sequence_parallel as jsp
    from paddle_tpu.parallel.mesh import make_mesh

    q, k, v = _qkv(seed=3, t=16)
    _, g_ring, counts = _blocks(ring_attention, q, k, v, grads=True, causal=True)
    qr, kr, vr = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (reference_attention(qr, kr, vr, causal=True) ** 2).sum().backward()
    mesh = make_mesh(SEQ)
    g_jax = jax.grad(lambda a, b, c: jnp.sum(jsp.ring_attention(a, b, c, mesh, causal=True)
                                             ** 2), (0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for got, ref, jx in zip(g_ring, (qr.grad, kr.grad, vr.grad), g_jax):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=5e-4)
    # forward n - 1 pairs, backward n (each block's accumulators come home)
    assert counts["send_recv"] == 3 + 4


@pytest.mark.parametrize("kw", [{}, {"causal": True}, {"lengths": [25, 7]}],
                         ids=["full", "causal", "lengths"])
def test_ulysses_matches_reference_and_jax(kw):
    q, k, v = _qkv(seed=4)  # h=4 divisible by the seq axis
    got, _, counts = _blocks(ulysses_attention, q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), _ref(q, k, v, **kw).numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _jax("ulysses_attention", q, k, v, **kw),
                               atol=2e-5)
    assert counts["all_to_all"] == 2  # q, k, v stacked in one; the output back


def test_ulysses_grads_match_reference():
    q, k, v = _qkv(seed=7, t=16)
    _, g, counts = _blocks(ulysses_attention, q, k, v, grads=True, causal=True)
    qr, kr, vr = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (reference_attention(qr, kr, vr, causal=True) ** 2).sum().backward()
    for got, ref in zip(g, (qr.grad, kr.grad, vr.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-4)
    assert counts["all_to_all"] == 4  # the backward's two inverse swaps


def test_ulysses_rejects_indivisible_heads():
    q, k, v = _qkv(seed=5, h=3)
    with pytest.raises(AssertionError, match="divisible"):  # a rank's ValueError
        _blocks(ulysses_attention, q, k, v)


def test_ring_composes_with_data_axis():
    """seq=4 x data=2: batch rows over data, the sequence over seq."""
    q, k, v = _qkv(seed=6, b=4)
    axes = {"data": 2, "seq": 4}
    got, _, _ = _blocks(ring_attention, q, k, v, axes=axes, causal=True)
    np.testing.assert_allclose(got.numpy(), _ref(q, k, v, causal=True).numpy(), atol=2e-5)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lives on a card."""

    @property
    def is_cuda(self):
        return True


class _TwoRanks:
    def size(self):
        return 2

    def rank(self):
        return 0


def test_gloo_refuses_cuda_send_recv():
    """gloo's send/recv read a CUDA tensor's pointer as host memory and
    abort the process (torch 2.11 on the card): the mesh refuses first."""
    from paddle_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.Mesh({"seq": 2}, _TwoRanks(), 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="CPU tensors only"):
        mesh.shift([torch.ones(2).as_subclass(_OnCard)], "seq", 1)
