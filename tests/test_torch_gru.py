"""The port's whole-sequence GRU (`paddle_tpu_torch/ops/rnn_kernels.py`,
`ops/rnn.py`) against the JAX package's, on the CPU.

Same numpy inputs on both sides (seeded): ragged masks with a length-1 row,
non-zero h0, both directions.

  * Plain forward vs JAX `gru_scan` on its lax.scan path
    (PADDLE_TPU_PALLAS=0): rtol = atol = 1e-5 (f32 both sides; only the
    summation order differs).
  * Plain forward and its gradients vs JAX `gru_scan` through the Pallas
    `gru_seq_fused` kernel in interpret mode (PADDLE_TPU_PALLAS=interpret):
    atol 5e-4 on values, rtol 2e-3 / atol 5e-3 on gradients — the
    tolerances the JAX package holds its own kernel to against its scan
    (tests/test_pallas_rnn.py).
  * `gru_seq_bwd_ref` vs torch.autograd through `gru_seq_fused_ref` (1e-5)
    and vs jax.grad through the JAX scan (rtol 1e-4, atol 1e-5), for w_hzr,
    w_hc, bias, proj and h0.
  * On a card (marked `cuda`, skipped here): each CUDA kernel vs its plain
    version. jax is imported inside the CPU tests only, so the `cuda` tests
    run where jax is absent."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops import rnn_kernels as K

NAMES = ("w_hzr", "w_hc", "bias", "proj", "h0")


def _inputs(seed=0, b=5, t=7, h=6, lens=(7, 3, 1, 5, 6)):
    """Batch-major numpy inputs: proj [B,T,3H], mask [B,T], weights, h0."""
    rs = np.random.RandomState(seed)
    proj = rs.randn(b, t, 3 * h).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    w_hzr = (rs.randn(h, 2 * h) * 0.3).astype(np.float32)
    w_hc = (rs.randn(h, h) * 0.3).astype(np.float32)
    bias = (rs.randn(3 * h) * 0.1).astype(np.float32)
    h0 = rs.randn(b, h).astype(np.float32)
    return dict(w_hzr=w_hzr, w_hc=w_hc, bias=bias, proj=proj, h0=h0), mask


def _loss_torch(hs, h_last):
    return (hs ** 2).sum() + (0.5 * h_last * h_last + h_last).sum()


def _jax_scan(arrs, mask, reverse, flag, monkeypatch):
    """(hs, h_last, grads) from the JAX package's gru_scan under
    PADDLE_TPU_PALLAS=flag."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import rnn as jrnn

    monkeypatch.setenv("PADDLE_TPU_PALLAS", flag)

    def loss(w_hzr, w_hc, bias, proj, h0):
        hs, hl = jrnn.gru_scan(proj, jnp.asarray(mask),
                               jrnn.GruParams(w_hzr, w_hc, bias), h0=h0,
                               reverse=reverse)
        return jnp.sum(hs ** 2) + jnp.sum(0.5 * hl * hl + hl), (hs, hl)

    args = [jnp.asarray(arrs[n]) for n in NAMES]
    (_, (hs, hl)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    return np.asarray(hs), np.asarray(hl), [np.asarray(g) for g in grads]


def _torch_scan(arrs, mask, reverse):
    ts = {n: torch.tensor(arrs[n], requires_grad=True) for n in NAMES}
    hs, hl = trnn.gru_scan(ts["proj"], torch.tensor(mask),
                           trnn.GruParams(ts["w_hzr"], ts["w_hc"], ts["bias"]),
                           h0=ts["h0"], reverse=reverse)
    grads = torch.autograd.grad(_loss_torch(hs, hl), [ts[n] for n in NAMES])
    return hs.detach().numpy(), hl.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forward_matches_jax_scan(monkeypatch, seed, reverse):
    arrs, mask = _inputs(seed)
    hs_j, hl_j, _ = _jax_scan(arrs, mask, reverse, "0", monkeypatch)
    hs_t, hl_t, _ = _torch_scan(arrs, mask, reverse)
    np.testing.assert_allclose(hs_t, hs_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hl_t, hl_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_jax_interpret_kernel(monkeypatch, reverse):
    arrs, mask = _inputs(2)
    hs_j, hl_j, g_j = _jax_scan(arrs, mask, reverse, "interpret", monkeypatch)
    hs_t, hl_t, g_t = _torch_scan(arrs, mask, reverse)
    np.testing.assert_allclose(hs_t, hs_j, atol=5e-4)
    np.testing.assert_allclose(hl_t, hl_j, atol=5e-4)
    for name, a, b in zip(NAMES, g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=5e-3, err_msg=name)


def _tm(x):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_ref_matches_autograd_of_plain_forward(reverse):
    arrs, mask = _inputs(3)
    ts = {n: torch.tensor(arrs[n], requires_grad=True) for n in NAMES}
    proj_tm = ts["proj"].transpose(0, 1)
    hs, zrc = K.gru_seq_fused_ref(proj_tm, _tm(mask), ts["w_hzr"], ts["w_hc"],
                                  ts["bias"], ts["h0"], reverse)
    h_last = hs[0] if reverse else hs[-1]
    rs = np.random.RandomState(9)
    dhs = torch.from_numpy(rs.randn(*hs.shape).astype(np.float32))
    dhl = torch.from_numpy(rs.randn(*h_last.shape).astype(np.float32))
    want = torch.autograd.grad((hs * dhs).sum() + (h_last * dhl).sum(),
                               [ts[n] for n in NAMES])
    dproj, dwzr, dwc, db, dh0 = K.gru_seq_bwd_ref(
        zrc.detach(), hs.detach(), ts["h0"].detach(), _tm(mask),
        ts["w_hzr"].detach(), ts["w_hc"].detach(), dhs, dhl, reverse)
    got = (dwzr, dwc, db, dproj.transpose(0, 1), dh0)
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_ref_matches_jax_grad_of_scan(monkeypatch, reverse):
    arrs, mask = _inputs(4)
    _, _, g_j = _jax_scan(arrs, mask, reverse, "0", monkeypatch)
    _, _, g_t = _torch_scan(arrs, mask, reverse)  # CPU: gru_seq_bwd_ref
    for name, a, b in zip(NAMES, g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_cpu_path_launches_no_kernel():
    arrs, mask = _inputs(5)
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    _torch_scan(arrs, mask, False)
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == before


def test_kernel_wrappers_reject_cpu_tensors_and_bad_shapes():
    arrs, mask = _inputs(6)
    t = {n: torch.from_numpy(arrs[n]) for n in NAMES}
    args = (_tm(arrs["proj"]), _tm(mask), t["w_hzr"], t["w_hc"], t["bias"], t["h0"])
    with pytest.raises(ValueError, match="CUDA"):
        K.gru_seq_fwd(*args)
    with pytest.raises(ValueError, match="w_hc must be"):
        K.check_inputs(args[0], args[1], args[2], args[2], args[4], args[5])


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


CARD_SHAPES = [  # b, t, h, lengths
    (5, 7, 24, (7, 3, 1, 5, 6)),
    (9, 13, 64, (13, 1, 8, 13, 2, 11, 5, 13, 7)),
    # H not a multiple of 4 (a block with fewer units, 4-byte staging) and
    # more rows than one block has threads
    (300, 4, 30, tuple(1 + np.arange(300) % 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,h,lens", CARD_SHAPES)
def test_cuda_kernels_match_plain_versions(cuda, b, t, h, lens, reverse):
    arrs, mask = _inputs(7, b, t, h, lens)
    args = [x.to(cuda) for x in (_tm(arrs["proj"]), _tm(mask))]
    args += [torch.from_numpy(arrs[n]).to(cuda) for n in ("w_hzr", "w_hc", "bias", "h0")]
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    hs, zrc = K.gru_seq_fwd(*args, reverse=reverse)
    hs_ref, zrc_ref = K.gru_seq_fused_ref(*args, reverse=reverse)
    rs = np.random.RandomState(8)
    dhs = torch.from_numpy(rs.randn(t, b, h).astype(np.float32)).to(cuda)
    dhl = torch.from_numpy(rs.randn(b, h).astype(np.float32)).to(cuda)
    common = (args[5], args[1], args[2], args[3], dhs, dhl)
    got = K.gru_seq_bwd(zrc, hs, *common, reverse=reverse)
    want = K.gru_seq_bwd_ref(zrc_ref, hs_ref, *common, reverse=reverse)
    torch.cuda.synchronize()
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(hs, hs_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(zrc, zrc_ref, atol=1e-4, rtol=0)
    for name, a, w in zip(("dproj", "dw_zr", "dw_c", "db", "dh0"), got, want):
        tol = 1e-3 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(a, w, atol=tol, rtol=0, msg=name)


@pytest.mark.cuda
def test_cuda_gru_scan_goes_through_the_kernels(cuda):
    arrs, mask = _inputs(10)
    ts = {n: torch.tensor(arrs[n], device=cuda, requires_grad=True) for n in NAMES}
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    hs, hl = trnn.gru_scan(ts["proj"], torch.tensor(mask, device=cuda),
                           trnn.GruParams(ts["w_hzr"], ts["w_hc"], ts["bias"]),
                           h0=ts["h0"], reverse=True)
    _loss_torch(hs, hl).backward()
    torch.cuda.synchronize()
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    hs_c, hl_c, g_c = _torch_scan(arrs, mask, True)
    np.testing.assert_allclose(hs.detach().cpu().numpy(), hs_c, atol=1e-4)
    for name, g in zip(NAMES, g_c):
        np.testing.assert_allclose(ts[name].grad.cpu().numpy(), g,
                                   atol=1e-3 * max(1.0, np.abs(g).max()), err_msg=name)
