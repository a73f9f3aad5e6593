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
  * The identities the backward kernel relies on: a masked step's dproj
    row is exactly 0 and dh passes through it (bit for bit, with the JAX
    interpret-mode kernel's dproj 0 there too), and dW_zr, dW_c, db are
    each one product (or sum) over the flattened T*B rows, held to the
    plain walk (1e-5) and to the JAX kernel's VMEM sums (rtol 2e-3 / atol
    5e-3).
  * On a card (marked `cuda`, skipped here): each CUDA kernel vs its plain
    version (hs and h_last at 1e-4, zrc at every row, masked ones too),
    also with steps masked between valid ones (the forward keeps a row's
    sums across them; the plain version carries h through them bit for
    bit), two forward calls give bit-identical hs and zrc and two backward calls
    bit-identical dW and db, gru_scan launches at H=1024, and the plans
    lay both legs out as (row group, unit group) grids within the SMs.
  * The route: `gru_step_loop` (the CUDA route where the kernels' plan has
    no layout) vs JAX `gru_scan` on its lax.scan path, forward (1e-5) and
    gradients (rtol 1e-4, atol 1e-5), both directions; `gru_seq_fits`
    answers from the plan's return code alone (a stand-in plan here), and
    on a card gru_scan at B=249, H=1280 (no backward layout) takes the
    step loop, launches no kernel and matches the plain path on the CPU.
jax is imported inside the CPU tests only, so the `cuda` tests run where
jax is absent."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops import rnn_kernels as K

NAMES = ("w_hzr", "w_hc", "bias", "proj", "h0")


def _inputs(seed=0, b=5, t=7, h=6, lens=(7, 3, 1, 5, 6), w_scale=0.3):
    """Batch-major numpy inputs: proj [B,T,3H], mask [B,T], weights, h0."""
    rs = np.random.RandomState(seed)
    proj = rs.randn(b, t, 3 * h).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    w_hzr = (rs.randn(h, 2 * h) * w_scale).astype(np.float32)
    w_hc = (rs.randn(h, h) * w_scale).astype(np.float32)
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


def _tm_inputs(arrs, mask):
    """Time-major torch tensors: proj, mask, w_hzr, w_hc, bias, h0."""
    t = {n: torch.from_numpy(arrs[n]) for n in NAMES}
    return _tm(arrs["proj"]), _tm(mask), t["w_hzr"], t["w_hc"], t["bias"], t["h0"]


def _h_prev(hs, h0, reverse):
    return torch.cat([hs[1:], h0[None]]) if reverse else torch.cat([h0[None], hs[:-1]])


def _holes_mask(b, t):
    """[B, T] mask with masked steps between valid ones: a row masked
    throughout, one valid throughout, one alternating, the rest random."""
    mask = (np.random.RandomState(3).rand(b, t) < 0.6).astype(np.float32)
    mask[0], mask[1], mask[2] = 0.0, 1.0, np.arange(t) % 2
    return mask


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_steps_carry_h_bit_for_bit(reverse):
    """What the CUDA forward's skipped products rest on: at a masked step h
    is h_prev exactly, so h_prev W_zr equals the product of the last step
    at which the row was computed. Steps masked between valid ones."""
    b, t = 6, 9
    arrs, _ = _inputs(13, b, t, 8, (t,) * b)
    mask = _holes_mask(b, t)
    hs, _ = K.gru_seq_fused_ref(_tm(arrs["proj"]), _tm(mask), *(
        torch.from_numpy(arrs[n]) for n in ("w_hzr", "w_hc", "bias", "h0")), reverse=reverse)
    prev = torch.cat([hs[1:], torch.from_numpy(arrs["h0"])[None]]) if reverse else \
        torch.cat([torch.from_numpy(arrs["h0"])[None], hs[:-1]])
    masked = torch.from_numpy(mask.T == 0)
    assert masked.any() and torch.equal(hs[masked], prev[masked])


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_steps_are_exact(monkeypatch, reverse):
    """At a masked (t, b) the plain backward's dproj row is exactly 0 and
    dh passes through: each row's backward equals, bit for bit, that of
    its valid steps alone with the masked steps' dhs summed into the carry
    (in walk order). The JAX interpret-mode kernel's dproj is 0 there too."""
    lens = (6, 3, 1, 4, 6)
    arrs, mask = _inputs(11, lens=lens)
    _, _, g_j = _jax_scan(arrs, mask, reverse, "interpret", monkeypatch)
    assert np.all(g_j[NAMES.index("proj")][mask == 0] == 0.0)
    proj, m, w_hzr, w_hc, bias, h0 = _tm_inputs(arrs, mask)
    rs = np.random.RandomState(12)
    dhs = torch.from_numpy(rs.randn(*proj.shape[:2], 6).astype(np.float32))
    dhl = torch.from_numpy(rs.randn(5, 6).astype(np.float32))
    for b, n in enumerate(lens):
        row = lambda x, k=None: x[:k, b:b + 1].contiguous()
        hs, zrc = K.gru_seq_fused_ref(row(proj), row(m), w_hzr, w_hc, bias, h0[b:b + 1], reverse)
        dproj, dwzr, dwc, db, dh0 = K.gru_seq_bwd_ref(
            zrc, hs, h0[b:b + 1], row(m), w_hzr, w_hc, row(dhs), dhl[b:b + 1], reverse)
        assert torch.all(dproj[n:] == 0.0)
        carry = dhl[b:b + 1]
        if not reverse:  # the masked tail comes first in the walk
            for t in range(proj.shape[0] - 1, n - 1, -1):
                carry = carry + dhs[t, b:b + 1]
        hs_v, zrc_v = K.gru_seq_fused_ref(row(proj, n), row(m, n), w_hzr, w_hc, bias,
                                          h0[b:b + 1], reverse)
        got = K.gru_seq_bwd_ref(zrc_v, hs_v, h0[b:b + 1], row(m, n), w_hzr, w_hc,
                                row(dhs, n), carry, reverse)
        dh0_v = got[4]
        if reverse:  # the masked tail comes last
            for t in range(n, proj.shape[0]):
                dh0_v = dh0_v + dhs[t, b:b + 1]
        for name, a, w in zip(("dproj", "dw_zr", "dw_c", "db", "dh0"),
                              (dproj[:n], dwzr, dwc, db, dh0), (*got[:4], dh0_v)):
            assert torch.equal(a, w), name


@pytest.mark.parametrize("reverse", [False, True])
def test_weight_grads_are_one_product(monkeypatch, reverse):
    """dW_zr = h_prev^T dgzr and dW_c = (r * h_prev)^T dgc, each ONE product
    over the flattened [T*B] rows, and db = dproj summed over them: equal to
    the plain walk's sums (1e-5) and to the JAX kernel's VMEM-accumulated
    gradients in interpret mode (its own tolerances, rtol 2e-3 / atol
    5e-3)."""
    arrs, mask = _inputs(13)
    _, _, g_j = _jax_scan(arrs, mask, reverse, "interpret", monkeypatch)
    proj, m, w_hzr, w_hc, bias, h0 = _tm_inputs(arrs, mask)
    hs, zrc = K.gru_seq_fused_ref(proj, m, w_hzr, w_hc, bias, h0, reverse)
    h_last = hs[0] if reverse else hs[-1]
    # the loss of _jax_scan: sum(hs^2) + sum(0.5 h_last^2 + h_last)
    dproj, dwzr, dwc, db, _ = K.gru_seq_bwd_ref(zrc, hs, h0, m, w_hzr, w_hc, 2 * hs,
                                                h_last + 1.0, reverse)
    h = hs.shape[-1]
    hp = _h_prev(hs, h0, reverse).reshape(-1, h)
    d = dproj.reshape(-1, 3 * h)
    one = (hp.T @ d[:, :2 * h], (zrc[..., h:2 * h].reshape(-1, h) * hp).T @ d[:, 2 * h:],
           d.sum(dim=0))
    for name, a, w, j in zip(("w_hzr", "w_hc", "bias"), one, (dwzr, dwc, db),
                             (g_j[0], g_j[1], g_j[2])):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5, msg=name)
        np.testing.assert_allclose(a.numpy(), j, rtol=2e-3, atol=5e-3, err_msg=name)


def _step_loop(arrs, mask, reverse):
    ts = {n: torch.tensor(arrs[n], requires_grad=True) for n in NAMES}
    hs, hl = trnn.gru_step_loop(ts["proj"], torch.tensor(mask),
                                trnn.GruParams(ts["w_hzr"], ts["w_hc"], ts["bias"]),
                                ts["h0"], reverse=reverse)
    grads = torch.autograd.grad(_loss_torch(hs, hl), [ts[n] for n in NAMES])
    return hs.detach().numpy(), hl.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_step_loop_matches_jax_scan(monkeypatch, seed, reverse):
    arrs, mask = _inputs(seed)
    hs_j, hl_j, g_j = _jax_scan(arrs, mask, reverse, "0", monkeypatch)
    hs_t, hl_t, g_t = _step_loop(arrs, mask, reverse)
    np.testing.assert_allclose(hs_t, hs_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hl_t, hl_j, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(NAMES, g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rc,fits", [(0, True), (1, False)])
def test_fits_answers_from_the_plan(monkeypatch, rc, fits):
    """`gru_seq_fits` reads `gru_seq_plan`'s return code once per (card,
    shape); 1 (cudaErrorInvalidValue) is "no layout"; another code raises."""
    calls = []

    def plan(source, index, t, b, h):
        calls.append((source, index, t, b, h))
        return rc, [1] * len(K._PLAN_KEYS)

    monkeypatch.setattr(K, "_call_plan", plan)
    monkeypatch.setattr(K, "_plans", {})
    dev = torch.device("cuda", 0)
    assert K.gru_seq_fits(1280, 249, 3, dev) is fits
    assert K.gru_seq_fits(1280, 249, 3, dev) is fits
    assert calls == [("gru_seq", 0, 3, 249, 1280)]
    assert trnn.takes_fused(dev, K.gru_seq_fits, 1280, 249, 3) is fits
    monkeypatch.setattr(K, "_call_plan", lambda *a: (719, [0] * len(K._PLAN_KEYS)))
    with pytest.raises(RuntimeError, match="719"):
        K.gru_seq_fits(1280, 250, 3, dev)


def test_route_off_the_card_never_asks_the_plan():
    def no(*a):
        raise AssertionError("the plan was asked")

    assert trnn.takes_fused(torch.device("cpu"), no, 1280, 249, 3)


def test_cpu_path_launches_no_kernel():
    arrs, mask = _inputs(5)
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    _torch_scan(arrs, mask, False)
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == before


def test_sync_probe_runs_only_on_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        K.gru_seq_fwd_sync(512, 128, 5, device="cpu")


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
    # the encoder's width at a short T (4 row groups x 32 groups of 16
    # units), rows that do not fill a row group, and one row
    (128, 6, 512, tuple(1 + np.arange(128) % 6)),
    (37, 5, 512, tuple(1 + np.arange(37) % 5)),
    (1, 4, 512, (3,)),
    # wider than one block per SM holds at 4 units (the forward's plan)
    (64, 12, 1024, tuple(1 + np.arange(64) % 12)),
    # lengths None: steps masked between valid ones (_holes_mask), across
    # which the forward keeps a row's sums of h W_zr
    (5, 9, 24, None),
    (37, 9, 512, None),
    (64, 6, 1024, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,h,lens", CARD_SHAPES)
def test_cuda_kernels_match_plain_versions(cuda, b, t, h, lens, reverse):
    # wide layers at a smart-normal scale: at 0.3 the H=512 pre-activations
    # reach ~7 and f32 summation order alone moves hs by ~1e-4
    arrs, mask = _inputs(7, b, t, h, lens or (t,) * b, w_scale=0.3 * min(1.0, (64 / h) ** 0.5))
    if lens is None:
        mask = _holes_mask(b, t)
    args = [x.to(cuda) for x in (_tm(arrs["proj"]), _tm(mask))]
    args += [torch.from_numpy(arrs[n]).to(cuda) for n in ("w_hzr", "w_hc", "bias", "h0")]
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    hs, zrc = K.gru_seq_fwd(*args, reverse=reverse)
    hs2, zrc2 = K.gru_seq_fwd(*args, reverse=reverse)
    hs_ref, zrc_ref = K.gru_seq_fused_ref(*args, reverse=reverse)
    rs = np.random.RandomState(8)
    dhs = torch.from_numpy(rs.randn(t, b, h).astype(np.float32)).to(cuda)
    dhl = torch.from_numpy(rs.randn(b, h).astype(np.float32)).to(cuda)
    common = (args[5], args[1], args[2], args[3], dhs, dhl)
    got = K.gru_seq_bwd(zrc, hs, *common, reverse=reverse)
    want = K.gru_seq_bwd_ref(zrc_ref, hs_ref, *common, reverse=reverse)
    again = K.gru_seq_bwd(zrc, hs, *common, reverse=reverse)
    torch.cuda.synchronize()
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
    for name, a, b2 in zip(("hs", "zrc", "dw_zr", "dw_c", "db"), (hs, zrc, *got[1:4]),
                           (hs2, zrc2, *again[1:4])):
        assert torch.equal(a, b2), f"{name} differs between two calls"  # no atomics
    last = 0 if reverse else -1
    torch.testing.assert_close(hs, hs_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(hs[last], hs_ref[last], atol=1e-4, rtol=0)
    # every row's gates, masked rows included: the backward reads them
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


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_gru_scan_launches_at_h1024(cuda, reverse):
    """The forward at H=1024, B=64 (wider than one block per SM holds at
    4 units) launches, and gru_scan through both kernels matches the plain
    path on the CPU."""
    b, t, h = 64, 12, 1024
    arrs, mask = _inputs(14, b, t, h, tuple(1 + np.arange(b) % t),
                         w_scale=0.3 * (64 / h) ** 0.5)
    ts = {n: torch.tensor(arrs[n], device=cuda, requires_grad=True) for n in NAMES}
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    hs, hl = trnn.gru_scan(ts["proj"], torch.tensor(mask, device=cuda),
                           trnn.GruParams(ts["w_hzr"], ts["w_hc"], ts["bias"]),
                           h0=ts["h0"], reverse=reverse)
    _loss_torch(hs, hl).backward()
    torch.cuda.synchronize()
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    hs_c, hl_c, g_c = _torch_scan(arrs, mask, reverse)
    np.testing.assert_allclose(hs.detach().cpu().numpy(), hs_c, atol=1e-4)
    np.testing.assert_allclose(hl.detach().cpu().numpy(), hl_c, atol=1e-4)
    for name, g in zip(NAMES, g_c):
        np.testing.assert_allclose(ts[name].grad.cpu().numpy(), g,
                                   atol=1e-3 * max(1.0, np.abs(g).max()), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_gru_scan_without_a_layout_takes_the_step_loop(cuda, reverse):
    """B=249, H=1280: the backward has no layout on a 132-SM card, so
    gru_scan takes the step loop (no kernel launch) and its forward and
    gradients match the plain path on the CPU."""
    b, t, h = 249, 3, 1280
    assert not K.gru_seq_fits(h, b, t, cuda)
    arrs, mask = _inputs(15, b, t, h, tuple(1 + np.arange(b) % t),
                         w_scale=0.3 * (64 / h) ** 0.5)
    ts = {n: torch.tensor(arrs[n], device=cuda, requires_grad=True) for n in NAMES}
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    hs, hl = trnn.gru_scan(ts["proj"], torch.tensor(mask, device=cuda),
                           trnn.GruParams(ts["w_hzr"], ts["w_hc"], ts["bias"]),
                           h0=ts["h0"], reverse=reverse)
    _loss_torch(hs, hl).backward()
    torch.cuda.synchronize()
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == before
    hs_c, hl_c, g_c = _torch_scan(arrs, mask, reverse)
    np.testing.assert_allclose(hs.detach().cpu().numpy(), hs_c, atol=1e-4)
    np.testing.assert_allclose(hl.detach().cpu().numpy(), hl_c, atol=1e-4)
    for name, g in zip(NAMES, g_c):
        np.testing.assert_allclose(ts[name].grad.cpu().numpy(), g,
                                   atol=1e-3 * max(1.0, np.abs(g).max()), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("h,b", [(512, 128), (1024, 64)])
def test_cuda_gru_plan_splits_rows_and_units(cuda, h, b):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = K.gru_seq_plan(h, b, 50)
    for leg in ("fwd", "bwd"):
        assert plan[f"{leg}_blocks"] == plan[f"{leg}_row_groups"] * -(-h // plan[f"{leg}_units"])
        assert plan[f"{leg}_blocks"] <= sms
        assert plan[f"{leg}_row_groups"] * plan[f"{leg}_rows_per_group"] >= b
    if h == 512:  # the encoder's shape: rows split, W resident
        assert plan["fwd_row_groups"] > 1 and plan["bwd_row_groups"] > 1
        assert plan["fwd_w_resident"] and plan["bwd_w_resident"]
    assert plan["dw_split_k"] >= 1 and plan["scratch_floats"] > 0


@pytest.mark.cuda
def test_cuda_gru_sync_probe_runs(cuda):
    K.gru_seq_fwd_sync(512, 128, 5)
    torch.cuda.synchronize()
