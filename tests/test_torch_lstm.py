"""The port's whole-sequence LSTM (`paddle_tpu_torch/ops/rnn_kernels.py`,
`ops/rnn.py`, `nn/recurrent.Lstm`) and activations against the JAX
package's, on the CPU.

Same numpy inputs on both sides (seeded): ragged masks with a length-1 row,
non-zero h0 and c0, both directions.

  * `lstm_scan` vs JAX `lstm_scan` on its lax.scan path
    (PADDLE_TPU_PALLAS=0), without and with peepholes and with
    `return_cell_seq`: values at rtol = atol = 1e-5, gradients of proj, W,
    b, h0, c0 (and the check weights) at rtol 1e-4 / atol 1e-5 (f32 both
    sides; only the summation order differs).
  * The port's fused path vs JAX `lstm_scan` through the Pallas
    `lstm_seq_fused` in interpret mode (PADDLE_TPU_PALLAS=interpret): atol
    5e-4 on values, rtol 2e-3 / atol 5e-3 on gradients — the tolerances the
    JAX package holds its own kernel to (tests/test_pallas_rnn.py).
  * `lstm_seq_bwd_ref` vs torch.autograd through `lstm_seq_fused_ref`
    (1e-5).
  * Every ported activation vs the JAX package's (1e-6).
  * The identities the backward kernel relies on: a masked step's dproj
    row is exactly 0 and dh, dc pass through it (bit for bit, with the JAX
    interpret-mode kernel's dproj 0 there too), and dW, db are one product
    (or sum) over the flattened T*B rows, held to the plain walk (1e-5) and
    to the JAX kernel's VMEM sums (rtol 2e-3 / atol 5e-3).
  * On a card (marked `cuda`, skipped here): each CUDA kernel vs its plain
    version (hs, gates, ct, cs at every row, masked ones too, and the last
    h and c at 1e-4), also with steps masked between valid ones (the
    forward keeps a row's sums across them; the plain version carries h
    and c through them bit for bit), two forward calls give bit-identical
    outputs and two backward calls bit-identical dW and db, and the plans
    lay both legs out as (row group, unit group) grids within the SMs.
  * The route: `lstm_step_loop` (the CUDA route where the kernels' plan has
    no layout) vs JAX `lstm_scan` on its lax.scan path at the standard
    config, forward (1e-5) and gradients (rtol 1e-4, atol 1e-5), both
    directions; `lstm_seq_fits` answers from the plan's return code alone
    (a stand-in plan here), and on a card lstm_scan at T=1, B=207, H=1280
    (no forward layout) takes the step loop, launches no kernel and
    matches the plain path on the CPU.
jax is imported inside the CPU tests only, so the `cuda` tests run where
jax is absent."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import activations as tact
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops import rnn_kernels as K

NAMES = ("w_hh", "bias", "proj", "h0", "c0")
CHECKS = ("check_i", "check_f", "check_o")


def _inputs(seed=0, b=5, t=7, h=6, lens=(7, 3, 1, 5, 6)):
    """Batch-major numpy inputs: proj [B,T,4H], mask [B,T], W, b, h0, c0 and
    peephole weights."""
    rs = np.random.RandomState(seed)
    arrs = dict(
        w_hh=(rs.randn(h, 4 * h) * 0.3).astype(np.float32),
        bias=(rs.randn(4 * h) * 0.1).astype(np.float32),
        proj=rs.randn(b, t, 4 * h).astype(np.float32),
        h0=rs.randn(b, h).astype(np.float32),
        c0=rs.randn(b, h).astype(np.float32),
    )
    for name in CHECKS:
        arrs[name] = (rs.randn(h) * 0.5).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    return arrs, mask


def _grad_names(peep):
    return NAMES + (CHECKS if peep else ())


def _jax_scan(arrs, mask, reverse, flag, monkeypatch, peep=False, cell_seq=False):
    """(outputs, grads) of the JAX package's lstm_scan under
    PADDLE_TPU_PALLAS=flag; the loss weighs every output."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import rnn as jrnn

    monkeypatch.setenv("PADDLE_TPU_PALLAS", flag)
    names = _grad_names(peep)

    def loss(*xs):
        a = dict(zip(names, xs))
        checks = [a[c] for c in CHECKS] if peep else []
        outs = jrnn.lstm_scan(a["proj"], jnp.asarray(mask),
                              jrnn.LstmParams(a["w_hh"], a["bias"], *checks),
                              h0=a["h0"], c0=a["c0"], reverse=reverse,
                              return_cell_seq=cell_seq)
        return _loss(outs, jnp), outs

    (_, outs), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True)(
            *[jnp.asarray(arrs[n]) for n in names])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _loss(outs, xp):
    a, b, c = outs
    return xp.sum(a ** 2) + xp.sum(0.5 * b * b + b) + xp.sum(c * c - c)


def _torch_scan(arrs, mask, reverse, peep=False, cell_seq=False, device="cpu"):
    names = _grad_names(peep)
    ts = {n: torch.tensor(arrs[n], device=device, requires_grad=True) for n in names}
    checks = [ts[c] for c in CHECKS] if peep else []
    outs = trnn.lstm_scan(ts["proj"], torch.tensor(mask, device=device),
                          trnn.LstmParams(ts["w_hh"], ts["bias"], *checks),
                          h0=ts["h0"], c0=ts["c0"], reverse=reverse,
                          return_cell_seq=cell_seq)
    grads = torch.autograd.grad(_loss(outs, torch), [ts[n] for n in names])
    return ([o.detach().cpu().numpy() for o in outs],
            [g.cpu().numpy() for g in grads])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("peep,cell_seq", [(False, False), (True, False), (False, True)])
def test_lstm_scan_matches_jax_scan(monkeypatch, peep, cell_seq, reverse):
    arrs, mask = _inputs(0)
    o_j, g_j = _jax_scan(arrs, mask, reverse, "0", monkeypatch, peep, cell_seq)
    o_t, g_t = _torch_scan(arrs, mask, reverse, peep, cell_seq)
    for a, b in zip(o_t, o_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(_grad_names(peep), g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_path_matches_jax_interpret_kernel(monkeypatch, reverse):
    arrs, mask = _inputs(2)
    o_j, g_j = _jax_scan(arrs, mask, reverse, "interpret", monkeypatch)
    o_t, g_t = _torch_scan(arrs, mask, reverse)
    for a, b in zip(o_t, o_j):
        np.testing.assert_allclose(a, b, atol=5e-4)
    for name, a, b in zip(NAMES, g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=5e-3, err_msg=name)


def test_only_the_standard_config_takes_the_fused_op(monkeypatch):
    """The fused op runs for sigmoid/tanh/tanh without peepholes and
    without return_cell_seq, and nowhere else."""
    arrs, mask = _inputs(3)
    calls = []
    real = trnn.lstm_seq_fused
    monkeypatch.setattr(trnn, "lstm_seq_fused", lambda *a: calls.append(1) or real(*a))
    _torch_scan(arrs, mask, False)
    assert calls == [1]
    _torch_scan(arrs, mask, False, peep=True)
    _torch_scan(arrs, mask, False, cell_seq=True)
    t = {n: torch.tensor(arrs[n]) for n in NAMES}
    trnn.lstm_scan(t["proj"], torch.tensor(mask), trnn.LstmParams(t["w_hh"], t["bias"]),
                   gate_act="relu")
    assert calls == [1]


def _tm(x):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_ref_matches_autograd_of_plain_forward(reverse):
    arrs, mask = _inputs(4)
    ts = {n: torch.tensor(arrs[n], requires_grad=True) for n in NAMES}
    fwd = (ts["proj"].transpose(0, 1), _tm(mask), ts["w_hh"], ts["bias"], ts["h0"], ts["c0"])
    hs, gates, ct, cs = K.lstm_seq_fused_ref(*fwd, reverse)
    last = 0 if reverse else -1
    rs = np.random.RandomState(9)
    dhs, dhl, dcl = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                     for s in (hs.shape, hs[last].shape, hs[last].shape))
    want = torch.autograd.grad(
        (hs * dhs).sum() + (hs[last] * dhl).sum() + (cs[last] * dcl).sum(),
        [ts[n] for n in NAMES])
    detached = [x.detach() for x in (gates, ct, hs, cs, ts["h0"], ts["c0"])]
    dproj, dw, db, dh0, dc0 = K.lstm_seq_bwd_ref(
        *detached, _tm(mask), ts["w_hh"].detach(), dhs, dhl, dcl, reverse)
    got = (dw, db, dproj.transpose(0, 1), dh0, dc0)
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def _tm_inputs(arrs, mask):
    """Time-major torch tensors: proj, mask, w_hh, bias, h0, c0."""
    t = {n: torch.from_numpy(arrs[n]) for n in NAMES}
    return _tm(arrs["proj"]), _tm(mask), t["w_hh"], t["bias"], t["h0"], t["c0"]


def _holes_mask(b, t):
    """[B, T] mask with masked steps between valid ones: a row masked
    throughout, one valid throughout, one alternating, the rest random."""
    mask = (np.random.RandomState(3).rand(b, t) < 0.6).astype(np.float32)
    mask[0], mask[1], mask[2] = 0.0, 1.0, np.arange(t) % 2
    return mask


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_steps_carry_state_bit_for_bit(reverse):
    """What the CUDA forward's skipped products rest on: at a masked step h
    and c are the previous step's exactly, so h_prev W equals the product
    of the last step at which the row was computed. Steps masked between
    valid ones."""
    b, t = 6, 9
    arrs, _ = _inputs(13, b, t, 8, (t,) * b)
    mask = _holes_mask(b, t)
    h0, c0 = (torch.from_numpy(arrs[n]) for n in ("h0", "c0"))
    hs, _, _, cs = K.lstm_seq_fused_ref(
        _tm(arrs["proj"]), _tm(mask), torch.from_numpy(arrs["w_hh"]),
        torch.from_numpy(arrs["bias"]), h0, c0, reverse=reverse)
    masked = torch.from_numpy(mask.T == 0)
    assert masked.any()
    for seq, x0 in ((hs, h0), (cs, c0)):
        prev = torch.cat([seq[1:], x0[None]]) if reverse else torch.cat([x0[None], seq[:-1]])
        assert torch.equal(seq[masked], prev[masked])


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_steps_are_exact(monkeypatch, reverse):
    """At a masked (t, b) the plain backward's dproj row is exactly 0 and
    the carries pass through (dh_prev = dh, dc_prev = dc): each row's
    backward equals, bit for bit, that of its valid steps alone with the
    masked steps' dhs summed into the dh carry (in walk order). The JAX
    interpret-mode kernel's dproj is 0 there too."""
    lens = (7, 3, 1, 5, 6)
    arrs, mask = _inputs(11, lens=lens)
    _, g_j = _jax_scan(arrs, mask, reverse, "interpret", monkeypatch)
    assert np.all(g_j[NAMES.index("proj")][mask == 0] == 0.0)
    proj, m, w_hh, bias, h0, c0 = _tm_inputs(arrs, mask)
    t_len, h = proj.shape[0], w_hh.shape[0]
    rs = np.random.RandomState(12)
    dhs = torch.from_numpy(rs.randn(t_len, 5, h).astype(np.float32))
    dhl, dcl = (torch.from_numpy(rs.randn(5, h).astype(np.float32)) for _ in range(2))

    def walk(b, n, dh_last):
        row = lambda x: x[:n, b:b + 1].contiguous()
        st = (h0[b:b + 1], c0[b:b + 1])
        hs, gates, ct, cs = K.lstm_seq_fused_ref(row(proj), row(m), w_hh, bias, *st, reverse)
        return K.lstm_seq_bwd_ref(gates, ct, hs, cs, *st, row(m), w_hh, row(dhs), dh_last,
                                  dcl[b:b + 1], reverse)

    for b, n in enumerate(lens):
        dproj, dw, db, dh0, dc0 = walk(b, t_len, dhl[b:b + 1])
        assert torch.all(dproj[n:] == 0.0)
        carry = dhl[b:b + 1]
        if not reverse:  # the masked tail comes first in the walk
            for t in range(t_len - 1, n - 1, -1):
                carry = carry + dhs[t, b:b + 1]
        got = walk(b, n, carry)
        dh0_v = got[3]
        if reverse:  # the masked tail comes last
            for t in range(n, t_len):
                dh0_v = dh0_v + dhs[t, b:b + 1]
        for name, a, w in zip(("dproj", "dw", "db", "dh0", "dc0"),
                              (dproj[:n], dw, db, dh0, dc0), (*got[:3], dh0_v, got[4])):
            assert torch.equal(a, w), name


@pytest.mark.parametrize("reverse", [False, True])
def test_weight_grads_are_one_product(monkeypatch, reverse):
    """dW = h_prev^T dproj as ONE product over the flattened [T*B] rows and
    db = dproj summed over them: equal to the plain walk's sums (1e-5) and
    to the JAX kernel's VMEM-accumulated gradients in interpret mode (its
    own tolerances, rtol 2e-3 / atol 5e-3)."""
    arrs, mask = _inputs(13)
    _, g_j = _jax_scan(arrs, mask, reverse, "interpret", monkeypatch)
    proj, m, w_hh, bias, h0, c0 = _tm_inputs(arrs, mask)
    hs, gates, ct, cs = K.lstm_seq_fused_ref(proj, m, w_hh, bias, h0, c0, reverse)
    last = 0 if reverse else -1
    # the loss of _jax_scan: sum(hs^2) + sum(0.5 h_last^2 + h_last) + sum(c^2 - c)
    dproj, dw, db, _, _ = K.lstm_seq_bwd_ref(gates, ct, hs, cs, h0, c0, m, w_hh, 2 * hs,
                                             hs[last] + 1.0, 2 * cs[last] - 1.0, reverse)
    h = hs.shape[-1]
    hp = (torch.cat([hs[1:], h0[None]]) if reverse else torch.cat([h0[None], hs[:-1]]))
    d = dproj.reshape(-1, 4 * h)
    one = (hp.reshape(-1, h).T @ d, d.sum(dim=0))
    for name, a, w in zip(("w_hh", "bias"), one, (dw, db)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5, msg=name)
        np.testing.assert_allclose(a.numpy(), g_j[NAMES.index(name)], rtol=2e-3, atol=5e-3,
                                   err_msg=name)


def test_cpu_path_launches_no_kernel():
    arrs, mask = _inputs(5)
    before = (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES)
    _torch_scan(arrs, mask, True)
    assert (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES) == before


def _step_loop(arrs, mask, reverse):
    ts = {n: torch.tensor(arrs[n], requires_grad=True) for n in NAMES}
    outs = trnn.lstm_step_loop(ts["proj"], torch.tensor(mask),
                               trnn.LstmParams(ts["w_hh"], ts["bias"]),
                               ts["h0"], ts["c0"], reverse=reverse)
    grads = torch.autograd.grad(_loss(outs, torch), [ts[n] for n in NAMES])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


@pytest.mark.parametrize("reverse", [False, True])
def test_step_loop_matches_jax_scan_at_the_standard_config(monkeypatch, reverse):
    """The step loop the fused config takes on the card where the kernels
    have no layout, vs the JAX package's lax.scan branch."""
    arrs, mask = _inputs(4)
    o_j, g_j = _jax_scan(arrs, mask, reverse, "0", monkeypatch)
    o_t, g_t = _step_loop(arrs, mask, reverse)
    for a, b in zip(o_t, o_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(NAMES, g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rc,fits", [(0, True), (1, False)])
def test_fits_answers_from_the_plan(monkeypatch, rc, fits):
    """`lstm_seq_fits` reads `lstm_seq_plan`'s return code once per (card,
    shape), and `lstm_seq_plan` raises where `fits` is False."""
    calls = []

    def plan(source, index, t, b, h):
        calls.append((source, index, t, b, h))
        return rc, list(range(len(K._PLAN_KEYS)))

    monkeypatch.setattr(K, "_call_plan", plan)
    monkeypatch.setattr(K, "_plans", {})
    dev = torch.device("cuda", 1)
    assert K.lstm_seq_fits(1280, 207, 1, dev) is fits
    assert trnn.takes_fused(dev, K.lstm_seq_fits, 1280, 207, 1) is fits
    assert calls == [("lstm_seq", 1, 1, 207, 1280)]
    if fits:
        assert K.lstm_seq_plan(1280, 207, 1, dev)["fwd_blocks"] == 3
    else:
        with pytest.raises(ValueError, match="no layout"):
            K.lstm_seq_plan(1280, 207, 1, dev)


def test_plan_dict_names_every_number():
    """`<source>_plan`'s numbers map to their keys in order; the two
    W-resident flags become bools, and a count that differs raises."""
    plan = K._plan_dict([4, 2, 3, 8, 1, 16, 4, 32, 128, 0, 5, 999])
    assert list(plan) == list(K._PLAN_KEYS)
    assert plan["fwd_units"] == 4 and plan["fwd_blocks"] == 8 and plan["bwd_units"] == 16
    assert plan["fwd_w_resident"] is True and plan["bwd_w_resident"] is False
    assert plan["dw_split_k"] == 5 and plan["scratch_floats"] == 999
    with pytest.raises(ValueError):
        K._plan_dict(range(len(K._PLAN_KEYS) - 2))


def test_sync_probe_runs_only_on_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        K.lstm_seq_fwd_sync(512, 128, 5, device="cpu")


def test_kernel_wrappers_reject_cpu_tensors_and_bad_shapes():
    arrs, mask = _inputs(6)
    t = {n: torch.from_numpy(arrs[n]) for n in NAMES}
    args = (_tm(arrs["proj"]), _tm(mask), t["w_hh"], t["bias"], t["h0"], t["c0"])
    with pytest.raises(ValueError, match="CUDA"):
        K.lstm_seq_fwd(*args)
    with pytest.raises(ValueError, match="w_hh must be"):
        K.check_lstm_inputs(args[0], args[1], args[2].T, args[3], args[4], args[5])
    with pytest.raises(ValueError, match="4H"):
        K.check_lstm_inputs(args[0][..., :-1], *args[1:])


def test_lstm_layer_param_names_and_layouts():
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn.graph import Network, reset_name_scope
    from paddle_tpu_torch.nn.recurrent import bidirectional_lstm, simple_lstm

    reset_name_scope()
    x = L.Data("x", shape=(5,), is_seq=True)
    a = simple_lstm(x, 3, name="a")
    bi = bidirectional_lstm(x, 2, name="bi", use_peephole=False)
    rs = np.random.RandomState(0)
    batch = {"x": rs.randn(2, 4, 5).astype(np.float32), "x.lengths": np.array([4, 2])}
    params = Network([a, bi]).init(batch, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    assert shapes == {
        "a.input_proj.w": (5, 12), "a.input_proj.b": (12,), "a.w_hh": (3, 12),
        "a.b": (12,), "a.check_i": (3,), "a.check_f": (3,), "a.check_o": (3,),
        **{f"bi.{d}.input_proj.w": (5, 8) for d in ("fw", "bw")},
        **{f"bi.{d}.input_proj.b": (8,) for d in ("fw", "bw")},
        **{f"bi.{d}.w_hh": (2, 8) for d in ("fw", "bw")},
        **{f"bi.{d}.b": (8,) for d in ("fw", "bw")},
    }


_ACT_NAMES = ["linear", "identity", "", "sigmoid", "softmax", "relu", "brelu", "tanh",
              "stanh", "softrelu", "abs", "square", "exponential", "exp", "log", "sqrt",
              "reciprocal"]


@pytest.mark.parametrize("name", _ACT_NAMES)
def test_activation_matches_jax(name):
    from paddle_tpu.nn import activations as jact

    rs = np.random.RandomState(1)
    x = (rs.randn(3, 7) * 20).astype(np.float32)
    if name in ("log", "sqrt", "reciprocal"):
        x = np.abs(x) + 0.5
    want = np.asarray(jact.get(name)(x))
    got = tact.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unported_activation_raises_keyerror():
    with pytest.raises(KeyError, match="not ported"):
        tact.get("no_such_activation")


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


CARD_SHAPES = [  # b, t, h, lengths
    (5, 7, 24, (7, 3, 1, 5, 6)),
    (9, 13, 64, (13, 1, 8, 13, 2, 11, 5, 13, 7)),
    # H not a multiple of 4 (4-byte staging) and more rows than one pass
    # of a block covers
    (600, 4, 30, tuple(1 + np.arange(600) % 4)),
    # 2 units per block and a last block with fewer units
    (7, 5, 130, (5, 4, 3, 2, 1, 5, 5)),
    # BASELINE's hidden sizes at its largest batch: 2 and 4 units per block
    (256, 3, 256, tuple(1 + np.arange(256) % 3)),
    (256, 3, 512, tuple(1 + np.arange(256) % 3)),
    # wide enough that each block's W slice is staged per k tile
    (6, 3, 1280, (3, 1, 2, 3, 3, 2)),
    # the backward's row x unit layouts: rows that do not fill a row group,
    # one row, and BASELINE's widest row (W rows staged per k tile)
    (37, 4, 512, tuple(1 + np.arange(37) % 4)),
    (1, 3, 512, (2,)),
    (64, 3, 1280, tuple(1 + np.arange(64) % 3)),
    # the text classifier's width and batch (4 row groups x 32 unit groups)
    (128, 5, 512, tuple(1 + np.arange(128) % 5)),
    # lengths None: steps masked between valid ones (_holes_mask), across
    # which the forward keeps a row's sums of h W
    (5, 9, 24, None),
    (37, 9, 512, None),
    (64, 3, 1280, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,h,lens", CARD_SHAPES)
def test_cuda_kernels_match_plain_versions(cuda, b, t, h, lens, reverse):
    arrs, mask = _inputs(7, b, t, h, lens or (t,) * b)
    if lens is None:
        mask = _holes_mask(b, t)
    args = [x.to(cuda) for x in (_tm(arrs["proj"]), _tm(mask))]
    args += [torch.from_numpy(arrs[n]).to(cuda) for n in ("w_hh", "bias", "h0", "c0")]
    before = (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES)
    got_f = K.lstm_seq_fwd(*args, reverse=reverse)
    again_f = K.lstm_seq_fwd(*args, reverse=reverse)
    want_f = K.lstm_seq_fused_ref(*args, reverse=reverse)
    rs = np.random.RandomState(8)
    dhs, dhl, dcl = (torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda)
                     for s in ((t, b, h), (b, h), (b, h)))
    tail = (args[4], args[5], args[1], args[2], dhs, dhl, dcl)
    got = K.lstm_seq_bwd(*got_f[1:3], got_f[0], got_f[3], *tail, reverse=reverse)
    want = K.lstm_seq_bwd_ref(*want_f[1:3], want_f[0], want_f[3], *tail, reverse=reverse)
    again = K.lstm_seq_bwd(*got_f[1:3], got_f[0], got_f[3], *tail, reverse=reverse)
    torch.cuda.synchronize()
    assert (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
    for name, a, b2 in zip(("hs", "gates", "ct", "cs", "dw", "db"), (*got_f, *got[1:3]),
                           (*again_f, *again[1:3])):
        assert torch.equal(a, b2), f"{name} differs between two calls"  # no atomics
    # every row, masked rows included: the backward reads their residuals
    for name, a, w in zip(("hs", "gates", "ct", "cs"), got_f, want_f):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)
    last = 0 if reverse else -1
    for name, a, w in (("h_last", got_f[0], want_f[0]), ("c_last", got_f[3], want_f[3])):
        torch.testing.assert_close(a[last], w[last], atol=1e-4, rtol=0, msg=name)
    for name, a, w in zip(("dproj", "dw", "db", "dh0", "dc0"), got, want):
        tol = 1e-3 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(a, w, atol=tol, rtol=0, msg=name)


@pytest.mark.cuda
def test_cuda_lstm_scan_goes_through_the_kernels(cuda):
    arrs, mask = _inputs(10)
    before = (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES)
    o_c, g_c = _torch_scan(arrs, mask, True, device=cuda)
    torch.cuda.synchronize()
    assert (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    o_p, g_p = _torch_scan(arrs, mask, True)
    for a, b in zip(o_c, o_p):
        np.testing.assert_allclose(a, b, atol=1e-4)
    for name, a, b in zip(NAMES, g_c, g_p):
        np.testing.assert_allclose(a, b, atol=1e-3 * max(1.0, np.abs(b).max()), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_lstm_scan_without_a_layout_takes_the_step_loop(cuda, reverse):
    """T=1, B=207, H=1280: the forward has no layout on a 132-SM card, so
    lstm_scan takes the step loop (no kernel launch) and its outputs and
    gradients match the plain path on the CPU."""
    b, t, h = 207, 1, 1280
    assert not K.lstm_seq_fits(h, b, t, cuda)
    arrs, mask = _inputs(16, b, t, h, (1,) * b)
    arrs["w_hh"] *= (64 / h) ** 0.5
    before = (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES)
    o_c, g_c = _torch_scan(arrs, mask, reverse, device=cuda)
    torch.cuda.synchronize()
    assert (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES) == before
    o_p, g_p = _torch_scan(arrs, mask, reverse)
    for a, b2 in zip(o_c, o_p):
        np.testing.assert_allclose(a, b2, atol=1e-4)
    for name, a, b2 in zip(NAMES, g_c, g_p):
        np.testing.assert_allclose(a, b2, atol=1e-3 * max(1.0, np.abs(b2).max()),
                                   err_msg=name)


@pytest.mark.cuda
def test_cuda_lstm_plan_splits_rows_and_units(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for h, b in ((512, 128), (1280, 64)):
        plan = K.lstm_seq_plan(h, b, 100)
        for leg in ("fwd", "bwd"):
            assert plan[f"{leg}_blocks"] == (plan[f"{leg}_row_groups"]
                                             * -(-h // plan[f"{leg}_units"]))
            assert plan[f"{leg}_blocks"] <= sms and plan[f"{leg}_row_groups"] > 1
            assert plan[f"{leg}_row_groups"] * plan[f"{leg}_rows_per_group"] >= b
        # W resident at the text classifier's width, staged per k tile at 1280
        assert plan["fwd_w_resident"] == plan["bwd_w_resident"] == (h == 512)
        assert plan["scratch_floats"] > 0


@pytest.mark.cuda
def test_cuda_lstm_sync_probe_runs(cuda):
    K.lstm_seq_fwd_sync(512, 128, 5)
    torch.cuda.synchronize()
