"""The port's ServableLM against the JAX package's, on the CPU.

The JAX model (the configuration of tests/test_decode_fastpath.py: vocab 96,
2 layers, d_model 32, 2 heads, max_len 96) draws its weights; they move to
the port by name (`convert.params_from_jax`). Every serving entry point then
gets the same numpy inputs on both sides and must agree at rtol=atol=1e-5 —
f32 on both sides, so the only differences are summation order — with
greedy tokens equal: `forward_logits`, `prefill` (first token, kc, vc),
`commit_prefill` (pools), `prefill_chunk` (pools + token) and three
successive `decode_step`s over a ragged block table (pools + tokens).
Checkpoints move both ways through the JAX package's .npz format."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving.convert import params_from_jax, params_to_jax
from paddle_tpu_torch.serving.model import LMConfig, ServableLM

pytestmark = pytest.mark.serving

CFG = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96)
TOL = dict(rtol=1e-5, atol=1e-5)
PS, NP, PMAX = 8, 13, 4  # page size, pool pages (page 0 = dump), pages per slot


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model on the CPU) with the same weights."""
    import jax

    from paddle_tpu.serving.model import LMConfig as JaxConfig
    from paddle_tpu.serving.model import ServableLM as JaxLM

    jm = JaxLM(JaxConfig(**CFG))
    jp = jm.init_params(jax.random.PRNGKey(0))
    pm = ServableLM(LMConfig(**CFG), device="cpu")
    pm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}))
    return jm, jp, pm


def _greedy(n):
    return (np.zeros(n, np.uint32), np.zeros(n, np.float32), np.zeros(n, np.int32))


def _pools(seed=0):
    """Identical random pools for both sides (numpy -> jnp / torch)."""
    shape = (CFG["n_layers"], NP, PS, CFG["d_model"])
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_param_names_round_trip(pair):
    jm, jp, pm = pair
    back = params_to_jax(pm)
    assert set(back) == set(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    # layer i's parameters live in layers[i] under the JAX name's suffix
    np.testing.assert_array_equal(
        pm.layers[1].w2.numpy(), np.asarray(jp["l1.w2"])
    )


def test_forward_logits(pair):
    import jax.numpy as jnp

    jm, jp, pm = pair
    toks = np.random.RandomState(1).randint(0, CFG["vocab"], (3, 20)).astype(np.int32)
    want = np.asarray(jm.forward_logits(jp, jnp.asarray(toks)))
    got = pm.forward_logits(_t(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill(pair):
    import jax.numpy as jnp

    jm, jp, pm = pair
    rng = np.random.RandomState(2)
    toks = np.zeros((3, 16), np.int32)
    lengths = np.array([5, 16, 1], np.int32)  # partial, full, one token
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.randint(3, CFG["vocab"], n)
    jt, jkc, jvc = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lengths),
                              *map(jnp.asarray, _greedy(3)))
    pt, pkc, pvc = pm.prefill(_t(toks), _t(lengths), *_greedy(3))
    assert pt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(pkc.numpy(), np.asarray(jkc), **TOL)
    np.testing.assert_allclose(pvc.numpy(), np.asarray(jvc), **TOL)


def test_commit_prefill(pair):
    import jax.numpy as jnp

    jm, jp, pm = pair
    kp, vp = _pools(3)
    rng = np.random.RandomState(3)
    kc = rng.randn(CFG["n_layers"], 2, 16, CFG["d_model"]).astype(np.float32)
    vc = rng.randn(*kc.shape).astype(np.float32)
    lengths = np.array([11, 20], np.int32)
    starts = np.array([0, 8], np.int32)  # a whole prompt and a chunk
    rows = np.array([[5, 2, 0, 0], [7, 9, 4, 0]], np.int32)
    jk, jv = jm.commit_prefill(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), jnp.asarray(rows), jnp.asarray(starts),
    )
    pk, pv = _t(kp.copy()), _t(vp.copy())
    pm.commit_prefill(pk, pv, _t(kc), _t(vc), _t(lengths), _t(rows), _t(starts))
    # page 0 is the dump page: padding positions write it in no set order
    np.testing.assert_allclose(pk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(pv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)


def test_prefill_chunk(pair):
    import jax.numpy as jnp

    jm, jp, pm = pair
    kp, vp = _pools(4)
    prompt = np.random.RandomState(4).randint(3, CFG["vocab"], 20).astype(np.int32)
    row = np.array([[3, 11, 6, 0]], np.int32)
    starts = np.array([8], np.int32)  # the second chunk of a 20-token prompt
    lengths = np.array([20], np.int32)
    toks = np.zeros((1, 8), np.int32)
    toks[0] = prompt[8:16]
    jk, jv, jt = jm.prefill_chunk(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(toks),
        jnp.asarray(starts), jnp.asarray(lengths), jnp.asarray(row),
        *map(jnp.asarray, _greedy(1)),
    )
    pk, pv = _t(kp.copy()), _t(vp.copy())
    pt = pm.prefill_chunk(pk, pv, _t(toks), _t(starts), _t(lengths), _t(row),
                          *_greedy(1))
    np.testing.assert_allclose(pk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(pv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)
    assert pt.tolist() == np.asarray(jt).tolist()

    # the final chunk (start 16, 4 valid tokens) samples at position 19
    toks[0] = 0
    toks[0, :4] = prompt[16:]
    starts[0] = 16
    jk, jv, jt = jm.prefill_chunk(
        jp, jk, jv, jnp.asarray(toks), jnp.asarray(starts),
        jnp.asarray(lengths), jnp.asarray(row), *map(jnp.asarray, _greedy(1)),
    )
    pt = pm.prefill_chunk(pk, pv, _t(toks), _t(starts), _t(lengths), _t(row),
                          *_greedy(1))
    np.testing.assert_allclose(pk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    assert pt.tolist() == np.asarray(jt).tolist()


def test_three_decode_steps_over_a_ragged_table(pair):
    import jax.numpy as jnp

    jm, jp, pm = pair
    kp, vp = _pools(5)
    # slot 0 mid page 2, slot 1 at a page edge, slot 2 inactive (dump row),
    # slot 3 at position 0; shuffled physical pages
    bt = np.array([[4, 9, 1, 0], [12, 7, 0, 0], [0, 0, 0, 0], [10, 0, 0, 0]],
                  np.int32)
    positions = np.array([18, 7, 0, 0], np.int32)
    active = np.array([True, True, False, True])
    tokens = np.array([5, 17, 0, 40], np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    pk, pv = _t(kp.copy()), _t(vp.copy())
    for _ in range(3):
        sampling = _greedy(4)
        steps = np.zeros(4, np.int32)
        jk, jv, jt = jm.decode_step(
            jp, jk, jv, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(active), jnp.asarray(bt), jnp.asarray(sampling[0]),
            jnp.asarray(steps), jnp.asarray(sampling[1]),
            jnp.asarray(sampling[2]),
        )
        pt = pm.decode_step(pk, pv, _t(tokens), _t(positions), _t(active),
                            _t(bt), sampling[0], steps, *sampling[1:])
        np.testing.assert_allclose(pk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
        np.testing.assert_allclose(pv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)
        jt = np.asarray(jt)
        assert pt.numpy()[active].tolist() == jt[active].tolist()
        tokens = jt.astype(np.int32)
        positions = positions + active


def test_decode_logits_equal_jax_full_context_logits(pair):
    """The decode step's logits themselves, not just their argmax: with
    positions < p committed to the pages, decoding token p at position p
    gives the JAX package's full-context logits at p."""
    import jax.numpy as jnp

    jm, jp, pm = pair
    ctx = np.random.RandomState(6).randint(3, CFG["vocab"], (2, 24)).astype(np.int32)
    want = np.asarray(jm.forward_logits(jp, jnp.asarray(ctx)))
    bt = np.array([[4, 9, 0, 0], [12, 7, 2, 0]], np.int32)
    positions = np.array([10, 23], np.int32)
    kc, vc = pm.prefill(_t(ctx), _t(np.array([24, 24], np.int32)), *_greedy(2))[1:]
    pk, pv = (torch.zeros(CFG["n_layers"], NP, PS, CFG["d_model"])
              for _ in range(2))
    pm.commit_prefill(pk, pv, kc, vc, _t(positions), _t(bt),
                      torch.zeros(2, dtype=torch.int32))
    got = pm.decode_logits(
        pk, pv, _t(ctx[np.arange(2), positions]), _t(positions),
        torch.ones(2, dtype=torch.bool), _t(bt),
    ).numpy()
    np.testing.assert_allclose(got[0], want[0, 10], **TOL)
    np.testing.assert_allclose(got[1], want[1, 23], **TOL)


def test_jax_checkpoint_loads_in_the_port(pair, tmp_path):
    import jax.numpy as jnp

    jm, jp, pm = pair
    path = str(tmp_path / "jax_ckpt.npz")
    jm.save(path, jp)
    loaded = ServableLM.load(path, device="cpu")
    assert loaded.cfg == pm.cfg
    toks = np.random.RandomState(7).randint(0, CFG["vocab"], (2, 12)).astype(np.int32)
    want = np.asarray(jm.forward_logits(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(loaded.forward_logits(_t(toks)).numpy(), want, **TOL)


def test_port_checkpoint_loads_in_jax(pair, tmp_path):
    import jax.numpy as jnp

    from paddle_tpu.serving.model import ServableLM as JaxLM

    _, _, pm = pair
    fresh = ServableLM(pm.cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3)
    )
    path = str(tmp_path / "port_ckpt.npz")
    fresh.save(path)
    jm, jp = JaxLM.load(path)
    assert jm.cfg.vocab == fresh.cfg.vocab and jm.cfg.eos_id == fresh.cfg.eos_id
    toks = np.random.RandomState(8).randint(0, CFG["vocab"], (2, 12)).astype(np.int32)
    want = np.asarray(jm.forward_logits(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(fresh.forward_logits(_t(toks)).numpy(), want, **TOL)


def test_init_params_scales_and_device_independence():
    cfg = LMConfig(vocab=64, n_layers=1, d_model=32, n_heads=2, max_len=64)
    a = ServableLM(cfg, device="cpu").init_params(torch.Generator().manual_seed(5))
    b = ServableLM(cfg, device="cpu").init_params(torch.Generator().manual_seed(5))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert abs(float(a.embed.std()) - 0.1) < 0.01
    assert abs(float(a.pos.std()) - 0.02) < 0.003
    assert torch.equal(a.layers[0].ln1, torch.ones(32))
    assert torch.equal(a.layers[0].b1, torch.zeros(128))
    assert not any(p.requires_grad for p in a.parameters())


def test_draw_seed_reaches_the_low_32_bits():
    """torch's CPU generator keeps only the low 32 bits of a seed: both the
    request seed and the token index must move them."""
    from paddle_tpu_torch.serving.model import _draw_seed

    low = 0xFFFFFFFF
    assert len({_draw_seed(s, 0) & low for s in range(2000)}) == 2000
    assert len({_draw_seed(7, t) & low for t in range(2000)}) == 2000
    assert _draw_seed(5, 3) == _draw_seed(5, 3) < 2**64


def test_gelu_is_the_tanh_approximation(pair):
    """jax.nn.gelu defaults to the tanh form; torch's default (exact erf)
    would drift by ~1e-3 and flip greedy tokens."""
    import jax
    import jax.numpy as jnp

    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(_t(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4
