"""The GAN demo's alternating training (MultiNetworkTrainer) against the
JAX package's.

The topology of tests/test_multi_network.py (chip_smoke.py's `gan_build`,
built in each package): a discriminator Fc 16 relu -> Fc 2 softmax
(`dis_*`), a generator Fc 16 relu -> Fc 2 (`gen_*`) scored by a static
copy of the discriminator, Adam(1e-2) in both phases. The JAX
trainers initialise; their parameters move into the port's by name; then 5
alternating iterations on the same real samples and noise, each phase's
fake samples drawn by its own package's generator: the costs agree within
rtol 1e-5 / atol 1e-6, the parameters within 1e-5 after the run, the
shared `dis_*` are bitwise equal in both port phases, and `gen_*` never
enter the discriminator's state.

On the card (`cuda`, skipped elsewhere): each phase's step is its own
graph, captured at its first step and replayed after; the shared
parameters stay bitwise in sync through the copies, and the costs follow
the CPU's."""

import numpy as np
import pytest
import torch

from chip_smoke import gan_build
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.nn.graph import Network as TNetwork
from paddle_tpu_torch.nn.graph import ParamAttr as TParamAttr
from paddle_tpu_torch.nn.graph import reset_name_scope as t_reset
from paddle_tpu_torch.optim import Adam as TAdam
from paddle_tpu_torch.trainer import MultiNetworkTrainer, SGDTrainer

DATA_MEAN = np.asarray([2.0, -1.0], np.float32)
BS = 16
ITERS = 5


def port_gan(device):
    t_reset()
    return gan_build(TL, TC, TParamAttr, TNetwork, TAdam, SGDTrainer, device=device)


def batches(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(ITERS):
        out.append(dict(real=DATA_MEAN + rs.randn(BS, 2).astype(np.float32) * 0.3,
                        noise_d=rs.randn(BS, 4).astype(np.float32),
                        noise_g=rs.randn(BS, 4).astype(np.float32)))
    return out


def first_batches(rs_seed=1):
    rs = np.random.RandomState(rs_seed)
    return {"dis": {"sample": DATA_MEAN + rs.randn(BS, 2).astype(np.float32) * 0.3,
                    "label": np.ones(BS, np.int64)},
            "gen": {"noise": rs.randn(BS, 4).astype(np.float32),
                    "label": np.ones(BS, np.int64)}}


def port_fake(mt, gen_net, out_name, noise):
    outs = gen_net.apply(mt.state_of("gen")["params"], {"noise": noise})
    return outs[out_name].value.detach().cpu().numpy()


def run_port(mt, gen_net, out_name, data):
    costs = []
    for b in data:
        fake = port_fake(mt, gen_net, out_name, b["noise_d"])
        samples = np.concatenate([b["real"], fake], 0)
        labels = np.concatenate([np.ones(BS), np.zeros(BS)]).astype(np.int64)
        cd = mt.step("dis", {"sample": samples, "label": labels})
        cg = mt.step("gen", {"noise": b["noise_g"], "label": np.ones(BS, np.int64)})
        costs.append((float(cd), float(cg)))
    return costs


def test_gan_alternating_steps_match_jax():
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import Network as JNetwork
    from paddle_tpu.nn.graph import ParamAttr as JParamAttr
    from paddle_tpu.nn.graph import reset_name_scope as j_reset
    from paddle_tpu.optim import Adam as JAdam
    from paddle_tpu.trainer import SGDTrainer as JTrainer
    from paddle_tpu.trainer.multi_network import MultiNetworkTrainer as JMulti

    j_reset()
    jdis, jgen, jgen_net, jname = gan_build(JL, JC, JParamAttr, JNetwork, JAdam, JTrainer)
    jmt = JMulti({"dis": jdis, "gen": jgen})
    jmt.init_state(first_batches())

    tdis, tgen, tgen_net, tname = port_gan("cpu")
    tmt = MultiNetworkTrainer({"dis": tdis, "gen": tgen})
    tmt.init_state(first_batches())
    for phase in ("dis", "gen"):
        tmt.trainers[phase].load_params(params_from_jax(jmt.state_of(phase)["params"], "cpu"))
    # the shared names start from one copy in both packages
    np.testing.assert_array_equal(tmt.state_of("gen")["params"]["dis_w1"].numpy(),
                                  tmt.state_of("dis")["params"]["dis_w1"].numpy())

    data = batches()
    want = []
    for b in data:
        outs, _ = jgen_net.apply(jmt.state_of("gen")["params"], jmt.state_of("gen")["states"],
                                 {"noise": b["noise_d"]})
        samples = np.concatenate([b["real"], np.asarray(outs[jname].value)], 0)
        labels = np.concatenate([np.ones(BS), np.zeros(BS)]).astype(np.int64)
        cd = jmt.step("dis", {"sample": samples, "label": labels})
        cg = jmt.step("gen", {"noise": b["noise_g"], "label": np.ones(BS, np.int64)})
        want.append((float(cd), float(cg)))
    got = run_port(tmt, tgen_net, tname, data)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for phase in ("dis", "gen"):
        jp = jmt.state_of(phase)["params"]
        tp = tmt.state_of(phase)["params"]
        assert set(tp) == set(jp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{phase} {k}")
    for k in ("dis_w1", "dis_b1", "dis_w2", "dis_b2"):
        np.testing.assert_array_equal(tmt.state_of("dis")["params"][k].numpy(),
                                      tmt.state_of("gen")["params"][k].numpy())
    assert "gen_w1" not in tmt.state_of("dis")["params"]


def test_sync_copies_into_the_phases_own_tensors():
    tdis, tgen, _, _ = port_gan("cpu")
    mt = MultiNetworkTrainer({"dis": tdis, "gen": tgen})
    mt.init_state(first_batches())
    held = mt.state_of("gen")["params"]["dis_w1"]
    with torch.no_grad():
        mt.state_of("dis")["params"]["dis_w1"].add_(1.0)
    mt.sync_shared("dis")
    assert mt.state_of("gen")["params"]["dis_w1"] is held
    assert torch.equal(held, mt.state_of("dis")["params"]["dis_w1"])
    assert held is not mt.state_of("dis")["params"]["dis_w1"]


def test_needs_a_trainer():
    with pytest.raises(ValueError):
        MultiNetworkTrainer({})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")


@pytest.mark.cuda
def test_cuda_two_phase_graphs_stay_in_sync(cuda):
    runs = {}
    for dev in ("cuda", "cpu"):
        tdis, tgen, gen_net, name = port_gan(dev)
        mt = MultiNetworkTrainer({"dis": tdis, "gen": tgen})
        mt.init_state(first_batches())
        if dev == "cuda":
            start = {p: {k: v.cpu() for k, v in mt.state_of(p)["params"].items()}
                     for p in ("dis", "gen")}
        else:
            for p in ("dis", "gen"):
                mt.trainers[p].load_params(start[p])
        runs[dev] = (run_port(mt, gen_net, name, batches()), mt)
    mt = runs["cuda"][1]
    for p in ("dis", "gen"):
        (graph,) = mt.trainers[p].graphs.values()
        assert graph.replays == ITERS - 1
    for k in ("dis_w1", "dis_b1", "dis_w2", "dis_b2"):
        assert torch.equal(mt.state_of("dis")["params"][k], mt.state_of("gen")["params"][k])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4, atol=1e-5)
