"""Rematerialization (`SGDTrainer(remat=)`, `core/remat.py`), mirroring
tests/test_precision.py's remat tests.

On the CPU, on a small conv net with batch norm and Dropout:
  * "dots", "conv_only" and "full" give the parameters, slots and batch-norm
    states of no remat after 2 passes (rtol 1e-6, atol 1e-7; the lr is a
    power of two), so the recompute draws Dropout's masks unchanged;
  * the gradients of one step under "full" equal those of "none";
  * a bad policy is rejected by the constructor and by train(remat=),
    which re-pins the policy and drops the captured graphs when it changes;
  * the policies save what they say: conv_only keeps only the tagged
    conv/matmul outputs, dots every matmul and conv.

On the card (`cuda`, skipped elsewhere): the conv_only step captures into
a CUDA graph and its replays give the updates of no remat."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import prng, remat
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.optim import SGD
from paddle_tpu_torch.trainer import SGDTrainer

SIZE, CLASSES, BATCH = 8, 3, 4


def trainer(remat_policy=None, device="cpu"):
    tgraph.reset_name_scope()
    img = TL.Data("image", shape=(SIZE, SIZE, 3))
    lbl = TL.Data("label", shape=())
    x = TL.Conv2D(img, 4, 3, padding=1, act=None, bias=False, name="c1")
    x = TL.BatchNorm(x, act="relu", name="bn1")
    x = TL.Pool2D(x, 2, "max", name="p1")
    x = TL.Reshape(x, ((SIZE // 2) ** 2 * 4,), name="flat")
    x = TL.Fc(x, 16, act="relu", name="fc1")
    x = TL.Dropout(x, 0.5, name="drop")
    logits = TL.Fc(x, CLASSES, act=None, name="logits")
    return SGDTrainer(TC.ClassificationCost(logits, lbl), SGD(learning_rate=0.125, momentum=0.5),
                      seed=2, device=device, remat=remat_policy)


def batches(n=3, seed=0):
    rs = np.random.RandomState(seed)
    return [{"image": rs.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
             "label": rs.randint(0, CLASSES, BATCH).astype(np.int32)} for _ in range(n)]


def flat_state(tr):
    return {f"{name}/{k}": v.detach().cpu().numpy() for name, tree in tr._trees().items()
            for k, v in tree.items()}


@pytest.mark.parametrize("policy", ["dots", "conv_only", "full"])
def test_remat_never_changes_updates(policy):
    data = batches()
    base, rem = trainer(), trainer(policy)
    assert rem.remat == policy
    base.train(lambda: iter(data), num_passes=2)
    rem.train(lambda: iter(data), num_passes=2)
    a, b = flat_state(base), flat_state(rem)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7, err_msg=f"{policy}: {k}")


def test_full_remat_gradients_equal_none_with_dropout():
    data = batches(1)[0]
    base, rem = trainer(), trainer("full")
    base.init_state(data)
    rem.init_state(data)
    c0, g0 = base.cost_and_grads(data)
    c1, g1 = rem.cost_and_grads(data)
    assert float(c0) == float(c1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)
    # the masks matter: another key draws another cost
    other = rem.cost_grads_and_states(data, rng=prng.PRNGKey(99))[0]
    assert float(other) != float(c1)


def test_invalid_remat_rejected_and_train_override_rebuilds():
    with pytest.raises(ValueError, match="remat"):
        trainer("checkpoint_everything")
    tr = trainer()
    with pytest.raises(ValueError, match="remat"):
        tr.train(lambda: iter(batches(1)), remat="bogus")
    tr.train(lambda: iter(batches(1)), num_passes=1)
    tr.graphs[("marker",)] = object()  # stands for a captured graph
    tr.train(lambda: iter(batches(1)), num_passes=1, remat="dots")
    assert tr.remat == "dots" and not tr.graphs
    tr.graphs[("marker",)] = object()
    tr.train(lambda: iter(batches(1)), num_passes=1, remat="dots")
    assert ("marker",) in tr.graphs  # same policy: the graphs stay
    tr.train(lambda: iter(batches(1)), num_passes=1, remat="none")
    assert tr.remat is None


def test_segments_end_at_conv_and_fc_layers():
    from paddle_tpu_torch.nn.graph import _segments

    tr = trainer("conv_only")
    order = [x for x in tr.network.layer_order if x.type_name != "data"]
    segs = [[x.name for x in seg] for seg in _segments(order, True)]
    assert segs == [["c1"], ["bn1", "p1", "flat", "fc1"], ["drop", "logits"],
                    [tr.cost_names[0]]]
    assert [len(seg) for seg in _segments(order, False)] == [1] * len(order)


def test_policies_save_what_they_name():
    aten = torch.ops.aten
    save, recompute = (remat._ckpt.CheckpointPolicy.MUST_SAVE,
                       remat._ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    dots, conv_only = remat._policy("dots"), remat._policy("conv_only")
    assert dots(None, aten.mm.default) == save
    assert dots(None, aten.relu.default) == recompute
    assert conv_only(None, aten.mm.default) == recompute  # untagged
    with remat.name("conv_out"):
        assert conv_only(None, aten.convolution.default) == save
        assert conv_only(None, aten.mm.default) == save
        assert conv_only(None, aten.add.Tensor) == recompute
    assert remat.resolve("none") is None and remat.resolve(None) is None


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["conv_only", "full"])
def test_cuda_remat_graph_replays_match_none(cuda, policy):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = batches(4)
    base, rem = trainer(device=cuda), trainer(policy, device=cuda)
    base.train(lambda: iter(data), num_passes=1)
    rem.train(lambda: iter(data), num_passes=1)
    assert next(iter(rem.graphs.values())).replays == 3
    a, b = flat_state(base), flat_state(rem)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6, err_msg=f"{policy}: {k}")
