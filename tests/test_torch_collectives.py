"""The collective pins of the data-parallel step (the counterpart of
`tests/test_hlo_collectives.py`): where the JAX package counts the
collectives XLA emitted into the compiled step, the port counts the
torch.distributed calls its step makes on the mesh's group
(`parallel/mesh.py` `Mesh.counts`; under a CUDA graph, the captured calls
once per replay).

The port's numbers, for the 3-layer net of the JAX test (Fc 16 -> 64 ->
32 -> 4: six parameters) on 4 thread ranks over gloo, per step:

  * replicated: 1 all-reduce (every gradient and the cost in one flat f32
    buffer) and no gather;
  * zero1, none: 1 reduce-scatter (the concatenated gradients, the cost as
    a last column) + 1 all-gather (the updated rows);
  * zero1, bf16 / int8: 1 all-to-all (the encoded rows; the owner decodes
    and adds them up: a collective cannot add block-scaled int8) + 1
    all-gather (the bf16 delta);
  * zero2 at K = 1, 2, 4 in one `multi_step`: 1 scatter + 1 gather per
    DISPATCH; zero1 at K = 4: 4 + 4 (one pair a step);
  * zero3: 1 reduce-scatter and one all-gather per flat parameter (6; 8
    with a fourth layer's two): the gathers grow with the layers, the
    scatter does not (the JAX package's model also counts the backward's
    re-gather; the port's consuming ops keep the gathered view instead);
  * batch norm adds 2 all-reduces per layer (its sums forward, its
    gradient sums backward);
  * no count grows with the batch (32 vs 64 rows).

On the card (`cuda`, skipped here): a world-1 NCCL mesh, the step as one
CUDA graph with its collectives in it: the same pins per step through the
replays, and parameters bitwise those of a trainer without a mesh; a gloo
group holding CUDA tensors raises `UncapturableGroupError` when the
trainer is built."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.graph import ParamAttr as TParamAttr
from paddle_tpu_torch.optim import optimizers as topt
from paddle_tpu_torch.parallel import DataParallel, make_mesh
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.trainer.trainer import SGDTrainer

from test_torch_parallel import _bn_net, _image_batches, run_ranks


def _net(extra_layer=False):
    x = TL.Data("x", shape=(16,))
    lbl = TL.Data("label", shape=())
    h = TL.Fc(x, 64, act="relu", name="h")
    h = TL.Fc(h, 32, act="relu", name="h2")
    if extra_layer:
        h = TL.Fc(h, 32, act="relu", name="h3")
    logits = TL.Fc(h, 4, act=None, name="out")
    return TC.ClassificationCost(logits, lbl, name="cost")


def _batch(bs, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(bs, 16).astype(np.float32),
            "label": rs.randint(0, 4, bs).astype(np.int32)}


def _pins(**kw):
    return {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0, "all_to_all": 0, **kw}


def _counts(shard=False, comp=None, bs=32, k=1, extra_layer=False, bn=False, n=4):
    """The collectives of one dispatch (after a warm-up step), on rank 0."""
    cost = _bn_net(TL, TC, TParamAttr) if bn else _net(extra_layer)
    batches = (_image_batches(n_batches=k, bs=bs) if bn
               else [_batch(bs, seed) for seed in range(k)])

    def fn(r, mesh):
        tr = SGDTrainer(cost, topt.SGD(learning_rate=0.125), seed=0, device="cpu",
                        parallel=DataParallel(mesh), shard_update=shard,
                        grad_compression=comp)
        tr.step(batches[0])
        mesh.reset_counts()
        if k == 1:
            tr.step(batches[0])
        else:
            tr.multi_step({key: np.stack([b[key] for b in batches]) for key in batches[0]})
        return mesh.counts()

    return run_ranks(n, fn)[0]


@pytest.mark.parametrize("shard,comp,want", [
    (False, None, _pins(all_reduce=1)),
    ("zero1", None, _pins(reduce_scatter=1, all_gather=1)),
    ("zero1", "bf16", _pins(all_to_all=1, all_gather=1)),
    ("zero1", "int8", _pins(all_to_all=1, all_gather=1)),
    ("zero3", None, _pins(reduce_scatter=1, all_gather=6)),
    ("zero3", "int8", _pins(all_to_all=1, all_gather=6)),
])
def test_collective_counts_pinned(shard, comp, want):
    assert _counts(shard, comp) == want


def test_replicated_path_has_no_gathers():
    got = _counts(False)
    assert got["all_gather"] == got["reduce_scatter"] == got["all_to_all"] == 0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_zero2_one_scatter_and_one_gather_per_dispatch(k):
    assert _counts("zero2", k=k) == _pins(reduce_scatter=1, all_gather=1)


def test_zero1_k_dispatch_keeps_per_step_collectives():
    assert _counts("zero1", k=4) == _pins(reduce_scatter=4, all_gather=4)


def test_zero3_gathers_scale_per_layer_scatters_do_not():
    base, more = _counts("zero3"), _counts("zero3", extra_layer=True)
    assert more["all_gather"] == base["all_gather"] + 2  # the new layer's w and b
    assert more["reduce_scatter"] == base["reduce_scatter"] == 1


@pytest.mark.parametrize("shard", [False, "zero1", "zero3"])
def test_no_count_grows_with_the_batch(shard):
    assert _counts(shard, bs=32) == _counts(shard, bs=64)


@pytest.mark.parametrize("shard,want", [
    (False, _pins(all_reduce=2 * 2 + 1)),
    ("zero1", _pins(all_reduce=2 * 2, reduce_scatter=1, all_gather=1)),
])
def test_batch_norm_adds_two_all_reduces_a_layer(shard, want):
    assert _counts(shard, bs=16, bn=True) == want


# -- on the card: world 1 over NCCL, the collectives in the step graph --------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL and CUDA graphs have no CPU mode")


STEP_PINS = {False: _pins(all_reduce=1), "zero1": _pins(reduce_scatter=1, all_gather=1),
             "zero3": _pins(reduce_scatter=1, all_gather=6)}


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [False, "zero1", "zero3"])
def test_cuda_world1_nccl_step_graph_bitwise_and_counted(cuda, shard):
    mesh = make_mesh({"data": 1})
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    assert mesh.axis_group("data") is mesh.group  # the step graph holds NCCL calls
    cost = _net()
    batches = [_batch(32, seed) for seed in range(4)]
    plain = SGDTrainer(cost, topt.SGD(learning_rate=0.1, momentum=0.9), seed=0)
    tr = SGDTrainer(cost, topt.SGD(learning_rate=0.1, momentum=0.9), seed=0,
                    parallel=DataParallel(mesh), shard_update=shard)
    for t in (plain, tr):
        t.init_state(batches[0])
    tr.load_params({k: v.clone() for k, v in plain.state["params"].items()})
    mesh.reset_counts()
    for b in batches:  # eager + capture, then three replays
        plain.step(b)
        tr.step(b)
    torch.cuda.synchronize()
    assert len(tr.graphs) == 1
    assert mesh.counts() == {k: 4 * v for k, v in STEP_PINS[shard].items()}
    got, want = tr.canonical_params(), plain.state["params"]
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_gloo_group_holding_cuda_tensors_raises(cuda):
    group = tmesh.new_gloo_group(torch.distributed.HashStore(), 0, 1)
    mesh = make_mesh({"data": 1}, group=group, device="cuda")
    with pytest.raises(tmesh.UncapturableGroupError, match="gloo"):
        SGDTrainer(_net(), topt.SGD(learning_rate=0.1), parallel=DataParallel(mesh))


# -- the model and seq axes ------------------------------------------------------


def test_tp_decode_step_pins():
    """A tensor-parallel decode step on {"data": 1, "model": 2} (2 layers):
    2 L + 1 all-reduces (wo and w2 a layer, the embed gather) and 1
    all-gather (the logits) on the model axis, none on the data axis."""
    from paddle_tpu_torch.serving.session import make_demo_session
    from paddle_tpu_torch.serving.tp import TPWorker

    kw = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, max_slots=2, page_size=8,
              prefill_buckets=(8,), max_new_limit=8, device="cpu")

    def fn(r, mesh):
        s = make_demo_session(tp=2, group=mesh.group, **kw)
        if isinstance(s, TPWorker):
            s.run()
            return None
        s.submit([1, 5, 9], 8)
        s.step()  # admission: the prefill and the first decode step
        m = s.model.mesh
        m.reset_counts()
        steps = s.decode_steps
        s.step()
        got = (s.decode_steps - steps, m.counts("model"), m.counts("data"))
        s.run_until_idle()
        s.stop()
        return got

    steps, model, data = run_ranks(2, fn, axes={"data": 1, "model": 2})[0]
    assert steps == 1
    assert model == _pins(all_reduce=2 * 2 + 1, all_gather=1)
    assert data == _pins()


def test_sequence_parallel_pins():
    """A ring call: n - 1 send/recv pairs (the packed K/V rotating), no
    other collective; a Ulysses call: 2 all-to-alls (q, k, v stacked in
    one, the output back)."""
    from paddle_tpu_torch.parallel.sequence_parallel import ring_attention, ulysses_attention

    q = torch.randn(1, 4, 4, 8)

    def fn(r, mesh):
        out = {}
        for name, f in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            mesh.reset_counts()
            f(q, q, q, mesh)
            out[name] = mesh.counts("seq")
        return out

    got = run_ranks(4, fn, axes={"seq": 4})[0]
    assert got["ring"] == {**_pins(), "send_recv": 3}
    assert got["ulysses"] == _pins(all_to_all=2)
