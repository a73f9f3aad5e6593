"""The port's paddle.v2 trainer API (`paddle_tpu_torch/v2/{trainer,parameters,
event,inference,plot,minibatch}.py`, `v2.init`) and the py_paddle surface
(`api.py`) against the JAX package's, on the CPU.

  * A v2 script — `layer.data` / `embedding` / `networks.simple_gru` (the
    fused GRU) / `last_seq` / `fc(2, Softmax)` / `classification_cost`,
    `trainer.SGD(update_equation=optimizer.Adam(1e-3))` over
    `batch(numpy reader, 8)` with `feeding` — gives the JAX package's
    first 4 EndIteration costs (within 1e-5 relative), `test()` cost and
    `infer` values (1e-5) and ids (exactly), starting from the JAX
    `Parameters` moved across as a tar.
  * `Parameters` tars are bytewise equal across the packages for the same
    values, and load into each other bitwise.
  * Twins of tests/test_v2_api.py:28 (train / test / infer round trip,
    on a numpy reader for mnist), :63 (tar round trip) and :150 (the
    GradientMachine / Arguments shapes; SequenceGenerator builds, its
    numbers in tests/test_torch_generation_serving.py), with the JAX
    package's numbers where they exist:
    `forwardBackward`'s cost and gradients within 1e-5.
  * `trainer_count > 1` builds `DataParallel` over a group of that many
    ranks (two threads over gloo here) and trains on it; without a group
    it says how to launch the ranks; a model axis and `resize_to` on a
    mesh still name ROADMAP.md §1 item 8; `paddle.dataset` and
    `paddle.image` are the port's modules; `plot` and `minibatch.batch`
    work.
  * On a card (marked `cuda`, skipped here): the script launches the fused
    GRU forward and backward every step in one graph, agrees with the CPU,
    and `infer` launches the forward once a chunk.
jax is imported inside the tests only."""

import io
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu_torch.v2 as tpaddle
from paddle_tpu_torch.core import init_ctx
from paddle_tpu_torch.nn import graph as tgraph

VOCAB, WIDTH, BATCH = 40, 16, 8


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh auto-names, and the port's `paddle.init` flags put back."""
    saved = init_ctx.flags().__dict__.copy()
    tgraph.reset_name_scope()
    yield
    init_ctx.flags().__dict__.update(saved)


def _samples(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        label = int(rs.randint(2))
        ids = rs.randint(3, VOCAB, size=rs.randint(3, 7))
        ids[:2] = 1 + label
        out.append((ids.tolist(), label))
    return out


def _reader(samples):
    def reader():
        yield from samples
    return reader


def _gru_net(paddle):
    word = paddle.layer.data(name="word",
                             type=paddle.data_type.integer_value_sequence(VOCAB))
    label = paddle.layer.data(name="label", type=paddle.data_type.integer_value(2))
    emb = paddle.layer.embedding(input=word, size=WIDTH)
    gru = paddle.networks.simple_gru(input=emb, size=WIDTH)
    out = paddle.layer.fc(input=paddle.layer.last_seq(input=gru), size=2,
                          act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=out, label=label)
    return out, cost


def _jax_gru_run(train, test, infer_in):
    """The JAX package's v2 script: (its Parameters' tar, step costs, test
    cost, infer values, infer ids)."""
    import paddle_tpu.v2 as jpaddle
    from paddle_tpu.nn.graph import reset_name_scope

    reset_name_scope()
    jpaddle.init(use_gpu=False, trainer_count=1)
    out, cost = _gru_net(jpaddle)
    params = jpaddle.parameters.create(cost)
    tar = io.BytesIO()
    params.to_tar(tar)
    tr = jpaddle.trainer.SGD(cost=cost, parameters=params,
                             update_equation=jpaddle.optimizer.Adam(learning_rate=1e-3))
    costs = []
    tr.train(reader=jpaddle.batch(_reader(train), BATCH), num_passes=1,
             event_handler=lambda e: costs.append(e.cost)
             if type(e).__name__ == "EndIteration" else None,
             feeding={"word": 0, "label": 1})
    res = tr.test(reader=jpaddle.batch(_reader(test), BATCH), feeding={"word": 0, "label": 1})
    vals, ids = jpaddle.infer(output_layer=out, parameters=tr.parameters, input=infer_in,
                              feeding={"word": 0}, field=["value", "id"])
    return tar.getvalue(), costs, res.cost, np.asarray(vals), np.asarray(ids)


def test_v2_gru_script_matches_jax():
    train, test = _samples(4 * BATCH, 0), _samples(2 * BATCH, 1)
    infer_in = [(ids,) for ids, _ in _samples(11, 2)]
    tar, jcosts, jtest, jvals, jids = _jax_gru_run(train, test, infer_in)

    out, cost = _gru_net(tpaddle)
    params = tpaddle.parameters.Parameters.from_tar(io.BytesIO(tar))
    tr = tpaddle.trainer.SGD(cost=cost, parameters=params,
                             update_equation=tpaddle.optimizer.Adam(learning_rate=1e-3),
                             device="cpu")
    events = []
    tr.train(reader=tpaddle.batch(_reader(train), BATCH), num_passes=1,
             event_handler=events.append, feeding={"word": 0, "label": 1})
    costs = [e.cost for e in events if isinstance(e, tpaddle.event.EndIteration)]
    assert [type(e).__name__ for e in events][-1] == "EndPass"
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    res = tr.test(reader=tpaddle.batch(_reader(test), BATCH), feeding={"word": 0, "label": 1})
    assert isinstance(res, tpaddle.event.TestResult)
    np.testing.assert_allclose(res.cost, jtest, rtol=1e-5)
    vals, ids = tpaddle.infer(output_layer=out, parameters=tr.parameters, input=infer_in,
                              feeding={"word": 0}, field=["value", "id"], batch_size=4,
                              device="cpu")
    assert vals.shape == (11, 2) and ids.shape == (11,)
    np.testing.assert_allclose(vals, jvals, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids, jids)


def test_parameters_tar_bytes_and_values_cross_packages():
    import paddle_tpu.v2 as jpaddle

    rs = np.random.RandomState(0)
    values = {"b.w": rs.randn(3, 4).astype(np.float32),
              "a.b": rs.randn(4).astype(np.float32),
              "emb": rs.randn(5, 2).astype(np.float32)}
    jp = jpaddle.parameters.Parameters.from_dict(values)
    tp = tpaddle.parameters.Parameters.from_dict(values)
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jp.to_tar(jbuf)
    tp.to_tar(tbuf)
    assert jbuf.getvalue() == tbuf.getvalue()
    back_t = tpaddle.parameters.Parameters.from_tar(io.BytesIO(jbuf.getvalue()))
    back_j = jpaddle.parameters.Parameters.from_tar(io.BytesIO(tbuf.getvalue()))
    for k, v in values.items():
        assert back_t.get(k).tobytes() == v.tobytes()
        assert back_j.get(k).tobytes() == v.tobytes()


def _mlp(paddle):
    images = paddle.layer.data(name="pixel", type=paddle.data_type.dense_vector(784))
    label = paddle.layer.data(name="label", type=paddle.data_type.integer_value(10))
    h = paddle.layer.fc(input=images, size=32, act=paddle.activation.Tanh())
    out = paddle.layer.fc(input=h, size=10, act=None, name="output")
    cost = paddle.layer.classification_cost(input=out, label=label)
    return images, label, out, cost


def _mnist_like(n, seed):
    """(784-dim image, label) samples with a planted bright block per class,
    in the place of paddle.dataset.mnist."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = int(rs.randint(10))
        x = rs.rand(784).astype(np.float32) * 0.2
        x[y * 70:y * 70 + 70] += 1.0
        out.append((x, y))
    return out


def test_train_test_infer_roundtrip():
    """Twin of tests/test_v2_api.py:28 on a numpy reader."""
    tpaddle.init(use_gpu=False, trainer_count=1)
    _, _, out, cost = _mlp(tpaddle)
    params = tpaddle.parameters.create(cost)
    assert "output.w" in params.names()
    trainer = tpaddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=tpaddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9))
    costs = []

    def handler(e):
        if isinstance(e, tpaddle.event.EndIteration):
            costs.append(e.cost)

    reader = tpaddle.batch(tpaddle.reader.shuffle(_reader(_mnist_like(768, 0)),
                                                  buf_size=500), batch_size=64)
    trainer.train(reader=lambda: itertools.islice(reader(), 12), num_passes=2,
                  event_handler=handler)
    assert costs[-1] < costs[0], f"no learning: {costs[0]} -> {costs[-1]}"
    res = trainer.test(reader=tpaddle.batch(_reader(_mnist_like(192, 1)), 64))
    assert np.isfinite(res.cost)
    samples = [(s,) for s, _ in _mnist_like(8, 2)]
    probs = tpaddle.infer(output_layer=out, parameters=trainer.parameters,
                          input=samples, feeding={"pixel": 0})
    assert probs.shape == (8, 10)


def test_parameters_tar_roundtrip():
    """Twin of tests/test_v2_api.py:63."""
    _, _, out, cost = _mlp(tpaddle)
    params = tpaddle.parameters.create(cost, device="cpu")
    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    params2 = tpaddle.parameters.Parameters.from_tar(buf)
    assert set(params2.names()) == set(params.names())
    for k in params.names():
        np.testing.assert_array_equal(params.get(k), params2.get(k))


def test_save_parameter_to_tar_and_warm_start(tmp_path):
    """save_parameter_to_tar writes the trained values; an SGD given them
    tests to the same cost without training."""
    _, _, out, cost = _mlp(tpaddle)
    opt = tpaddle.optimizer.Adam(learning_rate=1e-3)
    tr = tpaddle.trainer.SGD(cost=cost, update_equation=opt, device="cpu")
    data = tpaddle.batch(_reader(_mnist_like(64, 3)), 32)
    tr.train(reader=data, num_passes=1)
    path = tmp_path / "params.tar"
    with open(path, "wb") as f:
        tr.save_parameter_to_tar(f)
    loaded = tpaddle.parameters.Parameters.load_from_file(str(path))
    for k, v in tr.trainer.state["params"].items():
        np.testing.assert_array_equal(loaded.get(k), v.numpy())
    warm = tpaddle.trainer.SGD(cost=cost, parameters=loaded, update_equation=opt,
                               device="cpu")
    assert warm.test(reader=data).cost == pytest.approx(tr.test(reader=data).cost,
                                                        rel=1e-6)


def test_swig_api_shapes_match_jax():
    """Twin of tests/test_v2_api.py:150: forward, forwardBackward and
    getLayerOutput on the JAX parameters give the JAX package's numbers;
    a SequenceGenerator wraps the machine (its generation is held to the
    JAX package's in tests/test_torch_generation_serving.py)."""
    from paddle_tpu.api import Arguments as JArguments
    from paddle_tpu.api import GradientMachine as JGradientMachine
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.v2 import layer as jvl

    from paddle_tpu_torch import api
    from paddle_tpu_torch.v2 import data_type as tdt
    from paddle_tpu_torch.v2 import layer as tvl

    def build(vl, dt):
        x = vl.data(name="x", type=dt.dense_vector(8))
        y = vl.data(name="y", type=dt.integer_value(3))
        out = vl.fc(input=x, size=3, act="softmax", name="out")
        return [vl.classification_cost(input=out, label=y), out]

    rs = np.random.RandomState(0)
    xs, ys = rs.randn(4, 8).astype(np.float32), rs.randint(0, 3, 4)
    reset_name_scope()
    from paddle_tpu.v2 import data_type as jdt

    jgm = JGradientMachine(build(jvl, jdt))
    jargs = JArguments()
    jargs.setSlotValue("x", xs)
    jargs.setSlotIds("y", ys)
    jouts = jgm.forward(jargs)
    jc, jgrads = jgm.forwardBackward(jargs)

    gm = api.GradientMachine(build(tvl, tdt), device="cpu")
    args = api.Arguments()
    args.setSlotValue("x", xs)
    args.setSlotIds("y", ys)
    gm.forward(args)  # initParams on the first call, as the reference does
    gm.setParameters(jgm.getParameters())
    outs = gm.forward(args)
    assert outs["out"].shape == (4, 3)
    np.testing.assert_allclose(outs["out"], jouts["out"], rtol=1e-5, atol=1e-7)
    c, grads = gm.forwardBackward(args)
    assert np.isfinite(c) and "out.w" in grads
    np.testing.assert_allclose(c, jc, rtol=1e-5)
    for k in jgrads:
        np.testing.assert_allclose(grads[k], np.asarray(jgrads[k]), rtol=1e-5, atol=1e-6)
    assert gm.getLayerOutput("out", args).shape == (4, 3)
    assert gm.makeEvaluator().printStats() == ""

    # ragged start positions -> padded + lengths
    a2 = api.Arguments()
    flat = rs.randn(5, 2).astype(np.float32)
    a2.setSlotValue("s", flat)
    a2.setSlotSequenceStartPositions("s", [0, 2, 5])
    b = a2.as_batch()
    assert b["s"].shape == (2, 3, 2)
    np.testing.assert_array_equal(b["s.lengths"], [2, 3])
    sg = api.SequenceGenerator(gm, gm.network.outputs[1], dict_file=["a", "b", "c"])
    assert sg.machine is gm and sg.vocab == ["a", "b", "c"]


def test_named_errors_plot_and_minibatch(tmp_path):
    # paddle.dataset and paddle.image are the port's own modules now
    from paddle_tpu_torch.data import datasets, image

    assert tpaddle.dataset is datasets and tpaddle.image is image
    _, _, out, cost = _mlp(tpaddle)
    tpaddle.init(trainer_count=2)
    with pytest.raises(RuntimeError, match=r"one process per rank.*initialize"):
        tpaddle.trainer.SGD(cost=cost, update_equation=tpaddle.optimizer.Adam(), device="cpu")
    from test_torch_parallel import run_ranks

    from paddle_tpu_torch.parallel import DataParallel, make_mesh

    samples = _mnist_like(16, 3)

    def rank(r, mesh):
        sgd = tpaddle.trainer.SGD(cost=cost, update_equation=tpaddle.optimizer.Adam(),
                                  device="cpu", group=mesh.group)
        tr = sgd.trainer
        assert isinstance(tr.parallel, DataParallel) and tr.mesh.size == 2
        sgd.train(reader=tpaddle.batch(_reader(samples), 8), num_passes=1)
        # item 8c is ported: a same-size resize re-shards onto a new group
        # and the v2 parameters read back bitwise
        trained = np.array(sgd.parameters.get("output.w"))
        old = tr.mesh
        tr.resize_to(2)
        assert tr.mesh is not old and old.closed and tr.mesh.size == 2
        sgd._sync_parameters_out()
        np.testing.assert_array_equal(np.array(sgd.parameters.get("output.w")), trained)
        return trained

    trained = run_ranks(2, rank)
    np.testing.assert_array_equal(trained[0], trained[1])  # replicated
    # the model axis is ported: two ranks need a group, as two data ranks do
    with pytest.raises(RuntimeError, match=r"parallel\.distributed\.initialize"):
        make_mesh({"data": 1, "model": 2}, device="cpu")
    p = tpaddle.plot.Ploter("train", "test")
    p.append("train", 0, 1.5)
    p.append("train", 1, 1.0)
    assert p.data["train"].value == [1.5, 1.0]
    p.plot(str(tmp_path / "plot.png"))
    p.reset()
    assert p.data["train"].step == []
    batches = list(tpaddle.minibatch.batch(_reader(list(range(7))), 3)())
    assert batches == [[0, 1, 2], [3, 4, 5], [6]]


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_v2_script_launches_the_gru_kernels_and_matches_cpu(cuda):
    """The v2 GRU script on the card: the fused GRU forward at the state's
    init and every step, its backward every step, one graph; its costs
    within 1e-4 of the CPU's from the same Parameters; infer launches the
    forward once a chunk."""
    from paddle_tpu_torch.ops import rnn_kernels

    train = _samples(4 * BATCH, 0)
    costs, start = {}, None
    for dev in ("cpu", "cuda"):
        tgraph.reset_name_scope()
        out, cost = _gru_net(tpaddle)
        params = tpaddle.parameters.create(cost, device="cpu")
        if start is None:
            start = params.as_dict()
        params = tpaddle.parameters.Parameters.from_dict(start)
        tr = tpaddle.trainer.SGD(cost=cost, parameters=params, device=dev,
                                 update_equation=tpaddle.optimizer.Adam(learning_rate=1e-3))
        f0, b0 = rnn_kernels.FWD_LAUNCHES, rnn_kernels.BWD_LAUNCHES
        events = []
        tr.train(reader=tpaddle.batch(_reader(train), BATCH), num_passes=1,
                 event_handler=events.append, feeding={"word": 0, "label": 1})
        costs[dev] = [e.cost for e in events if isinstance(e, tpaddle.event.EndIteration)]
        launches = (rnn_kernels.FWD_LAUNCHES - f0, rnn_kernels.BWD_LAUNCHES - b0)
    assert launches == (1 + 4, 4)
    (graph,) = tr.trainer.graphs.values()
    assert graph.replays == 3
    np.testing.assert_allclose(costs["cuda"], costs["cpu"], rtol=1e-4)
    f0 = rnn_kernels.FWD_LAUNCHES
    inf = tpaddle.inference.Inference(out, tr.parameters, device="cuda")
    vals = inf.infer([(ids,) for ids, _ in train[:12]], feeding={"word": 0}, batch_size=8)
    assert vals.shape == (12, 2)
    assert rnn_kernels.FWD_LAUNCHES - f0 == 1 + 2  # the init's forward, 2 chunks
