"""The v1 layer vocabulary in the port (`paddle_tpu_torch/nn/layers.py`,
ROADMAP §1 items 6a-6b) against the JAX package's `nn/layers.py`, on the
CPU.

The cases are chip_smoke.py's `VOCAB_CASES`: the 36 layers the port lacked
(`VOCAB_LAYERS`, CrossMapNorm among them) at small shapes, plus further
shapes and options of some (the transposed conv at stride 1 and 2 and
padding 0 and 1, bilinear resizing down as well as up, SPP's average,
DataNorm's three strategies, Trans of the whole batch, SelectiveFc without
a selection). Each case builds the layer in both packages from the same
constructor; the JAX package's init makes the parameters (and DataNorm's
states, then set to random statistics), which move to the port by name;
both get the same numpy input from a seed and the same cotangent. The
output, the input gradients and the parameter gradients agree in f32
within 1e-5 relative L2 norm; ids and 0/1 flags exactly (SamplingId's
gumbel noise is jax's threefry stream for the same key). The JAX side runs
its products at `highest` matmul precision: its einsums (TensorLayer,
ConvShift, ...) pass no precision of their own, and the f32 oracle is the
full-precision product. The transposed conv and CrossMapNorm also run
under the bf16 policy, within 1e-2 relative L2 (bf16's 8 bits, summed in a
different order).

Also: the port's own init makes the JAX package's parameter and state
names and shapes; PrintLayer prints the JAX package's `jax.debug.print`
line; a PrintLayer in a graph capture with no sink raises; the DSL builds
each layer through `v2.layer` and the v1 helpers. On a card (marked
`cuda`, skipped here): every case card against CPU, and a PrintLayer
inside the step graph printing once a replay. jax is imported inside the
CPU tests only."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn import projections as TP
from paddle_tpu_torch.nn.convert import params_from_jax

F32_REL_L2 = 1e-5
BF16_REL_L2 = 1e-2
# outputs compared for equality: integer ids and the 0/1 flags of ids
EXACT = ("sampling_id", "eos_id")


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_run(name, inputs, ct, policy_name):
    """The JAX package's layer: init-mode parameters and states (states then
    random), the train-mode forward and, for a float output, the VJP of
    the float inputs and parameters at `ct` -> dict."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.core import dtypes as jdtypes
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import projections as JP
    from paddle_tpu.nn.graph import Argument, Context, reset_name_scope

    reset_name_scope()
    layer = cs.vocab_build(name, JL, JP, JL.Data)
    policy = jdtypes.get(policy_name)
    key = jax.random.PRNGKey(cs.VOCAB_RNG_SEED)

    def to_args(values):
        it = iter(values)
        return [Argument(next(it) if v.dtype != np.int32 else jnp.asarray(v),
                         None if n is None else jnp.asarray(n)) for v, n in inputs]

    floats = [jnp.asarray(v).astype(policy.compute_dtype)
              for v, _ in inputs if v.dtype != np.int32]
    init = Context("init", {}, {}, key, True, policy=policy)
    layer.forward(init, to_args(floats))
    params = {k: np.asarray(v, np.float32) for k, v in init.params.items()}
    states = cs.vocab_states(np, init.states)

    def f(xs, ps):
        ctx = Context("apply", ps, {k: jnp.asarray(v) for k, v in states.items()}, key,
                      True, policy=policy)
        return layer.forward(ctx, to_args(xs)).value

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    with jax.default_matmul_precision("highest"):
        out = jax.jit(f)(floats, jparams)
        res = dict(out=np.asarray(out.astype(jnp.float32) if out.dtype == jnp.bfloat16
                                  else out),
                   params=params, states=states, dx=[], dp={})
        if ct is not None and jnp.issubdtype(out.dtype, jnp.floating) and name not in EXACT:
            dxs, dps = jax.jit(lambda xs, ps, c: jax.vjp(f, xs, ps)[1](c))(
                floats, jparams, jnp.asarray(ct).astype(out.dtype))
            res["dx"] = [np.asarray(g, np.float32) for g in dxs]
            res["dp"] = {k: np.asarray(g, np.float32) for k, g in dps.items()}
    return res


def _compare(name, policy, tol):
    inputs = cs.vocab_inputs(np, name)
    tgraph.reset_name_scope()
    shape = cs.vocab_port_run(torch, name, "cpu", inputs)["out"].shape
    ct = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = _jax_run(name, inputs, ct, policy)
    tgraph.reset_name_scope()
    got = cs.vocab_port_run(torch, name, "cpu", inputs, ct,
                            params_from_jax(want["params"], device="cpu"),
                            params_from_jax(want["states"], device="cpu"), policy=policy)
    out = got["out"]
    if name in EXACT:
        np.testing.assert_array_equal(out.numpy(), want["out"])
        return {}
    errs = {"out": rel_l2(out.float().numpy(), want["out"])}
    assert out.shape == want["out"].shape
    assert len(got["dx"]) == len(want["dx"])
    for j, (g, w) in enumerate(zip(got["dx"], want["dx"])):
        errs[f"dx{j}"] = rel_l2(g.float().numpy(), w)
    assert set(got["dp"]) == set(want["dp"])
    for k, w in want["dp"].items():
        errs[k] = rel_l2(got["dp"][k].float().numpy(), w)
    assert max(errs.values()) <= tol, errs
    return errs


@pytest.mark.parametrize("name", list(cs.VOCAB_CASES))
def test_layer_matches_jax(name):
    _compare(name, "f32", F32_REL_L2)


@pytest.mark.parametrize("name", ["conv_transpose", "conv_transpose_s1p0", "lrn"])
def test_layer_matches_jax_bf16(name):
    _compare(name, "bf16", BF16_REL_L2)


def test_vocabulary_covers_the_36_layers():
    assert len(cs.VOCAB_LAYERS) == 36 == len(set(cs.VOCAB_LAYERS))
    assert set(cs.VOCAB_LAYERS) <= set(cs.VOCAB_CASES)
    kinds = {type(cs.vocab_build(n, TL, TP, TL.Data)).__name__ for n in cs.VOCAB_LAYERS}
    assert len(kinds) == 36
    for kind in kinds:
        assert getattr(TL, kind).__module__ == "paddle_tpu_torch.nn.layers"


@pytest.mark.parametrize("name", ["conv_transpose", "lrn", "data_norm", "tensor",
                                  "concat2", "prelu", "selective_fc", "row_conv"])
def test_port_init_makes_the_jax_names_and_shapes(name):
    inputs = cs.vocab_inputs(np, name)
    want = _jax_run(name, inputs, None, "f32")
    tgraph.reset_name_scope()
    got = cs.vocab_port_run(torch, name, "cpu", inputs)
    assert {k: tuple(v.shape) for k, v in got["params"].items()} == {
        k: v.shape for k, v in want["params"].items()}
    assert {k: tuple(v.shape) for k, v in got["states"].items()} == {
        k: v.shape for k, v in want["states"].items()}


def test_sampling_id_draws_jax_categorical():
    """SamplingId's ids are `jax.random.categorical(key, log p)` for the
    layer's key, over many rows (a wrong noise stream would part from it
    in most of them)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.core import prng

    rs = np.random.RandomState(4)
    p = np.exp(rs.randn(64, 11))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 3)
    want = np.asarray(jax.random.categorical(key, jnp.log(jnp.maximum(p, 1e-30)), axis=-1))

    class Ctx:
        mode = "apply"

        def next_rng(self, tag):
            return prng.fold_in(prng.PRNGKey(9), 3)

    layer = TL.SamplingId(TL.Data("p", shape=(11,)), name="s")
    got = layer.forward(Ctx(), [tgraph.Argument(torch.tensor(p))]).value
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_print_layer_prints_the_jax_line(capfd):
    """The port's line for a value is `jax.debug.print`'s for it under jit;
    init mode prints nothing."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import Argument, Context

    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 4
    jl = JL.PrintLayer(JL.Data("x", shape=(3,)), message="h1", name="p")
    jax.jit(lambda v: jl.forward(Context("apply", {}, {}, None, False),
                                 [Argument(v)]).value)(jnp.asarray(x)).block_until_ready()
    jax.effects_barrier()
    want = capfd.readouterr().out
    tl = TL.PrintLayer(TL.Data("x", shape=(3,)), message="h1", name="p")
    out = tl.forward(tgraph.Context("apply", {}), [tgraph.Argument(torch.tensor(x))])
    got = capfd.readouterr().out
    assert got == want and got.startswith("h1 [[")
    assert torch.equal(out.value, torch.tensor(x))
    tl.forward(tgraph.Context("init", {}), [tgraph.Argument(torch.tensor(x))])
    assert capfd.readouterr().out == ""


def test_print_layer_keeps_braces_in_its_message(capsys):
    """A message with braces prints them literally. The JAX package's
    PrintLayer escapes them too, but `jax.debug.print` then finds no
    placeholder first and its callback fails (ROADMAP §3 fault 15)."""
    tl = TL.PrintLayer(TL.Data("x", shape=(2,)), message="h {a}", name="p")
    tl.forward(tgraph.Context("apply", {}), [tgraph.Argument(torch.tensor([1.0, 2.0]))])
    assert capsys.readouterr().out == "h {a} [1. 2.]\n"


def test_captured_prints_print_after_the_replay(capsys):
    """The capture path on the CPU's terms: values appended under
    `captured_prints` print through `emit_prints`, once each, in order."""
    with TL.captured_prints() as sink:
        sink.append(("a {x}", torch.tensor([1.0, 2.0])))
        sink.append(("b {x}", torch.tensor([3], dtype=torch.int32)))
    TL.emit_prints(sink)
    assert capsys.readouterr().out == "a [1. 2.]\nb [3]\n"


def test_dsl_builds_every_layer():
    """The v2 constructors and the v1 helpers build each ported layer, as
    the JAX package's do: same layer class, no named error."""
    import paddle_tpu_torch.v2 as tpaddle
    from paddle_tpu_torch.config import helpers as H

    tgraph.reset_name_scope()
    layer = tpaddle.layer
    dt = tpaddle.data_type
    img = layer.data("img", dt.dense_array((6, 6, 4)))
    x = layer.data("x", dt.dense_vector(6))
    y = layer.data("y", dt.dense_vector(6))
    w = layer.data("w", dt.dense_vector(1))
    ids = layer.data("ids", dt.integer_value(3))
    seq = layer.data("seq", dt.dense_vector_sequence(4))
    built = {
        "img_conv(trans)": layer.img_conv(img, 3, 2, trans=True),
        "cos_sim": layer.cos_sim(x, y, scale=5), "cos_vm": layer.cos_sim(x, y, size=3),
        "trans": layer.trans(x), "scaling": layer.scaling(x, w),
        "slope_intercept": layer.slope_intercept(x, 2.0, 1.0),
        "interpolation": layer.interpolation([x, y], w), "power": layer.power(x, w),
        "dot_prod": layer.dot_prod(x, y), "out_prod": layer.out_prod(x, y),
        "conv_shift": layer.conv_shift(x, w), "tensor": layer.tensor(x, y, 3),
        "multiplex": layer.multiplex([ids, x, y]), "sampling_id": layer.sampling_id(x),
        "eos": layer.eos(ids, 1), "print_layer": layer.print_layer(x),
        "clip": layer.clip(x, -1, 1), "scale_shift": layer.scale_shift(x),
        "prelu": layer.prelu(x), "maxout": layer.maxout(img, 2), "spp": layer.spp(img),
        "img_cmrnorm": layer.img_cmrnorm(img, 5), "sum_to_one_norm": layer.sum_to_one_norm(x),
        "row_l2_norm": layer.row_l2_norm(x), "cross_channel_norm": layer.cross_channel_norm(img),
        "data_norm": layer.data_norm(x), "bilinear_interp": layer.bilinear_interp(img, 8, 8),
        "pad": layer.pad(img, pad_c=[1, 1]), "crop": layer.crop(img, 1, 3),
        "rotate": layer.rotate(img), "featmap_expand": layer.featmap_expand(x, 2),
        "repeat": layer.repeat(x, 2), "resize": layer.resize(x, 3),
        "row_conv": layer.row_conv(seq, 2), "selective_fc": layer.selective_fc(x, 4),
        "linear_comb": layer.linear_comb(w, x), "convex_comb": layer.convex_comb(w, x),
    }
    want = {"img_conv(trans)": "Conv2DTranspose", "cos_sim": "CosSim", "cos_vm": "CosSimVecMat",
            "trans": "Trans", "scaling": "Scaling", "slope_intercept": "SlopeIntercept",
            "interpolation": "Interpolation", "power": "Power", "dot_prod": "DotProd",
            "out_prod": "OuterProd", "conv_shift": "ConvShift", "tensor": "TensorLayer",
            "multiplex": "Multiplex", "sampling_id": "SamplingId", "eos": "EosIdCheck",
            "print_layer": "PrintLayer", "clip": "Clip", "scale_shift": "ScaleShift",
            "prelu": "ParameterRelu", "maxout": "Maxout", "spp": "SpatialPyramidPool",
            "img_cmrnorm": "CrossMapNorm", "sum_to_one_norm": "SumToOneNorm",
            "row_l2_norm": "RowL2Norm", "cross_channel_norm": "CrossChannelNorm",
            "data_norm": "DataNorm", "bilinear_interp": "BilinearInterp", "pad": "Pad",
            "crop": "Crop", "rotate": "Rotate", "featmap_expand": "FeatureMapExpand",
            "repeat": "FeatureMapExpand", "resize": "Resize", "row_conv": "RowConv",
            "selective_fc": "SelectiveFc", "linear_comb": "LinearComb",
            "convex_comb": "LinearComb"}
    assert {k: type(v).__name__ for k, v in built.items()} == want
    tgraph.reset_name_scope()
    v1 = H.data_layer(name="v1img", size=4 * 6 * 6, height=6, width=6)
    assert type(H.img_cmrnorm_layer(v1, 5)).__name__ == "CrossMapNorm"
    assert type(H.maxout_layer(v1, 2)).__name__ == "Maxout"
    assert type(H.spp_layer(v1, pyramid_height=2)).__name__ == "SpatialPyramidPool"
    assert type(H.bilinear_interp_layer(v1, 8, 8)).__name__ == "BilinearInterp"
    assert type(H.img_conv_layer(v1, 3, 2, trans=True)).__name__ == "Conv2DTranspose"
    proj = H.concat_layer([H.full_matrix_projection(x, size=3), H.identity_projection(y)])
    assert type(proj).__name__ == "Concat2"


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(cs.VOCAB_CASES))
def test_cuda_layer_matches_cpu(cuda, name):
    """The case on the card against the port's CPU result, f32 with TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        inputs = cs.vocab_inputs(np, name)
        cpu0 = cs.vocab_port_run(torch, name, "cpu", inputs)
        states = {k: torch.as_tensor(v) for k, v in cs.vocab_states(np, cpu0["states"]).items()}
        params = {k: v.detach() for k, v in cpu0["params"].items()}
        ct = np.random.RandomState(2).randn(*cpu0["out"].shape).astype(np.float32)
        cpu = cs.vocab_port_run(torch, name, "cpu", inputs, ct, params, states)
        card = cs.vocab_port_run(torch, name, "cuda", inputs, ct, params, states)
        if name in EXACT:
            assert torch.equal(card["out"].cpu(), cpu["out"])
            return
        assert rel_l2(card["out"].float().cpu(), cpu["out"].float()) <= F32_REL_L2
        for g, w in zip(card["dx"], cpu["dx"]):
            assert rel_l2(g.cpu(), w) <= F32_REL_L2
        for k, w in cpu["dp"].items():
            assert rel_l2(card["dp"][k].cpu(), w) <= F32_REL_L2, k
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
def test_cuda_print_layer_prints_once_a_replay(cuda, capfd):
    """A PrintLayer inside the training step's graph: the first step prints
    eagerly, every replay prints the step's value once, after it ran."""
    from paddle_tpu_torch.nn import costs as TC
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    tgraph.reset_name_scope()
    x = TL.Data("x", shape=(4,))
    label = TL.Data("label", shape=(1,))
    h = TL.PrintLayer(TL.Fc(x, 1, act=None, name="fc"), message="fc", name="p")
    tr = SGDTrainer(TC.SquareError(h, label, name="cost"), SGD(learning_rate=0.1), seed=0,
                    device="cuda")
    batch = {"x": np.ones((2, 4), np.float32), "label": np.zeros((2, 1), np.float32)}
    tr.init_state(batch)
    capfd.readouterr()
    for _ in range(4):
        tr.step(batch)
    lines = [l for l in capfd.readouterr().out.splitlines() if l.startswith("fc ")]
    assert len(lines) == 4 and len(set(lines)) == 4  # each step's own value
    assert sum(g.replays for g in tr.graphs.values()) == 3
