"""The port's v1 config pipeline (`paddle_tpu_torch/config/`, `proto/`,
`v2/`, `compat/`) against the JAX package's, on the CPU.

  * Proto parity: every config of the set parses to the same
    `proto.to_text(trainer_config)` in both packages — tests/test_config.py's
    MLP, the bi-GRU text classifier, LeNet, one mixed_layer per projection
    kind, text_conv_pool, settings() with each optimizer, regularization,
    ModelAverage and gradient clipping, get_config_arg, and more of the
    DSL (LSTMs, sequence layers, image helpers, structured costs, layer
    arithmetic, the `with mixed_layer(...) as m` form).
  * The layers ROADMAP §1 items 6a-6b ported, through their v1 helpers:
    proto parity for an image config (the transposed conv, img_cmrnorm,
    maxout, bilinear_interp, spp, pad, crop, rotate, cross_channel_norm,
    prelu), a vector config (cos_sim both forms, trans, scaling,
    slope_intercept, interpolation, power, dot_prod, out_prod,
    conv_shift, tensor, linear_comb, multiplex, the norms, data_norm,
    clip, scale_shift, resize, repeat, selective_fc, sampling_id, eos,
    print_layer, row_conv), layer_math's scalar forms, concat_layer of
    projections, the transposed conv projection and operator, and
    chip_smoke.py's v1 AlexNet and new-helper configs.
  * Layer parity: each projection's mixed layer, and six configs whole
    (the bi-GRU, LeNet, text_conv_pool, sequence layers, the `with
    mixed_layer` form, chip_smoke.py's new-helper config), given the JAX parameters moved by name and the same batch,
    give the JAX package's outputs, costs and gradients (f32, rtol 1e-5).
  * The `paddle.*` imports of a config resolve to the port's modules and
    `sys.modules` is put back afterwards; layers no output reaches stay in
    the config (`record_layers`).
  * The helpers of ROADMAP §1 items 6c-6e (NCE, hsigmoid, the 3-D pool and
    conv, priorbox, lambda_cost, recurrent_layer, the packed v1 detection
    layers) parse and dump the JAX package's text.
jax is imported inside the tests only."""

import sys
import textwrap

import numpy as np
import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch import proto as tproto
from paddle_tpu_torch.config import parse_config as tparse
from paddle_tpu_torch.nn.convert import params_from_jax

BIGRU = """
from paddle.trainer_config_helpers import *
vocab = get_config_arg('vocab', int, 40)
size = get_config_arg('size', int, 8)
settings(batch_size=4, learning_rate=1e-3, learning_method=AdamOptimizer())
word = data_layer(name='word', size=vocab)
label = data_layer(name='label', size=2)
emb = embedding_layer(input=word, size=size)
bi = bidirectional_gru(input=emb, size=size)
out = fc_layer(input=bi, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=label))
"""

LENET = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.01, learning_method=MomentumOptimizer(0.9))
img = data_layer(name='pixel', size=784, height=28, width=28)
lbl = data_layer(name='label', size=10)
c1 = simple_img_conv_pool(input=img, filter_size=5, num_filters=4, num_channel=1,
                          pool_size=2, pool_stride=2, act=ReluActivation())
c2 = simple_img_conv_pool(input=c1, filter_size=5, num_filters=6, num_channel=4,
                          pool_size=2, pool_stride=2, act=ReluActivation())
out = fc_layer(input=c2, size=10, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=lbl))
"""

TEXT_CONV = """
from paddle.trainer_config_helpers import *
settings(batch_size=16, learning_rate=1e-3, learning_method=AdamOptimizer())
word = data_layer(name='word', size=50)
label = data_layer(name='label', size=2)
emb = embedding_layer(input=word, size=8)
conv = text_conv_pool(input=emb, context_len=3, hidden_size=12)
out = fc_layer(input=conv, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=label))
"""

CONFIG_ARGS = """
from paddle.trainer_config_helpers import *
hid = get_config_arg('hid', int, 32)
use_drop = get_config_arg('drop', bool, False)
act = get_config_arg('act', str, 'tanh')
x = data_layer(name='x', size=8)
h = fc_layer(input=x, size=hid,
             act=TanhActivation() if act == 'tanh' else ReluActivation(),
             layer_attr=ExtraAttr(drop_rate=0.5) if use_drop else None)
outputs(fc_layer(input=h, size=2))
"""

# more of the DSL: LSTMs, sequence layers, image helpers, structured
# costs, layer arithmetic, the `with mixed_layer(...) as m` form
LSTM_TEXT = """
from paddle.trainer_config_helpers import *
settings(batch_size=8, learning_rate=2e-3, learning_method=AdamOptimizer(),
         regularization=L2Regularization(8e-4), gradient_clipping_threshold=25)
word = data_layer(name='word', size=100)
label = data_layer(name='label', size=2)
emb = embedding_layer(input=word, size=16)
bi = bidirectional_lstm(input=emb, size=12)
drop = dropout_layer(input=bi, dropout_rate=0.5)
out = fc_layer(input=drop, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=label))
"""
SEQ_LAYERS = """
from paddle.trainer_config_helpers import *
word = data_layer(name='word', size=50)
emb = embedding_layer(input=word, size=8, param_attr=ParamAttr(name='emb_shared'))
emb2 = embedding_layer(input=word, size=8, param_attr=ParamAttr(name='emb_shared'))
lstm = simple_lstm(input=emb, size=6)
gru = simple_gru2(input=emb2, size=6, reverse=True)
avg = pooling_layer(input=lstm, pooling_type=AvgPooling())
mx = pooling_layer(input=gru, pooling_type=MaxPooling())
last = last_seq(input=lstm)
first = first_seq(input=gru)
cat = concat_layer(input=[avg, mx, last, first])
ex = expand_layer(input=cat, expand_as=emb)
sc = seq_concat_layer(a=emb, b=emb2)
add = addto_layer(input=[avg, mx], act=ReluActivation())
mid = maxid_layer(input=fc_layer(input=cat, size=5, act=SoftmaxActivation()))
outputs(sum_cost(input=pooling_layer(input=ex)), sum_cost(input=pooling_layer(input=sc)), sum_cost(input=add))
"""
IMAGE = """
from paddle.trainer_config_helpers import *
settings(batch_size=16, learning_rate=0.1, learning_method=MomentumOptimizer(0.9))
img = data_layer(name='image', size=3*16*16, height=16, width=16)
lbl = data_layer(name='label', size=10)
g = img_conv_group(input=img, num_channels=3, conv_num_filter=[8, 8], pool_size=2, pool_stride=2,
                   conv_padding=1, conv_filter_size=3, conv_act=ReluActivation(),
                   conv_with_batchnorm=True, conv_batchnorm_drop_rate=[0.3, 0.0], pool_type=MaxPooling())
c = img_conv_layer(input=g, filter_size=3, num_filters=4, padding=1, stride=2, act=LinearActivation(), bias_attr=False)
bn = batch_norm_layer(input=c, act=ReluActivation())
p = img_pool_layer(input=bn, pool_size=2, stride=1, pool_type=AvgPooling())
out = fc_layer(input=p, size=10, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=lbl))
"""
STRUCT_COSTS = """
from paddle.trainer_config_helpers import *
feat = data_layer(name='feat', size=12)
lbl = data_layer(name='lbl', size=5)
h = fc_layer(input=feat, size=6, act=LinearActivation())
pooled = pooling_layer(input=h)
outputs(ctc_layer(input=fc_layer(input=h, size=6, act=SoftmaxActivation()), label=lbl, size=6),
        crf_layer(input=h, label=data_layer(name='tags', size=6), size=6),
        square_error_cost(input=fc_layer(input=pooled, size=1), label=data_layer(name='y', size=1)))
"""
LAYER_MATH = """
from paddle.trainer_config_helpers import *
x = data_layer(name='x', size=4)
y = data_layer(name='y', size=4)
e = layer_math.exp(x)
s = layer_math.sigmoid(y)
outputs(e + s, layer_math.tanh(x), layer_math.square(y))
"""
MIXED_CTX_MGR = """
from paddle.trainer_config_helpers import *
x = data_layer(name='x', size=8)
y = data_layer(name='y', size=6)
with mixed_layer(size=5, act=SigmoidActivation(), bias_attr=ParamAttr(initial_std=0.0)) as m:
    m += full_matrix_projection(input=x)
    m += full_matrix_projection(input=y, param_attr=ParamAttr(name='wy', learning_rate=0.1))
outputs(m)
"""

# the layers of ROADMAP §1 items 6a-6b through the v1 helpers: images,
# vectors and ids, layer_math's scalar forms, concat_layer of projections
VOCAB_IMAGE = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.01, learning_method=MomentumOptimizer(0.9))
img = data_layer(name='image', size=3*12*12, height=12, width=12)
lbl = data_layer(name='label', size=10)
c = img_conv_layer(input=img, filter_size=3, num_filters=8, num_channels=3, padding=1)
n = img_cmrnorm_layer(input=c, size=5, scale=0.001, power=0.5)
m = maxout_layer(input=n, groups=2)
up = img_conv_layer(input=m, filter_size=3, num_filters=4, stride=2, padding=1, trans=True,
                    act=LinearActivation())
bi = bilinear_interp_layer(input=up, out_size_x=10, out_size_y=9)
sp = spp_layer(input=bi, pyramid_height=3, pool_type=AvgPooling())
pd = pad_layer(input=m, pad_c=[1, 1], pad_h=[1, 0], pad_w=[0, 2])
cr = crop_layer(input=pd, offset=[1, 1], shape=[10, 11])
rt = rotate_layer(input=cr)
cn = cross_channel_norm_layer(input=rt)
f = fc_layer(input=[sp, cn], size=12, act=LinearActivation())
pr = prelu_layer(input=f, partial_sum=3)
out = fc_layer(input=pr, size=10, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=lbl))
"""
VOCAB_VECTOR = """
from paddle.trainer_config_helpers import *
x = data_layer(name='x', size=8)
y = data_layer(name='y', size=8)
w = data_layer(name='w', size=1)
sel = data_layer(name='sel', size=6)
ids = data_layer(name='ids', size=1)
word = data_layer(name='word', size=20)
h = fc_layer(input=x, size=8, act=TanhActivation())
outputs(cos_sim(a=h, b=y, scale=5),
        cos_sim(a=fc_layer(input=x, size=4), b=fc_layer(input=y, size=12), size=3),
        trans_layer(input=h), scaling_layer(input=h, weight=w),
        slope_intercept_layer(input=h, slope=2.0, intercept=0.5),
        interpolation_layer(input=[h, y], weight=w),
        power_layer(input=fc_layer(input=x, size=8, act=SigmoidActivation()), weight=w),
        dot_prod_layer(h, y), out_prod_layer(h, y),
        conv_shift_layer(a=h, b=fc_layer(input=x, size=3)),
        tensor_layer(a=h, b=y, size=4),
        linear_comb_layer(weights=fc_layer(input=x, size=2),
                          vectors=fc_layer(input=y, size=8), size=4),
        multiplex_layer(input=[ids, h, y]),
        sum_to_one_norm_layer(input=fc_layer(input=x, size=5, act=SigmoidActivation())),
        row_l2_norm_layer(input=h), data_norm_layer(input=x),
        clip_layer(input=h, min=-0.5, max=0.5), scale_shift_layer(input=h),
        resize_layer(input=h, size=4), repeat_layer(input=h, num_repeats=2),
        sampling_id_layer(input=selective_fc_layer(input=h, select=sel, size=6,
                                                   act=SoftmaxActivation())),
        eos_layer(input=ids, eos_id=1), print_layer(input=h),
        row_conv_layer(input=embedding_layer(input=word, size=4), context_len=3))
"""
LAYER_MATH_SCALARS = """
from paddle.trainer_config_helpers import *
x = data_layer(name='x', size=4)
y = data_layer(name='y', size=4)
z = data_layer(name='z', size=1)
outputs(1 + layer_math.exp(x) * z, 2 - y, y * 3, x + z, x - y, z * layer_math.tanh(y) - 1)
"""
CONCAT_PROJECTIONS = """
from paddle.trainer_config_helpers import *
x = data_layer(name='x', size=8)
y = data_layer(name='y', size=6)
img = data_layer(name='img', size=64, height=8, width=8)
c = concat_layer(input=[full_matrix_projection(input=x, size=5), identity_projection(input=y),
                        conv_projection(input=img, filter_size=3, num_filters=2,
                                        num_channels=1, padding=1)],
                 act=TanhActivation(), bias_attr=True)
outputs(c)
"""

# projection kind -> (the projection, the mixed layer's size, the data
# layers it reads, whether its output is pooled: a sequence input)
PROJECTIONS = {
    "full_matrix": ("full_matrix_projection(input=x, size=8)", 8, "x", False),
    "trans_full_matrix": ("trans_full_matrix_projection(input=x, size=6)", 6, "x", False),
    "identity": ("identity_projection(input=x)", 8, "x", False),
    "identity_offset": ("identity_projection(input=x, offset=2, size=4)", 4, "x", False),
    "dotmul": ("dotmul_projection(input=x)", 8, "x", False),
    "scaling": ("scaling_projection(input=x)", 8, "x", False),
    "table": ("table_projection(input=ids, size=8)", 8, "ids", False),
    "context": ("context_projection(input=x, context_len=3)", 24, "x", True),
    "context_frozen": ("context_projection(input=x, context_len=4, context_start=-1, "
                       "padding_attr=False)", 32, "x", True),
    "slice": ("slice_projection(input=x, slices=[(0, 2), (4, 8)])", 6, "x", False),
    "dotmul_operator": ("dotmul_operator(a=x, b=y, scale=2.0)", 8, "x,y", False),
    "conv_projection": ("conv_projection(input=img, filter_size=3, num_filters=2, "
                        "num_channels=1, padding=1)", 128, "img", False),
    "conv_operator": ("conv_operator(img=img, filter=filt, filter_size=3, "
                      "num_filters=2, num_channels=1)", 72, "img,filt", False),
    "conv_projection_trans": ("conv_projection(input=img, filter_size=3, num_filters=2, "
                              "num_channels=1, stride=2, padding=1, trans=True)", 450,
                              "img", False),
    "conv_operator_trans": ("conv_operator(img=img, filter=filt, filter_size=3, "
                            "num_filters=2, num_channels=1, trans=True)", 200, "img,filt",
                            False),
}
_DATA = {
    "x": "x = data_layer(name='x', size=8)",
    "y": "y = data_layer(name='y', size=8)",
    "ids": "ids = data_layer(name='ids', size=16)",
    "img": "img = data_layer(name='img', size=64, height=8, width=8)",
    "filt": "filt = data_layer(name='filt', size=18)",
}


def mixed_config(kind: str) -> str:
    proj, size, inputs, pooled = PROJECTIONS[kind]
    lines = ["from paddle.trainer_config_helpers import *"]
    lines += [_DATA[n] for n in inputs.split(",")]
    lines.append(f"m = mixed_layer(size={size}, input=[{proj}], bias_attr=True, "
                 "act=TanhActivation())")
    lines.append("outputs(pooling_layer(input=m, pooling_type=SumPooling()))"
                 if pooled else "outputs(m)")
    return "\n".join(lines) + "\n"


OPTIMIZERS = {
    "momentum": "MomentumOptimizer(momentum=0.9)",
    "adam": "AdamOptimizer(beta1=0.8, beta2=0.99, epsilon=1e-6)",
    "adamax": "AdamaxOptimizer()",
    "adagrad": "AdaGradOptimizer()",
    "decayed_adagrad": "DecayedAdaGradOptimizer(rho=0.9)",
    "adadelta": "AdaDeltaOptimizer()",
    "rmsprop": "RmsPropOptimizer(rho=0.9, epsilon=1e-5)",
}


def settings_config(method: str) -> str:
    return textwrap.dedent(f"""
        from paddle.trainer_config_helpers import *
        settings(batch_size=32, learning_rate=0.05, learning_method={OPTIMIZERS[method]},
                 regularization=L2Regularization(1e-4), model_average=ModelAverage(0.5),
                 gradient_clipping_threshold=GradientClippingThreshold(5.0),
                 learning_rate_decay_a=0.1, learning_rate_decay_b=1000.0,
                 learning_rate_schedule='discexp')
        x = data_layer(name='x', size=8)
        outputs(fc_layer(input=x, size=4))
        """)


SETTINGS_L1 = """
from paddle.trainer_config_helpers import *
settings(batch_size=32, learning_rate=0.05, regularization=L1Regularization(1e-3))
x = data_layer(name='x', size=8)
outputs(fc_layer(input=x, size=4,
                 param_attr=ParamAttr(name='shared_w', initial_std=0.02, l2_rate=1e-3,
                                      learning_rate=0.5),
                 bias_attr=ParamAttr(initial_mean=0.1, initial_std=0.0)))
"""


def _mlp():
    from test_config import CONF_SRC

    return CONF_SRC


CASES = {
    "mlp": (_mlp, "hid=24"),
    "bigru": (lambda: BIGRU, ""),
    "bigru_args": (lambda: BIGRU, "vocab=30,size=6"),
    "lenet": (lambda: LENET, ""),
    "text_conv_pool": (lambda: TEXT_CONV, ""),
    "config_args_default": (lambda: CONFIG_ARGS, ""),
    "config_args_set": (lambda: CONFIG_ARGS, "hid=12,drop=1,act=relu"),
    "settings_l1_param_attrs": (lambda: SETTINGS_L1, ""),
    "lstm_text": (lambda: LSTM_TEXT, ""),
    "seq_layers": (lambda: SEQ_LAYERS, ""),
    "image_helpers": (lambda: IMAGE, ""),
    "struct_costs": (lambda: STRUCT_COSTS, ""),
    "layer_math": (lambda: LAYER_MATH, ""),
    "mixed_context_manager": (lambda: MIXED_CTX_MGR, ""),
    "vocab_image": (lambda: VOCAB_IMAGE, ""),
    "vocab_vector": (lambda: VOCAB_VECTOR, ""),
    "layer_math_scalars": (lambda: LAYER_MATH_SCALARS, ""),
    "concat_projections": (lambda: CONCAT_PROJECTIONS, ""),
    "v1_vocab": (lambda: cs.V1_VOCAB_CONFIG, cs.config_args(cs.V1_VOCAB_SMALL)),
    "v1_alexnet": (lambda: cs.V1_ALEXNET_CONFIG, cs.config_args(cs.V1_ALEXNET_SMALL)),
}
# providers the chip_smoke configs name, written beside them
_PROVIDERS = {"v1_vocab": ("v1_vocab_provider", "V1_VOCAB_PROVIDER"),
              "v1_alexnet": ("v1_alexnet_provider", "V1_ALEXNET_PROVIDER")}
CASES.update({f"mixed_{k}": ((lambda k=k: mixed_config(k)), "") for k in PROJECTIONS})
CASES.update({f"settings_{k}": ((lambda k=k: settings_config(k)), "") for k in OPTIMIZERS})


def write_config(tmp_path, src: str, name: str = "conf.py") -> str:
    path = tmp_path / name
    path.write_text(textwrap.dedent(src))
    return str(path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_proto_text_matches_jax(case, tmp_path, monkeypatch):
    """The same config script gives the same TrainerConfig text."""
    from paddle_tpu import proto as jproto
    from paddle_tpu.config import parse_config as jparse

    if case == "mlp":  # its provider sits beside the config
        from test_config import PROVIDER_SRC

        (tmp_path / "conf_provider.py").write_text(PROVIDER_SRC)
        monkeypatch.syspath_prepend(str(tmp_path))
    if case in _PROVIDERS:
        module, text = _PROVIDERS[case]
        (tmp_path / f"{module}.py").write_text(getattr(cs, text))
        (tmp_path / "train.list").write_text("train\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        monkeypatch.chdir(tmp_path)
    src, args = CASES[case]
    path = write_config(tmp_path, src())
    port = tproto.to_text(tparse(path, args).trainer_config)
    ref = jproto.to_text(jparse(path, args).trainer_config)
    assert port == ref


# -- numbers: the same parameters and batch give the same outputs ------------


def _random_batch(topology, rs, b=4, t=7):
    """Random values for every data layer of a parsed config: ids in their
    declared range, floats elsewhere, sequences of lengths up to t."""
    batch = {}
    for name, layer in topology.data_layers().items():
        spec = getattr(layer, "data_type", None)
        shape = tuple(layer.shape)
        is_seq = getattr(layer, "is_seq", False)
        ids = spec is not None and spec.kind.startswith("index")
        lead = (b, t) if is_seq else (b,)
        if ids:
            batch[name] = rs.randint(0, max(int(spec.dim), 2), size=lead).astype(np.int32)
        else:
            batch[name] = rs.randn(*(lead + shape)).astype(np.float32)
        if is_seq:
            batch[name + ".lengths"] = rs.randint(2, t + 1, size=b).astype(np.int32)
    return batch


def _outputs_and_grads(src, args, tmp_path, rs_seed=0):
    """(port outs, port grads, jax outs, jax grads, cost names) of a config:
    JAX parameters moved by name, one batch, the summed outputs' squares
    (or the cost) differentiated."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.config import parse_config as jparse

    path = write_config(tmp_path, src)
    jpc = jparse(path, args, emit_proto=False)
    tpc = tparse(path, args, emit_proto=False)
    jnet, tnet = jpc.topology.network, tpc.topology.network
    batch = _random_batch(tpc.topology, np.random.RandomState(rs_seed))
    params, states = jnet.init(jax.random.PRNGKey(0), batch)
    names = [l.name for l in jnet.outputs]

    def jloss(p):
        outs, _ = jnet.apply(p, states, batch, train=True)
        return sum(jnp.sum(outs[n].value.astype(jnp.float32) ** 2) for n in names), outs

    (_, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tparams = {k: v.requires_grad_(True)
               for k, v in params_from_jax(params, device="cpu").items()}
    touts = tnet.apply(tparams, batch, train=True)
    tloss = sum((touts[n].value.float() ** 2).sum() for n in names)
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss, list(tparams.values()))))
    return touts, tgrads, jouts, jgrads, names


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("kind", sorted(PROJECTIONS))
def test_mixed_projection_matches_jax(kind, tmp_path):
    """Each projection's mixed layer (tanh over the sum plus a bias): the
    same output and parameter gradients as the JAX package's."""
    touts, tgrads, jouts, jgrads, names = _outputs_and_grads(
        mixed_config(kind), "", tmp_path)
    for n in names:
        _close(touts[n].value.detach(), jouts[n].value)
    assert set(tgrads) == set(jgrads)
    for k in jgrads:
        _close(tgrads[k], jgrads[k])


@pytest.mark.parametrize("case", ["bigru", "lenet", "text_conv_pool", "seq_layers",
                                  "mixed_context_manager", "v1_vocab"])
def test_config_outputs_and_grads_match_jax(case, tmp_path, monkeypatch):
    """A whole config's outputs (its costs) and every gradient, f32, rtol
    1e-5 (the JAX GRU on its lax.scan oracle)."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")
    if case in _PROVIDERS:
        module, text = _PROVIDERS[case]
        (tmp_path / f"{module}.py").write_text(getattr(cs, text))
        monkeypatch.syspath_prepend(str(tmp_path))
        monkeypatch.chdir(tmp_path)
    src = {"bigru": BIGRU, "lenet": LENET, "text_conv_pool": TEXT_CONV,
           "seq_layers": SEQ_LAYERS, "mixed_context_manager": MIXED_CTX_MGR,
           "v1_vocab": cs.V1_VOCAB_CONFIG}[case]
    args = cs.config_args(cs.V1_VOCAB_SMALL) if case == "v1_vocab" else ""
    touts, tgrads, jouts, jgrads, names = _outputs_and_grads(src, args, tmp_path)
    for n in names:
        _close(touts[n].value.detach(), jouts[n].value)
    assert set(tgrads) == set(jgrads)
    for k in jgrads:
        _close(tgrads[k], jgrads[k])


# -- the compat mapping, record_layers and named errors -----------------------


def test_config_imports_resolve_to_the_port_and_modules_are_restored(tmp_path):
    sentinel = type(sys)("paddle")
    before = {k: v for k, v in sys.modules.items()
              if k == "paddle" or k.startswith("paddle.")}
    probe = write_config(tmp_path, """
        import paddle.trainer_config_helpers as h
        import paddle.trainer.config_parser as cp
        from paddle.trainer.PyDataProvider2 import integer_value
        assert h.__name__ == 'paddle_tpu_torch.compat.trainer_config_helpers'
        assert cp.parse_config.__module__ == 'paddle_tpu_torch.config.config_parser'
        assert integer_value.__module__ == 'paddle_tpu_torch.data.feeder'
        from paddle.trainer_config_helpers import *
        outputs(fc_layer(input=data_layer(name='x', size=4), size=2))
        """)
    try:
        sys.modules["paddle"] = sentinel
        tparse(probe)
        assert sys.modules["paddle"] is sentinel
        assert not any(k.startswith("paddle.") for k in sys.modules
                       if k not in before)
    finally:
        for k in [k for k in sys.modules if k == "paddle" or k.startswith("paddle.")]:
            del sys.modules[k]
        sys.modules.update(before)


def test_record_layers_keeps_layers_no_output_reaches(tmp_path):
    """The port's `nn/graph.record_layers`: a layer the script made but no
    output reaches stays in the config (its `extra_layers`), as in the JAX
    package."""
    from paddle_tpu import proto as jproto
    from paddle_tpu.config import parse_config as jparse
    from paddle_tpu_torch.nn import graph as tgraph
    from paddle_tpu_torch.nn import layers as TL

    sink = []
    with tgraph.record_layers(sink):
        d = TL.Data("a", shape=(3,))
        with tgraph.record_layers([]) as inner:
            TL.Fc(d, 2, name="probe")
    assert [l.name for l in sink] == ["a"] and [l.name for l in inner] == ["probe"]
    path = write_config(tmp_path, """
        from paddle.trainer_config_helpers import *
        x = data_layer(name='x', size=4)
        unused = fc_layer(input=x, size=3, name='unused')
        outputs(fc_layer(input=x, size=2, name='out'))
        """)
    port = tparse(path)
    assert "unused" in {l.name for l in port.model_config.layers}
    assert tproto.to_text(port.trainer_config) == jproto.to_text(
        jparse(path).trainer_config)


_VOL = "v = data_layer(name='v', size=2 * 4 * 4 * 4)"
_IMG = ("img = data_layer(name='img', size=3 * 8 * 8, height=8, width=8)\n"
        "c = img_conv_layer(input=img, filter_size=3, num_filters=4, padding=1, "
        "num_channels=3)")
_SEQ = "q = data_layer(name='q', size=5)\nrel = data_layer(name='rel', size=1)"
_PACKED = ("loc = data_layer(name='loc', size=16)\nconf = data_layer(name='conf', size=84)\n"
           "prior = data_layer(name='prior', size=32)\nlbl6 = data_layer(name='lbl6', size=12)")


@pytest.mark.parametrize("src", [
    "outputs(nce_layer(input=fc_layer(input=x, size=6), label=lbl, num_classes=4))",
    "outputs(hsigmoid(input=fc_layer(input=x, size=6), label=lbl, num_classes=4))",
    f"{_VOL}\noutputs(img_pool3d_layer(input=v, pool_size=2, num_channels=2))",
    f"{_VOL}\noutputs(img_conv3d_layer(input=v, filter_size=3, num_filters=4, "
    "num_channels=2, padding=1))",
    f"{_IMG}\noutputs(priorbox_layer(input=c, image_size=8, min_size=[2], max_size=[4]))",
    f"{_SEQ}\noutputs(lambda_cost(input=fc_layer(input=q, size=1), score=rel))",
    f"{_SEQ}\noutputs(recurrent_layer(input=fc_layer(input=q, size=6), reverse=True))",
    f"{_PACKED}\noutputs(multibox_loss_layer(input_loc=loc, input_conf=conf, priorbox=prior, "
    "label=lbl6, num_classes=21), detection_output_layer(input_loc=loc, input_conf=conf, "
    "priorbox=prior, num_classes=21, keep_top_k=5))",
])
def test_unported_helpers_raise_named_errors(src, tmp_path):
    """The helpers that raised a named error until ROADMAP §1 item 6 was
    ported (NCE, hsigmoid, the 3-D pool and conv, priorbox, lambda_cost)
    and the other helpers of items 6c-6e: each config parses in the port
    and dumps the JAX package's text."""
    from paddle_tpu import proto as jproto
    from paddle_tpu.config import parse_config as jparse

    path = write_config(tmp_path, "from paddle.trainer_config_helpers import *\n"
                        "x = data_layer(name='x', size=8)\n"
                        "lbl = data_layer(name='lbl', size=4)\n" + src + "\n")
    assert tproto.to_text(tparse(path).trainer_config) == \
        jproto.to_text(jparse(path).trainer_config)


def test_dump_config_function_and_build_model_config_agree():
    from paddle_tpu_torch.config import build_model_config, dump_config
    from paddle_tpu_torch.nn import graph as tgraph
    from paddle_tpu_torch.v2 import data_type, layer

    tgraph.reset_name_scope()
    x = layer.data("x", data_type.dense_vector(6))
    out = layer.fc(x, 3, act="softmax")
    mc = build_model_config(out)
    assert [l.name for l in mc.layers] == ["x", out.name]
    assert {p.name: p.dims for p in mc.parameters} == {
        f"{out.name}.w": [6, 3], f"{out.name}.b": [3]}
    assert dump_config(out) == tproto.to_text(mc)


# -- faults found on this path (ROADMAP.md §3) ---------------------------------


def test_model_average_keeps_max_average_window():
    """settings(model_average=ModelAverage(w, max_average_window=N)): the
    JAX package's `v2/optimizer._V2Optimizer` builds ModelAverage(w) and
    drops N (the average runs uncapped); the port keeps the cap."""
    from paddle_tpu.config import config_parser as jcp
    from paddle_tpu.config import optimizers as jopt
    from paddle_tpu_torch.config import config_parser as tcp
    from paddle_tpu_torch.config import optimizers as topt

    got = {}
    for name, cp, opt in (("jax", jcp, jopt), ("port", tcp, topt)):
        with cp.fresh_context():
            oc = opt.settings(batch_size=4, model_average=opt.ModelAverage(0.5, 100))
            got[name] = opt.build_optimizer(oc).model_average
    assert got["port"].max_average_window == 100
    assert got["jax"].max_average_window == 2 ** 31 - 1  # the reference fault
    assert got["port"].average_window == got["jax"].average_window == 0.5


def test_grumemory_config_keeps_the_references_fields(tmp_path):
    """The JAX package's dump registers its GRU emitter under the wire name
    `gated_recurrent`, which no layer's type_name is, so a grumemory's
    LayerConfig has no `reversed` / `active_gate_type`: they ride in
    `attrs` (reverse, gate_act). The port prints the same, for text
    parity."""
    path = write_config(tmp_path, BIGRU)
    mc = tparse(path).model_config
    bw = next(l for l in mc.layers if l.type == "gated_recurrent" and l.name.endswith("_bw"))
    assert bw.reversed is None and bw.attrs["reverse"] is True
    assert bw.attrs["gate_act"] == "sigmoid"
