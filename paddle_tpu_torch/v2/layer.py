"""paddle.v2.layer analog (counterpart of `paddle_tpu/v2/layer.py`) —
functional layer constructors.

Mirrors python/paddle/v2/layer.py + trainer_config_helpers/layers.py names
(fc_layer -> fc, img_conv_layer -> img_conv, ...), returning the port's
graph nodes directly, built exactly as the JAX package builds them, so a
config yields the same names, parameters and proto text in both packages.

    images = paddle.layer.data(name='pixel', type=paddle.data_type.dense_vector(784))
    h = paddle.layer.fc(input=images, size=200, act=paddle.activation.Tanh())
    cost = paddle.layer.classification_cost(input=out, label=lbl)

Every constructor of the JAX package's module builds here: the layers of
`nn/layers.py`, the 3-D convs, `recurrent`, `mdlstm`, the structured costs
and the detection layers.
"""

from __future__ import annotations

from typing import Sequence

from paddle_tpu_torch.data.feeder import InputSpec
from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import detection_layers as D
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn import layers3d as L3
from paddle_tpu_torch.nn import projections as P
from paddle_tpu_torch.nn import recurrent as R
from paddle_tpu_torch.nn import seq_layers as S
from paddle_tpu_torch.nn import struct_costs as SC
from paddle_tpu_torch.nn.graph import Layer
from paddle_tpu_torch.v2.activation import resolve as _act
from paddle_tpu_torch.v2.pooling import resolve as _pool

__all__ = [
    "data", "fc", "embedding", "img_conv", "img_pool", "batch_norm", "dropout",
    "addto", "concat", "seq_concat", "lstmemory", "grumemory", "recurrent",
    "pool", "last_seq", "first_seq", "expand", "max_id", "eos",
    "cross_entropy_cost", "classification_cost", "square_error_cost",
    "cos_sim", "trans", "scaling", "slope_intercept", "interpolation",
    "power", "dot_prod", "mixed", "full_matrix_projection",
    "identity_projection", "dotmul_projection", "table_projection",
    "context_projection", "scaling_projection", "trans_full_matrix_projection",
    "dotmul_operator", "crf", "crf_decoding", "ctc", "warp_ctc", "nce",
    "hsigmoid", "rank_cost", "lambda_cost", "sum_cost", "huber_regression_cost",
    "huber_classification_cost", "smooth_l1_cost", "multi_binary_label_cross_entropy_cost",
    "cross_entropy_with_selfnorm_cost", "soft_binary_class_cross_entropy",
    "maxout", "spp", "img_cmrnorm", "sum_to_one_norm", "row_l2_norm",
    "cross_channel_norm", "data_norm", "bilinear_interp", "pad", "crop",
    "rotate", "switch_order", "featmap_expand", "clip", "scale_shift", "prelu",
    "multiplex", "out_prod", "conv_shift", "tensor", "sampling_id",
    "seq_reshape", "seq_slice", "kmax_seq_score", "sub_seq", "print_layer",
    "priorbox", "multibox_loss", "detection_output", "bidirectional_lstm",
    "bidirectional_gru", "simple_lstm", "simple_gru", "repeat", "resize",
    "block_expand", "row_conv", "selective_fc", "gated_unit",
    "img_conv3d", "img_pool3d", "linear_comb", "convex_comb", "mdlstm",
    "sub_nested_seq", "cross_entropy_over_beam", "BeamInput",
]


# -- data ------------------------------------------------------------------


def data(name: str, type: InputSpec, height: int = 0, width: int = 0) -> Layer:
    """data_layer. Shape derives from the InputSpec; the spec is attached to
    the node so Topology can build the DataFeeder automatically."""
    spec = type
    if spec.kind == "dense":
        if height and width:
            shape: Sequence[int] = (height, width, int(spec.dim) // (height * width))
        elif isinstance(spec.dim, tuple):
            shape = spec.dim
        else:
            shape = (int(spec.dim),)
        is_seq = False
    elif spec.kind == "index":
        shape, is_seq = (), False
    elif spec.kind == "dense_seq":
        shape = spec.dim if isinstance(spec.dim, tuple) else (int(spec.dim),)
        is_seq = True
    elif spec.kind == "index_seq":
        shape, is_seq = (), True
    elif spec.kind == "dense_subseq":
        shape = spec.dim if isinstance(spec.dim, tuple) else (int(spec.dim),)
        is_seq = True
    elif spec.kind == "index_subseq":
        shape, is_seq = (), True
    elif spec.kind in ("sparse_binary", "sparse_value"):
        shape, is_seq = (int(spec.dim),), False
    elif spec.kind == "sparse_binary_seq":
        shape, is_seq = (int(spec.dim),), True
    else:
        raise ValueError(f"unknown input kind {spec.kind}")
    node = L.Data(name, shape=shape, is_seq=is_seq)
    node.data_type = spec
    return node


# -- core ------------------------------------------------------------------


def fc(input, size, act=None, name=None, param_attr=None, bias_attr=None, layer_attr=None):
    bias = bias_attr is not False
    return _with_drop(
        L.Fc(input, size, act=_act(act) or "tanh", bias=bias,
             param_attr=param_attr, bias_attr=_or_none(bias_attr), name=name),
        layer_attr,
    )


def embedding(input, size, param_attr=None, name=None, layer_attr=None):
    # id range comes from the data layer's declared type (integer_value*(range))
    spec = getattr(input, "data_type", None)
    vocab = int(spec.dim) if spec is not None and spec.kind in ("index", "index_seq") else None
    return _with_drop(
        L.Embedding(input, size, vocab_size=vocab, param_attr=param_attr, name=name),
        layer_attr,
    )


def img_conv(
    input, filter_size, num_filters, num_channels=None, stride=1, padding=0,
    dilation=1, groups=1, act=None, bias_attr=None, param_attr=None, name=None,
    trans=False, layer_attr=None, **_compat,
):
    cls = L.Conv2DTranspose if trans else L.Conv2D
    kwargs = dict(
        num_filters=num_filters, filter_size=filter_size, stride=stride,
        padding=padding, act=_act(act), bias=bias_attr is not False,
        param_attr=param_attr, bias_attr=_or_none(bias_attr), name=name,
    )
    if not trans:
        kwargs.update(dilation=dilation, groups=groups)
    return _with_drop(cls(input, **kwargs), layer_attr)


def img_pool(
    input, pool_size, pool_type=None, stride=None, padding=0, name=None,
    layer_attr=None, **_compat,
):
    return _with_drop(
        L.Pool2D(input, pool_size, _pool(pool_type), stride=stride, padding=padding, name=name),
        layer_attr,
    )


def batch_norm(
    input, act=None, name=None, moving_average_fraction=0.9, epsilon=1e-5,
    use_global_stats=None, param_attr=None, bias_attr=None, layer_attr=None, **_compat,
):
    return _with_drop(
        L.BatchNorm(
            input, act=_act(act), epsilon=epsilon,
            moving_average_fraction=moving_average_fraction,
            use_global_stats=use_global_stats, param_attr=param_attr,
            bias_attr=_or_none(bias_attr), name=name,
        ),
        layer_attr,
    )


def dropout(input, dropout_rate, name=None):
    return L.Dropout(input, dropout_rate, name=name)


def addto(input, act=None, bias_attr=False, name=None, layer_attr=None):
    ins = input if isinstance(input, (list, tuple)) else [input]
    return _with_drop(
        L.Addto(ins, act=_act(act), bias=bias_attr is not False,
                bias_attr=_or_none(bias_attr), name=name),
        layer_attr,
    )


def concat(input, act=None, name=None, layer_attr=None):
    return _with_drop(L.Concat(list(input), act=_act(act), name=name), layer_attr)


def seq_concat(a, b, name=None):
    return S.SeqConcat(a, b, name=name)


# -- recurrent -------------------------------------------------------------


def lstmemory(input, size=None, reverse=False, act=None, gate_act=None,
              state_act=None, param_attr=None, bias_attr=None, name=None, **_compat):
    return R.Lstm(
        input, size=size, reverse=reverse, act=_act(act) or "tanh",
        gate_act=_act(gate_act) or "sigmoid", state_act=_act(state_act) or "tanh",
        param_attr=param_attr, bias_attr=_or_none(bias_attr), name=name,
    )


def grumemory(input, size=None, reverse=False, act=None, gate_act=None,
              param_attr=None, bias_attr=None, name=None, **_compat):
    return R.Gru(
        input, size=size, reverse=reverse, act=_act(act) or "tanh",
        gate_act=_act(gate_act) or "sigmoid", param_attr=param_attr,
        bias_attr=_or_none(bias_attr), name=name,
    )


def recurrent(input, act=None, reverse=False, bias_attr=None, param_attr=None, name=None):
    return R.SimpleRnn(input, act=_act(act) or "tanh", reverse=reverse,
                       bias=bias_attr is not False, param_attr=param_attr,
                       bias_attr=None if bias_attr in (None, True, False) else bias_attr,
                       name=name)


simple_lstm = R.simple_lstm
simple_gru = R.simple_gru
bidirectional_lstm = R.bidirectional_lstm
bidirectional_gru = R.bidirectional_gru


def gated_unit(input, size, act=None, gate_param_attr=None, name=None, **_compat):
    """gated_unit_layer: act(fc(x)) * sigmoid(fc(x)) — composed exactly like the
    reference helper (mixed + dotmul_operator)."""
    proj = L.Fc(input, size, act=_act(act), bias=True,
                name=(name + ".proj") if name else None)
    gate = L.Fc(input, size, act="sigmoid", param_attr=gate_param_attr,
                name=(name + ".gate") if name else None)
    return L.Mixed([P.DotMulOperator(proj, gate)], size=size, name=name)


# -- sequence --------------------------------------------------------------


def pool(input, pooling_type=None, name=None, **_compat):
    return S.SeqPool(input, _pool_seq(pooling_type), name=name)


def _pool_seq(p) -> str:
    nm = _pool(p)
    return {"max": "max", "avg": "average", "sum": "sum", "sqrt": "sqrt"}[nm]


def last_seq(input, agg_level=None, stride=-1, name=None, **_compat):
    return S.LastSeq(input, agg_level=agg_level, stride=stride, name=name)


def first_seq(input, agg_level=None, stride=-1, name=None, **_compat):
    return S.FirstSeq(input, agg_level=agg_level, stride=stride, name=name)


def expand(input, expand_as, expand_level=None, name=None, **_compat):
    return S.Expand(input, expand_as, expand_level=expand_level, name=name)


def repeat(input, num_repeats, as_row_vector=True, act=None, name=None, **_compat):
    return L.FeatureMapExpand(input, num_repeats, as_row_vector=as_row_vector,
                              act=_act(act), name=name)


def seq_reshape(input, reshape_size, name=None):
    return S.SeqReshape(input, reshape_size, name=name)


def seq_slice(input, k=None, from_start=True, starts=None, ends=None, name=None):
    starts = None if starts is False else starts
    ends = None if ends is False else ends
    return S.SeqSlice(input, k, from_start=from_start, starts=starts,
                      ends=ends, name=name)


def kmax_seq_score(input, beam_size=1, name=None):
    return S.KmaxSeqScore(input, beam_size, name=name)


def sub_seq(input, offsets, sizes, name=None):
    return S.SubSeq(input, offsets, sizes, name=name)


# -- elementwise / misc ----------------------------------------------------


def img_conv3d(input, filter_size, num_filters, num_channels=None, stride=1,
               padding=0, dilation=1, groups=1, act=None, bias_attr=None,
               param_attr=None, name=None, trans=False, layer_attr=None,
               **_compat):
    """img_conv3d_layer (layers.py:6770), NDHWC input."""
    cls = L3.Conv3DTranspose if trans else L3.Conv3D
    kwargs = dict(num_filters=num_filters, filter_size=filter_size, stride=stride,
                  padding=padding, act=_act(act), bias=bias_attr is not False,
                  param_attr=param_attr, bias_attr=_or_none(bias_attr), name=name)
    if not trans:
        kwargs.update(dilation=dilation, groups=groups)
    return _with_drop(cls(input, **kwargs), layer_attr)


def img_pool3d(input, pool_size, pool_type=None, stride=None, padding=0,
               ceil_mode=True, name=None, layer_attr=None, **_compat):
    """img_pool3d_layer (layers.py:2695); ceil_mode=True is the v1 output
    size, as img_pool_layer's."""
    return _with_drop(L3.Pool3D(input, pool_size, _pool(pool_type), stride=stride,
                                padding=padding, ceil_mode=ceil_mode, name=name),
                      layer_attr)


def linear_comb(weights, vectors, size=None, name=None, **_compat):
    """linear_comb_layer / convex_comb_layer (layers.py:4984)."""
    return L.LinearComb(weights, vectors, size=size, name=name)


convex_comb = linear_comb


def mdlstm(input, size=None, directions=(True, True), param_attr=None,
           bias_attr=None, name=None, **_compat):
    """mdlstmemory (config_parser.py:3621): the 2-D multi-dimensional LSTM
    over a projected [B, H, W, 5*size] grid."""
    return R.MDLstm(input, size=size, directions=directions, param_attr=param_attr,
                    bias_attr=_or_none(bias_attr), name=name)


def sub_nested_seq(input, selected_indices, name=None):
    """sub_nested_seq_layer (layers.py:6582)."""
    return S.SubNestedSeq(input, selected_indices, name=name)


def cross_entropy_over_beam(input, name=None):
    """cross_entropy_over_beam (layers.py:6038); input is a list of
    BeamInput(candidate_scores, selected_candidates, gold)."""
    return SC.CrossEntropyOverBeam(input, name=name)


BeamInput = SC.BeamInput


def cos_sim(a, b, scale=1.0, size=1, name=None):
    """cos_sim_layer (layers.py:2228): size=1 is the row-wise cosine; size=N>1
    the vector-against-matrix form (cos_vm, CosSimVecMatLayer)."""
    if size and size > 1:
        return L.CosSimVecMat(a, b, size=size, scale=scale, name=name)
    return L.CosSim(a, b, scale=scale, name=name)


def trans(input, height=None, name=None):
    return L.Trans(input, height, name=name)


def scaling(input, weight, name=None):
    return L.Scaling(weight, input, name=name)


def slope_intercept(input, slope=1.0, intercept=0.0, name=None):
    return L.SlopeIntercept(input, slope=slope, intercept=intercept, name=name)


def interpolation(input, weight, name=None):
    a, b = input
    return L.Interpolation(weight, a, b, name=name)


def power(input, weight, name=None):
    return L.Power(weight, input, name=name)


def dot_prod(a, b, name=None):
    return L.DotProd(a, b, name=name)


def out_prod(a, b, name=None):
    return L.OuterProd(a, b, name=name)


def conv_shift(a, b, name=None):
    return L.ConvShift(a, b, name=name)


def tensor(a, b, size, act=None, param_attr=None, bias_attr=None, name=None, **_compat):
    return L.TensorLayer(a, b, size, act=_act(act), bias=bias_attr is not False,
                         param_attr=param_attr, bias_attr=bias_attr, name=name)


def multiplex(input, name=None):
    ins = list(input)
    return L.Multiplex(ins[0], ins[1:], name=name)


def max_id(input, name=None):
    return L.MaxId(input, name=name)


def sampling_id(input, name=None):
    return L.SamplingId(input, name=name)


def eos(input, eos_id, name=None):
    return L.EosIdCheck(input, eos_id=eos_id, name=name)


def print_layer(input, format=None, name=None):
    return L.PrintLayer(input, message=format or "", name=name)


def clip(input, min, max, name=None):
    return L.Clip(input, min=min, max=max, name=name)


def scale_shift(input, param_attr=None, bias_attr=None, name=None):
    return L.ScaleShift(input, bias=bias_attr is not False,
                        param_attr=param_attr, bias_attr=bias_attr, name=name)


def prelu(input, partial_sum=1, param_attr=None, name=None):
    return L.ParameterRelu(input, partial_sum=partial_sum, param_attr=param_attr, name=name)


# -- image misc ------------------------------------------------------------


def maxout(input, groups, name=None, **_compat):
    return L.Maxout(input, groups, name=name)


def spp(input, pyramid_height=3, pool_type=None, name=None, **_compat):
    return L.SpatialPyramidPool(input, pyramid_height, _pool(pool_type), name=name)


def img_cmrnorm(input, size, scale=0.0128, power=0.75, name=None, **_compat):
    return L.CrossMapNorm(input, size=size, scale=scale, power=power, name=name)


def sum_to_one_norm(input, name=None):
    return L.SumToOneNorm(input, name=name)


def row_l2_norm(input, name=None):
    return L.RowL2Norm(input, name=name)


def cross_channel_norm(input, param_attr=None, name=None):
    return L.CrossChannelNorm(input, name=name)


def data_norm(input, name=None, **_compat):
    return L.DataNorm(input, name=name)


def bilinear_interp(input, out_size_x, out_size_y, name=None):
    return L.BilinearInterp(input, (out_size_y, out_size_x), name=name)


def pad(input, pad_c=None, pad_h=None, pad_w=None, name=None):
    return L.Pad(input, pad_c=pad_c or [0, 0], pad_h=pad_h or [0, 0],
                 pad_w=pad_w or [0, 0], name=name)


def crop(input, offset, shape, name=None, **_compat):
    off_h, off_w = (offset if isinstance(offset, (list, tuple)) else (offset, offset))
    out_h, out_w = (shape if isinstance(shape, (list, tuple)) else (shape, shape))
    return L.Crop(input, off_h, off_w, out_h, out_w, name=name)


def rotate(input, name=None):
    return L.Rotate(input, name=name)


def switch_order(input, to="NCHW", name=None, **_compat):
    return L.SwitchOrder(input, to=to, name=name)


def featmap_expand(input, num_filters, name=None):
    return L.FeatureMapExpand(input, num_filters, name=name)


def resize(input, size, name=None):
    return L.Resize(input, size, name=name)


def block_expand(input, block_x, block_y, stride_x=None, stride_y=None,
                 padding_x=0, padding_y=0, num_channels=None, name=None):
    return L.BlockExpand(input, block_x=block_x, block_y=block_y,
                         stride_x=stride_x or block_x, stride_y=stride_y or block_y,
                         padding_x=padding_x, padding_y=padding_y, name=name)


def row_conv(input, context_len, act=None, param_attr=None, name=None):
    return L.RowConv(input, context_len, act=_act(act), param_attr=param_attr, name=name)


def selective_fc(input, size, select=None, act=None, param_attr=None,
                 bias_attr=None, name=None, **_compat):
    return L.SelectiveFc(
        [input, select] if select is not None else input, size, act=_act(act),
        bias=bias_attr is not False, param_attr=param_attr, name=name,
    )


# -- mixed / projections ---------------------------------------------------


def mixed(size=0, input=None, act=None, bias_attr=False, name=None, layer_attr=None):
    # MixedLayer adds a bias only when bias_attr is explicitly truthy
    # (layers.py mixed_layer: default False; None also means no bias)
    bias = bias_attr is not False and bias_attr is not None
    if input is None:
        # context-manager form: `with mixed_layer(size=N) as m: m += proj`
        return L.Mixed([], size=size, act=_act(act),
                       bias=bias, bias_attr=bias_attr, name=name)
    from paddle_tpu_torch.nn.projections import Projection

    if isinstance(input, Projection):
        input = [input]
    return _with_drop(
        L.Mixed(list(input), size=size, act=_act(act),
                bias=bias, bias_attr=bias_attr, name=name),
        layer_attr,
    )


def full_matrix_projection(input, size=0, param_attr=None):
    # size may be given here or by the enclosing mixed() at apply time
    return P.FullMatrix(input, param_attr=param_attr, size=size)


def trans_full_matrix_projection(input, size=0, param_attr=None):
    return P.TransposedFullMatrix(input, param_attr=param_attr)


def identity_projection(input, offset=None, size=None):
    return P.Identity(input, offset=offset or 0, size=size)


def dotmul_projection(input, param_attr=None):
    return P.DotMul(input, param_attr=param_attr)


def slice_projection(input, slices, **_compat):
    return P.SliceProj(input, slices)


def table_projection(input, size=0, param_attr=None, vocab_size=None):
    if vocab_size is None:
        spec = getattr(input, "data_type", None)
        if spec is not None and spec.kind.startswith("index"):
            vocab_size = int(spec.dim) or None
        elif getattr(input, "_v1_size", None):
            vocab_size = int(input._v1_size)
        elif getattr(input, "shape", None):
            n = 1
            for d in input.shape:
                n *= int(d)
            vocab_size = n or None
    if vocab_size is None:
        spec = getattr(input, "data_type", None)
        vocab_size = int(spec.dim) if spec is not None else 0
    return P.Table(input, vocab_size=vocab_size, param_attr=param_attr, size=size)


_PADDING_ATTR_UNSET = object()


def context_projection(input, context_len, context_start=None,
                       padding_attr=_PADDING_ATTR_UNSET, **_compat):
    start = -(context_len // 2) if context_start is None else context_start
    # wrap_bias_attr_default semantics (reference layers.py:719-755): the
    # decorator substitutes a ParamAttr whenever the caller passed nothing,
    # None or True, so padding is TRAINABLE in all those cases; only an
    # EXPLICIT False yields non-trainable zero padding.
    if padding_attr is _PADDING_ATTR_UNSET or padding_attr is None or padding_attr is True:
        trainable, attr = True, None  # default-substituted ParamAttr
    elif padding_attr is False:
        trainable, attr = False, None
    else:  # a ParameterAttribute: honored, trainable
        trainable, attr = True, padding_attr
    return P.Context_(input, start, context_len,
                      trainable_padding=trainable, param_attr=attr)


def scaling_projection(input, param_attr=None):
    return P.Scaling(input, param_attr=param_attr)


def dotmul_operator(a, b, scale=1.0):
    return P.DotMulOperator(a, b, scale=scale)


# -- costs -----------------------------------------------------------------


def effective_act(node):
    """The activation the cost layer actually sees, looking through
    activation-less passthrough wrappers (dropout, an error clip) and a
    recurrent group (to its step output) — a drop_rate or
    error_clipping_threshold layer_attr, or a group, must not hide a
    softmax-activated layer from the cost. The JAX package looks through
    dropout only, and so re-softmaxes the seqToseq demo's probabilities
    (ROADMAP.md §3)."""
    while node is not None:
        a = getattr(node, "act", None)
        if a is not None:
            return a
        kind = getattr(node, "type_name", None)
        if kind in ("dropout", "error_clip"):
            node = node.inputs[0]
        elif kind == "recurrent_layer_group":
            node = node.core.out_layers[node.out_index]
        else:
            return None
    return None


def classification_cost(input, label, weight=None, name=None, coeff=1.0, **_compat):
    # The standard idiom feeds a softmax-activated layer; the cost must then
    # consume probabilities, not re-softmax (layers.py:4347 applies softmax as
    # the *input layer's* activation, so the cost itself is plain CE).
    from_logits = effective_act(input) != "softmax"
    return C.ClassificationCost(input, label, weight=weight, name=name,
                                coeff=coeff, from_logits=from_logits)


cross_entropy_cost = classification_cost


def square_error_cost(input, label, weight=None, name=None, coeff=1.0):
    return C.SquareError(input, label, weight=weight, name=name, coeff=coeff)


mse_cost = square_error_cost
regression_cost = square_error_cost


def soft_binary_class_cross_entropy(input, label, name=None, coeff=1.0):
    return C.SoftBinaryCrossEntropy(input, label, name=name, coeff=coeff)


def cross_entropy_with_selfnorm_cost(input, label, name=None, coeff=1.0, softmax_selfnorm_alpha=0.1):
    return C.CrossEntropyWithSelfNorm(input, label, name=name, coeff=coeff,
                                      softmax_selfnorm_alpha=softmax_selfnorm_alpha)


def multi_binary_label_cross_entropy_cost(input, label, name=None, coeff=1.0):
    return C.MultiBinaryLabelCrossEntropy(input, label, name=name, coeff=coeff)


def huber_regression_cost(input, label, name=None, delta=1.0, coeff=1.0):
    return C.HuberRegression(input, label, name=name, delta=delta, coeff=coeff)


def huber_classification_cost(input, label, name=None, coeff=1.0):
    return C.HuberTwoClassification(input, label, name=name, coeff=coeff)


def smooth_l1_cost(input, label, name=None, coeff=1.0):
    return C.SmoothL1(input, label, name=name, coeff=coeff)


def rank_cost(left, right, label, weight=None, name=None, coeff=1.0):
    return C.RankCost(left, right, label, weight=weight, name=name, coeff=coeff)


def lambda_cost(input, score, NDCG_num=5, name=None, coeff=1.0, **_compat):
    return SC.LambdaCost(input, score, ndcg_num=NDCG_num, name=name, coeff=coeff)


def sum_cost(input, name=None):
    return C.SumCost(input, name=name)


def crf(input, label, size=None, param_attr=None, name=None, coeff=1.0, **_compat):
    return SC.CRFCost(input, label, size=size, param_attr=param_attr, name=name, coeff=coeff)


def crf_decoding(input, size=None, label=None, param_attr=None, name=None):
    return SC.CRFDecoding(input, size=size, label=label, param_attr=param_attr, name=name)


def ctc(input, label, size=None, blank=None, norm_by_times=False, name=None, **_compat):
    # reference convention: blank = size-1 (the alphabet's last id); size is
    # inferred from the input layer when omitted, like config_parser does
    if blank is None:
        inferred = size or getattr(input, "size", None) or (
            input.cfg.get("size") if hasattr(input, "cfg") else None)
        if inferred is None:
            raise ValueError("ctc: pass size= (or blank=) — cannot infer the "
                             "alphabet size from this input layer")
        blank = int(inferred) - 1
    return SC.CTCCost(input, label, blank=blank, norm_by_times=norm_by_times,
                      size=size or blank + 1, name=name)


def warp_ctc(input, label, size=None, blank=0, norm_by_times=False, name=None, **_compat):
    """warp_ctc_layer: same loss, XLA-native implementation (no warp-ctc dlopen;
    reference paddle/cuda/src/hl_warpctc_wrap.cc)."""
    node = SC.CTCCost(input, label, blank=blank, norm_by_times=norm_by_times,
                      size=size, name=name)
    node.type_name = "warp_ctc"  # same math, distinct wire type
    return node


def nce(input, label, num_classes, weight=None, num_neg_samples=10,
        neg_distribution=None, bias_attr=None, param_attr=None, name=None,
        **_compat):
    return SC.NCECost(input, label, num_classes, num_neg_samples=num_neg_samples,
                      neg_distribution=neg_distribution, bias=bias_attr is not False,
                      param_attr=param_attr, weight=weight, name=name)


def hsigmoid(input, label, num_classes, bias_attr=None, param_attr=None, name=None, **_compat):
    return SC.HierarchicalSigmoid(input, label, num_classes, bias=bias_attr is not False,
                                  param_attr=param_attr, name=name)


# -- detection -------------------------------------------------------------


def priorbox(input, image_size, min_size, max_size=(), aspect_ratio=(2.0,),
             variance=(0.1, 0.1, 0.2, 0.2), clip=True, name=None):
    if isinstance(image_size, int):
        image_size = (image_size, image_size)
    return D.PriorBox(input, image_size=image_size, min_size=min_size, max_size=max_size,
                      aspect_ratio=aspect_ratio, variance=variance, clip=clip, name=name)


def multibox_loss(input_loc, input_conf, priorbox, label, num_classes,
                  overlap_threshold=0.5, neg_pos_ratio=3.0, background_id=0,
                  name=None, **_compat):
    """label = (gt_boxes layer, gt_labels layer): the reference packs both in
    one LoD slot; the padded arrays feed as two slots."""
    gt_boxes, gt_labels = label
    return D.MultiBoxLoss(_as_list(input_loc), _as_list(input_conf), _as_list(priorbox),
                          gt_boxes, gt_labels, num_classes=num_classes,
                          overlap_threshold=overlap_threshold, neg_pos_ratio=neg_pos_ratio,
                          background_id=background_id, name=name)


def detection_output(input_loc, input_conf, priorbox, num_classes,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     confidence_threshold=0.01, background_id=0, name=None):
    return D.DetectionOutput(_as_list(input_loc), _as_list(input_conf), _as_list(priorbox),
                             num_classes=num_classes, nms_threshold=nms_threshold,
                             nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                             confidence_threshold=confidence_threshold,
                             background_id=background_id, name=name)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]




# -- helpers ---------------------------------------------------------------


def _or_none(attr):
    return None if isinstance(attr, bool) else attr


def _with_drop(node: Layer, layer_attr) -> Layer:
    """Apply ExtraAttr knobs by chaining nodes (the reference applies both
    inside Layer::forward/backwardActivation when set): drop_rate → Dropout,
    error_clipping_threshold → identity-forward/clipped-backward."""
    if layer_attr is not None and getattr(
        layer_attr, "error_clipping_threshold", None
    ):
        node = L.ErrorClip(
            node, layer_attr.error_clipping_threshold, name=node.name + ".eclip"
        )
    if layer_attr is not None and getattr(layer_attr, "drop_rate", None):
        return L.Dropout(node, layer_attr.drop_rate, name=node.name + ".drop")
    return node


# -- recurrent groups (RecurrentGradientMachine parity) and generation ------

from paddle_tpu_torch.nn.recurrent_group import (  # noqa: E402
    GeneratedInput,
    StaticInput,
    SubsequenceInput,
    SubSequenceInput,
    beam_search,
    get_output_layer,
    memory,
    recurrent_group,
)



def gru_step(input, output_mem, size=None, act=None, gate_act=None, name=None,
             bias_attr=None, param_attr=None, layer_attr=None):
    """paddle.v2's gru_step (v1 gru_step_layer, layers.py): one GRU step
    inside a group, the decoder of the v2 book's machine translation. The
    JAX package's v2 layer module has no such name; its configs call
    `config.v1_layers.gru_step_layer`, this same layer."""
    from paddle_tpu_torch.config.v1_layers import gru_step_layer

    return gru_step_layer(input, output_mem, size=size, act=act, gate_act=gate_act,
                          bias_attr=bias_attr, param_attr=param_attr, name=name,
                          layer_attr=layer_attr)


__all__ += [
    "recurrent_group", "memory", "StaticInput", "GeneratedInput",
    "SubsequenceInput", "SubSequenceInput",
    "beam_search", "get_output_layer", "gru_step",
]
