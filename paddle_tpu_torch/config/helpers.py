"""trainer_config_helpers surface — the v1 config-script DSL names
(counterpart of `paddle_tpu/config/helpers.py`).

Parity with python/paddle/trainer_config_helpers/{layers.py, activations.py,
poolings.py, attrs.py, evaluators.py, data_sources.py}: the classic
`*_layer` constructors, activation/pooling tag classes, ParamAttr, evaluator
declarations and `settings()`. Every constructor is the same graph node the
v2 API builds (`v2/layer.py`), and every default name is the reference's
(`_REF_NAME_PREFIX`), so a config gives the JAX package's layer and
parameter names counter for counter.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import proto
from paddle_tpu_torch.data import feeder as _feeder
from paddle_tpu_torch.v2 import layer as _v2
from paddle_tpu_torch.v2 import networks as _nets
from paddle_tpu_torch.v2.activation import (
    Abs as AbsActivation,
    BRelu as BReluActivation,
    Exp as ExpActivation,
    Linear as LinearActivation,
    Log as LogActivation,
    Relu as ReluActivation,
    SequenceSoftmax as SequenceSoftmaxActivation,
    Sigmoid as SigmoidActivation,
    Softmax as SoftmaxActivation,
    SoftRelu as SoftReluActivation,
    Square as SquareActivation,
    STanh as STanhActivation,
    Tanh as TanhActivation,
)
from paddle_tpu_torch.v2.attr import ExtraAttr as ExtraLayerAttribute
from paddle_tpu_torch.v2.attr import Param as ParamAttr
from paddle_tpu_torch.v2.pooling import Avg as AvgPooling
from paddle_tpu_torch.v2.pooling import Max as MaxPooling
from paddle_tpu_torch.v2.pooling import SquareRootN as SquareRootNPooling
from paddle_tpu_torch.v2.pooling import Sum as SumPooling
from paddle_tpu_torch.v2.pooling import CudnnAvg as CudnnAvgPooling
from paddle_tpu_torch.v2.pooling import CudnnMax as CudnnMaxPooling
from paddle_tpu_torch.config.optimizers import (
    AdaDeltaOptimizer,
    AdaGradOptimizer,
    AdamaxOptimizer,
    AdamOptimizer,
    DecayedAdaGradOptimizer,
    GradientClippingThreshold,
    L1Regularization,
    L2Regularization,
    ModelAverage,
    MomentumOptimizer,
    RmsPropOptimizer,
    settings,
)

from paddle_tpu_torch.v2.activation import (  # noqa: E402
    Identity as IdentityActivation,
    Reciprocal as ReciprocalActivation,
    Sqrt as SqrtActivation,
)

ParameterAttribute = ParamAttr
ExtraAttr = ExtraLayerAttribute


class AggregateLevel:
    """layers.py:275 — pooling/aggregation level over (nested) sequences."""

    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    EACH_TIMESTEP = TO_NO_SEQUENCE
    EACH_SEQUENCE = TO_SEQUENCE


class ExpandLevel:
    """layers.py:1762 — expansion source level."""

    FROM_NO_SEQUENCE = AggregateLevel.TO_NO_SEQUENCE
    FROM_SEQUENCE = AggregateLevel.TO_SEQUENCE
    FROM_TIMESTEP = FROM_NO_SEQUENCE

# -- input types (PyDataProvider2.py:63-236) --------------------------------
dense_vector = _feeder.dense_vector
dense_array = _feeder.dense_array
integer_value = _feeder.integer_value
dense_vector_sequence = _feeder.dense_vector_sequence
integer_value_sequence = _feeder.integer_value_sequence
sparse_binary_vector = _feeder.sparse_binary_vector
sparse_value_slot = _feeder.sparse_value_slot

# -- layers (trainer_config_helpers/layers.py ~100 wrappers) ----------------
addto_layer = _v2.addto
seq_concat_layer = _v2.seq_concat
lstmemory = _v2.lstmemory
grumemory = _v2.grumemory
recurrent_layer = _v2.recurrent
gated_unit_layer = _v2.gated_unit
last_seq = _v2.last_seq
first_seq = _v2.first_seq
expand_layer = _v2.expand
repeat_layer = _v2.repeat
resize_layer = _v2.resize
seq_reshape_layer = _v2.seq_reshape
seq_slice_layer = _v2.seq_slice
kmax_sequence_score_layer = _v2.kmax_seq_score
sub_seq_layer = _v2.sub_seq
cos_sim = _v2.cos_sim
trans_layer = _v2.trans
scaling_layer = _v2.scaling
slope_intercept_layer = _v2.slope_intercept
interpolation_layer = _v2.interpolation
power_layer = _v2.power
dot_prod_layer = _v2.dot_prod
out_prod_layer = _v2.out_prod
conv_shift_layer = _v2.conv_shift
tensor_layer = _v2.tensor
multiplex_layer = _v2.multiplex
sampling_id_layer = _v2.sampling_id
eos_layer = _v2.eos
print_layer = _v2.print_layer
clip_layer = _v2.clip
scale_shift_layer = _v2.scale_shift
prelu_layer = _v2.prelu
maxout_layer = _v2.maxout
spp_layer = _v2.spp
sum_to_one_norm_layer = _v2.sum_to_one_norm
row_l2_norm_layer = _v2.row_l2_norm
cross_channel_norm_layer = _v2.cross_channel_norm
data_norm_layer = _v2.data_norm
bilinear_interp_layer = _v2.bilinear_interp
pad_layer = _v2.pad
crop_layer = _v2.crop
rotate_layer = _v2.rotate
switch_order_layer = _v2.switch_order
block_expand_layer = _v2.block_expand
row_conv_layer = _v2.row_conv
selective_fc_layer = _v2.selective_fc
img_conv3d_layer = _v2.img_conv3d
img_pool3d_layer = _v2.img_pool3d
linear_comb_layer = _v2.linear_comb
convex_comb_layer = _v2.convex_comb
sub_nested_seq_layer = _v2.sub_nested_seq
cross_entropy_over_beam = _v2.cross_entropy_over_beam
BeamInput = _v2.BeamInput

# mixed layer + projections/operators
mixed_layer = _v2.mixed
full_matrix_projection = _v2.full_matrix_projection
trans_full_matrix_projection = _v2.trans_full_matrix_projection
identity_projection = _v2.identity_projection
dotmul_projection = _v2.dotmul_projection
table_projection = _v2.table_projection
context_projection = _v2.context_projection
scaling_projection = _v2.scaling_projection
slice_projection = _v2.slice_projection
dotmul_operator = _v2.dotmul_operator

# costs
cross_entropy_with_selfnorm = _v2.cross_entropy_with_selfnorm_cost
multi_binary_label_cross_entropy = _v2.multi_binary_label_cross_entropy_cost
soft_binary_class_cross_entropy = _v2.soft_binary_class_cross_entropy
square_error_cost = _v2.square_error_cost
regression_cost = _v2.square_error_cost
mse_cost = _v2.square_error_cost
huber_regression_cost = _v2.huber_regression_cost
huber_classification_cost = _v2.huber_classification_cost
smooth_l1_cost = _v2.smooth_l1_cost
rank_cost = _v2.rank_cost
lambda_cost = _v2.lambda_cost
sum_cost = _v2.sum_cost
crf_layer = _v2.crf
crf_decoding_layer = _v2.crf_decoding
ctc_layer = _v2.ctc
warp_ctc_layer = _v2.warp_ctc
nce_layer = _v2.nce
hsigmoid = _v2.hsigmoid

# detection
priorbox_layer = _v2.priorbox
multibox_loss_layer = _v2.multibox_loss
detection_output_layer = _v2.detection_output

# recurrent groups (nn/recurrent_group): the v1 dynamic-unroll API
from paddle_tpu_torch.v2.layer import (  # noqa: E402
    GeneratedInput,
    recurrent_group,
    memory,
    StaticInput,
    SubsequenceInput,
    SubSequenceInput,
    beam_search,
    get_output_layer,
)

# prebuilt networks (trainer_config_helpers/networks.py)
vgg_16_network = _nets.vgg_16_network
simple_attention = _nets.simple_attention

# -- reference-faithful v1 signatures override the bare v2 aliases ----------
# (config/v1_layers.py matches layers.py/networks.py signatures so
# unmodified reference config scripts run; see that module's docstring)
from paddle_tpu_torch.config.v1_layers import (  # noqa: E402
    batch_norm_layer,
    bidirectional_gru,
    bilinear_interp_layer,
    block_expand_layer,
    bidirectional_lstm,
    classification_cost,
    concat_layer,
    conv_operator,
    conv_projection,
    crf_decoding_layer,
    crf_layer,
    cross_entropy,
    ctc_layer,
    data_layer,
    detection_output_layer,
    dropout_layer,
    embedding_layer,
    expand_layer,
    fc_layer,
    first_seq,
    gated_unit_layer,
    get_output_layer,
    gru_group,
    gru_step_layer,
    gru_step_naive_layer,
    gru_unit,
    img_cmrnorm_layer,
    img_conv3d_layer,
    img_conv_group,
    img_conv_layer,
    hsigmoid,
    img_pool3d_layer,
    img_pool_layer,
    kmax_sequence_score_layer,
    lambda_cost,
    last_seq,
    lstm_step_layer,
    lstmemory,
    lstmemory_group,
    lstmemory_unit,
    grumemory,
    maxid_layer,
    maxout_layer,
    multibox_loss_layer,
    nce_layer,
    pooling_layer,
    recurrent_group,
    recurrent_layer,
    row_conv_layer,
    spp_layer,
    seq_concat_layer,
    seq_reshape_layer,
    seq_slice_layer,
    sequence_conv_pool,
    simple_gru,
    simple_gru2,
    simple_img_conv_pool,
    simple_lstm,
    sub_nested_seq_layer,
    text_conv_pool,
    warp_ctc_layer,
)


# -- evaluator declarations (trainer_config_helpers/evaluators.py) ----------


def _declare_evaluator(etype: str, *input_layers, name: Optional[str] = None, **kw):
    from paddle_tpu_torch.config import config_parser as cp

    if name is None:
        # config_parser names evaluators "{type}_evaluator" (uniquified)
        base = f"{etype}_evaluator"
        taken = {e.name for e in cp.g_context().evaluators}
        name = base
        i = 0
        while name in taken:
            i += 1
            name = f"{base}_{i}"
    cfg = proto.EvaluatorConfig(
        name=name,
        type=etype,
        input_layers=[l.name for l in input_layers if l is not None],
    )
    for k, v in kw.items():  # EvaluatorConfig fields (chunk_scheme, top_k, ...)
        if hasattr(cfg, k) and v is not None:
            setattr(cfg, k, v)
    cp.g_context().evaluators.append(cfg)
    return cfg


def classification_error_evaluator(input=None, label=None, weight=None,
                                   name=None, **kw):
    return _declare_evaluator("classification_error", input, label, weight,
                              name=name, **kw)


def auc_evaluator(input=None, label=None, name=None, **kw):
    return _declare_evaluator("auc", input, label, name=name, **kw)


def precision_recall_evaluator(input=None, label=None, name=None, **kw):
    return _declare_evaluator("precision_recall", input, label, name=name, **kw)


def pnpair_evaluator(input=None, label=None, query_id=None, name=None, **kw):
    return _declare_evaluator("pnpair", input, label, query_id, name=name, **kw)


def sum_evaluator(input=None, name=None, **kw):
    return _declare_evaluator("sum", input, name=name, **kw)


def column_sum_evaluator(input=None, name=None, **kw):
    return _declare_evaluator("column_sum", input, name=name, **kw)


def chunk_evaluator(input=None, label=None, chunk_scheme="IOB",
                    num_chunk_types=0, name=None, excluded_chunk_types=None,
                    **kw):
    return _declare_evaluator(
        "chunk", input, label, name=name, chunk_scheme=chunk_scheme,
        num_chunk_types=num_chunk_types or 1,
        excluded_chunk_types=excluded_chunk_types or [],
    )


def seqtext_printer_evaluator(input=None, result_file=None, id_input=None,
                              dict_file=None, delimited=None, name=None, **kw):
    """evaluators.py seqtext_printer_evaluator: dump generated sequences to
    result_file (SequenceTextPrinter) — consumed by the generation CLI."""
    return _declare_evaluator(
        "seq_text_printer", input, id_input, name=name,
        result_file=result_file or "", dict_file=dict_file or "",
        delimited=bool(delimited) if delimited is not None else True, **kw)


def value_printer_evaluator(input=None, name=None, **kw):
    """utils evaluator (Evaluator.h ValuePrinter): print layer outputs."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    return _declare_evaluator("value_printer", *ins, name=name, **kw)


def gradient_printer_evaluator(input=None, name=None, **kw):
    """GradientPrinter: per-layer gradients are not materialized outside the
    compiled step here, so this prints the layer's forward value with a note
    (declared for config compatibility)."""
    return _declare_evaluator("gradient_printer", input, name=name, **kw)


def maxid_printer_evaluator(input=None, num_results=1, name=None, **kw):
    return _declare_evaluator("max_id_printer", input, name=name,
                              num_results=num_results, **kw)


def classification_error_printer_evaluator(input=None, label=None, name=None, **kw):
    return _declare_evaluator("classification_error_printer", input, label,
                              name=name, **kw)


def ctc_error_evaluator(input=None, label=None, name=None, **kw):
    return _declare_evaluator("ctc_edit_distance", input, label, name=name, **kw)


def detection_map_evaluator(input=None, label=None, name=None, **kw):
    return _declare_evaluator("detection_map", input, label, name=name, **kw)


# -- reference default naming (default_decorators.py wrap_name_default) ----
# The reference auto-names every helper's layer "__{prefix}_{n}__" with a
# per-helper counter (prefix = the decorator argument, else the helper's own
# __name__). The golden protostrs encode those names, so the DSL surface
# wraps each helper to inject the same default; counters live in the graph's
# name scope and reset with reset_name_scope().
_REF_NAME_PREFIX = {
    # explicit wrap_name_default("...") prefixes in layers.py / networks.py
    "mixed_layer": "mixed", "embedding_layer": "embedding",
    "print_layer": "print", "printer_layer": "print",
    "priorbox_layer": "priorbox", "multibox_loss_layer": "multibox_loss",
    "detection_output_layer": "detection_output",
    "cross_channel_norm_layer": "cross_channel_norm",
    "pooling_layer": "seq_pooling", "lstmemory": "lstmemory",
    "grumemory": "gru", "seq_reshape_layer": "seqreshape",
    "img_conv_layer": "conv", "img_pool_layer": "pool",
    "img_pool3d_layer": "pool3d", "spp_layer": "spp",
    "img_cmrnorm_layer": "crmnorm", "batch_norm_layer": "batch_norm",
    "addto_layer": "addto", "concat_layer": "concat",
    "seq_concat_layer": "seqconcat", "lstm_step_layer": "lstm_step",
    "gru_step_layer": "gru_step", "gru_step_naive_layer": "gru_step_naive",
    "recurrent_group": "recurrent_group", "dropout_layer": "dropout",
    "switch_order_layer": "switch_order", "clip_layer": "clip",
    "scale_shift_layer": "scale_shift", "resize_layer": "resize",
    "pad_layer": "pad", "classification_cost": "cost",
    "kmax_sequence_score_layer": "kmax_seq_score_layer",
    # networks.py composites
    "sequence_conv_pool": "sequence_conv_pooling",
    "simple_img_conv_pool": "conv_pool", "img_conv_bn_pool": "conv_bn_pool",
    "simple_lstm": "lstm", "lstmemory_unit": "lstm_unit",
    "lstmemory_group": "lstm_group", "gru_unit": "gru_unit",
    "gru_group": "gru_group", "simple_gru": "simple_gru",
    "simple_gru2": "simple_gru2", "bidirectional_gru": "bidirectional_gru",
    "bidirectional_lstm": "bidirectional_lstm",
}

# helpers auto-named by their own __name__ (wrap_name_default() bare)
_REF_NAMED_HELPERS = [
    "fc_layer", "selective_fc_layer", "last_seq", "first_seq", "expand_layer",
    "repeat_layer", "interpolation_layer", "bilinear_interp_layer",
    "power_layer", "scaling_layer", "trans_layer", "rotate_layer", "cos_sim",
    "hsigmoid", "sum_to_one_norm_layer", "row_l2_norm_layer",
    "get_output_layer", "recurrent_layer", "maxid_layer", "out_prod_layer",
    "eos_layer", "beam_search", "square_error_cost", "conv_shift_layer",
    "sampling_id_layer", "slope_intercept_layer", "linear_comb_layer",
    "block_expand_layer", "maxout_layer", "ctc_layer", "warp_ctc_layer",
    "crf_layer", "crf_decoding_layer", "nce_layer", "rank_cost",
    "lambda_cost", "cross_entropy", "cross_entropy_with_selfnorm",
    "sum_cost", "huber_regression_cost", "huber_classification_cost",
    "multi_binary_label_cross_entropy", "cross_entropy_over_beam",
    "smooth_l1_cost", "multiplex_layer", "prelu_layer", "crop_layer",
    "sub_nested_seq_layer", "seq_slice_layer", "gated_unit_layer",
    "dot_prod_layer", "tensor_layer", "convex_comb_layer", "row_conv_layer",
    "img_conv3d_layer", "data_norm_layer",
]


def _with_ref_default_name(fn, prefix):
    import functools

    from paddle_tpu_torch.nn.graph import _auto_name

    @functools.wraps(fn)
    def named(*args, **kw):
        if kw.get("name") is None:
            kw["name"] = _auto_name(prefix)
        return fn(*args, **kw)

    return named


def _install_ref_naming():
    g = globals()
    table = dict(_REF_NAME_PREFIX)
    table.update({h: h for h in _REF_NAMED_HELPERS})
    for helper, prefix in table.items():
        fn = g.get(helper)
        if callable(fn):
            g[helper] = _with_ref_default_name(fn, prefix)


_install_ref_naming()

printer_layer = print_layer  # both spellings exist across reference versions
kmax_seq_score_layer = kmax_sequence_score_layer

# layer_math must import after the wrapped helpers exist (it resolves them
# lazily, but importing it installs the Layer arithmetic operators)
from paddle_tpu_torch.config import layer_math  # noqa: E402

__all__ = [
    "printer_layer", "kmax_seq_score_layer", "layer_math",
    "slice_projection", "CudnnMaxPooling", "CudnnAvgPooling",
    "GeneratedInput",
    "lstmemory_group", "lstmemory_unit", "gru_group", "gru_unit",
    "lstm_step_layer", "gru_step_layer", "gru_step_naive_layer",
    "simple_gru2", "gated_unit_layer", "seq_slice_layer",
    "sub_nested_seq_layer", "seq_reshape_layer",
    "AggregateLevel", "ExpandLevel", "IdentityActivation",
    "SqrtActivation", "ReciprocalActivation",
    # attrs / activations / poolings
    "ParamAttr", "ParameterAttribute", "ExtraLayerAttribute", "ExtraAttr",
    "LinearActivation", "SigmoidActivation", "SoftmaxActivation",
    "SequenceSoftmaxActivation", "ReluActivation", "BReluActivation",
    "TanhActivation", "STanhActivation", "SoftReluActivation", "AbsActivation",
    "SquareActivation", "ExpActivation", "LogActivation",
    "MaxPooling", "AvgPooling", "SumPooling", "SquareRootNPooling",
    # input types
    "dense_vector", "dense_array", "integer_value", "dense_vector_sequence",
    "integer_value_sequence", "sparse_binary_vector", "sparse_value_slot",
    # optimizers / settings
    "settings", "MomentumOptimizer", "AdamOptimizer", "AdamaxOptimizer",
    "AdaGradOptimizer", "DecayedAdaGradOptimizer", "AdaDeltaOptimizer",
    "RmsPropOptimizer", "L1Regularization", "L2Regularization", "ModelAverage",
    "GradientClippingThreshold",
    # layers
    "data_layer", "fc_layer", "embedding_layer", "img_conv_layer",
    "img_pool_layer", "batch_norm_layer", "dropout_layer", "addto_layer",
    "concat_layer", "seq_concat_layer", "lstmemory", "grumemory",
    "recurrent_layer", "gated_unit_layer", "pooling_layer", "last_seq",
    "first_seq", "expand_layer", "repeat_layer", "resize_layer",
    "seq_reshape_layer", "seq_slice_layer", "kmax_sequence_score_layer",
    "sub_seq_layer", "cos_sim", "trans_layer", "scaling_layer",
    "slope_intercept_layer", "interpolation_layer", "power_layer",
    "dot_prod_layer", "out_prod_layer", "conv_shift_layer", "tensor_layer",
    "multiplex_layer", "maxid_layer", "sampling_id_layer", "eos_layer",
    "print_layer", "clip_layer", "scale_shift_layer", "prelu_layer",
    "maxout_layer", "spp_layer", "img_cmrnorm_layer", "sum_to_one_norm_layer",
    "row_l2_norm_layer", "cross_channel_norm_layer", "data_norm_layer",
    "bilinear_interp_layer", "pad_layer", "crop_layer", "rotate_layer",
    "switch_order_layer", "block_expand_layer", "row_conv_layer",
    "selective_fc_layer", "bidirectional_lstm", "bidirectional_gru",
    "simple_lstm", "simple_gru", "img_conv3d_layer", "img_pool3d_layer",
    "linear_comb_layer", "convex_comb_layer", "sub_nested_seq_layer",
    "cross_entropy_over_beam", "BeamInput",
    # mixed
    "mixed_layer", "full_matrix_projection", "trans_full_matrix_projection",
    "identity_projection", "dotmul_projection", "table_projection",
    "context_projection", "scaling_projection", "dotmul_operator",
    # costs
    "classification_cost", "cross_entropy", "cross_entropy_with_selfnorm",
    "multi_binary_label_cross_entropy", "soft_binary_class_cross_entropy",
    "square_error_cost", "regression_cost", "mse_cost",
    "huber_regression_cost", "huber_classification_cost", "smooth_l1_cost",
    "rank_cost", "lambda_cost", "sum_cost", "crf_layer", "crf_decoding_layer",
    "ctc_layer", "warp_ctc_layer", "nce_layer", "hsigmoid",
    # detection
    "priorbox_layer", "multibox_loss_layer", "detection_output_layer",
    # recurrent groups
    "recurrent_group", "memory", "StaticInput", "SubsequenceInput",
    "SubSequenceInput", "beam_search",
    "get_output_layer",
    # networks
    "simple_img_conv_pool", "img_conv_group", "vgg_16_network",
    "text_conv_pool", "simple_attention", "sequence_conv_pool",
    "conv_projection", "conv_operator",
    # evaluators
    "seqtext_printer_evaluator", "classification_error_evaluator", "auc_evaluator",
    "precision_recall_evaluator", "pnpair_evaluator", "sum_evaluator",
    "column_sum_evaluator", "chunk_evaluator", "ctc_error_evaluator",
    "detection_map_evaluator",
]
