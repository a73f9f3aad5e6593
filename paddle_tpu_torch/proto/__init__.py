"""Config message layer (the port's copy of `paddle_tpu/proto/__init__.py`)
— the contract between the Python config DSL and the runtime (reference:
proto/ModelConfig.proto, TrainerConfig.proto, ParameterConfig.proto,
DataConfig.proto).

Plain dataclass messages with a protobuf-text-format serializer (`to_text`)
and a dict form (`to_dict`), field for field the JAX package's, so both
packages print the same text for the same config. Field names match the
reference protos so dumped configs read like the originals.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


# ---------------------------------------------------------------------------
# generic text-format serialization
# ---------------------------------------------------------------------------


def _emit(value: Any, name: str, indent: int, out: List[str]) -> None:
    pad = "  " * indent
    if value is None:
        return
    if dataclasses.is_dataclass(value):
        body: List[str] = []
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            if v is None or (isinstance(v, (list, dict)) and not v):
                continue
            _emit(v, f.name, indent + 1, body)
        if body:
            out.append(f"{pad}{name} {{")
            out.extend(body)
            out.append(f"{pad}}}")
        else:
            out.append(f"{pad}{name} {{}}")
    elif isinstance(value, list):
        for item in value:
            _emit(item, name, indent, out)
    elif isinstance(value, dict):
        # free-form extras: emitted as key: value pairs under the field name
        # (list values unrolled to repeated scalar lines, text-proto style)
        body = []
        for k, v in sorted(value.items()):
            if isinstance(v, (list, tuple)):
                body.extend(f"{pad}  {k}: {_scalar(x)}" for x in v)
            else:
                body.append(f"{pad}  {k}: {_scalar(v)}")
        out.append(f"{pad}{name} {{")
        out.extend(body)
        out.append(f"{pad}}}")
    else:
        out.append(f"{pad}{name}: {_scalar(value)}")


def _scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (tuple, list)):
        return json.dumps(list(v))
    return str(v)


def to_text(msg: Any) -> str:
    """Protobuf-text-format rendering of a message dataclass."""
    out: List[str] = []
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if v is None or (isinstance(v, (list, dict)) and not v):
            continue
        _emit(v, f.name, 0, out)
    return "\n".join(out) + "\n"


def to_dict(msg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(msg)


# ---------------------------------------------------------------------------
# ParameterConfig (proto/ParameterConfig.proto:34)
# ---------------------------------------------------------------------------


@dataclass
class ParameterConfig:
    name: str = ""
    size: int = 0
    dims: List[int] = field(default_factory=list)
    learning_rate: float = 1.0
    momentum: Optional[float] = None
    decay_rate: Optional[float] = None      # L2
    decay_rate_l1: Optional[float] = None
    initial_mean: float = 0.0
    initial_std: Optional[float] = None
    is_static: bool = False
    is_sparse: bool = False
    sparse_remote_update: bool = False
    gradient_clipping_threshold: Optional[float] = None
    # TPU-native addition: logical mesh axes for pjit sharding, e.g. ["model", ""]
    sharding: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# ModelConfig (proto/ModelConfig.proto:637 and friends)
# ---------------------------------------------------------------------------


@dataclass
class ConvConfig:
    """proto/ModelConfig.proto:38 (x = width, y = height)."""

    filter_size: int = 0
    channels: int = 0
    stride: int = 1
    padding: int = 0
    groups: int = 1
    filter_channels: int = 0
    output_x: int = 0
    img_size: int = 0
    caffe_mode: bool = True
    filter_size_y: int = 0
    padding_y: int = 0
    stride_y: int = 1
    output_y: Optional[int] = None
    img_size_y: Optional[int] = None
    dilation: Optional[int] = None
    dilation_y: Optional[int] = None
    filter_size_z: Optional[int] = None
    padding_z: Optional[int] = None
    stride_z: Optional[int] = None
    output_z: Optional[int] = None
    img_size_z: Optional[int] = None


@dataclass
class PoolConfig:
    """proto/ModelConfig.proto:96."""

    pool_type: str = ""
    channels: int = 0
    size_x: int = 0
    stride: int = 1
    output_x: int = 0
    img_size: int = 0
    padding: int = 0
    size_y: Optional[int] = None
    stride_y: Optional[int] = None
    output_y: Optional[int] = None
    img_size_y: Optional[int] = None
    padding_y: Optional[int] = None
    size_z: Optional[int] = None
    stride_z: Optional[int] = None
    output_z: Optional[int] = None
    img_size_z: Optional[int] = None
    padding_z: Optional[int] = None


@dataclass
class NormConfig:
    """proto/ModelConfig.proto:149."""

    norm_type: str = ""
    channels: int = 0
    size: int = 0
    scale: float = 0.0
    pow: float = 0.0
    output_x: int = 0
    img_size: int = 0
    blocked: bool = False
    output_y: Optional[int] = None
    img_size_y: Optional[int] = None


@dataclass
class ImageConfig:
    """proto/ModelConfig.proto:259."""

    channels: int = 0
    img_size: int = 0
    img_size_y: Optional[int] = None
    img_size_z: Optional[int] = None


@dataclass
class BlockExpandConfig:
    """proto/ModelConfig.proto:184."""

    channels: int = 0
    stride_x: int = 0
    stride_y: int = 0
    padding_x: int = 0
    padding_y: int = 0
    block_x: int = 0
    block_y: int = 0
    output_x: int = 0
    output_y: int = 0
    img_size_x: int = 0
    img_size_y: int = 0


@dataclass
class MaxOutConfig:
    image_conf: Optional[ImageConfig] = None
    groups: int = 0


@dataclass
class SppConfig:
    image_conf: Optional[ImageConfig] = None
    pool_type: str = ""
    pyramid_height: int = 0


@dataclass
class BilinearInterpConfig:
    image_conf: Optional[ImageConfig] = None
    out_size_x: int = 0
    out_size_y: int = 0


@dataclass
class PadConfig:
    image_conf: Optional[ImageConfig] = None
    pad_c: List[int] = field(default_factory=list)
    pad_h: List[int] = field(default_factory=list)
    pad_w: List[int] = field(default_factory=list)


@dataclass
class RowConvConfig:
    context_length: int = 0


@dataclass
class ClipConfig:
    min: float = 0.0
    max: float = 0.0


@dataclass
class PriorBoxConfig:
    min_size: List[int] = field(default_factory=list)
    max_size: List[int] = field(default_factory=list)
    aspect_ratio: List[float] = field(default_factory=list)
    variance: List[float] = field(default_factory=list)


@dataclass
class MultiBoxLossConfig:
    num_classes: int = 0
    overlap_threshold: float = 0.0
    neg_pos_ratio: float = 0.0
    neg_overlap: float = 0.0
    background_id: int = 0
    input_num: int = 0
    height: Optional[int] = None
    width: Optional[int] = None


@dataclass
class DetectionOutputConfig:
    num_classes: int = 0
    nms_threshold: float = 0.0
    nms_top_k: int = 0
    background_id: int = 0
    input_num: int = 0
    keep_top_k: int = 0
    confidence_threshold: float = 0.0
    height: Optional[int] = None
    width: Optional[int] = None


@dataclass
class ReshapeConfig:
    height_axis: List[int] = field(default_factory=list)
    width_axis: List[int] = field(default_factory=list)


@dataclass
class SliceConfig:
    start: int = 0
    end: int = 0


@dataclass
class ProjectionConfig:
    type: str = ""
    name: str = ""
    input_size: int = 0
    output_size: int = 0
    context_start: Optional[int] = None
    context_length: Optional[int] = None
    trainable_padding: Optional[bool] = None
    conv_conf: Optional[ConvConfig] = None
    num_filters: Optional[int] = None
    offset: Optional[int] = None
    pool_conf: Optional[PoolConfig] = None
    slices: List[SliceConfig] = field(default_factory=list)


@dataclass
class OperatorConfig:
    type: str = ""
    input_indices: List[int] = field(default_factory=list)
    input_sizes: List[int] = field(default_factory=list)
    output_size: int = 0
    dotmul_scale: Optional[float] = None
    conv_conf: Optional[ConvConfig] = None
    num_filters: Optional[int] = None


@dataclass
class LayerInputConfig:
    """proto/ModelConfig.proto:319."""

    input_layer_name: str = ""
    input_parameter_name: Optional[str] = None
    conv_conf: Optional[ConvConfig] = None
    pool_conf: Optional[PoolConfig] = None
    norm_conf: Optional[NormConfig] = None
    proj_conf: Optional[ProjectionConfig] = None
    block_expand_conf: Optional[BlockExpandConfig] = None
    image_conf: Optional[ImageConfig] = None
    input_layer_argument: Optional[str] = None
    bilinear_interp_conf: Optional[BilinearInterpConfig] = None
    maxout_conf: Optional[MaxOutConfig] = None
    spp_conf: Optional[SppConfig] = None
    priorbox_conf: Optional[PriorBoxConfig] = None
    pad_conf: Optional[PadConfig] = None
    row_conv_conf: Optional[RowConvConfig] = None
    multibox_loss_conf: Optional[MultiBoxLossConfig] = None
    detection_output_conf: Optional[DetectionOutputConfig] = None
    clip_conf: Optional[ClipConfig] = None


@dataclass
class LayerConfig:
    """proto/ModelConfig.proto:347 — typed field set of the reference's
    LayerConfig (fields this runtime has no use for are still modeled so
    golden protostrs diff structurally; see config/protostr.py)."""

    name: str = ""
    type: str = ""
    size: int = 0
    active_type: str = ""
    inputs: List[LayerInputConfig] = field(default_factory=list)
    bias_parameter_name: Optional[str] = None
    num_filters: Optional[int] = None
    shared_biases: Optional[bool] = None
    partial_sum: Optional[int] = None
    drop_rate: Optional[float] = None
    num_classes: Optional[int] = None
    reversed: Optional[bool] = None
    active_gate_type: Optional[str] = None
    active_state_type: Optional[str] = None
    num_neg_samples: Optional[int] = None
    neg_sampling_dist: List[float] = field(default_factory=list)
    output_max_index: Optional[bool] = None
    softmax_selfnorm_alpha: Optional[float] = None
    directions: List[bool] = field(default_factory=list)
    norm_by_times: Optional[bool] = None
    coeff: Optional[float] = None
    average_strategy: Optional[str] = None
    error_clipping_threshold: Optional[float] = None
    operator_confs: List[OperatorConfig] = field(default_factory=list)
    NDCG_num: Optional[int] = None
    max_sort_size: Optional[int] = None
    slope: Optional[float] = None
    intercept: Optional[float] = None
    cos_scale: Optional[float] = None
    data_norm_strategy: Optional[str] = None
    bos_id: Optional[int] = None
    eos_id: Optional[int] = None
    beam_size: Optional[int] = None
    select_first: Optional[bool] = None
    trans_type: Optional[str] = None
    selective_fc_pass_generation: Optional[bool] = None
    has_selected_colums: Optional[bool] = None
    selective_fc_full_mul_ratio: Optional[float] = None
    use_global_stats: Optional[bool] = None
    moving_average_fraction: Optional[float] = None
    bias_size: Optional[int] = None
    user_arg: Optional[str] = None
    height: Optional[int] = None
    width: Optional[int] = None
    blank: Optional[int] = None
    seq_pool_stride: Optional[int] = None
    axis: Optional[int] = None
    offset: List[int] = field(default_factory=list)
    shape: List[int] = field(default_factory=list)  # crop layer (proto field 56)
    delta: Optional[float] = None
    depth: Optional[int] = None
    reshape_conf: Optional[ReshapeConfig] = None
    # free-form layer-specific attributes with no reference field; kept out
    # of the typed surface so protostr output stays reference-shaped
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EvaluatorConfig:
    name: str = ""
    type: str = ""
    input_layers: List[str] = field(default_factory=list)
    # ChunkEvaluator (ModelConfig.proto:537-540, :561)
    chunk_scheme: str = ""
    num_chunk_types: int = 0
    excluded_chunk_types: List[int] = field(default_factory=list)
    # PrecisionRecall / ClassificationError (:543-546, :566)
    classification_threshold: float = 0.5
    positive_label: int = -1
    top_k: int = 1
    # printers (:548-557)
    dict_file: str = ""
    result_file: str = ""
    num_results: int = 1
    delimited: bool = True
    # DetectionMAP (:568-574)
    overlap_threshold: float = 0.5
    background_id: int = 0
    evaluate_difficult: bool = False
    ap_type: str = "11point"


@dataclass
class LinkConfig:
    layer_name: str = ""
    link_name: str = ""


@dataclass
class MemoryConfig:
    link_name: str = ""
    layer_name: str = ""
    boot_layer_name: Optional[str] = None
    boot_bias_parameter_name: Optional[str] = None
    boot_bias_active_type: Optional[str] = None
    boot_with_const_id: Optional[int] = None
    is_sequence: Optional[bool] = None


@dataclass
class SubModelConfig:
    name: str = ""
    layer_names: List[str] = field(default_factory=list)
    input_layer_names: List[str] = field(default_factory=list)
    output_layer_names: List[str] = field(default_factory=list)
    is_recurrent_layer_group: bool = False
    reversed: Optional[bool] = None
    memories: List[MemoryConfig] = field(default_factory=list)
    in_links: List[LinkConfig] = field(default_factory=list)
    out_links: List[LinkConfig] = field(default_factory=list)
    target_inlinkid: Optional[int] = None


@dataclass
class ModelConfig:
    type: str = "nn"
    layers: List[LayerConfig] = field(default_factory=list)
    parameters: List[ParameterConfig] = field(default_factory=list)
    input_layer_names: List[str] = field(default_factory=list)
    output_layer_names: List[str] = field(default_factory=list)
    evaluators: List[EvaluatorConfig] = field(default_factory=list)
    sub_models: List[SubModelConfig] = field(default_factory=list)


# ---------------------------------------------------------------------------
# OptimizationConfig / TrainerConfig (proto/TrainerConfig.proto:21/:140)
# ---------------------------------------------------------------------------


@dataclass
class OptimizationConfig:
    batch_size: int = 1
    algorithm: str = "sgd"
    learning_method: str = "momentum"
    learning_rate: float = 0.01
    momentum: float = 0.0
    learning_rate_decay_a: float = 0.0
    learning_rate_decay_b: float = 0.0
    learning_rate_schedule: str = "constant"
    learning_rate_warmup_steps: int = 0
    l1_weight_decay: float = 0.0
    l2_weight_decay: float = 0.0
    gradient_clipping_threshold: float = 0.0
    average_window: float = 0.0
    max_average_window: int = 0
    ada_epsilon: float = 1e-6
    ada_rou: float = 0.95
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    # extra args threaded through to the optimizer constructor
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    type: str = "py2"
    files: Optional[str] = None
    load_data_module: Optional[str] = None
    load_data_object: Optional[str] = None
    load_data_args: str = ""
    async_load_data: bool = False
    # directory of the config script that declared this source: provider
    # modules and file lists resolve relative to it (PyDataProvider2.cpp
    # loads the module from the config's directory)
    config_dir: str = ""


@dataclass
class TrainerConfig:
    model_config: ModelConfig = field(default_factory=ModelConfig)
    opt_config: OptimizationConfig = field(default_factory=OptimizationConfig)
    data_config: Optional[DataConfig] = None
    test_data_config: Optional[DataConfig] = None
    save_dir: str = "./output"


__all__ = [
    "ParameterConfig", "ProjectionConfig", "OperatorConfig", "LayerInputConfig",
    "LayerConfig", "EvaluatorConfig", "SubModelConfig", "ModelConfig",
    "OptimizationConfig", "DataConfig", "TrainerConfig", "to_text", "to_dict",
    "ConvConfig", "PoolConfig", "NormConfig", "ImageConfig",
    "BlockExpandConfig", "MaxOutConfig", "SppConfig", "BilinearInterpConfig",
    "PadConfig", "RowConvConfig", "ClipConfig", "PriorBoxConfig",
    "MultiBoxLossConfig", "DetectionOutputConfig", "ReshapeConfig",
    "SliceConfig", "LinkConfig", "MemoryConfig",
]
