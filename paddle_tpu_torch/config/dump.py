"""Layer graph -> ModelConfig emission, dump_config parity (counterpart of
`paddle_tpu/config/dump.py`).

The graph nodes already carry full shape inference in their `forward`, so
the emitter runs the network once in init mode on a synthetic batch
(`Topology.sample_batch`), on the CPU without autograd, and reads every
layer's output shape and created parameters (python/paddle/utils/
dump_config.py, config_parser.py:4208). Emission is typed against the
reference field set (proto/ModelConfig.proto:347 LayerConfig and the
per-input sub-confs at :319) and follows the JAX package's emitter rule for
rule, so both packages print the same text for the same config. Geometry
follows the reference: x = width, y = height; image tensors are NHWC, so
input shape [B, H, W, C] maps to img_size_y=H, img_size=W, channels=C.
A recurrent group expands as the reference's RecurrentLayerGroup does
(`_emit_recurrent_group`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch import proto
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.v2.topology import Topology

# our registry name → the reference's REGISTER_LAYER wire name, where they
# differ (gserver/layers/*.cpp registrations)
_TYPE_ALIAS = {
    "conv": "exconv",
    "conv_transpose": "exconvt",
    "cos_sim": "cos",
    "smooth_l1_cost": "smooth_l1",
    "last_seq": "seqlastins",
    "first_seq": "seqlastins",
    "seq_concat": "seqconcat",
    "seq_reshape": "seqreshape",
    "classification_cost": "multi-class-cross-entropy",
    "grumemory": "gated_recurrent",
    "lrn": "norm",
    "outer_prod": "out_prod",
    "block_expand": "blockexpand",
    "feature_map_expand": "featmap_expand",
    "square_error": "square_error",
    "step_arg_output": "get_output",
    "rank_cost": "rank-cost",
    "huber_regression_cost": "huber_regression",
    "huber_classification_cost": "huber_classification",
    "cross_entropy": "multi-class-cross-entropy",
    "cross_entropy_with_selfnorm": "multi_class_cross_entropy_with_selfnorm",
    "soft_binary_class_cross_entropy": "soft_binary_class_cross_entropy",
}

_SKIP_ATTRS = {
    "name", "type_name", "inputs", "cfg", "act", "param_attr", "bias_attr",
    "data_type", "rate", "core", "bias",
}


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _act_name(layer: Layer) -> str:
    a = getattr(layer, "act", None)
    if not isinstance(a, str) or a in ("linear", "identity"):
        return ""
    return a


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1]), int(v[2])
    return int(v), int(v), int(v)


def _geom(arg: Argument) -> Optional[Tuple[int, int, int, int]]:
    """(D, H, W, C) of an NHWC/NDHWC argument (D=1 for 2-D images)."""
    shape = arg.value.shape
    feat = shape[2:] if arg.is_seq else shape[1:]
    if len(feat) == 3:
        return 1, int(feat[0]), int(feat[1]), int(feat[2])
    if len(feat) == 4:
        return int(feat[0]), int(feat[1]), int(feat[2]), int(feat[3])
    return None


def _hw(arg: Argument) -> Optional[Tuple[int, int, int]]:
    """(H, W, C) of an NHWC argument ([B,H,W,C] or seq [B,T,H,W,C])."""
    g = _geom(arg)
    if g is None or g[0] != 1:
        return None
    return g[1], g[2], g[3]


def _image_conf(arg: Argument) -> Optional[proto.ImageConfig]:
    g = _geom(arg)
    if g is None:
        return None
    d, h, w, c = g
    ic = proto.ImageConfig(channels=c, img_size=w, img_size_y=h)
    if d != 1:
        ic.img_size_z = d
    return ic


# ---------------------------------------------------------------------------
# per-type typed emitters: fill LayerConfig fields + input sub-confs
# ---------------------------------------------------------------------------

_EMITTERS: Dict[str, Callable[[Layer, List[Argument], Argument, proto.LayerConfig], None]] = {}


def _emitter(*types: str):
    def deco(fn):
        for t in types:
            _EMITTERS[t] = fn
        return fn

    return deco


def _set_hw(lc: proto.LayerConfig, out: Argument) -> None:
    g = _geom(out)
    if g is not None:
        lc.height, lc.width = g[1], g[2]
        if g[0] != 1:
            lc.depth = g[0]


@_emitter("conv", "conv_transpose")
def _emit_conv(layer, ins, out, lc):
    kh, kw = _pair(layer.filter_size)
    sh, sw = _pair(layer.stride)
    pad = layer.padding
    ph, pw = _pair(pad) if not isinstance(pad, str) else (0, 0)
    dh, dw = _pair(getattr(layer, "dilation", 1))
    ihwc, ohwc = _hw(ins[0]), _hw(out)
    cin = ihwc[2] if ihwc else 0
    groups = getattr(layer, "groups", 1)
    trans = layer.type_name == "conv_transpose"
    cc = proto.ConvConfig(
        filter_size=kw, filter_size_y=kh,
        channels=cin,
        stride=sw, stride_y=sh,
        padding=pw, padding_y=ph,
        groups=groups,
        # exconvt describes the forward conv it transposes: its input
        # channels are this layer's num_filters
        filter_channels=(layer.num_filters if trans else cin) // max(groups, 1),
        caffe_mode=True,
    )
    if dh != 1 or dw != 1:
        cc.dilation, cc.dilation_y = dw, dh
    src, dst = (ohwc, ihwc) if trans else (ihwc, ohwc)  # parse_conv's swap
    if src:
        cc.img_size, cc.img_size_y = src[1], src[0]
    if dst:
        cc.output_x, cc.output_y = dst[1], dst[0]
    lc.inputs[0].conv_conf = cc
    lc.num_filters = layer.num_filters
    lc.shared_biases = True
    _set_hw(lc, out)


@_emitter("pool")
def _emit_pool(layer, ins, out, lc):
    kh, kw = _pair(layer.pool_size)
    sh, sw = _pair(layer.stride if layer.stride is not None else layer.pool_size)
    ph, pw = _pair(layer.padding)
    ihwc, ohwc = _hw(ins[0]), _hw(out)
    pc = proto.PoolConfig(
        pool_type=f"{layer.pool_type}-projection",
        channels=ihwc[2] if ihwc else 0,
        size_x=kw, size_y=kh,
        stride=sw, stride_y=sh,
        padding=pw, padding_y=ph,
    )
    if ihwc:
        pc.img_size, pc.img_size_y = ihwc[1], ihwc[0]
    if ohwc:
        pc.output_x, pc.output_y = ohwc[1], ohwc[0]
    lc.inputs[0].pool_conf = pc
    _set_hw(lc, out)


@_emitter("conv3d", "deconv3d")
def _emit_conv3d(layer, ins, out, lc):
    fd, fh, fw = _triple(layer.filter_size)
    sd, sh, sw = _triple(layer.stride)
    pd, ph, pw = _triple(layer.padding)
    ig, og = _geom(ins[0]), _geom(out)
    trans = layer.type_name == "deconv3d"
    groups = getattr(layer, "groups", 1)
    cin = ig[3] if ig else 0
    cc = proto.ConvConfig(
        filter_size=fw, filter_size_y=fh, filter_size_z=fd,
        channels=cin,
        stride=sw, stride_y=sh, stride_z=sd,
        padding=pw, padding_y=ph, padding_z=pd,
        groups=groups,
        filter_channels=(layer.num_filters if trans else cin) // max(groups, 1),
        caffe_mode=True,
    )
    src, dst = (og, ig) if trans else (ig, og)
    if src:
        cc.img_size, cc.img_size_y, cc.img_size_z = src[2], src[1], src[0]
    if dst:
        cc.output_x, cc.output_y, cc.output_z = dst[2], dst[1], dst[0]
    lc.inputs[0].conv_conf = cc
    lc.num_filters = layer.num_filters
    lc.shared_biases = True
    _set_hw(lc, out)


@_emitter("pool3d")
def _emit_pool3d(layer, ins, out, lc):
    fd, fh, fw = _triple(layer.pool_size)
    sd, sh, sw = _triple(layer.stride if layer.stride is not None else layer.pool_size)
    pd, ph, pw = _triple(layer.padding)
    ig, og = _geom(ins[0]), _geom(out)
    pc = proto.PoolConfig(
        pool_type=f"{layer.pool_type}-projection",
        channels=ig[3] if ig else 0,
        size_x=fw, size_y=fh, size_z=fd,
        stride=sw, stride_y=sh, stride_z=sd,
        padding=pw, padding_y=ph, padding_z=pd,
    )
    if ig:
        pc.img_size, pc.img_size_y, pc.img_size_z = ig[2], ig[1], ig[0]
    if og:
        pc.output_x, pc.output_y, pc.output_z = og[2], og[1], og[0]
    lc.inputs[0].pool_conf = pc
    _set_hw(lc, out)


@_emitter("batch_norm")
def _emit_bn(layer, ins, out, lc):
    ic = _image_conf(ins[0])
    if ic is None:
        feat = ins[0].value.shape[1:]
        ic = proto.ImageConfig(channels=int(feat[-1]) if feat else 1, img_size=1, img_size_y=1)
    lc.inputs[0].image_conf = ic
    lc.moving_average_fraction = getattr(layer, "maf", 0.9)
    ugs = getattr(layer, "use_global_stats", None)
    if ugs is not None:
        lc.use_global_stats = bool(ugs)
    _set_hw(lc, out)


@_emitter("sampling_id")
def _emit_sampling_id(layer, ins, out, lc):
    # SamplingIdLayer keeps its input's size in the config even though the
    # forward emits one sampled id per row (SamplingIdLayer.cpp)
    feat = ins[0].value.shape[1:]
    lc.size = int(np.prod(feat)) if feat else 1


@_emitter("lrn")
def _emit_norm(layer, ins, out, lc):
    ihwc = _hw(ins[0])
    size = getattr(layer, "size", 0)
    nc = proto.NormConfig(
        norm_type="cmrnorm-projection",
        channels=ihwc[2] if ihwc else 0,
        size=size,
        # config_parser stores scale/size (parse_norm); the kernel multiplies
        # by the window sum so the product is the user's scale
        scale=getattr(layer, "scale", 0.0) / max(size, 1),
        pow=getattr(layer, "power", 0.0),
        blocked=False,
    )
    if ihwc:
        nc.img_size, nc.img_size_y = ihwc[1], ihwc[0]
        nc.output_x, nc.output_y = ihwc[1], ihwc[0]
    lc.inputs[0].norm_conf = nc
    _set_hw(lc, out)


@_emitter("clip")
def _emit_clip(layer, ins, out, lc):
    lc.inputs[0].clip_conf = proto.ClipConfig(
        min=getattr(layer, "lo", 0.0), max=getattr(layer, "hi", 0.0))


@_emitter("pad")
def _emit_pad(layer, ins, out, lc):
    # the image_conf only: the JAX package's emitter prints no pad sizes
    # (ROADMAP.md §3 fault 16), and the same text is printed here
    lc.inputs[0].pad_conf = proto.PadConfig(image_conf=_image_conf(ins[0]))
    _set_hw(lc, out)


@_emitter("maxout")
def _emit_maxout(layer, ins, out, lc):
    lc.inputs[0].maxout_conf = proto.MaxOutConfig(
        image_conf=_image_conf(ins[0]), groups=getattr(layer, "groups", 0))
    _set_hw(lc, out)


@_emitter("spp")
def _emit_spp(layer, ins, out, lc):
    lc.inputs[0].spp_conf = proto.SppConfig(
        image_conf=_image_conf(ins[0]),
        pool_type=f"{getattr(layer, 'pool_type', 'max')}-projection",
        pyramid_height=getattr(layer, "pyramid_height", 0))


@_emitter("bilinear_interp")
def _emit_bilinear(layer, ins, out, lc):
    ohwc = _hw(out)
    lc.inputs[0].bilinear_interp_conf = proto.BilinearInterpConfig(
        image_conf=_image_conf(ins[0]),
        out_size_x=ohwc[1] if ohwc else 0,
        out_size_y=ohwc[0] if ohwc else 0)
    _set_hw(lc, out)


@_emitter("row_conv")
def _emit_row_conv(layer, ins, out, lc):
    lc.inputs[0].row_conv_conf = proto.RowConvConfig(context_length=layer.context_len)


@_emitter("block_expand")
def _emit_block_expand(layer, ins, out, lc):
    ihwc = _hw(ins[0])
    by, bx = _pair(getattr(layer, "block", (0, 0)))  # stored (y, x)
    sy, sx = _pair(getattr(layer, "stride", (1, 1)))
    py, px = _pair(getattr(layer, "padding", (0, 0)))
    bc = proto.BlockExpandConfig(
        channels=ihwc[2] if ihwc else 0,
        block_x=bx, block_y=by,
        stride_x=sx, stride_y=sy,
        padding_x=px, padding_y=py,
    )
    # img_size_x/y and output_x/y intentionally omitted: the reference
    # leaves them 0 at parse time (computed by the runtime kernel)
    lc.inputs[0].block_expand_conf = bc


@_emitter("dropout")
def _emit_dropout(layer, ins, out, lc):
    lc.drop_rate = getattr(layer, "rate", None)


@_emitter("embedding")
def _emit_embedding(layer, ins, out, lc):
    # the reference's embedding_layer is a mixed + table projection
    # (layers.py embedding_layer → mixed_layer(table_projection))
    lc.type = "mixed"
    vocab = getattr(layer, "vocab_size", None)
    if not vocab:
        src = layer.inputs[0]
        spec = getattr(src, "data_type", None)
        vocab = int(spec.dim) if spec is not None and spec.dim else 0
    lc.inputs[0].proj_conf = proto.ProjectionConfig(
        type="table", name=None, input_size=vocab or 0,
        output_size=getattr(layer, "size", lc.size),
    )


@_emitter("last_seq", "first_seq")
def _emit_seq_ins(layer, ins, out, lc):
    lc.select_first = layer.type_name == "first_seq"
    lc.trans_type = getattr(layer, "agg_level", None) or "non-seq"
    lc.seq_pool_stride = getattr(layer, "stride", -1) or -1


@_emitter("lstmemory")
def _emit_lstm(layer, ins, out, lc):
    lc.reversed = bool(getattr(layer, "reverse", False))
    lc.active_gate_type = getattr(layer, "gate_act", "sigmoid")
    lc.active_state_type = getattr(layer, "state_act", "tanh")


@_emitter("multibox_loss")
def _emit_multibox(layer, ins, out, lc):
    lc.size = 1
    lc.inputs[0].multibox_loss_conf = proto.MultiBoxLossConfig(
        num_classes=layer.num_classes,
        overlap_threshold=layer.overlap_threshold,
        neg_pos_ratio=layer.neg_pos_ratio,
        neg_overlap=getattr(layer, "neg_overlap", 0.5),  # the v1 layer's only
        background_id=layer.background_id,
        input_num=layer.n_heads,
    )


@_emitter("detection_output")
def _emit_detection_output(layer, ins, out, lc):
    lc.inputs[0].detection_output_conf = proto.DetectionOutputConfig(
        num_classes=layer.num_classes,
        nms_threshold=layer.nms_threshold,
        nms_top_k=layer.nms_top_k,
        background_id=layer.background_id,
        input_num=layer.n_heads,
        keep_top_k=layer.keep_top_k,
        confidence_threshold=layer.confidence_threshold,
    )


@_emitter("recurrent")
def _emit_recurrent(layer, ins, out, lc):
    lc.reversed = bool(layer.reverse)


@_emitter("crop")
def _emit_crop(layer, ins, out, lc):
    # axis 2 and the offset; no shape, as the JAX package's (§3 fault 16)
    lc.axis = 2
    lc.offset = list(layer.offset)


@_emitter("prelu")
def _emit_prelu(layer, ins, out, lc):
    lc.partial_sum = getattr(layer, "partial_sum", 1)


@_emitter("slope_intercept")
def _emit_slope(layer, ins, out, lc):
    lc.slope = getattr(layer, "slope", 1.0)
    lc.intercept = getattr(layer, "intercept", 0.0)


@_emitter("cos_sim", "cos_vm")
def _emit_cos(layer, ins, out, lc):
    lc.cos_scale = getattr(layer, "scale", 1.0)


@_emitter("crf", "crf_decoding")
def _emit_crf(layer, ins, out, lc):
    if getattr(layer, "size", None):
        lc.size = layer.size


@_emitter("ctc", "warp_ctc")
def _emit_ctc(layer, ins, out, lc):
    lc.norm_by_times = bool(getattr(layer, "norm_by_times", False))
    lc.blank = getattr(layer, "blank", 0)
    if getattr(layer, "size", None):
        lc.size = layer.size


@_emitter("nce")
def _emit_nce(layer, ins, out, lc):
    lc.num_classes = layer.num_classes
    lc.num_neg_samples = layer.num_neg_samples
    lc.active_type = "sigmoid"  # NCELayer's fixed activation


@_emitter("hsigmoid")
def _emit_hsigmoid(layer, ins, out, lc):
    lc.num_classes = layer.num_classes


@_emitter("expand")
def _emit_expand(layer, ins, out, lc):
    lc.trans_type = getattr(layer, "expand_level", "non-seq")


@_emitter("seq_pool", "global_pool")
def _emit_seqpool(layer, ins, out, lc):
    lc.trans_type = getattr(layer, "agg_level", None) or "non-seq"
    lc.seq_pool_stride = getattr(layer, "stride", -1) or -1
    if getattr(layer, "output_max_index", None):
        lc.output_max_index = True
    # MaxLayer is its own type; everything else is AverageLayer + strategy
    pt = getattr(layer, "pool_type", "sum")
    if pt == "max":
        lc.type = "max"
    else:
        lc.type = "average"
        lc.average_strategy = {
            "avg": "average", "average": "average", "sum": "sum",
            "sqrt": "squarerootn",
        }.get(pt, pt)


_PROJ_TYPES = {
    "FullMatrix": "fc",
    "TransposedFullMatrix": "trans_fc",
    "Identity": "identity",
    "DotMul": "dot_mul",
    "Scaling": "scaling",
    "Table": "table",
    "Context_": "context",
    "ConvProj": "conv",
}


@_emitter("mixed", "concat2")
def _emit_mixed(layer, ins, out, lc):
    out_feat = out.value.shape[2:] if out.is_seq else out.value.shape[1:]
    out_size = int(np.prod(out_feat)) if out_feat else 1
    slot_lists = getattr(
        layer, "_arg_slots",
        None,
    )
    if slot_lists is None:  # concat2 keeps plain sequential slots
        slot_lists, pos = [], 0
        for proj in getattr(layer, "projections", []):
            slot_lists.append(list(range(pos, pos + len(proj.sources))))
            pos += len(proj.sources)
    for proj, slots in zip(getattr(layer, "projections", []), slot_lists):
        arg = ins[slots[0]]
        lic = lc.inputs[slots[0]]
        cls = type(proj).__name__
        ptype = _PROJ_TYPES.get(cls)
        if ptype == "conv" and getattr(proj, "trans", False):
            ptype = "convt"
        if ptype is None:
            if cls in ("DotMulOperator", "ConvOperator"):
                oc = proto.OperatorConfig(
                    type="dot_mul" if cls == "DotMulOperator" else "conv",
                    input_indices=list(slots),
                    output_size=out_size,
                )
                if cls == "ConvOperator":
                    oc.num_filters = proj.num_filters
                lc.operator_confs.append(oc)
            continue
        feat = arg.value.shape[2:] if arg.is_seq else arg.value.shape[1:]
        in_size = int(np.prod(feat)) if feat else 1
        if ptype == "table":  # input is ids; input_size is the vocab
            in_size = getattr(proj, "vocab_size", None) or in_size
        psize = out_size
        if layer.type_name == "concat2" or ptype == "identity":
            psize = in_size  # each projection contributes its own width
        pc = proto.ProjectionConfig(
            type=ptype, name=None, input_size=in_size, output_size=psize
        )
        if ptype == "context":
            pc.context_start = getattr(proj, "context_start", None)
            pc.context_length = getattr(proj, "context_length", None)
        lic.proj_conf = pc


_COST_TYPES = {
    "multi-class-cross-entropy", "mse", "square_error", "rank-cost",
    "lambda_cost", "sum_cost", "huber_regression", "huber_classification",
    "smooth_l1_cost", "multi_binary_label_cross_entropy", "cross_entropy",
    "soft_binary_class_cross_entropy", "cross_entropy_with_selfnorm",
}


# ---------------------------------------------------------------------------


def _layer_attrs(layer: Layer, consumed: set) -> Dict[str, object]:
    """Scalar/int-tuple hyperparameters with no typed field (kept under
    `attrs`, emitted as repeated scalars)."""
    out: Dict[str, object] = {}
    for k, v in sorted(vars(layer).items()):
        if k.startswith("_") or k in _SKIP_ATTRS or k in consumed:
            continue
        if isinstance(v, (bool, int, float, str)):
            out[k] = v
        elif isinstance(v, (tuple, list)) and v and all(
            isinstance(x, (int, float)) for x in v
        ):
            out[k] = list(v)
    return out




def _v1_size_of(layer: Layer) -> int:
    s = getattr(layer, "_v1_size", None)
    if s:
        return int(s)
    shape = getattr(layer, "shape", None)
    if shape:
        n = 1
        for d in shape:
            n *= int(d)
        return n
    sz = getattr(layer, "size", None)
    if isinstance(sz, int):
        return sz
    return 0


def _emit_recurrent_group(layer, mc, by_layer, alias, seen_cores) -> None:
    """Expand a RecurrentGroup node as config_parser's
    RecurrentLayerGroup{Begin,End} do: a `recurrent_layer_group` marker, a
    scatter_agent per in-link, a `+delay1` agent per memory, the step net's
    layers suffixed `@{group}`, and a gather_agent per step output under the
    step layer's own name. The group node itself aliases to its output's
    gather agent, so downstream inputs read as the reference's."""
    from paddle_tpu_torch.nn.recurrent_group import MemoryLayer, _Placeholder

    core = layer.core
    group = layer.name
    out_layer = core.out_layers[layer.out_index]
    alias[layer.name] = out_layer.name
    if id(core) in seen_cores:
        return
    seen_cores[id(core)] = group

    mc.layers.append(proto.LayerConfig(name=group, type="recurrent_layer_group"))
    sub = proto.SubModelConfig(name=group, is_recurrent_layer_group=True,
                               reversed=bool(core.reverse))
    sub.layer_names.append(group)

    def in_group(n: str) -> str:
        return f"{n}@{group}"

    ph_names: Dict[str, str] = {}
    for ph in core.placeholders:
        src = getattr(ph, "src_layer", None)
        if src is None:
            continue
        agent = in_group(src.name)
        ph_names[ph.name] = agent
        mc.layers.append(proto.LayerConfig(name=agent, type="scatter_agent",
                                           size=_v1_size_of(ph)))
        sub.layer_names.append(agent)
        sub.in_links.append(proto.LinkConfig(layer_name=agent, link_name=src.name))
    for m in core.memories:
        link = core.links[m.name]
        # named memories surface as "{name}+delay1"; anonymous ones keep
        # their auto "__memory_N__" name (config_parser Memory naming)
        agent = (f"{link.name}+delay1@{group}" if getattr(m, "user_named", True)
                 else in_group(m.name))
        ph_names[m.name] = agent
        mc.layers.append(proto.LayerConfig(name=agent, type="agent", size=m.size or 0))
        sub.layer_names.append(agent)
        memc = proto.MemoryConfig(link_name=in_group(link.name), layer_name=agent)
        if m.boot_layer is not None:
            memc.boot_layer_name = m.boot_layer.name
        sub.memories.append(memc)

    for step_l in core.order:
        if isinstance(step_l, (_Placeholder, MemoryLayer)):
            continue
        lc = proto.LayerConfig(
            name=in_group(step_l.name),
            type=_TYPE_ALIAS.get(step_l.type_name, step_l.type_name),
            size=_v1_size_of(step_l),
            active_type=_act_name(step_l),
        )
        owned = dict(by_layer.get(step_l.name, {}))
        for bias_key in ("b", "bias"):
            if bias_key in owned:
                lc.bias_parameter_name = owned.pop(bias_key)
                break
        weight_names = sorted(owned.values())
        for i, inp in enumerate(step_l.inputs):
            lic = proto.LayerInputConfig(
                input_layer_name=ph_names.get(inp.name, in_group(inp.name)))
            if i < len(weight_names):
                lic.input_parameter_name = weight_names[i]
            lc.inputs.append(lic)
        # typed sub-confs from annotations (no traced values in a group)
        if step_l.type_name in ("mixed", "concat2"):
            _emit_ingroup_mixed(step_l, lc)
        mc.layers.append(lc)
        sub.layer_names.append(in_group(step_l.name))

    for out_l in core.out_layers:
        mc.layers.append(proto.LayerConfig(name=out_l.name, type="gather_agent",
                                           size=_v1_size_of(out_l)))
        sub.layer_names.append(out_l.name)
        sub.out_links.append(proto.LinkConfig(layer_name=in_group(out_l.name),
                                              link_name=out_l.name))
    mc.sub_models.append(sub)


def _emit_ingroup_mixed(step_l, lc) -> None:
    out_size = _v1_size_of(step_l)
    for proj, slots in zip(getattr(step_l, "projections", []),
                           getattr(step_l, "_arg_slots", [])):
        ptype = _PROJ_TYPES.get(type(proj).__name__)
        if ptype is None:
            continue
        in_size = _v1_size_of(proj.sources[0])
        if ptype == "identity" and not in_size:
            in_size = out_size
        lc.inputs[slots[0]].proj_conf = proto.ProjectionConfig(
            type=ptype, name=None, input_size=in_size,
            output_size=in_size if ptype == "identity" else out_size)


def build_model_config(
    topology: Union[Topology, Layer, Sequence[Layer]],
    batch_size: int = 2,
    seq_len: int = 8,
) -> proto.ModelConfig:
    if not isinstance(topology, Topology):
        topology = Topology(topology)
    net = topology.network

    cpu = torch.device("cpu")
    ctx = Context("init", {}, device=cpu, train=False, rng=prng.PRNGKey(0))
    with torch.no_grad():
        values = net._run(ctx, topology.sample_batch(batch_size, seq_len), cpu,
                          keep_all=True)

    # group created parameters by owning layer; Context.param records the
    # (layer, slot) → parameter-name binding, which survives sharing via
    # ParamAttr.name (a shared global name binds to every consuming layer)
    by_layer: Dict[str, Dict[str, str]] = {}
    for (lname, pname), full in ctx.param_owners.items():
        by_layer.setdefault(lname, {})[pname] = full

    mc = proto.ModelConfig()
    # ExtraAttr drop_rate chains an explicit "{x}.drop" Dropout node here;
    # the reference folds it into the wrapped layer's drop_rate field —
    # merge on emission so configs read like the originals
    alias: Dict[str, str] = {}
    lc_by_name: Dict[str, proto.LayerConfig] = {}
    seen_cores: Dict[int, str] = {}
    for layer in net.layer_order:
        if hasattr(layer, "core") and layer.type_name == "recurrent_layer_group":
            _emit_recurrent_group(layer, mc, by_layer, alias, seen_cores)
            continue
        if (
            layer.type_name == "dropout"
            and layer.name.endswith(".drop")
            and len(layer.inputs) == 1
            and alias.get(layer.inputs[0].name, layer.inputs[0].name) in lc_by_name
        ):
            parent = alias.get(layer.inputs[0].name, layer.inputs[0].name)
            lc_by_name[parent].drop_rate = getattr(layer, "rate", None)
            alias[layer.name] = parent
            continue
        if (
            layer.type_name == "error_clip"
            and layer.name.endswith(".eclip")
            and len(layer.inputs) == 1
            and layer.inputs[0].name in lc_by_name
        ):
            lc_by_name[layer.inputs[0].name].error_clipping_threshold = layer.threshold
            alias[layer.name] = layer.inputs[0].name
            continue
        arg = values[layer.name]
        shape = tuple(int(d) for d in arg.value.shape)
        if arg.is_seq and arg.sub_lengths is not None and len(shape) > 3:
            feat = shape[3:]  # nested [B, S, T, ...]
        elif arg.is_seq:
            feat = shape[2:]
        else:
            feat = shape[1:]
        size = int(np.prod(feat)) if feat else 1

        lc = proto.LayerConfig(
            name=layer.name,
            type=_TYPE_ALIAS.get(layer.type_name, layer.type_name),
            size=size,
            active_type=_act_name(layer),
        )
        lc_by_name[layer.name] = lc
        owned = by_layer.get(layer.name, {})
        for bias_key in ("b", "bias"):  # batch_norm names its beta "bias"
            if bias_key in owned:
                lc.bias_parameter_name = owned.pop(bias_key)
                break
        weight_names = sorted(owned.values())
        in_args: List[Argument] = []
        for i, inp in enumerate(layer.inputs):
            lic = proto.LayerInputConfig(
                input_layer_name=alias.get(inp.name, inp.name)
            )
            if i < len(weight_names):
                lic.input_parameter_name = weight_names[i]
            lc.inputs.append(lic)
            in_args.append(values[inp.name])
        if layer.type_name in _COST_TYPES or layer.type_name.endswith("cost"):
            lc.coeff = getattr(layer, "coeff", 1.0)
        emitter = _EMITTERS.get(layer.type_name)
        if emitter is not None and lc.inputs:
            emitter(layer, in_args, arg, lc)
        # remaining layer-specific scalars with no reference field
        consumed = _emitted_attr_names(layer.type_name)
        lc.attrs = _layer_attrs(layer, consumed)
        mc.layers.append(lc)

        if layer.type_name == "data":
            mc.input_layer_names.append(layer.name)
            _set_hw(lc, arg)
            spec = getattr(layer, "data_type", None)
            if spec is not None and spec.kind.startswith("index") and spec.dim:
                lc.size = int(spec.dim)  # id slots keep their declared range
            # v1 data slots are flat; declared image geometry rides on the node
            g3 = getattr(layer, "_v1_geom3d", None)
            g2 = getattr(layer, "_v1_geom", None)
            if g3 is not None:
                _, lc.depth, lc.height, lc.width = g3
            elif g2 is not None and lc.height is None:
                _, lc.height, lc.width = g2

    declared = getattr(topology, "declared_outputs", None)
    mc.output_layer_names = [
        alias.get(l.name, l.name) for l in (declared or net.outputs)
    ]
    mc.sub_models.append(
        proto.SubModelConfig(
            name="root",
            layer_names=[l.name for l in net.layer_order],
            input_layer_names=list(mc.input_layer_names),
            output_layer_names=list(mc.output_layer_names),
            is_recurrent_layer_group=False,
        )
    )

    for full, value in ctx.params.items():
        attr = ctx.param_attrs.get(full)
        pc = proto.ParameterConfig(
            name=full,
            size=int(np.prod(value.shape)),
            dims=[int(d) for d in value.shape],
        )
        if attr is not None:
            pc.learning_rate = attr.learning_rate
            pc.momentum = attr.momentum
            pc.decay_rate = attr.l2_decay
            pc.decay_rate_l1 = attr.l1_decay
            pc.initial_mean = attr.initial_mean
            pc.initial_std = attr.initial_std
            pc.is_static = attr.is_static
            pc.is_sparse = attr.is_sparse
            pc.gradient_clipping_threshold = attr.gradient_clipping_threshold
            if attr.sharding:
                pc.sharding = [a or "" for a in attr.sharding]
        mc.parameters.append(pc)
    return mc


# attr names consumed by each typed emitter (kept out of the attrs block so
# the same fact is not emitted twice)
_EMITTED_ATTRS = {
    "conv": {"filter_size", "stride", "padding", "dilation", "groups", "num_filters"},
    "conv_transpose": {"filter_size", "stride", "padding", "dilation", "groups",
                       "num_filters"},
    "pool": {"pool_size", "pool_type", "stride", "padding", "ceil_mode"},
    "batch_norm": {"maf", "use_global_stats", "epsilon"},
    "lrn": {"size", "scale", "power"},
    "clip": {"lo", "hi"},
    "maxout": {"groups"},
    "spp": {"pool_type", "pyramid_height"},
    "block_expand": {"block", "stride", "padding"},
    "dropout": {"rate"},
    "last_seq": {"stride"},
    "first_seq": {"stride"},
    "recurrent": {"reverse"},
    "lstmemory": {"reverse", "gate_act", "state_act"},
    "crop": {"offset"},
    "prelu": {"partial_sum"},
    "slope_intercept": {"slope", "intercept"},
    "cos_sim": {"scale"},
    "cos_vm": {"scale"},
    "ctc": {"norm_by_times", "blank"},
    "warp_ctc": {"norm_by_times", "blank"},
    "nce": {"num_classes", "num_neg_samples"},
    "hsigmoid": {"num_classes"},
    "expand": {"expand_level"},
    "seq_pool": {"agg_level", "pool_type"},
    "global_pool": {"agg_level", "pool_type"},
}


def _emitted_attr_names(type_name: str) -> set:
    return _EMITTED_ATTRS.get(type_name, set())


def dump_config(
    topology: Union[Topology, Layer, Sequence[Layer]],
    batch_size: int = 2,
    seq_len: int = 8,
) -> str:
    """Text-format ModelConfig (python/paddle/utils/dump_config.py parity)."""
    return proto.to_text(build_model_config(topology, batch_size, seq_len))
