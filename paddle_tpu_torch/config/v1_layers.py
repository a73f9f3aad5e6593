"""v1 `trainer_config_helpers` wrappers with reference-faithful signatures
(counterpart of `paddle_tpu/config/v1_layers.py`).

Every public function here matches the positional/keyword signature of its
namesake in the reference's python/paddle/trainer_config_helpers/layers.py
(and networks.py for the composites), including the decorator-injected
defaults (@wrap_act_default / @wrap_bias_attr_default — e.g. img_conv_layer
defaults to ReluActivation, fc_layer to TanhActivation, pooling_layer to
MaxPooling), so unmodified reference config scripts execute against it.

v1 image-shape semantics: data layers are FLAT vectors (CHW order); image
layers carry (channels, height, width) geometry and the first image op
infers height = width = sqrt(size / channels) (config_parser.py
parse_image). Here that geometry rides on the graph node as `_v1_geom`, and
a flat input entering an image layer gets an explicit Reshape(CHW) +
SwitchOrder(NHWC) adapter, everything downstream NHWC.

recurrent_group and its step layers (`gru_step_layer`, `lstm_step_layer`,
`get_output_layer`) build `nn/recurrent_group.py`'s groups, and so do the
composites on them: `gru_unit` / `gru_group`, `lstmemory_unit` /
`lstmemory_group` and `simple_gru`, which the reference routes through
gru_group; `simple_gru2` and `bidirectional_gru` run the fused grumemory.
The transposed conv (`img_conv_layer(trans=True)`), `concat_layer` of
projections, the 3-D convs and pools (a flat CDHW slot gets an NDHWC
adapter, as a flat CHW one gets NHWC) and the packed v1 detection layers
build as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import detection_layers as D
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn import recurrent as R
from paddle_tpu_torch.nn import seq_layers as S
from paddle_tpu_torch.nn.graph import Layer
from paddle_tpu_torch.v2 import layer as _v2
from paddle_tpu_torch.v2.activation import resolve as _act
from paddle_tpu_torch.v2.pooling import resolve as _pool_name

__all__ = [
    "data_layer", "fc_layer", "embedding_layer", "img_conv_layer",
    "img_pool_layer", "img_cmrnorm_layer", "batch_norm_layer",
    "dropout_layer", "concat_layer", "conv_projection", "conv_operator",
    "pooling_layer",
    "maxid_layer", "classification_cost", "cross_entropy",
    "img_conv_group", "simple_img_conv_pool", "sequence_conv_pool",
    "text_conv_pool", "simple_lstm", "simple_gru", "bidirectional_lstm",
    "bidirectional_gru", "last_seq", "first_seq", "expand_layer",
    "ctc_layer", "warp_ctc_layer", "crf_layer", "crf_decoding_layer",
    "nce_layer", "hsigmoid", "lstmemory", "grumemory", "recurrent_layer",
    "lambda_cost", "maxout_layer", "bilinear_interp_layer", "spp_layer",
    "row_conv_layer", "block_expand_layer", "img_conv3d_layer",
    "img_pool3d_layer",
    "seq_slice_layer", "kmax_sequence_score_layer", "seq_concat_layer",
    "seq_reshape_layer", "sub_nested_seq_layer", "gated_unit_layer",
    "simple_gru2", "lstm_step_layer", "gru_step_layer",
    "gru_step_naive_layer", "get_output_layer", "lstmemory_unit",
    "lstmemory_group", "gru_unit", "gru_group", "recurrent_group",
    "multibox_loss_layer", "detection_output_layer",
]


# ---------------------------------------------------------------------------
# v1 geometry bookkeeping (config_parser parse_image semantics)
# ---------------------------------------------------------------------------


def _size_of(node: Layer) -> Optional[int]:
    s = getattr(node, "_v1_size", None)
    if s is not None:
        return int(s)
    shape = getattr(node, "shape", None)  # data layers
    if shape:
        n = 1
        for d in shape:
            n *= int(d)
        return n
    if getattr(node, "size", None):
        return int(node.size)
    return None


def _annotate(node: Layer, size: Optional[int] = None, geom=None) -> Layer:
    if size is not None:
        node._v1_size = int(size)
    if geom is not None:
        node._v1_geom = tuple(int(v) for v in geom)
        c, h, w = node._v1_geom
        node._v1_size = c * h * w
    return node


def _infer_geom(input: Layer, num_channels: Optional[int]):
    """(c, h, w) of `input`, inferring square maps from the flat size the way
    parse_image does (img_size = sqrt(size / channels))."""
    geom = getattr(input, "_v1_geom", None)
    if geom is not None:
        return geom
    if num_channels is None:
        raise ValueError(
            f"layer {getattr(input, 'name', input)!r} has no image geometry; "
            f"pass num_channels= on the first image layer (v1 convention)"
        )
    size = _size_of(input)
    if size is None:
        raise ValueError(
            f"cannot infer image size of layer {getattr(input, 'name', input)!r}"
        )
    hw = size // num_channels
    # parse_image's rule (config_parser.py get_img_size): width = floor-sqrt
    # of the pixel count, height = pixels / width — square when possible,
    # rectangular otherwise, rejected when indivisible
    w = int(math.isqrt(hw))
    if w == 0 or hw % w:
        raise ValueError(
            f"input size {size} with {num_channels} channels has no "
            f"integer {{w}}x{{h}} factorization from width floor-sqrt "
            f"(parse_image would reject this too)"
        )
    return (num_channels, hw // w, w)


def _is_flat(node: Layer) -> bool:
    """True when the node's values are flat [B, c*h*w] even though image
    geometry may be declared: data layers always feed flat values (the
    provider's dense slot), and elementwise wrappers over them stay flat."""
    return (
        getattr(node, "type_name", None) == "data"
        or getattr(node, "_v1_flat", False)
    )


def _ensure_nhwc(input: Layer, num_channels: Optional[int]):
    """Returns (nhwc_node, (c, h, w)). Inserts the flat-CHW -> NHWC adapter
    when the input is not already an image-layout node. The adapter is cached
    on the input so a data layer feeding several image branches (inception
    towers) reuses one node instead of colliding on names."""
    geom = getattr(input, "_v1_geom", None)
    if geom is not None and not _is_flat(input):
        return input, geom
    cached = getattr(input, "_v1_nhwc_node", None)
    if cached is not None:
        return cached, cached._v1_geom
    c, h, w = geom if geom is not None else _infer_geom(input, num_channels)
    node = L.Reshape(input, (c, h, w), name=f"{input.name}.as_image")
    node = L.SwitchOrder(node, to="NHWC", name=f"{input.name}.to_nhwc")
    _annotate(node, geom=(c, h, w))
    input._v1_nhwc_node = node
    return node, (c, h, w)






def _annotate3d(node: Layer, geom3d) -> Layer:
    c, d, h, w = (int(v) for v in geom3d)
    node._v1_geom3d = (c, d, h, w)
    node._v1_size = c * d * h * w
    return node


def _ensure_ndhwc(input: Layer, num_channels: Optional[int]):
    """3-D analog of _ensure_nhwc: flat [B, c*d*h*w] (CDHW order) → NDHWC."""
    geom3d = getattr(input, "_v1_geom3d", None)
    if geom3d is not None and not _is_flat(input):
        return input, geom3d
    cached = getattr(input, "_v1_ndhwc_node", None)
    if cached is not None:
        return cached, cached._v1_geom3d
    if geom3d is None:
        size = _size_of(input)
        if size is None or num_channels is None:
            raise ValueError(
                f"cannot infer 3-D geometry of {getattr(input, 'name', input)!r}; "
                "declare height/width/depth on the data layer or pass num_channels"
            )
        side = round((size // num_channels) ** (1 / 3))
        geom3d = (num_channels, side, side, side)
    c, d, h, w = geom3d
    node = L.Reshape(input, (c, d, h, w), name=f"{input.name}.as_vol")
    node = L.SwitchOrder(node, to="NDHWC", name=f"{input.name}.to_ndhwc")
    _annotate3d(node, (c, d, h, w))
    input._v1_ndhwc_node = node
    return node, (c, d, h, w)


def img_conv3d_layer(input, filter_size, num_filters=None, name=None,
                     num_channels=None, act=None, groups=1, stride=1,
                     padding=0, bias_attr=None, param_attr=None,
                     shared_biases=True, layer_attr=None,
                     trans=False, layer_type=None, **_compat):
    """layers.py img_conv3d_layer: a flat CDHW data slot gets the NDHWC
    adapter; filter_size / stride / padding are one value for all three
    axes or [d, h, w] lists."""
    ndhwc, (cin, dz, h, w) = _ensure_ndhwc(input, num_channels)
    f = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size,) * 3
    s = stride if isinstance(stride, (list, tuple)) else (stride,) * 3
    p = padding if isinstance(padding, (list, tuple)) else (padding,) * 3
    node = _v2.img_conv3d(
        ndhwc, tuple(f), num_filters, stride=tuple(s), padding=tuple(p),
        groups=groups, act=_act(act),
        bias_attr=bias_attr, param_attr=_or_none(param_attr), name=name,
        trans=trans,
    )
    if trans:
        od = (dz - 1) * s[0] - 2 * p[0] + f[0]
        oh = (h - 1) * s[1] - 2 * p[1] + f[1]
        ow = (w - 1) * s[2] - 2 * p[2] + f[2]
    else:
        od = _conv_out(dz, f[0], p[0], s[0])
        oh = _conv_out(h, f[1], p[1], s[1])
        ow = _conv_out(w, f[2], p[2], s[2])
    return _with_drop(
        _annotate3d(node, (num_filters, od, oh, ow)), layer_attr
    )


def img_pool3d_layer(input, pool_size, name=None, num_channels=None,
                     pool_type=None, stride=1, padding=0, layer_attr=None,
                     ceil_mode=True, **_compat):
    ndhwc, (c, dz, h, w) = _ensure_ndhwc(input, num_channels)
    f = pool_size if isinstance(pool_size, (list, tuple)) else (pool_size,) * 3
    s = stride if isinstance(stride, (list, tuple)) else (stride,) * 3
    p = padding if isinstance(padding, (list, tuple)) else (padding,) * 3
    node = _v2.img_pool3d(ndhwc, tuple(f), pool_type=pool_type,
                          stride=tuple(s), padding=tuple(p), name=name)
    od = _pool_out(dz, f[0], p[0], s[0], ceil_mode)
    oh = _pool_out(h, f[1], p[1], s[1], ceil_mode)
    ow = _pool_out(w, f[2], p[2], s[2], ceil_mode)
    return _with_drop(_annotate3d(node, (c, od, oh, ow)), layer_attr)


def _conv_out(size: int, filt: int, pad: int, stride: int, dilation: int = 1) -> int:
    """caffeMode output size (MathUtils.cpp outputSize, caffeMode=true)."""
    eff = dilation * (filt - 1) + 1
    return (size + 2 * pad - eff) // stride + 1


def _pool_out(size: int, filt: int, pad: int, stride: int, ceil: bool) -> int:
    if ceil:  # v1 img_pool default (MathUtils outputSize caffeMode=false)
        return -(-(size + 2 * pad - filt) // stride) + 1
    return (size + 2 * pad - filt) // stride + 1


def _with_drop(node: Layer, layer_attr) -> Layer:
    out = _v2._with_drop(node, layer_attr)
    if out is not node and hasattr(node, "_v1_geom"):
        _annotate(out, geom=node._v1_geom)
    elif out is not node and _size_of(node) is not None:
        _annotate(out, size=_size_of(node))
    return out


def _or_none(attr):
    return None if isinstance(attr, bool) else attr


# ---------------------------------------------------------------------------
# core layers (layers.py signatures)
# ---------------------------------------------------------------------------


def data_layer(name, size, depth=None, height=None, width=None,
               layer_attr=None):
    """layers.py:916 — flat data slot; height/width (/depth for 3D) declare
    image geometry."""
    node = L.Data(name, shape=(int(size),), is_seq=False)
    _annotate(node, size=size)
    if height and width:
        if depth:
            ch = int(size) // (int(depth) * int(height) * int(width))
            node._v1_geom3d = (ch, int(depth), int(height), int(width))
        else:
            ch = int(size) // (int(height) * int(width))
            node._v1_geom = (ch, int(height), int(width))
    return node


def fc_layer(input, size, act=None, name=None, param_attr=None,
             bias_attr=None, layer_attr=None):
    """layers.py:996 — act defaults to TanhActivation (@wrap_act_default)."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    node = L.Fc(
        list(ins), size, act=_act(act) or "tanh", bias=bias_attr is not False,
        param_attr=_or_none(param_attr), bias_attr=_or_none(bias_attr),
        name=name,
    )
    return _with_drop(_annotate(node, size=size), layer_attr)


def embedding_layer(input, size, name=None, param_attr=None, layer_attr=None):
    """layers.py:963 — vocab comes from the input data layer's declared size."""
    vocab = _size_of(input)
    spec = getattr(input, "data_type", None)
    if spec is not None and spec.kind in ("index", "index_seq"):
        vocab = int(spec.dim)
    elif getattr(input, "type_name", None) == "data" and spec is None:
        # v1: a data layer feeding an embedding is an id slot (TableProjection
        # consumes ids); record it so the auto feeder treats it as ids
        from paddle_tpu_torch.data.feeder import integer_value

        input.data_type = integer_value(vocab or 0)
        input.shape = ()
    node = L.Embedding(input, size, vocab_size=vocab,
                       param_attr=_or_none(param_attr), name=name)
    return _with_drop(_annotate(node, size=size), layer_attr)


def dropout_layer(input, dropout_rate, name=None):
    node = L.Dropout(input, dropout_rate, name=name)
    if hasattr(input, "_v1_geom"):
        _annotate(node, geom=input._v1_geom)
        if _is_flat(input):  # elementwise: stays flat if the input was flat
            node._v1_flat = True
    elif _size_of(input) is not None:
        _annotate(node, size=_size_of(input))
    return node


def img_conv_layer(input, filter_size, num_filters, name=None,
                   num_channels=None, act=None, groups=1, stride=1, padding=0,
                   dilation=1, bias_attr=None, param_attr=None,
                   shared_biases=True, layer_attr=None, filter_size_y=None,
                   stride_y=None, padding_y=None, dilation_y=None,
                   trans=False, layer_type=None):
    """layers.py:2373 — act defaults to ReluActivation (@wrap_act_default);
    non-square kernels via the *_y parameters or (x, y) pairs; trans=True is
    deconv."""
    nhwc, (cin, h, w) = _ensure_nhwc(input, num_channels)
    # the reference unpacks sequence args as (x, y) pairs (layers.py:2525)
    if isinstance(filter_size, (tuple, list)):
        filter_size, filter_size_y = filter_size
    if isinstance(stride, (tuple, list)):
        stride, stride_y = stride
    if isinstance(padding, (tuple, list)):
        padding, padding_y = padding
    if isinstance(dilation, (tuple, list)):
        dilation, dilation_y = dilation
    fy = filter_size_y if filter_size_y is not None else filter_size
    sy = stride_y if stride_y is not None else stride
    py = padding_y if padding_y is not None else padding
    dy = dilation_y if dilation_y is not None else dilation
    kwargs = dict(
        num_filters=num_filters,
        filter_size=(fy, filter_size),  # (h, w): *_y is the vertical extent
        stride=(sy, stride),
        padding=(py, padding),
        act=_act(act) or "relu",
        bias=bias_attr is not False,
        param_attr=_or_none(param_attr),
        bias_attr=_or_none(bias_attr),
        name=name,
    )
    if trans:
        node = L.Conv2DTranspose(nhwc, **kwargs)
        oh = (h - 1) * sy - 2 * py + fy
        ow = (w - 1) * stride - 2 * padding + filter_size
    else:
        node = L.Conv2D(nhwc, dilation=(dy, dilation), groups=groups, **kwargs)
        oh = _conv_out(h, fy, py, sy, dy)
        ow = _conv_out(w, filter_size, padding, stride, dilation)
    return _with_drop(_annotate(node, geom=(num_filters, oh, ow)), layer_attr)


def img_pool_layer(input, pool_size, name=None, num_channels=None,
                   pool_type=None, stride=1, padding=0, layer_attr=None,
                   pool_size_y=None, stride_y=None, padding_y=None,
                   ceil_mode=True):
    """layers.py:2568 — pool_type defaults to MaxPooling; ceil_mode=True is
    the v1 default output-size rule."""
    nhwc, (c, h, w) = _ensure_nhwc(input, num_channels)
    fy = pool_size_y if pool_size_y is not None else pool_size
    sy = stride_y if stride_y is not None else stride
    py = padding_y if padding_y is not None else padding
    ptype = _pool_name(pool_type) if pool_type is not None else "max"
    if ptype not in ("max", "avg"):
        raise ValueError(f"img_pool_layer supports max/avg, got {ptype!r}")
    node = L.Pool2D(
        nhwc, (fy, pool_size), ptype, stride=(sy, stride),
        padding=(py, padding), ceil_mode=ceil_mode, name=name,
    )
    oh = _pool_out(h, fy, py, sy, ceil_mode)
    ow = _pool_out(w, pool_size, padding, stride, ceil_mode)
    return _with_drop(_annotate(node, geom=(c, oh, ow)), layer_attr)


def img_cmrnorm_layer(input, size, scale=0.0128, power=0.75, name=None,
                      num_channels=None, layer_attr=None):
    """layers.py:2931 — cross-map response normalization (AlexNet LRN)."""
    nhwc, geom = _ensure_nhwc(input, num_channels)
    node = _v2.img_cmrnorm(nhwc, size, scale=scale, power=power, name=name)
    return _with_drop(_annotate(node, geom=geom), layer_attr)


def batch_norm_layer(input, act=None, name=None, img3D=False,
                     num_channels=None, bias_attr=None, param_attr=None,
                     layer_attr=None, batch_norm_type=None,
                     epsilon=1e-5, moving_average_fraction=0.9,
                     use_global_stats=None, mean_var_names=None):
    """layers.py batch_norm_layer — on image input keeps geometry (and must
    normalize per channel, so flat image data goes through the NHWC adapter
    first, matching CudnnBatchNorm's per-channel statistics)."""
    geom = getattr(input, "_v1_geom", None)
    geom3d = getattr(input, "_v1_geom3d", None)
    node_in = input
    if img3D and (geom3d is not None or num_channels is not None):
        if geom3d is None:
            size = _size_of(input)
            side = round((size // num_channels) ** (1 / 3))
            geom3d = (num_channels, side, side, side)
        c, d, h, w = geom3d
        cached = getattr(input, "_v1_ndhwc_node", None)
        if cached is not None:
            node_in = cached
        else:
            node_in = L.Reshape(input, (c, d, h, w), name=f"{input.name}.as_vol")
            node_in = L.SwitchOrder(node_in, to="NDHWC", name=f"{input.name}.to_ndhwc")
            input._v1_ndhwc_node = node_in
    elif geom is not None or num_channels is not None:
        node_in, geom = _ensure_nhwc(input, num_channels)
    node = L.BatchNorm(
        # @wrap_act_default(act=ReluActivation()) on the reference helper
        node_in, act=_act(act) if act is not None else "relu", epsilon=epsilon,
        moving_average_fraction=moving_average_fraction,
        use_global_stats=use_global_stats, param_attr=_or_none(param_attr),
        bias_attr=_or_none(bias_attr), name=name,
    )
    if geom is not None:
        _annotate(node, geom=geom)
    elif _size_of(input) is not None:
        _annotate(node, size=_size_of(input))
    return _with_drop(node, layer_attr)




def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, groups=1, param_attr=None,
                    trans=False, filter_size_y=None, stride_y=None,
                    padding_y=None):
    from paddle_tpu_torch.nn.projections import ConvProj

    if filter_size_y is not None:
        filter_size = (filter_size_y, filter_size)
    if stride_y is not None:
        stride = (stride_y, stride)
    if padding_y is not None:
        padding = (padding_y, padding)

    if num_channels is None:
        geom = getattr(input, "_v1_geom", None)
        num_channels = geom[0] if geom else None
    return ConvProj(input, filter_size, num_filters,
                    num_channels=num_channels, stride=stride, padding=padding,
                    groups=groups, param_attr=_or_none(param_attr), trans=trans)


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0, filter_size_y=None, stride_y=None,
                  padding_y=None, trans=False):
    from paddle_tpu_torch.nn.projections import ConvOperator

    if num_channels is None:
        geom = getattr(img, "_v1_geom", None)
        num_channels = geom[0] if geom else None
    return ConvOperator(img, filter, filter_size, num_filters,
                        num_channels=num_channels, stride=stride,
                        padding=padding, trans=trans)


def concat_layer(input, act=None, name=None, layer_attr=None, bias_attr=None):
    """layers.py:3252 — concatenates layers, or applies projections then
    concatenates (the reference's concat2/ConcatenateLayer2 path, which is
    what GoogleNet's inception blocks use with conv_projection inputs)."""
    ins = list(input) if isinstance(input, (list, tuple)) else [input]
    built: List[Layer] = []
    for i, item in enumerate(ins):
        if not isinstance(item, Layer) and not hasattr(item, "build"):
            # plain projections → ConcatenateLayer2 applying them in place
            from paddle_tpu_torch.nn.projections import Projection

            assert all(isinstance(x, Projection) for x in ins), (
                "concat_layer mixes projections and layers"
            )
            node = L.Concat2(ins, act=_act(act),
                             bias=bias_attr not in (None, False),
                             bias_attr=_or_none(bias_attr), name=name)
            return _with_drop(node, layer_attr)
        if hasattr(item, "build") and not isinstance(item, Layer):
            built.append(item.build(f"{name}.proj{i}" if name else None))
        elif _is_flat(item) and getattr(item, "_v1_geom", None) is not None:
            built.append(_ensure_nhwc(item, None)[0])  # channel concat needs NHWC
        else:
            built.append(item)
    geoms = [getattr(b, "_v1_geom", None) for b in built]
    node = L.Concat(built, act=None, name=name)
    out_geom = None
    if all(g is not None for g in geoms):
        c = sum(g[0] for g in geoms)
        out_geom = (c, geoms[0][1], geoms[0][2])
        _annotate(node, geom=out_geom)
    else:
        sizes = [_size_of(b) for b in built]
        if all(s is not None for s in sizes):
            _annotate(node, size=sum(sizes))
    act_name = _act(act)
    if bias_attr not in (None, False) or (act_name and act_name != "linear"):
        # concat2 semantics: shared bias + activation applied on the result
        node = L.Addto([node], act=act_name, bias=bias_attr not in (None, False),
                       bias_attr=_or_none(bias_attr),
                       name=f"{name}.out" if name else None)
        if out_geom is not None:
            _annotate(node, geom=out_geom)
    return _with_drop(node, layer_attr)


def pooling_layer(input, pooling_type=None, name=None, bias_attr=None,
                  agg_level=None, stride=-1, layer_attr=None):
    """layers.py:1343 — sequence pooling; pooling_type defaults MaxPooling.
    stride>0 pools fixed windows (SequencePoolLayer stride mode);
    agg_level=AggregateLevel.TO_SEQUENCE pools within subsequences."""
    _mark_seq_root(input)
    nm = _pool_name(pooling_type) if pooling_type is not None else "max"
    seq_kind = {"max": "max", "avg": "average", "sum": "sum", "sqrt": "sqrt"}[nm]
    node = S.SeqPool(input, seq_kind, name=name, agg_level=agg_level,
                     stride=-1 if stride is None else stride)
    if getattr(pooling_type, "output_max_index", None):
        node.output_max_index = True
    sz = _size_of(input)
    if sz is not None:
        _annotate(node, size=sz)
    return _with_drop(node, layer_attr)


def last_seq(input, agg_level=None, stride=-1, name=None, layer_attr=None):
    _mark_seq_root(input)
    node = _v2.last_seq(input, agg_level=agg_level, stride=stride, name=name)
    sz = _size_of(input)
    if sz is not None:
        _annotate(node, size=sz)
    return _with_drop(node, layer_attr)


def first_seq(input, agg_level=None, stride=-1, name=None, layer_attr=None):
    _mark_seq_root(input)
    node = _v2.first_seq(input, agg_level=agg_level, stride=stride, name=name)
    sz = _size_of(input)
    if sz is not None:
        _annotate(node, size=sz)
    return _with_drop(node, layer_attr)


def expand_layer(input, expand_as, name=None, bias_attr=None,
                 expand_level=None, layer_attr=None):
    _mark_seq_root(expand_as)
    node = _v2.expand(input, expand_as, expand_level=expand_level, name=name)
    sz = _size_of(input)
    if sz is not None:
        _annotate(node, size=sz)
    return _with_drop(node, layer_attr)


def seq_slice_layer(input, starts=None, ends=None, name=None):
    _mark_seq_root(input)
    return _v2.seq_slice(input, starts=starts, ends=ends, name=name)


def kmax_sequence_score_layer(input, name=None, beam_size=1):
    _mark_seq_root(input)
    return _v2.kmax_seq_score(input, beam_size=beam_size, name=name)


def seq_concat_layer(a, b, act=None, name=None, layer_attr=None,
                     bias_attr=None):
    _mark_seq_root(a)
    _mark_seq_root(b)
    node = S.SeqConcat(a, b, name=name)
    sz = _size_of(a)
    if sz is not None:
        _annotate(node, size=sz)
    return _with_drop(node, layer_attr)


def seq_reshape_layer(input, reshape_size, act=None, name=None,
                      layer_attr=None, bias_attr=None):
    _mark_seq_root(input)
    node = _v2.seq_reshape(input, reshape_size, name=name)
    _annotate(node, size=reshape_size)
    return _with_drop(node, layer_attr)


def sub_nested_seq_layer(input, selected_indices, name=None):
    _mark_seq_root(input, nested=True)
    return _v2.sub_nested_seq(input, selected_indices, name=name)


def maxid_layer(input, name=None, layer_attr=None):
    return _with_drop(_v2.max_id(input, name=name), layer_attr)


def lstmemory(input, name=None, size=None, reverse=False, act=None,
              gate_act=None, state_act=None, bias_attr=None, param_attr=None,
              layer_attr=None):
    """layers.py lstmemory: input is the pre-projected [4*size] mixed/fc."""
    _mark_seq_root(input)
    if size is None:
        insz = _size_of(input)
        size = insz // 4 if insz else None
    node = _v2.lstmemory(input, size=size, reverse=reverse, act=act,
                         gate_act=gate_act, state_act=state_act,
                         param_attr=_or_none(param_attr),
                         bias_attr=bias_attr, name=name)
    if size:
        _annotate(node, size=size)
    return _with_drop(node, layer_attr)


def grumemory(input, name=None, size=None, reverse=False, act=None,
              gate_act=None, bias_attr=None, param_attr=None, layer_attr=None):
    """layers.py grumemory: input is the pre-projected [3*size] mixed/fc."""
    _mark_seq_root(input)
    if size is None:
        insz = _size_of(input)
        size = insz // 3 if insz else None
    node = _v2.grumemory(input, size=size, reverse=reverse, act=act,
                         gate_act=gate_act, param_attr=_or_none(param_attr),
                         bias_attr=bias_attr, name=name)
    if size:
        _annotate(node, size=size)
    return _with_drop(node, layer_attr)


def recurrent_layer(input, act=None, bias_attr=None, param_attr=None,
                    name=None, reverse=False, layer_attr=None):
    _mark_seq_root(input)
    node = _v2.recurrent(input, act=act, reverse=reverse,
                         bias_attr=bias_attr, param_attr=_or_none(param_attr),
                         name=name)
    sz = _size_of(input)
    if sz:
        _annotate(node, size=sz)
    return _with_drop(node, layer_attr)


def maxout_layer(input, groups, num_channels=None, name=None, layer_attr=None):
    nhwc, (c, h, w) = _ensure_nhwc(input, num_channels)
    node = _v2.maxout(nhwc, groups, name=name)
    return _with_drop(_annotate(node, geom=(c // groups, h, w)), layer_attr)


def bilinear_interp_layer(input, out_size_x=None, out_size_y=None, name=None,
                          layer_attr=None):
    nhwc, (c, h, w) = _ensure_nhwc(input, None)
    node = _v2.bilinear_interp(nhwc, out_size_x, out_size_y, name=name)
    return _with_drop(_annotate(node, geom=(c, out_size_y, out_size_x)), layer_attr)


def spp_layer(input, name=None, num_channels=None, pool_type=None,
              pyramid_height=None, layer_attr=None):
    nhwc, (c, h, w) = _ensure_nhwc(input, num_channels)
    node = _v2.spp(nhwc, pyramid_height=pyramid_height, pool_type=pool_type,
                   name=name)
    bins = sum(4 ** i for i in range(pyramid_height))
    return _with_drop(_annotate(node, size=c * bins), layer_attr)


def row_conv_layer(input, context_len, act=None, name=None, param_attr=None,
                   layer_attr=None):
    _mark_seq_root(input)
    node = _v2.row_conv(input, context_len, act=act,
                        param_attr=_or_none(param_attr), name=name)
    sz = _size_of(input)
    if sz:
        _annotate(node, size=sz)
    return _with_drop(node, layer_attr)


def block_expand_layer(input, block_x=0, block_y=0, stride_x=0, stride_y=0,
                       padding_x=0, padding_y=0, num_channels=None, name=None,
                       layer_attr=None):
    nhwc, (c, h, w) = _ensure_nhwc(input, num_channels)
    node = _v2.block_expand(nhwc, block_x=block_x, block_y=block_y,
                            stride_x=stride_x or block_x,
                            stride_y=stride_y or block_y,
                            padding_x=padding_x, padding_y=padding_y,
                            name=name)
    _annotate(node, size=c * block_x * block_y)
    return _with_drop(node, layer_attr)


def multibox_loss_layer(input_loc, input_conf, priorbox, label, num_classes,
                        overlap_threshold=0.5, neg_pos_ratio=3.0,
                        neg_overlap=0.5, background_id=0, name=None):
    """layers.py multibox_loss_layer: packed v1 slots (priorbox rows of 8,
    label rows of 6) in the reference input order."""
    locs = input_loc if isinstance(input_loc, (list, tuple)) else [input_loc]
    confs = input_conf if isinstance(input_conf, (list, tuple)) else [input_conf]
    node = D.MultiBoxLossV1(
        list(locs), list(confs), priorbox, label, num_classes,
        overlap_threshold=overlap_threshold, neg_pos_ratio=neg_pos_ratio,
        neg_overlap=neg_overlap, background_id=background_id, name=name,
    )
    return _annotate(node, size=1)


def detection_output_layer(input_loc, input_conf, priorbox, num_classes,
                           nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                           confidence_threshold=0.01, background_id=0,
                           name=None):
    locs = input_loc if isinstance(input_loc, (list, tuple)) else [input_loc]
    confs = input_conf if isinstance(input_conf, (list, tuple)) else [input_conf]
    node = D.DetectionOutputV1(
        list(locs), list(confs), priorbox, num_classes,
        nms_threshold=nms_threshold, nms_top_k=nms_top_k,
        keep_top_k=keep_top_k, confidence_threshold=confidence_threshold,
        background_id=background_id, name=name,
    )
    return _annotate(node, size=keep_top_k * 7)


def lambda_cost(input, score, name=None, NDCG_num=5, max_sort_size=-1,
                layer_attr=None):
    """LambdaRank works on score sequences (LambdaCost.cpp)."""
    _mark_seq_root(input)
    _mark_seq_root(score)
    return _with_drop(
        _v2.lambda_cost(input, score, NDCG_num=NDCG_num, name=name),
        layer_attr,
    )


def _mark_label_as_id_seq(label: Layer) -> None:
    """Sequence-label costs (ctc/crf): the label slot is an id sequence."""
    from paddle_tpu_torch.data.feeder import integer_value_sequence

    if getattr(label, "type_name", None) == "data" and (
        getattr(label, "data_type", None) is None
        or label.data_type.kind in ("dense", "index")
    ):
        label.data_type = integer_value_sequence(_size_of(label) or 0)
        label.shape = ()
        label.is_seq = True


def ctc_layer(input, label, size=None, name=None, norm_by_times=False,
              layer_attr=None):
    """layers.py ctc_layer: size defaults to the input layer's size (the
    alphabet incl. blank, CTCLayer.cpp)."""
    _mark_seq_root(input)
    lbl_size = _size_of(label)
    _mark_label_as_id_seq(label)
    if size is None:  # layers.py:5251: size = label dict size + 1 (blank last)
        size = (lbl_size + 1) if lbl_size else _size_of(input)
    return _with_drop(
        _v2.ctc(input, label, size=size, norm_by_times=norm_by_times, name=name),
        layer_attr,
    )


def warp_ctc_layer(input, label, size=None, name=None, blank=0,
                   norm_by_times=False, layer_attr=None):
    _mark_seq_root(input)
    lbl_size = _size_of(label)
    _mark_label_as_id_seq(label)
    if size is None:
        size = (lbl_size + 1) if lbl_size else _size_of(input)
    return _with_drop(
        _v2.warp_ctc(input, label, size=size, blank=blank,
                     norm_by_times=norm_by_times, name=name),
        layer_attr,
    )


def crf_layer(input, label, size=None, weight=None, param_attr=None,
              name=None, coeff=1.0, layer_attr=None):
    _mark_seq_root(input)
    _mark_label_as_id_seq(label)
    return _with_drop(
        _v2.crf(input, label, size=size or _size_of(input),
                param_attr=_or_none(param_attr), name=name, coeff=coeff),
        layer_attr,
    )


def crf_decoding_layer(input, size=None, label=None, param_attr=None,
                       name=None, layer_attr=None):
    _mark_seq_root(input)
    if label is not None:
        _mark_label_as_id_seq(label)
    return _with_drop(
        _v2.crf_decoding(input, size=size or _size_of(input), label=label,
                         param_attr=_or_none(param_attr), name=name),
        layer_attr,
    )


def nce_layer(input, label, num_classes=None, weight=None, num_neg_samples=10,
              neg_distribution=None, name=None, bias_attr=None,
              param_attr=None, layer_attr=None):
    """layers.py nce_layer: num_classes defaults to the label layer's size."""
    _mark_label_as_ids(label)
    if num_classes is None:
        num_classes = _size_of(label) or 0
    return _with_drop(
        _v2.nce(input, label, num_classes, weight=weight,
                num_neg_samples=num_neg_samples,
                neg_distribution=neg_distribution, bias_attr=bias_attr,
                param_attr=_or_none(param_attr), name=name),
        layer_attr,
    )


def hsigmoid(input, label, num_classes=None, name=None, bias_attr=None,
             param_attr=None, layer_attr=None):
    _mark_label_as_ids(label)
    if num_classes is None:
        num_classes = _size_of(label) or 0
    return _with_drop(
        _v2.hsigmoid(input, label, num_classes, bias_attr=bias_attr,
                     param_attr=_or_none(param_attr), name=name),
        layer_attr,
    )


def _mark_seq_root(node: Layer, nested: bool = False) -> None:
    """A sequence-consuming wrapper (seq pooling, lstm/gru, context conv)
    reveals that the data layers feeding it carry sequences — information the
    reference gets from the provider's input_types at runtime
    (PyDataProvider2 slot binding). Walk back to the data roots and mark
    them, so shape inference and auto-built feeders produce [B, T, ...]
    (nested=True → SUB_SEQUENCE slots, [B, S, T, ...])."""
    from paddle_tpu_torch.data.feeder import (
        dense_vector_sequence,
        dense_vector_sub_sequence,
        integer_value_sequence,
        integer_value_sub_sequence,
    )

    seen = set()
    stack = [node]
    while stack:
        cur = stack.pop()
        if id(cur) in seen:
            continue
        seen.add(id(cur))
        if getattr(cur, "type_name", None) == "data":
            cur.is_seq = True
            spec = getattr(cur, "data_type", None)
            if spec is None and nested:
                cur.data_type = dense_vector_sub_sequence(_size_of(cur) or 1)
            elif spec is not None and spec.kind == "index":
                cur.data_type = (
                    integer_value_sub_sequence(int(spec.dim))
                    if nested
                    else integer_value_sequence(int(spec.dim))
                )
            elif spec is not None and spec.kind == "dense":
                cur.data_type = (
                    dense_vector_sub_sequence(spec.dim)
                    if nested
                    else dense_vector_sequence(spec.dim)
                )
            elif spec is not None and spec.kind == "dense_seq" and nested:
                cur.data_type = dense_vector_sub_sequence(spec.dim)
            elif spec is not None and spec.kind == "index_seq" and nested:
                cur.data_type = integer_value_sub_sequence(int(spec.dim))
            continue
        stack.extend(getattr(cur, "inputs", []) or [])


def _mark_label_as_ids(label: Layer) -> None:
    """v1 declares label data layers by class count (data_layer('label', 10))
    and the provider feeds integer ids; multi-class cost layers are what
    reveal the id-ness. Rewrite the data layer to an index slot so shape
    inference and auto-built feeders treat it as ids (what PyDataProvider2's
    integer_value slot binding does at runtime)."""
    if getattr(label, "type_name", None) != "data":
        return
    if getattr(label, "data_type", None) is not None:
        return
    from paddle_tpu_torch.data.feeder import integer_value

    n = _size_of(label) or 0
    label.data_type = integer_value(n)
    label.shape = ()


def classification_cost(input, label, weight=None, name=None,
                        evaluator=None, layer_attr=None, coeff=1.):
    """layers.py:4347 — input is the (typically softmax-activated) output
    layer; declares a classification_error evaluator like the reference."""
    from paddle_tpu_torch.config import helpers as _h

    _mark_label_as_ids(label)
    from_logits = _act(_v2.effective_act(input)) != "softmax"
    node = C.ClassificationCost(
        input, label, weight=weight, name=name, coeff=coeff,
        from_logits=from_logits,
    )
    # the default evaluator declaration (the reference's default argument)
    if evaluator is None:
        _h.classification_error_evaluator(input=input, label=label, weight=weight)
    elif callable(evaluator):
        evaluator(input=input, label=label, weight=weight)
    return _with_drop(node, layer_attr)


def cross_entropy(input, label, name=None, coeff=1.0, weight=None,
                  layer_attr=None):
    """layers.py:5738 — input already carries its output activation."""
    _mark_label_as_ids(label)
    from_logits = _act(_v2.effective_act(input)) != "softmax"
    node = C.ClassificationCost(
        input, label, weight=weight, name=name, coeff=coeff,
        from_logits=from_logits,
    )
    return _with_drop(node, layer_attr)


# ---------------------------------------------------------------------------
# networks.py composites (reference signatures)
# ---------------------------------------------------------------------------


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0,
                   pool_stride=1, pool_type=None, param_attr=None):
    """networks.py:336 — the VGG conv block."""
    n = len(conv_num_filter)

    def bc(v, default):
        if isinstance(v, (list, tuple)):
            return list(v)
        return [v if v is not None else default] * n

    paddings = bc(conv_padding, 1)
    fsizes = bc(conv_filter_size, 3)
    acts = bc(conv_act, None)
    with_bn = bc(conv_with_batchnorm, False)
    bn_drop = bc(conv_batchnorm_drop_rate, 0)

    tmp = input
    for i in range(n):
        tmp = img_conv_layer(
            tmp, fsizes[i], conv_num_filter[i],
            num_channels=num_channels if i == 0 else None,
            padding=paddings[i],
            act="linear" if with_bn[i] else (acts[i] or "relu"),
            param_attr=param_attr,
        )
        if with_bn[i]:
            from paddle_tpu_torch.v2.attr import ExtraAttr

            tmp = batch_norm_layer(
                tmp, act=acts[i] or "relu",
                layer_attr=ExtraAttr(drop_rate=bn_drop[i]) if bn_drop[i] else None,
            )
    return img_pool_layer(tmp, pool_size, stride=pool_stride,
                          pool_type=pool_type)


def simple_img_conv_pool(input, filter_size, num_filters, pool_size, name=None,
                         pool_type=None, act=None, groups=1, conv_stride=1,
                         conv_padding=0, bias_attr=None, num_channel=None,
                         param_attr=None, shared_bias=True, conv_layer_attr=None,
                         pool_stride=1, pool_padding=0, pool_layer_attr=None):
    """networks.py:144."""
    conv = img_conv_layer(
        input, filter_size, num_filters, name=f"{name}_conv" if name else None,
        num_channels=num_channel, act=act, groups=groups, stride=conv_stride,
        padding=conv_padding, bias_attr=bias_attr, param_attr=param_attr,
        shared_biases=shared_bias, layer_attr=conv_layer_attr,
    )
    return img_pool_layer(
        conv, pool_size, name=f"{name}_pool" if name else None,
        pool_type=pool_type, stride=pool_stride, padding=pool_padding,
        layer_attr=pool_layer_attr,
    )


def sequence_conv_pool(input, context_len, hidden_size, name=None,
                       context_start=None, pool_type=None,
                       context_proj_layer_name=None,
                       context_proj_param_attr=False, fc_layer_name=None,
                       fc_param_attr=None, fc_bias_attr=None, fc_act=None,
                       pool_bias_attr=None, fc_attr=None, context_attr=None,
                       pool_attr=None):
    """networks.py:40 — context projection + fc + sequence pooling (the
    text-CNN block used by quick_start's trainer_config.cnn.py)."""
    from paddle_tpu_torch.nn import projections as P

    _mark_seq_root(input)
    start = context_start if context_start is not None else -(context_len // 2)
    in_size = _size_of(input)
    proj_size = (in_size or 0) * context_len
    ctxp = L.Mixed(
        [P.Context_(input, start, context_len,
                    trainable_padding=bool(context_proj_param_attr))],
        size=proj_size or None,
        name=context_proj_layer_name or (f"{name}.context" if name else None),
    )
    if in_size is not None:
        _annotate(ctxp, size=proj_size)
    fc = fc_layer(
        ctxp, hidden_size, act=fc_act or "linear",
        name=fc_layer_name or (f"{name}.fc" if name else None),
        param_attr=fc_param_attr, bias_attr=fc_bias_attr, layer_attr=fc_attr,
    )
    return pooling_layer(fc, pooling_type=pool_type, name=name,
                         bias_attr=pool_bias_attr, layer_attr=pool_attr)


def text_conv_pool(input, context_len=5, hidden_size=128, act=None, **kw):
    return sequence_conv_pool(input, context_len, hidden_size, fc_act=act, **kw)


def simple_lstm(input, size, name=None, reverse=False, mat_param_attr=None,
                bias_param_attr=None, inner_param_attr=None, act=None,
                gate_act=None, state_act=None, mixed_layer_attr=None,
                lstm_cell_attr=None):
    """networks.py:553 — fc(4H) projection + lstmemory."""
    _mark_seq_root(input)
    proj = fc_layer(
        input, size * 4, act="linear", name=f"{name}.input_proj" if name else None,
        param_attr=mat_param_attr, bias_attr=False, layer_attr=mixed_layer_attr,
    )
    node = R.Lstm(
        proj, size=size, reverse=reverse, act=_act(act) or "tanh",
        gate_act=_act(gate_act) or "sigmoid",
        state_act=_act(state_act) or "tanh",
        param_attr=_or_none(inner_param_attr),
        bias_attr=_or_none(bias_param_attr), name=name,
    )
    return _with_drop(_annotate(node, size=size), lstm_cell_attr)


def recurrent_group(step, input, reverse=False, name=None, targetInlink=None,
                    **_compat):
    """layers.py recurrent_group: marks the iterated data roots as (nested)
    sequences, then builds the group (nn/recurrent_group.py)."""
    items = input if isinstance(input, (list, tuple)) else [input]
    for item in items:
        if isinstance(item, _v2.SubsequenceInput):
            _mark_seq_root(item.input, nested=True)
        elif isinstance(item, Layer):
            _mark_seq_root(item)
    return _v2.recurrent_group(step, input, reverse=reverse, name=name)


def lstm_step_layer(input, state, size=None, act=None, gate_act=None,
                    state_act=None, bias_attr=None, name=None, layer_attr=None):
    """layers.py lstm_step_layer — one LSTM cell step inside a group."""
    if size is None:
        size = (_size_of(input) or 0) // 4
    node = R.LstmStep(
        input, state, size, act=_act(act), gate_act=_act(gate_act),
        state_act=_act(state_act), bias=bias_attr is not False,
        bias_attr=_or_none(bias_attr), name=name,
    )
    return _with_drop(_annotate(node, size=size), layer_attr)


def gru_step_layer(input, output_mem, size=None, act=None, gate_act=None,
                   bias_attr=None, param_attr=None, name=None,
                   layer_attr=None):
    """layers.py gru_step_layer — one GRU step inside a group."""
    if size is None:
        size = (_size_of(input) or 0) // 3
    node = R.GruStep(
        input, output_mem, size, act=_act(act), gate_act=_act(gate_act),
        bias=bias_attr is not False, bias_attr=_or_none(bias_attr),
        param_attr=_or_none(param_attr), name=name,
    )
    return _with_drop(_annotate(node, size=size), layer_attr)


gru_step_naive_layer = gru_step_layer


def get_output_layer(input, arg_name, name=None, layer_attr=None):
    """Dual-role get_output_layer: inside a step net it reads a layer's
    auxiliary output arg (GetOutputLayer); on a finished recurrent_group it
    fetches another step output sequence."""
    if hasattr(input, "_group_core") or hasattr(input, "core"):
        return _v2.get_output_layer(input, arg_name, name=name)
    return R.StepArgOutput(input, arg_name, name=name)


def lstmemory_unit(input, out_memory=None, name=None, size=None,
                   param_attr=None, act=None, gate_act=None, state_act=None,
                   input_proj_bias_attr=None, input_proj_layer_attr=None,
                   lstm_bias_attr=None, lstm_layer_attr=None):
    """networks.py lstmemory_unit: the in-group LSTM step — input+recurrent
    mixed projection, lstm_step, state published for the state memory."""
    if size is None:
        size = (_size_of(input) or 0) // 4
    out_mem = _v2.memory(name=name, size=size) if out_memory is None else out_memory
    state_mem = _v2.memory(name=f"{name}_state", size=size)
    m = _v2.mixed(
        size=size * 4,
        name=f"{name}_input_recurrent",
        bias_attr=input_proj_bias_attr,
        layer_attr=input_proj_layer_attr,
        act="linear",
        input=[
            _v2.identity_projection(input=input),
            _v2.full_matrix_projection(input=out_mem, param_attr=_or_none(param_attr)),
        ],
    )
    _annotate(m, size=size * 4)
    lstm_out = lstm_step_layer(
        name=name, input=m, state=state_mem, size=size,
        bias_attr=lstm_bias_attr, act=act, gate_act=gate_act,
        state_act=state_act, layer_attr=lstm_layer_attr,
    )
    get_output_layer(name=f"{name}_state", input=lstm_out, arg_name="state")
    return lstm_out


def lstmemory_group(input, size=None, name=None, out_memory=None,
                    reverse=False, param_attr=None, act=None, gate_act=None,
                    state_act=None, input_proj_bias_attr=None,
                    input_proj_layer_attr=None, lstm_bias_attr=None,
                    lstm_layer_attr=None):
    """networks.py lstmemory_group: lstmemory_unit unrolled by
    recurrent_group (the layer-composed LSTM, vs the fused lstmemory)."""
    _mark_seq_root(input)
    if size is None:
        size = (_size_of(input) or 0) // 4

    def __lstm_step__(ipt):
        return lstmemory_unit(
            input=ipt, name=name, size=size, act=act, gate_act=gate_act,
            state_act=state_act, out_memory=out_memory,
            input_proj_bias_attr=input_proj_bias_attr,
            input_proj_layer_attr=input_proj_layer_attr,
            param_attr=param_attr, lstm_layer_attr=lstm_layer_attr,
            lstm_bias_attr=lstm_bias_attr,
        )

    node = _v2.recurrent_group(
        name=f"{name}_recurrent_group", step=__lstm_step__, reverse=reverse,
        input=input,
    )
    return _annotate(node, size=size)


def gru_unit(input, memory_boot=None, size=None, name=None, gru_bias_attr=None,
             gru_param_attr=None, act=None, gate_act=None, gru_layer_attr=None,
             naive=False):
    """networks.py gru_unit: in-group GRU step with its output memory."""
    if size is None:
        size = (_size_of(input) or 0) // 3
    out_mem = _v2.memory(name=name, size=size, boot_layer=memory_boot)
    return gru_step_layer(
        name=name, input=input, output_mem=out_mem, size=size,
        bias_attr=gru_bias_attr, param_attr=gru_param_attr, act=act,
        gate_act=gate_act, layer_attr=gru_layer_attr,
    )


def gru_group(input, memory_boot=None, size=None, name=None, reverse=False,
              gru_bias_attr=None, gru_param_attr=None, act=None,
              gate_act=None, gru_layer_attr=None, naive=False):
    """networks.py gru_group: gru_unit unrolled by recurrent_group."""
    _mark_seq_root(input)
    if size is None:
        size = (_size_of(input) or 0) // 3

    def __gru_step__(ipt):
        return gru_unit(
            input=ipt, memory_boot=memory_boot, name=name, size=size,
            gru_bias_attr=gru_bias_attr, gru_param_attr=gru_param_attr,
            act=act, gate_act=gate_act, gru_layer_attr=gru_layer_attr,
            naive=naive,
        )

    node = _v2.recurrent_group(
        name=f"{name}_recurrent_group", step=__gru_step__, reverse=reverse,
        input=input,
    )
    return _annotate(node, size=size)


def gated_unit_layer(input, size, act=None, name=None, gate_attr=None,
                     gate_param_attr=None, gate_bias_attr=True,
                     inproj_attr=None, inproj_param_attr=None,
                     inproj_bias_attr=True, layer_attr=None):
    """layers.py gated_unit_layer: input_proj fc ⊙ sigmoid gate fc via a
    dot_mul-operator mixed (GLU)."""
    input_proj = fc_layer(
        input=input, name=f"{name}_input_proj", size=size,
        act=act if act is not None else "linear",
        layer_attr=inproj_attr, param_attr=inproj_param_attr,
        bias_attr=inproj_bias_attr,
    )
    gate = fc_layer(
        input=input, name=f"{name}_gate", size=size, act="sigmoid",
        layer_attr=gate_attr, param_attr=gate_param_attr,
        bias_attr=gate_bias_attr,
    )
    node = _v2.mixed(
        size=size,
        input=_v2.dotmul_operator(input_proj, gate),
        name=f"{name}_gated_act", layer_attr=layer_attr,
    )
    return _annotate(node, size=size)


def _gru_transform(input, size, name, param_attr, bias_attr, layer_attr):
    """The `%s_transform` mixed(3H) projection both simple_gru variants
    share (networks.py simple_gru/simple_gru2)."""
    _mark_seq_root(input)
    m = _v2.mixed(
        size=size * 3,
        input=[_v2.full_matrix_projection(input, param_attr=_or_none(param_attr))],
        bias_attr=bias_attr,
        name=f"{name}_transform" if name else None,
        layer_attr=layer_attr,
    )
    return _annotate(m, size=size * 3)


def simple_gru(input, size, name=None, reverse=False, mixed_param_attr=None,
               mixed_bias_param_attr=None, mixed_layer_attr=None,
               gru_param_attr=None, gru_bias_attr=None, act=None,
               gate_act=None, gru_layer_attr=None, naive=False):
    """networks.py:981 — `%s_transform` mixed(3H) + gru_group, a
    recurrent_group of gru_step layers (simple_gru2 runs the fused
    grumemory: the same math)."""
    m = _gru_transform(input, size, name, mixed_param_attr,
                       mixed_bias_param_attr, mixed_layer_attr)
    return gru_group(input=m, size=size, name=name, reverse=reverse,
                     gru_bias_attr=gru_bias_attr, gru_param_attr=gru_param_attr,
                     act=act, gate_act=gate_act, gru_layer_attr=gru_layer_attr,
                     naive=naive)


def simple_gru2(input, size, name=None, reverse=False, mixed_param_attr=None,
                mixed_bias_attr=None, gru_param_attr=None, gru_bias_attr=None,
                act=None, gate_act=None, mixed_layer_attr=None,
                gru_cell_attr=None):
    """networks.py simple_gru2: `%s_transform` mixed(3H) + grumemory."""
    m = _gru_transform(input, size, name, mixed_param_attr, mixed_bias_attr,
                       mixed_layer_attr)
    return grumemory(m, name=name, size=size, reverse=reverse, act=act,
                     gate_act=gate_act, bias_attr=gru_bias_attr,
                     param_attr=gru_param_attr, layer_attr=gru_cell_attr)


def bidirectional_lstm(input, size, name=None, return_seq=False, **kw):
    """networks.py:1214 — concat of forward and backward simple_lstm."""
    fwd = simple_lstm(input, size, name=f"{name}_fw" if name else None)
    bwd = simple_lstm(input, size, name=f"{name}_bw" if name else None,
                      reverse=True)
    if return_seq:
        node = L.Concat([fwd, bwd], name=name)
        return _annotate(node, size=size * 2)
    last_f = S.LastSeq(fwd, name=f"{name}_fw_last" if name else None)
    first_b = S.FirstSeq(bwd, name=f"{name}_bw_first" if name else None)
    node = L.Concat([last_f, first_b], name=name)
    return _annotate(node, size=size * 2)


def bidirectional_gru(input, size, name=None, return_seq=False, **kw):
    """networks.py bidirectional_gru: two simple_gru2 passes + concat
    (fwd_/bwd_ prefixed attrs route to the respective pass)."""
    fwd_kw = {k[4:]: v for k, v in kw.items() if k.startswith("fwd_")}
    bwd_kw = {k[4:]: v for k, v in kw.items() if k.startswith("bwd_")}
    fwd = simple_gru2(input, size, name=f"{name}_fw", **fwd_kw)
    bwd = simple_gru2(input, size, name=f"{name}_bw", reverse=True, **bwd_kw)
    if return_seq:
        node = L.Concat([fwd, bwd], act=_act(kw.get("concat_act")), name=name)
        return _annotate(node, size=size * 2)
    last_f = last_seq(fwd, name=f"{name}_fw_last")
    first_b = first_seq(bwd, name=f"{name}_bw_last")
    node = L.Concat([last_f, first_b], act=_act(kw.get("concat_act")), name=name)
    return _annotate(node, size=size * 2)
