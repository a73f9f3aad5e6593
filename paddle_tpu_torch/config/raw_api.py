"""The rawest v1 config surface: Layer() and friends, by NAME registry
(counterpart of `paddle_tpu/config/raw_api.py`).

The oldest reference configs (chunking.conf, sample_trainer_config_rnn.conf,
sample_trainer_config_qb_rnn.conf, compare_sparse) skip trainer_config_helpers
entirely and call the low-level @config_func DSL of
python/paddle/trainer/config_parser.py directly: `Layer(name=..., type=...,
inputs=[...])` registering into a global name map, projections referencing
layers by name, and RecurrentLayerGroupBegin/End + Memory
(config_parser.py:367,2863) bracketing a step sub-net.

Here those primitives are a thin shim over the same builders the
trainer_config_helpers surface uses: names resolve through a per-parse
registry, and a recurrent layer group records its Layer()/Memory() calls as
deferred thunks replayed inside the step function of a recurrent_group — the
declarative bracketing becomes the group's step net. A raw layer type whose
layer the port does not have yet raises that layer's named error."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from paddle_tpu_torch.config import config_parser as cp


# ---------------------------------------------------------------------------
# per-parse state
# ---------------------------------------------------------------------------


def _state():
    ctx = cp.g_context()
    if not hasattr(ctx, "raw_layer_map"):
        ctx.raw_layer_map = {}
        ctx.raw_group_stack = []
    return ctx


def _register(name: str, node) -> None:
    st = _state()
    if st.raw_group_stack:
        st.raw_group_stack[-1]["local_names"].append(name)
    st.raw_layer_map[name] = node


def _resolve(ref, local: Optional[Dict[str, Any]] = None):
    """A layer reference: an actual node, or a name looked up in the replay
    overlay then the registry."""
    if not isinstance(ref, str):
        return ref
    if local is not None and ref in local:
        return local[ref]
    st = _state()
    if ref in st.raw_layer_map:
        return st.raw_layer_map[ref]
    raise KeyError(f"Layer() references unknown layer name {ref!r}")


# ---------------------------------------------------------------------------
# attribute wrappers
# ---------------------------------------------------------------------------


def _param_attr(parameter_name=None, initial_std=None, initial_mean=None,
                learning_rate=None, decay_rate=None, decay_rate_l1=None,
                momentum=None, initial_smart=False, is_static=False,
                sparse_update=False, sparse_remote_update=False, **_kw):
    from paddle_tpu_torch.nn.graph import ParamAttr

    pa = ParamAttr(
        name=parameter_name,
        initial_std=initial_std,
        initial_mean=initial_mean if initial_mean is not None else 0.0,
        learning_rate=learning_rate if learning_rate is not None else 1.0,
        momentum=momentum,
        l2_decay=decay_rate,
        l1_decay=decay_rate_l1,
        is_static=bool(is_static),
        is_sparse=bool(sparse_update or sparse_remote_update),
    )
    if initial_smart:
        # initial_smart overrides default_initial_std with 1/sqrt(fan_in)
        # (reference Parameter(), config_parser.py:3893) — an explicit
        # initializer wins over both initial_std and the global default
        from paddle_tpu_torch.nn import init as init_mod

        pa.initial_std = None
        pa.initializer = init_mod.smart_normal
    return pa


class Input:
    """Input(layer_name, parameter_name=..., ...) — a weighted input slot."""

    def __init__(self, layer_name, **kw):
        self.layer_name = layer_name
        self.attr = _param_attr(**kw)


def Bias(**kw):
    return _param_attr(**kw)


class _RawProjection:
    def __init__(self, kind: str, layer_name, kw: Dict[str, Any]):
        self.kind = kind
        self.layer_name = layer_name
        self.kw = kw

    def build(self, local=None):
        from paddle_tpu_torch.v2 import layer as v2

        src = _resolve(self.layer_name, local)
        attr = _param_attr(**self.kw)
        if self.kind == "fullmatrix":
            return v2.full_matrix_projection(src, param_attr=attr)
        if self.kind == "table":
            return v2.table_projection(src, param_attr=attr)
        if self.kind == "identity":
            return v2.identity_projection(src)
        if self.kind == "transposedfullmatrix":
            return v2.trans_full_matrix_projection(src, param_attr=attr)
        if self.kind == "dotmul":
            return v2.dotmul_projection(src, param_attr=attr)
        raise ValueError(f"unknown raw projection kind {self.kind}")


def FullMatrixProjection(layer_name, **kw):
    return _RawProjection("fullmatrix", layer_name, kw)


def TableProjection(layer_name, **kw):
    return _RawProjection("table", layer_name, kw)


def IdentityProjection(layer_name, **kw):
    return _RawProjection("identity", layer_name, kw)


def TransposedFullMatrixProjection(layer_name, **kw):
    return _RawProjection("transposedfullmatrix", layer_name, kw)


def DotMulProjection(layer_name, **kw):
    return _RawProjection("dotmul", layer_name, kw)


# ---------------------------------------------------------------------------
# activation mapping (raw active_type strings)
# ---------------------------------------------------------------------------

_ACT = {
    "": None, "linear": "linear", "tanh": "tanh", "sigmoid": "sigmoid",
    "relu": "relu", "softmax": "softmax", "exponential": "exp",
    "square": "square", "abs": "abs", "softrelu": "softrelu", "brelu": "brelu",
    "stanh": "stanh",
}


def _act_obj(active_type: Optional[str]):
    from paddle_tpu_torch.v2 import activation as A

    name = _ACT.get(active_type or "", active_type)
    if name is None:
        return None
    table = {
        "linear": A.Linear, "tanh": A.Tanh, "sigmoid": A.Sigmoid,
        "relu": A.Relu, "softmax": A.Softmax, "exp": A.Exp,
        "square": A.Square, "abs": A.Abs, "softrelu": A.SoftRelu,
        "brelu": A.BRelu, "stanh": A.STanh,
    }
    return table[name]()


# ---------------------------------------------------------------------------
# Layer() dispatch
# ---------------------------------------------------------------------------


def _normalize_inputs(inputs) -> List[Any]:
    if inputs is None:
        return []
    if not isinstance(inputs, (list, tuple)):
        return [inputs]
    return list(inputs)


def _split_input(item):
    """→ (layer_ref, ParamAttr or None)."""
    if isinstance(item, Input):
        return item.layer_name, item.attr
    return item, None


def _build_layer(spec: Dict[str, Any], local=None):
    import paddle_tpu_torch.config.v1_layers as v1
    from paddle_tpu_torch.v2 import layer as v2

    from paddle_tpu_torch.v2 import activation as A

    name = spec["name"]
    ltype = spec["type"]
    size = spec.get("size", 0)
    # raw LayerBase defaults active_type='' = LINEAR (config_parser.py), not
    # the trainer_config_helpers per-layer defaults (fc would get tanh there)
    act = _act_obj(spec.get("active_type", "")) or A.Linear()
    bias = spec.get("bias", None)
    bias_attr: Any
    if bias is False:
        bias_attr = False
    elif bias is None or bias is True:
        bias_attr = None
    else:
        bias_attr = bias  # a Bias(...) ParamAttr
    raw_inputs = _normalize_inputs(spec.get("inputs"))

    if ltype == "data":
        return v1.data_layer(name, size)

    if ltype == "mixed":
        projs = [
            item.build(local) if isinstance(item, _RawProjection) else item
            for item in raw_inputs
        ]
        return v2.mixed(size=size, input=projs, act=act,
                        bias_attr=bias_attr, name=name)

    if ltype == "fc":
        refs, attrs = zip(*(_split_input(i) for i in raw_inputs))
        nodes = [_resolve(r, local) for r in refs]
        # per-input parameters: fc over multiple inputs is a mixed of
        # full-matrix projections in the reference (FullyConnectedLayer
        # holds one weight per input)
        if len(nodes) == 1:
            return v1.fc_layer(nodes[0], size, act=act, name=name,
                               param_attr=attrs[0], bias_attr=bias_attr)
        projs = [
            v2.full_matrix_projection(n, param_attr=a)
            for n, a in zip(nodes, attrs)
        ]
        return v2.mixed(size=size, input=projs, act=act,
                        bias_attr=bias_attr if bias_attr is not None else None,
                        name=name)

    if ltype == "recurrent":
        (ref, attr), = [_split_input(i) for i in raw_inputs]
        return v1.recurrent_layer(
            _resolve(ref, local), act=act, name=name,
            bias_attr=bias_attr, param_attr=attr,
        )

    if ltype == "seqlastins":
        (ref, _), = [_split_input(i) for i in raw_inputs]
        return v1.last_seq(_resolve(ref, local), name=name)

    if ltype == "seqfirstins":
        (ref, _), = [_split_input(i) for i in raw_inputs]
        return v1.first_seq(_resolve(ref, local), name=name)

    if ltype in ("average", "max"):
        (ref, _), = [_split_input(i) for i in raw_inputs]
        pool = "avg" if ltype == "average" else "max"
        return v1.pooling_layer(
            _resolve(ref, local), pooling_type=pool, name=name
        )

    if ltype == "rank-cost":
        refs = [_split_input(i)[0] for i in raw_inputs]
        left, right, label = (_resolve(r, local) for r in refs)
        return v2.rank_cost(left, right, label, name=name)

    if ltype == "crf":
        items = [_split_input(i) for i in raw_inputs]
        inp = _resolve(items[0][0], local)
        label = _resolve(items[1][0], local)
        return v1.crf_layer(inp, label, size=size, name=name,
                            param_attr=items[0][1])

    if ltype == "crf_decoding":
        items = [_split_input(i) for i in raw_inputs]
        inp = _resolve(items[0][0], local)
        label = _resolve(items[1][0], local) if len(items) > 1 else None
        return v1.crf_decoding_layer(inp, size=size, label=label, name=name,
                                     param_attr=items[0][1])

    if ltype == "multi-class-cross-entropy":
        refs = [_split_input(i)[0] for i in raw_inputs]
        inp, label = (_resolve(r, local) for r in refs)
        return v2.classification_cost(inp, label, name=name)

    raise NotImplementedError(f"raw Layer type {ltype!r} not supported yet")


def Layer(name: str, type: str, **kw) -> str:  # noqa: A002
    """config_parser.py Layer(): build (or defer, inside a group) and
    register under `name`. Returns the name, as the reference does."""
    st = _state()
    spec = dict(kw, name=name, type=type)
    if st.raw_group_stack:
        st.raw_group_stack[-1]["thunks"].append(
            lambda local: local.__setitem__(name, _build_layer(spec, local))
        )
        st.raw_group_stack[-1]["local_names"].append(name)
        return name
    node = _build_layer(spec)
    _register(name, node)
    return name


# ---------------------------------------------------------------------------
# recurrent layer groups
# ---------------------------------------------------------------------------


def Memory(name: str, size: int, is_sequence: bool = False,
           boot_layer: Optional[str] = None, boot_bias: bool = False,
           **_kw) -> str:
    """config_parser.py:2863 — returns the agent name '{name}+delay1' which
    later projections reference; the actual memory node is created at
    replay time inside the step trace."""
    st = _state()
    if not st.raw_group_stack:
        raise ValueError("Memory() outside RecurrentLayerGroupBegin")
    agent_name = name + "+delay1"
    boot_node = _resolve(boot_layer) if boot_layer else None

    def thunk(local):
        from paddle_tpu_torch.nn.recurrent_group import memory as _memory

        local[agent_name] = _memory(
            name=name, size=size, boot_layer=boot_node, boot_bias=boot_bias,
            is_seq=is_sequence,
        )

    st.raw_group_stack[-1]["thunks"].append(thunk)
    st.raw_group_stack[-1]["local_names"].append(agent_name)
    return agent_name


def RecurrentLayerGroupBegin(name: str, in_links: Sequence[str],
                             out_links: Sequence[str],
                             generator=None, target_inlinkname: str = "",
                             seq_reversed: bool = False) -> None:
    if generator is not None:
        raise NotImplementedError(
            "raw generator groups: use beam_search via trainer_config_helpers"
        )
    st = _state()
    st.raw_group_stack.append({
        "name": name,
        "in_links": list(in_links),
        "out_links": list(out_links),
        "seq_reversed": bool(seq_reversed),
        "thunks": [],
        "local_names": [],
    })


def RecurrentLayerGroupEnd(name: str) -> None:
    from paddle_tpu_torch.nn.recurrent_group import recurrent_group

    st = _state()
    if not st.raw_group_stack or st.raw_group_stack[-1]["name"] != name:
        raise ValueError(f"RecurrentLayerGroupEnd({name!r}) does not match")
    g = st.raw_group_stack.pop()
    in_nodes = [_resolve(n) for n in g["in_links"]]

    def step(*args):
        local: Dict[str, Any] = dict(zip(g["in_links"], args))
        for thunk in g["thunks"]:
            thunk(local)
        outs = tuple(local[n] for n in g["out_links"])
        return outs if len(outs) > 1 else outs[0]

    result = recurrent_group(
        step=step, input=in_nodes, reverse=g["seq_reversed"], name=name
    )
    nodes = result if isinstance(result, tuple) else (result,)
    # out-link layers become visible in the parent by their step-net names
    # (GatherAgentLayer in the parent submodel, config_parser.py:402-409)
    for link, node in zip(g["out_links"], nodes):
        _register(link, node)


# ---------------------------------------------------------------------------
# Evaluator()
# ---------------------------------------------------------------------------

_RAW_EVAL_TYPES = {
    "sum": "sum",
    "classification_error": "classification_error",
    "chunk": "chunk",
    "last-column-sum": "column_sum",
    "last-column-auc": "auc",
    "precision_recall": "precision_recall",
}


def Evaluator(name: str, type: str, inputs, chunk_scheme: Optional[str] = None,  # noqa: A002
              num_chunk_types: Optional[int] = None, **kw) -> None:
    from paddle_tpu_torch.config.helpers import _declare_evaluator

    refs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    nodes = [_resolve(r) for r in refs]
    extra = {}
    if chunk_scheme is not None:
        extra["chunk_scheme"] = chunk_scheme
    if num_chunk_types is not None:
        extra["num_chunk_types"] = num_chunk_types
    _declare_evaluator(
        _RAW_EVAL_TYPES.get(type, type), *nodes, name=name, **extra
    )


RAW_API = {
    "Layer": Layer,
    "Input": Input,
    "Bias": Bias,
    "Memory": Memory,
    "RecurrentLayerGroupBegin": RecurrentLayerGroupBegin,
    "RecurrentLayerGroupEnd": RecurrentLayerGroupEnd,
    "Evaluator": Evaluator,
    "FullMatrixProjection": FullMatrixProjection,
    "TableProjection": TableProjection,
    "IdentityProjection": IdentityProjection,
    "TransposedFullMatrixProjection": TransposedFullMatrixProjection,
    "DotMulProjection": DotMulProjection,
}
