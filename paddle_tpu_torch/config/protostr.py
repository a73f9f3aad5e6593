"""Golden-protostr interchange (counterpart of
`paddle_tpu/config/protostr.py`): parse protobuf text format and compare
ModelConfigs structurally.

The reference proves its config DSL against 51 golden protostr files
(python/paddle/trainer_config_helpers/tests/configs/protostr/, emitted by
generate_protostr.sh from the configs in the same dir). `parse_text_proto`
reads a golden (or a `dump_config` output) into plain dicts, `summarize`
reduces a ModelConfig dict to its structural core, and `diff` reports the
discrepancies between a reference summary and ours. Plain Python, copied
from the JAX package so that both give the same summaries and the same
diff lines for the same texts.

Structural equivalence, not byte equality: a handful of systematic
differences of the layer graph are *expected* and normalized instead of
flagged, as documented on `diff` below.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# protobuf text-format parser (subset: messages, repeated fields, scalars)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<open>\{)
      | (?P<close>\})
      | (?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<colon>:)?
      | (?P<string>"(?:\\.|[^"\\])*")
      | (?P<scalar>[^\s{}]+)
    )""",
    re.VERBOSE,
)


def _tokens(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            break
        pos = m.end()
        yield m


def _coerce(s: str) -> Any:
    if s.startswith('"'):
        return s[1:-1].encode().decode("unicode_escape")
    if s in ("true", "True"):
        return True
    if s in ("false", "False"):
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def parse_text_proto(text: str) -> Dict[str, Any]:
    """Parse protobuf text format into nested dicts. Every field becomes a
    LIST (canonical repeated form) so goldens and our dumps compare uniformly
    regardless of optional-vs-repeated declarations."""
    root: Dict[str, Any] = {}
    stack: List[Dict[str, Any]] = [root]
    pending: Optional[str] = None
    it = _tokens(text)
    for m in it:
        if m.group("open"):
            child: Dict[str, Any] = {}
            stack[-1].setdefault(pending, []).append(child)
            stack.append(child)
            pending = None
        elif m.group("close"):
            stack.pop()
            if not stack:
                raise ValueError("unbalanced braces in text proto")
        elif m.group("name"):
            name = m.group("name")
            if m.group("colon"):
                v = next(it)
                val = _coerce(v.group("string") or v.group("scalar") or v.group("name") or "")
                stack[-1].setdefault(name, []).append(val)
            else:
                pending = name  # message field: `name {` (brace next)
        elif m.group("string") or m.group("scalar"):
            raise ValueError(f"unexpected bare value {m.group(0)!r}")
    if len(stack) != 1:
        raise ValueError("unterminated message in text proto")
    return root


def _one(d: Dict[str, Any], key: str, default: Any = None) -> Any:
    v = d.get(key)
    return v[0] if v else default


# ---------------------------------------------------------------------------
# structural summary
# ---------------------------------------------------------------------------


@dataclass
class LayerSummary:
    name: str
    type: str
    size: int
    active_type: str
    inputs: List[str]
    input_params: List[Optional[str]]
    bias_param: Optional[str]
    # typed per-input sub-conf dicts we model (conv/pool/norm/image/proj/...)
    sub_confs: List[Dict[str, Any]] = field(default_factory=list)
    fields: Dict[str, Any] = field(default_factory=dict)  # scalar LayerConfig fields


@dataclass
class ModelSummary:
    layers: Dict[str, LayerSummary]
    layer_order: List[str]
    parameters: Dict[str, List[int]]  # name -> dims
    input_layer_names: List[str]
    output_layer_names: List[str]
    evaluators: List[Tuple[str, str, Tuple[str, ...]]] = field(default_factory=list)


_SCALAR_FIELDS = (
    # LayerConfig scalar fields we compare when both sides emit them
    "num_filters", "shared_biases", "drop_rate", "num_classes", "reversed",
    "active_gate_type", "active_state_type", "num_neg_samples",
    "output_max_index", "norm_by_times", "coeff", "average_strategy",
    "slope", "intercept", "cos_scale", "bos_id", "eos_id", "beam_size",
    "select_first", "trans_type", "use_global_stats",
    "moving_average_fraction", "bias_size", "height", "width", "blank",
    "seq_pool_stride", "axis", "delta", "depth", "group_name",
)

_SUBCONF_FIELDS = (
    "conv_conf", "pool_conf", "norm_conf", "image_conf", "proj_conf",
    "block_expand_conf", "bilinear_interp_conf", "maxout_conf", "spp_conf",
    "pad_conf", "row_conv_conf", "clip_conf", "multibox_loss_conf",
    "detection_output_conf",
)


def summarize(mc: Dict[str, Any]) -> ModelSummary:
    if "model_config" in mc and "layers" not in mc:
        mc = mc["model_config"][0]  # TrainerConfig dump: descend
    layers: Dict[str, LayerSummary] = {}
    order: List[str] = []
    for l in mc.get("layers", []):
        ins, ps, subs = [], [], []
        for i in l.get("inputs", []):
            ins.append(_one(i, "input_layer_name", ""))
            ps.append(_one(i, "input_parameter_name"))
            sc = {}
            for f in _SUBCONF_FIELDS:
                if f in i:
                    sc[f] = i[f][0]
            subs.append(sc)
        fields = {f: _one(l, f) for f in _SCALAR_FIELDS if f in l}
        ls = LayerSummary(
            name=_one(l, "name", ""),
            type=_one(l, "type", ""),
            size=int(_one(l, "size", 0) or 0),
            active_type=_one(l, "active_type", "") or "",
            inputs=ins,
            input_params=ps,
            bias_param=_one(l, "bias_parameter_name"),
            sub_confs=subs,
            fields=fields,
        )
        layers[ls.name] = ls
        order.append(ls.name)
    params = {}
    for p in mc.get("parameters", []):
        dims = [int(d) for d in p.get("dims", [])]
        if not dims and _one(p, "size") is not None:
            dims = [int(_one(p, "size"))]  # older goldens omit dims
        params[_one(p, "name", "")] = dims
    evals = [
        (
            _one(e, "name", ""),
            _one(e, "type", ""),
            tuple(e.get("input_layers", [])),
        )
        for e in mc.get("evaluators", [])
    ]
    return ModelSummary(
        layers=layers,
        layer_order=order,
        parameters=params,
        input_layer_names=list(mc.get("input_layer_names", [])),
        output_layer_names=list(mc.get("output_layer_names", [])),
        evaluators=evals,
    )


# ---------------------------------------------------------------------------
# structural diff
# ---------------------------------------------------------------------------

# our graph inserts explicit layout adapters where the reference's kernels
# work on flat CHW buffers implicitly; hopping through them is not a
# topology difference (v1_layers module docstring)
_ADAPTER_TYPES = {"reshape", "switch_order"}

# parameter-name convention: reference `_<layer>.w0` / `_<layer>.wbias`
# (config_parser.py Parameter naming) vs ours `<layer>.w.<i>` / `<layer>.b`
_REF_PARAM = re.compile(r"^_(?P<layer>.+)\.(?:w(?P<idx>\d+)|(?P<bias>wbias)|(?P<raw>w))$")


def normalize_ref_param(name: str) -> str:
    # in-group parameters carry the "@<group>" suffix on the owning layer
    # (RecurrentLayerGroup name mangling); our params use the plain step name
    name = re.sub(r"@[^.]+", "", name)
    m = _REF_PARAM.match(name)
    if m is None:
        return name
    if m.group("bias"):
        return f"{m.group('layer')}.b"
    if m.group("raw"):
        return f"{m.group('layer')}.w.0"
    return f"{m.group('layer')}.w.{m.group('idx')}"


def normalize_our_param(name: str) -> str:
    """Canonicalize this repo's parameter names to the same role form:
    `X.w` (single weight) → `X.w.0`; batch_norm's `X.scale` → `X.w.0`."""
    m = re.search(r"\.proj(\d+)\.(w|b)$", name)
    if m is not None:  # mixed-layer projection params ({owner}.projN.w)
        base = name[: m.start()]
        return f"{base}.w.{m.group(1)}" if m.group(2) == "w" else f"{base}.b"
    if name.endswith(".w_hzr"):  # GRU recurrent weight, z/r block
        return name[: -len(".w_hzr")] + ".w.0"
    if name.endswith(".w_hc"):  # GRU candidate block (fused into w0 in ref)
        return name[: -len(".w_hc")] + ".w.0.c"
    if name.endswith(".w_hh"):  # LSTM recurrent weight
        return name[: -len(".w_hh")] + ".w.0"
    if name.endswith(".w"):
        return name + ".0"
    if name.endswith(".scale"):
        return name[: -len(".scale")] + ".w.0"
    if name.endswith(".bias"):
        return name[: -len(".bias")] + ".b"
    return name


def _resolve_through_adapters(name: str, ours: ModelSummary) -> str:
    """Follow our single-input adapter layers back to their source so edges
    compare against the reference's flat topology."""
    seen = set()
    while name in ours.layers and name not in seen:
        seen.add(name)
        l = ours.layers[name]
        if l.type in _ADAPTER_TYPES and len(l.inputs) == 1:
            name = l.inputs[0]
        else:
            break
    return name


def diff(
    ref: ModelSummary,
    ours: ModelSummary,
    check_sizes: bool = True,
) -> List[str]:
    """Structural comparison; returns human-readable discrepancy lines
    (empty = structurally matching).

    Checked: every reference layer exists with the same type, size,
    active_type and input topology; parameter existence + dims;
    input/output_layer_names; scalar LayerConfig fields and per-input
    sub-confs (conv/pool/...) where both sides emit them.

    Normalized (expected, never flagged):
    - our extra reshape/switch_order layout adapters (edges resolve through
      them);
    - parameter naming convention (`_X.w0` → `X.w.0`, `_X.wbias` → `X.b`);
    - conv filter dims: reference stores flat [cin*kh*kw/groups * ...] rows,
      ours HWIO — compared by element count;
    - active_type "" vs "linear" (both mean identity).
    """
    errs: List[str] = []

    def act(a: str) -> str:
        return "" if a in ("linear", "identity") else a

    for name in ref.layer_order:
        rl = ref.layers[name]
        ol = ours.layers.get(name)
        if ol is None:
            errs.append(f"layer missing: {name} (type {rl.type})")
            continue
        if rl.type != ol.type:
            errs.append(f"layer {name}: type {ol.type!r} != ref {rl.type!r}")
        if check_sizes and rl.size and ol.size and rl.size != ol.size:
            errs.append(f"layer {name}: size {ol.size} != ref {rl.size}")
        if act(rl.active_type) != act(ol.active_type):
            errs.append(
                f"layer {name}: active_type {ol.active_type!r} != ref {rl.active_type!r}"
            )
        rins = [_resolve_through_adapters(i, ref) for i in rl.inputs]
        oins = [_resolve_through_adapters(i, ours) for i in ol.inputs]
        if rl.type == "batch_norm":
            # the reference threads the same input thrice (value + the two
            # static moving-stat parameter slots, BatchNormBaseLayer); the
            # moving stats here are functional state, not extra edges
            rins = rins[:1]
        if rins != oins:
            errs.append(f"layer {name}: inputs {oins} != ref {rins}")
        if (rl.bias_param is None) != (ol.bias_param is None):
            errs.append(
                f"layer {name}: bias {'present' if ol.bias_param else 'absent'}"
                f" != ref {'present' if rl.bias_param else 'absent'}"
            )
        for f, rv in rl.fields.items():
            ov = ol.fields.get(f)
            if ov is not None and ov != rv:
                errs.append(f"layer {name}: {f} {ov!r} != ref {rv!r}")
        for k, (rsc, osc) in enumerate(zip(rl.sub_confs, ol.sub_confs)):
            for cf, rcv in rsc.items():
                ocv = osc.get(cf)
                if ocv is None:
                    errs.append(f"layer {name} input {k}: missing {cf}")
                    continue
                for fk, fv in rcv.items():
                    if fk in ("caffe_mode",):  # impl detail of ref im2col
                        continue
                    v = ocv.get(fk)
                    if v is not None and v != fv:
                        errs.append(
                            f"layer {name} input {k} {cf}.{fk}: {v} != ref {fv}"
                        )

    def _count(dims: List[int]) -> int:
        n = 1
        for d in dims:
            n *= d
        return n

    def _owner_of(pname: str, summary: ModelSummary) -> Optional[str]:
        best = None
        for ln in summary.layers:
            if pname.startswith(ln + ".") and (best is None or len(ln) > len(best)):
                best = ln
        return best

    ref_params = {normalize_ref_param(n): d for n, d in ref.parameters.items()}
    our_params = {normalize_our_param(n): d for n, d in ours.parameters.items()}
    # recurrent memories factor their weights differently (one fused ref
    # matrix vs per-gate blocks here, RNN ops design) — compare per-layer
    # aggregate element counts instead of per-name
    _AGGREGATE_TYPES = {"lstmemory", "gated_recurrent", "recurrent"}
    # DeConv3DLayer allocates its weight by the forward-conv formula with
    # channels<->filters swapped (a reference-side layout quirk); element
    # counts legitimately differ from the math's k^3*cin*cout
    _SKIP_PARAM_TYPES = {"deconv3d"}
    agg_checked = set()
    for pname, rdims in ref_params.items():
        lname, _, role = pname.rpartition(".")
        lname = lname[:-2] if lname.endswith(".w") else lname
        owner = ref.layers.get(lname) or ref.layers.get(_owner_of(pname, ref) or "")
        if owner is not None and owner.type == "batch_norm" and pname.endswith(
            (".w.1", ".w.2")
        ):
            continue  # moving mean/var: functional state here, not parameters
        if owner is not None and owner.type in _SKIP_PARAM_TYPES:
            continue
        if owner is not None and owner.type in _AGGREGATE_TYPES:
            if owner.name in agg_checked:
                continue
            agg_checked.add(owner.name)
            rn = sum(
                _count(d)
                for n, d in ref_params.items()
                if _owner_of(n, ref) == owner.name
            )
            on = sum(
                _count(d)
                for n, d in our_params.items()
                if _owner_of(n, ours) == owner.name
            )
            if rn != on:
                errs.append(
                    f"layer {owner.name}: total parameter elements {on} != ref {rn}"
                )
            continue
        odims = our_params.get(pname)
        if odims is None:
            errs.append(f"parameter missing: {pname} (ref dims {rdims})")
            continue
        rn, on = _count(rdims), _count(odims)
        if rn != on and f"{pname}.c" in our_params:
            # shared GRU weights split [H,2H]+[H,H] here vs one fused [H,3H]
            # (nn/recurrent.py GruStep derives a ".c" sharing key)
            on += _count(our_params[f"{pname}.c"])
        if rn != on:
            errs.append(f"parameter {pname}: {on} elements != ref {rn} ({odims} vs {rdims})")
    # ref input names must all be declared here; extras on our side are fine
    # (the reference config_parser drops some auxiliary data slots, e.g.
    # seq_slice starts/ends, from input_layer_names)
    missing_inputs = set(ref.input_layer_names) - set(ours.input_layer_names)
    if missing_inputs:
        errs.append(
            f"input_layer_names missing {sorted(missing_inputs)} "
            f"(ours {sorted(ours.input_layer_names)})"
        )
    if sorted(ref.output_layer_names) != sorted(ours.output_layer_names):
        errs.append(
            f"output_layer_names {sorted(ours.output_layer_names)} != "
            f"ref {sorted(ref.output_layer_names)}"
        )
    for ev in ref.evaluators:
        if ev not in ours.evaluators:
            errs.append(f"evaluator missing: {ev}")
    return errs


def diff_files(golden_path: str, our_text: str) -> List[str]:
    with open(golden_path) as f:
        ref = summarize(parse_text_proto(f.read()))
    return diff(ref, summarize(parse_text_proto(our_text)))
