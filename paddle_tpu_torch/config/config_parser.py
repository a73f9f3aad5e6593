"""config_parser: execute a v1 Python config script -> TrainerConfig
(counterpart of `paddle_tpu/config/config_parser.py`).

Parity with python/paddle/trainer/config_parser.py:4208 `parse_config` (the
function the reference's C++ trainer calls through embedded Python,
paddle/trainer/TrainerConfigHelper.cpp:34-56). The DSL names injected into the
script's namespace are the trainer_config_helpers surface
(`config/helpers.py`); layer calls build real graph nodes, so the "compile"
step is tracing the finished graph (`dump.build_model_config`).

While a script runs, `import paddle.trainer_config_helpers` (and the other
`paddle.*` paths a v1 script or provider imports) resolves to the port's own
modules (`compat/`), never to the repo's `paddle/` shim, which re-exports the
JAX package; what `sys.modules` held before is put back afterwards.

`parse_config_and_serialize` keeps the reference entry-point name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from paddle_tpu_torch import proto
from paddle_tpu_torch.nn.graph import Layer, reset_name_scope
from paddle_tpu_torch.v2.topology import Topology


# ---------------------------------------------------------------------------
# parsing context (the reference's g_config global, config_parser.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParseContext:
    outputs: List[Layer] = dataclasses.field(default_factory=list)
    inputs: List[Layer] = dataclasses.field(default_factory=list)
    pending_output_names: List[str] = dataclasses.field(default_factory=list)
    pending_input_names: List[str] = dataclasses.field(default_factory=list)
    model_type: str = "nn"
    opt_config: Optional[proto.OptimizationConfig] = None
    data_config: Optional[proto.DataConfig] = None
    test_data_config: Optional[proto.DataConfig] = None
    config_args: Dict[str, str] = dataclasses.field(default_factory=dict)
    evaluators: List[proto.EvaluatorConfig] = dataclasses.field(default_factory=list)


_tls = threading.local()


def g_context() -> ParseContext:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = ParseContext()
        _tls.ctx = ctx
    return ctx


@contextlib.contextmanager
def fresh_context(config_args: Optional[Dict[str, str]] = None):
    old = getattr(_tls, "ctx", None)
    _tls.ctx = ParseContext(config_args=dict(config_args or {}))
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = old


# ---------------------------------------------------------------------------
# DSL functions available inside config scripts
# ---------------------------------------------------------------------------


def outputs(*layers: Union[Layer, Sequence[Layer]]) -> None:
    """Declare network outputs (config_parser outputs())."""
    flat: List[Layer] = []
    for l in layers:
        if isinstance(l, Layer):
            flat.append(l)
        else:
            flat.extend(l)
    g_context().outputs.extend(flat)


def Outputs(*names: str) -> None:
    """Legacy raw-config output declaration by layer NAME
    (config_parser.py Outputs) — resolved after the script runs."""
    g_context().pending_output_names.extend(names)


def Inputs(*names: str) -> None:
    """Legacy raw-config input declaration by name (config_parser.py
    Inputs); input slots are derived from the data layers here, so this
    records intent only."""
    g_context().pending_input_names.extend(names)


def TrainData(spec, async_load_data: bool = False) -> None:
    """Legacy TrainData(ProtoData(...)/SimpleData(...)/PyData(...))."""
    if isinstance(spec, proto.DataConfig):
        spec.async_load_data = bool(async_load_data)
        g_context().data_config = spec


def TestData(spec, async_load_data: bool = False) -> None:
    if isinstance(spec, proto.DataConfig):
        g_context().test_data_config = spec


def ProtoData(files: str = "", type: str = "proto", **kw) -> proto.DataConfig:  # noqa: A002
    return proto.DataConfig(type=type, files=files)


def SimpleData(files: str = "", feat_dim: int = 0, **kw) -> proto.DataConfig:
    return proto.DataConfig(type="simple", files=files)


def PyData(files: str = "", load_data_module=None, load_data_object=None,
           load_data_args: str = "", **kw) -> proto.DataConfig:
    return proto.DataConfig(
        type="py", files=files, load_data_module=load_data_module,
        load_data_object=load_data_object, load_data_args=load_data_args,
    )


def Settings(**kw) -> None:
    """Legacy Settings(...) — maps onto the helpers' settings() keys where
    they exist."""
    from paddle_tpu_torch.config.optimizers import settings as _settings

    known = {}
    for k in ("batch_size", "learning_rate", "learning_method",
              "learning_rate_decay_a", "learning_rate_decay_b",
              "learning_rate_schedule", "l2_weight", "l1_weight",
              "average_window", "max_average_window"):
        if k in kw:
            known[k] = kw[k]
    if known:
        try:
            _settings(**known)
        except TypeError:
            pass


def model_type(name: str) -> None:
    """Legacy model_type('recurrent_nn'/'nn') declaration."""
    g_context().model_type = str(name)


def default_initial_std(v: float) -> None:
    """Legacy global param-init default (config_parser.py) — consumed by
    Context.param when a parameter has no explicit initial_std."""
    from paddle_tpu_torch.nn import graph as _g

    _g._param_default["initial_std"] = float(v)


def default_initial_mean(v: float) -> None:
    from paddle_tpu_torch.nn import graph as _g

    _g._param_default["initial_mean"] = float(v)


def default_decay_rate(v: float) -> None:
    g_context().config_args.setdefault("_default_decay_rate", str(v))


def default_device(v: int) -> None:  # device placement is a sharding concern
    return None


def default_num_batches_regularization(v: int) -> None:
    return None


def inputs(*layers: Layer) -> None:
    g_context().inputs.extend(layers)


def get_config_arg(name: str, type_: type = str, default: Any = None) -> Any:
    """Read a --config_args=k=v,... argument (config_parser get_config_arg)."""
    raw = g_context().config_args.get(name)
    if raw is None:
        return default
    if type_ is bool:
        return str(raw).lower() in ("1", "true", "yes", "on")
    return type_(raw)


def define_py_data_sources2(
    train_list: Optional[str],
    test_list: Optional[str],
    module: Union[str, Sequence[str]],
    obj: Union[str, Sequence[str]],
    args: Optional[Any] = None,
) -> None:
    """Declare the @provider-based data sources
    (trainer_config_helpers/data_sources.py define_py_data_sources2)."""
    import json

    ctx = g_context()

    def mk(file_list, which) -> Optional[proto.DataConfig]:
        if file_list is None:
            return None
        mod = module[which] if isinstance(module, (list, tuple)) else module
        ob = obj[which] if isinstance(obj, (list, tuple)) else obj
        a = args[which] if isinstance(args, (list, tuple)) else args
        return proto.DataConfig(
            type="py2",
            files=file_list,
            load_data_module=mod,
            load_data_object=ob,
            load_data_args=json.dumps(a) if a is not None else "",
        )

    ctx.data_config = mk(train_list, 0)
    ctx.test_data_config = mk(test_list, 1)


# ---------------------------------------------------------------------------
# parse_config
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParsedConfig:
    trainer_config: proto.TrainerConfig
    topology: Topology
    outputs: List[Layer]
    context: ParseContext

    @property
    def model_config(self) -> proto.ModelConfig:
        return self.trainer_config.model_config


def _dsl_namespace() -> Dict[str, Any]:
    import paddle_tpu_torch.config.helpers as helpers

    ns: Dict[str, Any] = {}
    for name in helpers.__all__:
        ns[name] = getattr(helpers, name)
    ns.update(
        outputs=outputs,
        inputs=inputs,
        get_config_arg=get_config_arg,
        define_py_data_sources2=define_py_data_sources2,
        # legacy raw-config primitives (config_parser.py)
        Inputs=Inputs, Outputs=Outputs, TrainData=TrainData, TestData=TestData,
        ProtoData=ProtoData, SimpleData=SimpleData, PyData=PyData,
        Settings=Settings, model_type=model_type,
        xrange=range, unicode=str,  # the reference's configs are python-2 era
        default_initial_std=default_initial_std,
        default_initial_mean=default_initial_mean,
        default_decay_rate=default_decay_rate, default_device=default_device,
        default_num_batches_regularization=default_num_batches_regularization,
    )
    # the rawest Layer()/Memory()/RecurrentLayerGroupBegin name-registry DSL
    from paddle_tpu_torch.config.raw_api import RAW_API

    ns.update(RAW_API)
    return ns


def _parse_arg_str(config_arg_str: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in (config_arg_str or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


def _generates(layer) -> bool:
    """Whether `layer` is what `outputs('__beam_search_predict__')` names:
    the reference's default name of the beam_search output, which the
    port's generating node does not carry (it takes the user's group
    name). A beam_search node counts, and so does an outer
    recurrent_group whose step generates (the nested-generation idiom,
    sample_trainer_nest_rnn_gen), whose output concatenates the inner
    beams."""
    if getattr(layer, "type_name", "") == "beam_search":
        return True
    core = getattr(layer, "_group_core", None)
    return core is not None and any(
        getattr(o, "type_name", "") == "beam_search" for o in core.out_layers)


def parse_config(
    config: Union[str, Callable[[], Any]],
    config_arg_str: str = "",
    emit_proto: bool = True,
) -> ParsedConfig:
    """Execute `config` (a .py file path or a zero-arg callable using the DSL)
    and return the parsed result. Mirrors parse_config(trainer_config,
    config_arg_str) → TrainerConfig proto."""
    from paddle_tpu_torch.nn.graph import record_layers

    with fresh_context(_parse_arg_str(config_arg_str)) as ctx, record_layers(
        []
    ) as created:
        reset_name_scope()
        if callable(config):
            ret = config()
            if ret is not None and not ctx.outputs:
                outputs(ret)
        else:
            # config scripts import `paddle.trainer_config_helpers`: while
            # the script runs those paths are the port's own modules
            from paddle_tpu_torch.compat import paddle_modules

            ns = _dsl_namespace()
            ns["__file__"] = config
            with open(config) as f:
                code = compile(f.read(), config, "exec")
            with paddle_modules():
                exec(code, ns)
        if ctx.pending_output_names:
            by_name = {l.name: l for l in created}
            for n in ctx.pending_output_names:
                node = by_name.get(n)
                if node is None and n == "__beam_search_predict__":
                    node = next((l for l in created if _generates(l)), None)
                if node is not None and node not in ctx.outputs:
                    ctx.outputs.append(node)
        if not ctx.outputs:
            raise ValueError(
                f"config {config!r} declared no outputs(); call outputs(cost)"
            )
        if not callable(config):
            import os

            cfg_dir = os.path.dirname(os.path.abspath(config))
            for dc in (ctx.data_config, ctx.test_data_config):
                if dc is not None and not dc.config_dir:
                    dc.config_dir = cfg_dir
        # bind the provider's declared input_types to the data layers before
        # tracing — the reference's runtime slot binding (PyDataProvider2);
        # this is where sub-sequence nesting comes from when the config
        # doesn't wrap inputs in SubsequenceInput. Only a provider that
        # cannot be imported is passed over (configs often name providers
        # that do not exist at parse time); any other failure raises.
        if ctx.data_config is not None and ctx.data_config.load_data_module:
            from paddle_tpu_torch.data.provider import bind_provider_types

            try:
                bind_provider_types(Topology(ctx.outputs), ctx.data_config)
            except ImportError:
                pass
        # layers created by the script but unreachable from outputs() stay in
        # the config, as the reference's do (unused_layers.py golden; print
        # layers have no consumers by design) — carried as extra_layers
        reachable = {
            l.name for l in Topology(ctx.outputs).network.layer_order
        }
        dangling = []
        for l in created:
            if l.name not in reachable and l.name not in {d.name for d in dangling}:
                dangling.append(l)
        topology = Topology(ctx.outputs, extra_layers=dangling)
        # Inputs(...) fixes the provider slot order (config_parser Inputs);
        # without it the data layers' topological order stands in
        topology.declared_inputs = list(ctx.pending_input_names)
        tc = proto.TrainerConfig(
            opt_config=ctx.opt_config or proto.OptimizationConfig(),
            data_config=ctx.data_config,
            test_data_config=ctx.test_data_config,
        )
        if emit_proto:
            from paddle_tpu_torch.config.dump import build_model_config

            tc.model_config = build_model_config(topology)
            tc.model_config.evaluators = list(ctx.evaluators)
            tc.model_config.type = ctx.model_type
        return ParsedConfig(tc, topology, list(ctx.outputs), ctx)


def parse_config_and_serialize(config: Union[str, Callable], config_arg_str: str = "") -> str:
    """Reference-named entry point: parse then serialize to text format."""
    return proto.to_text(parse_config(config, config_arg_str).trainer_config)
