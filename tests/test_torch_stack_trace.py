"""The port's layer-name crash context (`paddle_tpu_torch/core/stack_trace.py`
inside `nn/graph.py`'s forward) against the JAX package's, on the CPU.

  * `layer_frame` / `current_stack` / `format_stack` nest and unwind as
    the JAX package's, and `LayerError` formats the same text.
  * Twins of tests/test_graph.py:41-52 (two `Fc`s sharing a parameter at
    widths 8 and 4) and tests/test_utils_core.py:48 (an `Addto` of widths 4
    and 5), plus a forward error (a width-5 batch into an 8-wide `Fc`):
    the port raises `LayerError` naming the same layer, with the same
    layer stack text as the JAX package (the text up to the cause's type).
  * Inside a recurrent group: the JAX package evaluates a group's step
    net without frames of its own, so an inner layer's failure names the
    group; the port's is the same, and no error is wrapped twice.
jax is imported inside the tests only."""

import numpy as np
import pytest

from paddle_tpu_torch.core import stack_trace as tst


def _pkg(name):
    """(layers, graph, stack_trace, ParamAttr, v2 layer, v2 data_type)."""
    if name == "jax":
        from paddle_tpu.core import stack_trace
        from paddle_tpu.nn import graph, layers
        from paddle_tpu.nn.graph import ParamAttr
        from paddle_tpu.v2 import data_type, layer
    else:
        from paddle_tpu_torch.core import stack_trace
        from paddle_tpu_torch.nn import graph, layers
        from paddle_tpu_torch.nn.graph import ParamAttr
        from paddle_tpu_torch.v2 import data_type, layer
    return layers, graph, stack_trace, ParamAttr, layer, data_type


def _raise(pkg, build, batch, apply=False):
    """build(pkg modules) -> Network; its init (or apply from its init's
    parameters on `batch`) must raise the package's LayerError."""
    L, G, st, PA, vl, dt = _pkg(pkg)
    G.reset_name_scope()
    net = build(L, G, PA, vl, dt)
    if pkg == "jax":
        import jax

        init = lambda: net.init(jax.random.PRNGKey(0), batch[0])  # noqa: E731
        run = lambda p: net.apply(p[0], p[1], batch[1])  # noqa: E731
    else:
        init = lambda: net.init(batch[0], device="cpu", with_states=True)  # noqa: E731
        run = lambda p: net.apply(p[0], batch[1], p[1])  # noqa: E731
    with pytest.raises(st.LayerError) as ei:
        run(init()) if apply else init()
    e = ei.value
    assert not isinstance(e.__cause__, st.LayerError)  # wrapped once
    assert str(e).startswith(f"error in layer {e.layer_name!r} ")
    return e


def _head(e):
    """The text up to the cause: "error in layer 'x' (layer stack: ...)"."""
    return str(e).split("): ")[0] + ")"


def _same_as_jax(build, batch, match, apply=False):
    want = _raise("jax", build, batch, apply)
    got = _raise("torch", build, batch, apply)
    assert (got.layer_name, got.layer_stack, _head(got)) == (
        want.layer_name, want.layer_stack, _head(want))
    assert match in str(got) and match in str(want)
    return got


def test_frames_nest_and_unwind_as_jax():
    from paddle_tpu.core import stack_trace as jst

    for st in (jst, tst):
        assert st.current_stack() == [] and st.format_stack() == ""
        with st.layer_frame("outer"):
            with st.layer_frame("inner"):
                seen = (st.current_stack(), st.format_stack())
            with pytest.raises(KeyError):
                with st.layer_frame("raising"):
                    raise KeyError("x")
            assert st.current_stack() == ["outer"]
        assert seen == (["outer", "inner"], "outer -> inner")
        assert st.current_stack() == []
    cause = ValueError("bad width")
    for stack in ([], ["g", "fc"]):
        assert str(tst.LayerError("fc", stack, cause)) == str(jst.LayerError("fc", stack, cause))
    e = tst.LayerError("fc", ["g", "fc"], cause)
    assert (e.layer_name, e.layer_stack, isinstance(e, RuntimeError)) == ("fc", ["g", "fc"], True)


def _shared_mismatch(L, G, PA, vl, dt):
    data = L.Data("x", shape=(8,))
    shared = PA(name="w")
    a = L.Fc(data, size=8, act=None, bias=False, param_attr=shared)
    return G.Network(L.Fc(a, size=4, act=None, bias=False, param_attr=shared))


def test_shared_param_shape_mismatch_names_the_layer():
    """tests/test_graph.py:41-52's twin."""
    x = {"x": np.zeros((2, 8), np.float32)}
    e = _same_as_jax(_shared_mismatch, (x, x), "mismatch")
    assert e.layer_name == "__fc_1__" and e.layer_stack == ["__fc_1__"]


def test_addto_shape_error_names_the_layer():
    """tests/test_utils_core.py:48's twin."""
    def build(L, G, PA, vl, dt):
        bad = L.Addto([L.Data("a", shape=(4,)), L.Data("b", shape=(5,))],
                      name="mismatched_add")
        return G.Network([bad])

    batch = {"a": np.zeros((2, 4), np.float32), "b": np.zeros((2, 5), np.float32)}
    e = _same_as_jax(build, (batch, batch), "mismatched_add")
    assert e.layer_name == "mismatched_add"


def test_forward_error_names_the_layer():
    """A width-5 batch into an 8-wide Fc, from parameters made for 8."""
    def build(L, G, PA, vl, dt):
        return G.Network([L.Fc(L.Data("x", shape=(8,)), 3, act=None)])

    good, bad = {"x": np.zeros((2, 8), np.float32)}, {"x": np.zeros((2, 5), np.float32)}
    e = _same_as_jax(build, (good, bad), "__fc_0__", apply=True)
    assert str(e).startswith("error in layer '__fc_0__' (layer stack: __fc_0__): ")


def test_error_inside_a_recurrent_group_names_the_group():
    """A step net whose fc shares a parameter at the wrong shape: both
    packages name the group (the step's layers push no frame of their own)."""
    def build(L, G, PA, vl, dt):
        enc = vl.data(name="enc", type=dt.dense_vector_sequence(4))

        def step(x):
            h = vl.fc(input=x, size=4, act=None, bias_attr=False,
                      param_attr=PA(name="shared_w"))
            return vl.fc(input=h, size=3, act=None, bias_attr=False,
                         param_attr=PA(name="shared_w"))

        return G.Network([vl.recurrent_group(step=step, input=enc, name="grp")])

    batch = {"enc": np.zeros((2, 3, 4), np.float32), "enc.lengths": np.array([3, 2], np.int32)}
    e = _same_as_jax(build, (batch, batch), "shared_w")
    assert e.layer_name == "grp" and e.layer_stack == ["grp"]
    assert tst.current_stack() == []
