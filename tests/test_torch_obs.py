"""The port's host-side telemetry and fault injection (obs/, core/), as the
serving engine uses them: spans around prefill and decode, the serving
event counters and histograms in the metrics read paths, the chaos sites
the session polls, and the decode-signature counter."""

import numpy as np
import pytest

from paddle_tpu_torch.core import faults, stats
from paddle_tpu_torch.obs import metrics, trace
from paddle_tpu_torch.serving import make_demo_session


def _session(**kw):
    return make_demo_session(device="cpu", max_slots=2, **kw)


def test_spans_recorded_around_engine_work():
    trace.reset()
    trace.enable_tracing(True)
    try:
        s = _session(prefill_chunk=8)
        with trace.span("client.request"):
            s.submit([1, 5, 9], 3)
            s.submit([1] + list(range(3, 20)), 3)
        s.run_until_idle()
        out = trace.export_chrome()
    finally:
        trace.enable_tracing(False)
        trace.reset()
    names = {e["name"] for e in out["traceEvents"]}
    assert {"serving.prefill", "serving.prefill_chunk", "serving.decode_step",
            "serving.queue_wait", "serving.ttft"} <= names
    assert trace.validate_chrome(out) == []
    # engine spans of a request stitch under the submitter's trace id
    root = next(e for e in out["traceEvents"] if e["name"] == "client.request")
    tid = root["args"]["trace_id"]
    assert any(e["name"] == "serving.prefill" and e["args"]["trace_id"] == tid
               for e in out["traceEvents"])


def test_disabled_tracing_is_the_shared_no_op():
    assert not trace.TRACER.enabled
    assert trace.span("x", a=1) is trace.span("y")
    assert trace.wire_context() is None


def test_serving_counters_reach_the_read_paths():
    s = _session()
    before = metrics.snapshot().get(
        "paddle_tpu_events_total{event=serving_decode_steps,group=serving}", 0
    )
    s.submit([1, 5, 9], 4)
    s.run_until_idle()
    snap = metrics.snapshot()
    key = "paddle_tpu_events_total{event=serving_decode_steps,group=serving}"
    assert snap[key] == before + s.decode_steps
    assert snap["paddle_tpu_serving_ttft_seconds_count"] >= 1
    text = metrics.to_prometheus_text()
    assert "# TYPE paddle_tpu_serving_request_seconds_bucket counter" in text
    assert 'group="serving"' in text


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["decode_raise", "page_exhaust"])
def test_chaos_sites_fire_in_the_engine_step(site):
    s = _session()
    s.submit([1, 5, 9], 4)
    with faults.inject(f"{site}:step=0") as inj:
        with pytest.raises(faults.InjectedFault, match=site):
            s.step()
        assert inj.fired == {site: 1}
    assert not faults.get().active


def test_fault_spec_grammar():
    spec = faults.parse_spec("decode_raise:step=3, page_exhaust:0.5, x_delay:5ms")
    assert spec["decode_raise"].step == 3
    assert spec["page_exhaust"].prob == 0.5
    assert spec["x_delay"].delay_s == pytest.approx(0.005)
    for bad in ("decode_raise", "decode_raise:5ms", "x_delay:0.5", "a:2.0"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)


def test_batch_signature_and_recompile_stats():
    a = {"tokens": np.zeros(4, np.int32), "table": np.zeros((4, 8), np.int32)}
    b = {"tokens": np.ones(4, np.int32), "table": np.ones((4, 8), np.int32)}
    c = {"tokens": np.zeros(5, np.int32), "table": np.zeros((5, 8), np.int32)}
    rs = stats.RecompileStats(warn_threshold=2)
    assert rs.record(stats.batch_signature(a))
    assert not rs.record(stats.batch_signature(b))  # data, not shape
    assert rs.record(stats.batch_signature(c))
    assert rs.total_signatures() == 2
