"""The port's streaming evaluators (`paddle_tpu_torch/metrics/evaluators.py`)
against the JAX package's, on the same numpy inputs: every evaluator of the
registry, over three batches, gives the JAX package's statistic (and the
printers the same lines, seq_text_printer the same file), `detection_map`
included, in both AP rules. jax is imported inside the tests only."""

import numpy as np
import pytest

from paddle_tpu_torch.metrics import evaluators as tev


def _batches(kind, rs):
    """Three batches of update() keywords for an evaluator kind."""
    out = []
    for _ in range(3):
        b = 6
        if kind in ("classification_error", "classification_error_printer",
                    "max_id_printer"):
            kw = dict(output=rs.rand(b, 5).astype(np.float32),
                      label=rs.randint(0, 5, b), weight=rs.rand(b).astype(np.float32))
        elif kind == "classification_error_seq":
            kw = dict(output=rs.rand(b, 7, 4).astype(np.float32),
                      label=rs.randint(0, 4, (b, 7)), lengths=rs.randint(1, 8, b))
        elif kind == "seq_error":
            kw = dict(output=rs.rand(b, 5, 3).astype(np.float32),
                      label=rs.randint(0, 3, (b, 5)), lengths=rs.randint(1, 6, b))
        elif kind == "auc":
            kw = dict(output=rs.rand(b, 2).astype(np.float32), label=rs.randint(0, 2, b),
                      weight=rs.rand(b).astype(np.float32))
        elif kind == "precision_recall":
            kw = dict(output=rs.rand(b, 4).astype(np.float32), label=rs.randint(0, 4, b),
                      weight=rs.rand(b).astype(np.float32))
        elif kind == "pnpair":
            kw = dict(output=rs.rand(b).astype(np.float32), label=rs.randint(0, 3, b),
                      query_id=rs.randint(0, 2, b), weight=rs.rand(b).astype(np.float32))
        elif kind in ("sum", "value_printer", "gradient_printer"):
            kw = dict(output=rs.rand(b, 3).astype(np.float32),
                      weight=rs.rand(b).astype(np.float32))
        elif kind == "column_sum":
            kw = dict(output=rs.rand(b, 3).astype(np.float32))
        elif kind == "chunk":
            kw = dict(output=rs.randint(0, 7, (b, 9)), label=rs.randint(0, 7, (b, 9)),
                      lengths=rs.randint(3, 10, b))
        elif kind == "ctc_edit_distance":
            kw = dict(output=rs.rand(b, 8, 5).astype(np.float32),
                      lengths=rs.randint(3, 9, b), label=rs.randint(1, 5, (b, 4)),
                      label_lengths=rs.randint(1, 5, b), blank=0)
        elif kind == "ctc_decoded":
            dec = rs.randint(-1, 5, (b, 6))
            kw = dict(decoded=dec, label=rs.randint(1, 5, (b, 4)),
                      label_lengths=rs.randint(1, 5, b))
        else:
            raise AssertionError(kind)
        out.append(kw)
    return out


CASES = {
    # case: (registry name, constructor keywords)
    "classification_error": ("classification_error", {}),
    "classification_error_seq": ("classification_error", {}),
    "seq_error": ("seq_error", {}),
    "auc": ("auc", {}),
    "precision_recall": ("precision_recall", {}),
    "precision_recall_positive": ("precision_recall", {"positive_label": 1}),
    "pnpair": ("pnpair", {}),
    "sum": ("sum", {}),
    "column_sum": ("column_sum", {}),
    "chunk_iob": ("chunk", {"scheme": "IOB", "num_chunk_types": 3}),
    "chunk_ioe_excluded": ("chunk", {"scheme": "IOE", "num_chunk_types": 3,
                                     "excluded_chunk_types": [1]}),
    "chunk_iobes": ("chunk", {"scheme": "IOBES", "num_chunk_types": 1}),
    "chunk_plain": ("chunk", {"scheme": "plain", "num_chunk_types": 6}),
    "ctc_edit_distance": ("ctc_edit_distance", {}),
    "ctc_decoded": ("ctc_error", {}),
}


def _kind(case):
    if case.startswith("chunk"):
        return "chunk"
    if case.startswith("precision_recall"):
        return "precision_recall"
    return case


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_jax(case):
    from paddle_tpu.metrics.evaluators import EVALUATORS as JEVALUATORS

    name, kw = CASES[case]
    port, ref = tev.EVALUATORS.get(name)(**kw), JEVALUATORS.get(name)(**kw)
    for ev in (port, ref):
        ev.start()
    for batch in _batches(_kind(case), np.random.RandomState(len(case))):
        port.update(**batch)
        ref.update(**batch)
    got, want = port.finish(), ref.finish()
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("name,kw", [
    ("value_printer", {}), ("gradient_printer", {}),
    ("max_id_printer", {"num_results": 2}), ("classification_error_printer", {}),
])
def test_printers_write_the_jax_lines(name, kw):
    from paddle_tpu.metrics.evaluators import EVALUATORS as JEVALUATORS

    kind = "sum" if name in ("value_printer", "gradient_printer") else name
    lines = {"port": [], "ref": []}
    port = tev.EVALUATORS.get(name)(writer=lines["port"].append, **kw)
    ref = JEVALUATORS.get(name)(writer=lines["ref"].append, **kw)
    for ev in (port, ref):
        ev.start()
    for batch in _batches(kind, np.random.RandomState(3)):
        port.update(**batch)
        ref.update(**batch)
    assert lines["port"] == lines["ref"] and lines["port"]
    assert port.finish() == ref.finish()


def test_seq_text_printer_writes_the_jax_file(tmp_path):
    from paddle_tpu.metrics.evaluators import EVALUATORS as JEVALUATORS

    (tmp_path / "dict.txt").write_text("\n".join(f"w{i}" for i in range(10)))
    rs = np.random.RandomState(0)
    batches = [
        dict(output=rs.randint(0, 10, (3, 5)), lengths=np.array([5, 2, 4])),
        dict(output=rs.randint(0, 10, (2, 3, 4)), lengths=np.array([2, 3]),
             sub_lengths=np.array([[4, 1, 0], [2, 3, 4]])),
        dict(beam={"history": rs.randint(0, 10, (2, 2, 4)), "scores": rs.rand(2, 2),
                   "lengths": np.array([[4, 2], [3, 1]]), "num_results": 2}),
    ]
    texts = []
    for registry, out in ((tev.EVALUATORS, "port.txt"), (JEVALUATORS, "ref.txt")):
        ev = registry.get("seq_text_printer")(result_file=str(tmp_path / out),
                                              dict_file=str(tmp_path / "dict.txt"))
        ev.start()
        for b in batches:
            ev.update(**b)
        ev.finish()
        texts.append((tmp_path / out).read_text())
    assert texts[0] == texts[1] and texts[0].count("w") > 10


def test_registry_names_match_jax():
    from paddle_tpu.metrics.evaluators import EVALUATORS as JEVALUATORS

    assert tev.EVALUATORS.names() == JEVALUATORS.names()


@pytest.mark.parametrize("ap_type", ["11point", "integral"])
def test_detection_map_raises_named_error(ap_type):
    """`detection_map` (a named error until the detection layers were
    ported) against the JAX package's on two batches of detections, a
    padding row, an unmatched class and a duplicate hit among them."""
    from paddle_tpu.metrics.evaluators import EVALUATORS as JEVALUATORS

    dets = np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4], [1, 0.8, 0.6, 0.6, 0.9, 0.9],
                      [2, 0.7, 0.5, 0.5, 0.8, 0.8], [1, 0.6, 0.12, 0.1, 0.4, 0.42],
                      [0, 0.0, 0, 0, 0, 0]],
                     [[3, 0.95, 0.2, 0.2, 0.5, 0.5], [2, 0.5, 0.0, 0.0, 0.3, 0.3],
                      [1, 0.4, 0.5, 0.5, 0.9, 0.9], [0, 0.0, 0, 0, 0, 0],
                      [0, 0.0, 0, 0, 0, 0]]], np.float32)
    gtb = np.array([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.8, 0.8]],
                    [[0.2, 0.2, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9]]], np.float32)
    gtl = np.array([[1, 2], [3, 4]])
    results = []
    for registry in (tev.EVALUATORS, JEVALUATORS):
        ev = registry.get("detection_map")(ap_type=ap_type)
        ev.start()
        for _ in range(2):
            ev.update(detections=dets, gt_boxes=gtb, gt_labels=gtl,
                      gt_lengths=np.array([2, 2]))
        results.append(ev.finish())
    assert 0.0 < results[1] < 1.0
    assert results[0] == results[1]
