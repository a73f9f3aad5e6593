"""BENCHMARK.json against the contract's shape, and the files it names."""

import json
import re

import pytest

from portbench.manifest import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        # every cell the metric is read in reports the metric it moves
        for cell in m["workloads"]:
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or cell in mv["workloads"]
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_files_of_each_cell(w):
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    path = ROOT / conf["file"]
    assert path.is_file() and path.with_suffix(".py").is_file()
    assert path.with_name(path.stem + "_ref.py").is_file()
    assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    cfg = json.loads(path.read_text())
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    limits = json.loads((HERE / "cells" / f"{w['name']}.json").read_text())["limits"]
    assert limits and all(v > 0 for v in limits.values())
