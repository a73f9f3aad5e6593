"""`BENCHMARK.json` and the files it names, found by name.

A cell `<config>.<...>` of `workloads` names a configuration (its `file`,
`configs/<config>.json`, with the program's module `configs/<config>.py`
and the plain reference `configs/<config>_ref.py` beside it) and a traffic
mix (`traffic/<mix>.json`); its limits for `correct` are in
`cells/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`. Adding any of them is adding files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (names may hold dots)."""
    key = f"portbench._loaded.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    config_file: Path
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Optional[Dict[str, float]]

    def program(self):
        return load_module(self.config_file.with_suffix(".py"), f"{self.config['name']}_program")

    def reference(self):
        stem = self.config_file.with_suffix("")
        return load_module(stem.with_name(stem.name + "_ref.py"), f"{self.config['name']}_ref")

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py", f"metric_{metric}")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name), None)
    if cell is None:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config_file = ROOT / conf["file"]
    limits_file = HERE / "cells" / f"{cell_name}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else None
    return Cell(
        name=cell_name, chips=int(cell["chips"]),
        config=json.loads(config_file.read_text()),
        traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        config_file=config_file,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, cell_name)],
        limits=limits)
