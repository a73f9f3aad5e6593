"""No file of the benchmark imports JAX or the JAX package, compared by
whole top-level names; the plain references import nothing of the
program; a run that loads them late prints no result."""

import json
import sys
import time
import types

import pytest
import torch

from portbench import harness, isolation, manifest, trace
from portbench.manifest import HERE
from portbench.tests import tiny

FILES = sorted(HERE.rglob("*.py"))


def test_whole_names():
    assert isolation.forbidden_modules(["paddle_tpu_torch", "paddle_tpu_torch.nn",
                                        "jaxtyping", "numpy"]) == []
    assert isolation.forbidden_modules(["jax.numpy", "paddle_tpu.nn", "flax"]) == \
        ["flax", "jax", "paddle_tpu"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not isolation.imported_tops(path) & isolation.FORBIDDEN


@pytest.mark.parametrize("path", sorted(HERE.glob("configs/*_ref.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert isolation.PROGRAM not in isolation.imported_tops(path)
    assert isolation.imported_tops(path) <= {"__future__", "math", "typing", "numpy", "torch"}


def _late_import(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


@pytest.mark.parametrize("where", ["nowhere", "reference", "reader"])
def test_a_late_import_leaves_no_result(where, monkeypatch, capsys):
    """JAX loaded after the window, by the reference or by a per-layer
    reader, is caught in the process that prints: no result, exit 1. The
    traced stretch is stood in for on the CPU (the profiler needs a card)."""
    for name in [m for m in sys.modules if isolation.top(m) in isolation.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(trace, "profile_stretch",
                        lambda fn, device: (fn(), trace.Trace({"op": [1.0, 1]}, 1.0, 1.0, []))[1])
    if where == "reference":
        reference = harness.Setup.reference

        def planted(self, *args, **kwargs):
            out = reference(self, *args, **kwargs)
            _late_import(monkeypatch)
            return out

        monkeypatch.setattr(harness.Setup, "reference", planted)
    elif where == "reader":
        monkeypatch.setattr(manifest.Cell, "reader", lambda self, metric: types.SimpleNamespace(
            read=lambda run: _late_import(monkeypatch)))
    result = harness.run_rank(tiny.cell("nmt.ragged"), 2 ** 31 + 5, 0.3, True, harness.Coord(),
                              torch.device("cpu"), time.time())
    rc = harness.emit(result)
    out = capsys.readouterr()
    if where == "nowhere":
        assert rc == 0 and json.loads(out.out.strip().splitlines()[-1])["correct"]
    else:
        assert rc == 1 and out.out.strip() == ""
        assert "jax" in out.err
