"""The PyTorch port stands alone.

  * No file of `paddle_tpu_torch/` (nor chip_smoke.py) imports jax or the
    JAX package — matched by exact module name, since the port's own name
    starts with the string "paddle_tpu".
  * The whole package imports in a process where jax and `paddle_tpu` are
    unimportable.
  * Device policy: entry points without `device=` run on CUDA and raise
    when it is absent; the CPU runs only when asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _forbidden(module: str) -> bool:
    return any(
        module == root or module.startswith(root + ".")
        for root in ("jax", "jaxlib", "paddle_tpu")
    )


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_forbidden_matches_exact_module_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("paddle_tpu") and _forbidden("paddle_tpu.serving.model")
    assert not _forbidden("paddle_tpu_torch")
    assert not _forbidden("paddle_tpu_torch.serving.model")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None  # any `import jax` now raises ImportError

class _BlockReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "paddle_tpu" or name.startswith("paddle_tpu."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _BlockReference())
import paddle_tpu_torch
import paddle_tpu_torch.serving.session
names = [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "paddle_tpu" or m.startswith("paddle_tpu.")
               for m in sys.modules), "the JAX package was imported"
print(len(names))
"""


def test_package_imports_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


# -- device policy ------------------------------------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_demo_session_without_device_raises_when_cuda_absent(no_cuda):
    from paddle_tpu_torch.serving import make_demo_session

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_demo_session()


def test_model_and_session_without_device_raise_when_cuda_absent(no_cuda):
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.serving import LMConfig, ServableLM, ServingSession

    cfg = LMConfig(vocab=32, n_layers=1, d_model=16, n_heads=2, max_len=96)
    with pytest.raises(RuntimeError, match="is_available"):
        ServableLM(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    # a CPU model does not make a session quietly run on the CPU
    with pytest.raises(RuntimeError, match="is_available"):
        ServingSession(ServableLM(cfg, device="cpu"))


def test_unknown_device_rejected():
    from paddle_tpu_torch.device import resolve_device

    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_demo_session_on_cpu_when_asked(no_cuda):
    from paddle_tpu_torch.serving import make_demo_session

    s = make_demo_session(device="cpu", max_slots=2)
    h = s.submit([1, 5, 9], 4)
    s.run_until_idle()
    assert len(h.result()) == 4
    assert s.stats()["device"] == "cpu"
    assert s.k_pages.device.type == "cpu"
    assert s.model.device.type == "cpu"
