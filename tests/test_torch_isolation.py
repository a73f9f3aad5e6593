"""The PyTorch port stands alone.

  * No file of `paddle_tpu_torch/` (nor chip_smoke.py) imports jax, the
    JAX package or the repo's `paddle/` shim (which re-exports it) —
    matched by exact module name, since the port's own name starts with
    the string "paddle_tpu".
  * The whole package imports in a process where jax and `paddle_tpu` are
    unimportable; there a v1 config (`from paddle.trainer_config_helpers
    import *`) and its provider (`from paddle.trainer.PyDataProvider2
    import *`) parse and train one step on the CPU, and afterwards
    `sys.modules` holds neither the `paddle` shim nor `paddle_tpu`.
  * The native runtime is the port's own: `runtime/build.py` compiles only
    the sources under `paddle_tpu_torch/csrc/native/` into
    `build/paddle_tpu_torch/`; no port file names the top-level `csrc/`
    or the JAX package's `runtime/_lib`, and none reads
    `PADDLE_TPU_NO_NATIVE` (there is no fallback to switch to).
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
        for root in ("jax", "jaxlib", "paddle_tpu", "paddle")
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
    assert _forbidden("paddle") and _forbidden("paddle.trainer_config_helpers")


def test_scan_covers_the_config_pipeline():
    scanned = {p.relative_to(REPO).parts[1] for p in PORT_FILES
               if len(p.relative_to(REPO).parts) > 2}
    assert {"config", "proto", "v2", "metrics", "compat", "capi"} <= scanned
    assert REPO / "paddle_tpu_torch" / "api.py" in PORT_FILES


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_native_build_compiles_only_the_ports_sources():
    from paddle_tpu_torch.runtime import build

    port = REPO / "paddle_tpu_torch"
    assert build.NATIVE_DIR == port / "csrc" / "native"
    assert build.BUILD_DIR == REPO / "build" / "paddle_tpu_torch"
    assert build.sources() and all(s.resolve().is_relative_to(port)
                                   for s in build.sources() + build.headers())
    assert build.library_path().parent == build.BUILD_DIR


_NATIVE_FORBIDDEN = ("PADDLE_TPU_NO_NATIVE", "runtime/_lib", '"_lib"', "'_lib'")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_native_fallback_or_reference_library(path):
    text = path.read_text()
    bad = [w for w in _NATIVE_FORBIDDEN if w in text]
    assert not bad, f"{path.relative_to(REPO)} names {bad}"
    # the top-level csrc/ by path: a parent-relative join, or "csrc" as a
    # path component right under the repository root
    for node in ast.walk(ast.parse(text, str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not node.value.startswith(("csrc/", "../csrc", "/csrc")), \
                f"{path.relative_to(REPO)} names {node.value!r}"


_BLOCK = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None  # any `import jax` now raises ImportError

class _BlockReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "paddle_tpu" or name.startswith("paddle_tpu."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _BlockReference())
"""

_BLOCKED_IMPORT = _BLOCK + r"""
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


_V1_CONFIG = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.1, learning_method=MomentumOptimizer(0.9))
define_py_data_sources2(train_list='train.list', test_list=None,
                        module='v1_provider', obj='process')
x = data_layer(name='x', size=6)
y = data_layer(name='y', size=3)
h = mixed_layer(size=5, input=[full_matrix_projection(input=x)], act=TanhActivation())
out = fc_layer(input=h, size=3, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=y))
"""

_V1_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *

@provider(input_types={'x': dense_vector(6), 'y': integer_value(3)})
def process(settings, filename):
    rs = np.random.RandomState(0)
    for _ in range(4):
        yield {'x': rs.randn(6).astype('float32'), 'y': int(rs.randint(3))}
"""

_BLOCKED_V1 = _BLOCK + r"""
import os
os.chdir(sys.argv[1])
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch import cli
job = cli.prepare_train(cli.parse_args(
    ["train", "--config=conf.py", "--device=cpu", "--log_period=0"]))
assert job.run() == 0
left = [m for m in sys.modules if m in ("paddle", "paddle_tpu")
        or m.startswith(("paddle.", "paddle_tpu."))]
assert not left, left
assert job.trainer.state["samples"].item() == 4
print("ok")
"""


def test_v1_config_trains_with_jax_and_reference_blocked(tmp_path):
    (tmp_path / "conf.py").write_text(_V1_CONFIG)
    (tmp_path / "v1_provider.py").write_text(_V1_PROVIDER)
    (tmp_path / "train.list").write_text("dummy\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)  # the repo root holds the `paddle/` shim too
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_V1, str(tmp_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "pass 0: avg_cost=" in out.stdout
    assert out.stdout.strip().endswith("ok")


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
