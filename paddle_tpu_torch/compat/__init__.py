"""The `paddle.*` import paths of v1 scripts, on the port's own modules.

A v1 config begins `from paddle.trainer_config_helpers import *` and a
provider `from paddle.trainer.PyDataProvider2 import *`. The repo's
`paddle/` package answers those imports with the JAX package, so while the
port executes a config or imports a provider, `paddle_modules()` maps

    paddle                              -> a bare package of the four below
    paddle.trainer_config_helpers       -> compat/trainer_config_helpers.py
    paddle.trainer                      -> a bare package of the two below
    paddle.trainer.PyDataProvider2      -> compat/PyDataProvider2.py
    paddle.trainer.config_parser        -> compat/config_parser.py

in `sys.modules`, and puts back whatever was there (or nothing) when the
block ends. A submodule a script imports under another `paddle.*` name is
dropped afterwards too, so nothing of the mapping outlives the block."""

from __future__ import annotations

import contextlib
import importlib
import sys
import threading
import types
from typing import Dict, Optional

_MAPPED = {
    "paddle.trainer_config_helpers": "paddle_tpu_torch.compat.trainer_config_helpers",
    "paddle.trainer.PyDataProvider2": "paddle_tpu_torch.compat.PyDataProvider2",
    "paddle.trainer.config_parser": "paddle_tpu_torch.compat.config_parser",
}
_lock = threading.RLock()
_active: Optional[types.ModuleType] = None  # the mapped `paddle` while a block runs


def _package(name: str, children: Dict[str, types.ModuleType]) -> types.ModuleType:
    pkg = types.ModuleType(name, f"{name} (the port's v1 import path)")
    pkg.__path__ = []  # a package: `import paddle.x` looks its children up
    for attr, mod in children.items():
        setattr(pkg, attr, mod)
    return pkg


@contextlib.contextmanager
def paddle_modules():
    """Map the v1 `paddle.*` import paths to the port's modules for the
    block (re-entrant; the outermost block restores `sys.modules`)."""
    global _active
    with _lock:
        if _active is not None and sys.modules.get("paddle") is _active:
            yield  # nested: the mapping is in place
            return
        saved = {k: v for k, v in sys.modules.items()
                 if k == "paddle" or k.startswith("paddle.")}
        mods = {k: importlib.import_module(v) for k, v in _MAPPED.items()}
        trainer = _package("paddle.trainer", {
            "PyDataProvider2": mods["paddle.trainer.PyDataProvider2"],
            "config_parser": mods["paddle.trainer.config_parser"]})
        root = _package("paddle", {
            "trainer_config_helpers": mods["paddle.trainer_config_helpers"],
            "trainer": trainer})
        for k in saved:
            del sys.modules[k]
        sys.modules.update(mods)
        sys.modules["paddle.trainer"] = trainer
        sys.modules["paddle"] = root
        _active = root
        try:
            yield
        finally:
            _active = None
            for k in [k for k in sys.modules if k == "paddle" or k.startswith("paddle.")]:
                del sys.modules[k]
            sys.modules.update(saved)
