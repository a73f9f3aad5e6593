"""Build the port's native runtime (`paddle_tpu_torch/csrc/native/*.cc`) into
one shared library with g++ and return its path.

    g++ -std=c++17 -O2 -fPIC -shared -pthread \\
        -o build/paddle_tpu_torch/libpaddle_tpu_torch_rt-<hash>.so csrc/native/*.cc

The library lands in `build/paddle_tpu_torch/` beside the CUDA libraries
(`ops/build.py`), keyed by a hash of every source and header and the flags,
so an edited source builds anew and an unchanged one is reused. The build
runs at first use (`runtime/native.lib()`), never at import. g++ is `$CXX`
when set, else `g++` on PATH; a missing compiler or a failed build raises
with the compiler's output. There is no fallback: `recordio`, `allocator`,
`optimizer` and `TaskMaster` always run the native code."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PACKAGE_DIR / "csrc" / "native"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "paddle_tpu_torch"
NAME = "libpaddle_tpu_torch_rt"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()


def sources() -> List[Path]:
    """Every C++ source of the library, in name order."""
    return sorted(NATIVE_DIR.glob("*.cc"))


def headers() -> List[Path]:
    return sorted(NATIVE_DIR.glob("*.h"))


def library_path() -> Path:
    """Where the library lives, keyed by the sources, headers and flags."""
    h = hashlib.sha256()
    for f in sources() + headers():
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update("\0".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{NAME}-{h.hexdigest()[:16]}.so"


def find_cxx() -> str:
    """The C++ compiler: $CXX, else g++ on PATH; raises when neither is there."""
    for cand in (os.environ.get("CXX"), "g++"):
        if cand:
            path = shutil.which(cand)
            if path:
                return path
    raise RuntimeError("no C++ compiler for the native runtime of paddle_tpu_torch: set "
                       "$CXX or put g++ on PATH")


def build() -> Path:
    """The library's path, building it first when this source tree has none.
    Raises with g++'s output when the build fails."""
    with _lock:
        lib = library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [find_cxx(), *CXX_FLAGS, "-o", str(tmp), *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native runtime build failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent reader never sees half a .so
        return lib
