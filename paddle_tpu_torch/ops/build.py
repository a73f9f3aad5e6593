"""Build the port's CUDA sources into shared libraries and load them.

Each `paddle_tpu_torch/csrc/<name>.cu` exposes a plain C entry point and is
compiled on its own by nvcc into `build/paddle_tpu_torch/<name>-<hash>.so`
next to the package, then loaded with ctypes (no PyTorch headers, so a
build takes seconds rather than minutes). The hash covers the source bytes
and the flags, so an edited source builds anew and an unchanged one is
reused. Nothing builds at import: the first `load()` (or `build()`, which
chip_smoke.py calls up front) does, on the machine with the card.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/paddle_tpu_torch/<name>-<hash>.so csrc/<name>.cu

`sm_90a` (not `sm_90`) keeps Hopper's wgmma/setmaxnreg open to later
kernels. ptxas' register/spill report lands in `<name>-<hash>.log`."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "paddle_tpu_torch"

# every CUDA source of the port, by stem; build() with no names builds all
KERNELS = ("paged_attention",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises when absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of paddle_tpu_torch build on a machine with "
        "the CUDA toolkit"
    )


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where `name`'s library lives, keyed by a hash of source + flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source_path(name))]


def build(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Build every named source that has no library yet — one nvcc process
    per source, all started together — and return {name: library path}.
    Raises with nvcc's output when a build fails."""
    libs = {n: library_path(n) for n in names}
    todo = [n for n, p in libs.items() if not p.exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = libs[n].with_name(f"{libs[n].stem}.{os.getpid()}.tmp.so")
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, n, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        libs[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{source_path(n)} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[n])  # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return libs


def build_log(name: str) -> str:
    """nvcc/ptxas output of `name`'s current build ('' before one exists)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
