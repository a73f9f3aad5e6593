"""Dataset cache plumbing (python/paddle/v2/dataset/common.py; the port's
copy of `paddle_tpu/data/datasets/common.py`).

DATA_HOME caching with md5-checked reads. `download` never fetches: it
returns a file already cached under DATA_HOME whose md5 matches, and raises
`DownloadUnavailable` otherwise. Every dataset then falls back to a
deterministic synthetic sample generator with the exact same record schema,
flagged via the SYNTHETIC global and a log line, so training pipelines stay
runnable end to end without network access. Offline this is the same
behaviour as the JAX package's `download`, which tries the network first.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Callable, Optional

import numpy as np

log = logging.getLogger("paddle_tpu_torch.dataset")

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset")
)

# Set to True the first time a download fails and a synthetic fallback engages.
SYNTHETIC = False


def data_path(module_name: str, filename: str) -> str:
    d = os.path.join(DATA_HOME, module_name)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, filename)


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: Optional[str] = None) -> str:
    """Return the cached copy of url; raises DownloadUnavailable when the file
    is absent or its md5 differs. Nothing is fetched."""
    filename = data_path(module_name, url.split("/")[-1])
    if not os.path.exists(filename):
        raise DownloadUnavailable(f"{url} is not cached at {filename}")
    if md5sum is not None and md5file(filename) != md5sum:
        raise DownloadUnavailable(f"md5 mismatch for cached {filename}")
    return filename


class DownloadUnavailable(RuntimeError):
    pass


def fetch_or_synthetic(fetch: Callable[[], Callable], synth: Callable[[], Callable], what: str):
    """Return fetch() if the real data can be obtained, else synth().

    Both arguments are thunks returning reader creators."""
    global SYNTHETIC
    try:
        return fetch()
    except (DownloadUnavailable, OSError) as e:
        SYNTHETIC = True
        log.warning("%s: real dataset unavailable (%s); using deterministic "
                    "synthetic data with the same schema", what, e)
        return synth()


def rng(seed_tag: str) -> np.random.RandomState:
    """Deterministic per-dataset RandomState (stable across runs/processes)."""
    h = int(hashlib.md5(seed_tag.encode()).hexdigest()[:8], 16)
    return np.random.RandomState(h)
