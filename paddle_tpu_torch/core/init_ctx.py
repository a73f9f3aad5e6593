"""Process-level initialization and global flags (counterpart of
`paddle_tpu/core/init_ctx.py`).

Replaces the reference's gflags surface (paddle/utils/Flags.h:19-43:
use_gpu, trainer_count, log_period, seed, ...) and ``paddle.init``
(python/paddle/v2/__init__.py:65 -> initPaddle): the seed, the log period
and the ambient dtype policy (`core/dtypes.py`). The port has no compilation
cache to wire (the JAX package's `compile_cache` flag) and one device per
process (`device`, where the JAX package keeps `use_tpu`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict

log = logging.getLogger("paddle_tpu_torch")


@dataclasses.dataclass
class GlobalFlags:
    device: str = "cuda"
    trainer_count: int = 1
    log_period: int = 100
    seed: int = 0
    # "float32" | "bfloat16"
    dtype_policy: str = "float32"
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


_flags = GlobalFlags()


def flags() -> GlobalFlags:
    return _flags


def init(**kwargs: Any) -> GlobalFlags:
    """paddle.init analog. Takes the v1 flag names; unknown flags are kept in
    ``extras`` rather than rejected (the reference forwards argv to gflags).
    `use_gpu=False` means device "cpu"."""
    from paddle_tpu_torch.core import dtypes

    for key, value in kwargs.items():
        if key == "use_gpu":
            _flags.device = "cuda" if value else "cpu"
        elif hasattr(_flags, key) and key != "extras":
            setattr(_flags, key, type(getattr(_flags, key))(value))
        else:
            _flags.extras[key] = value
    dtypes.set_policy(dtypes.get(_flags.dtype_policy))
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return _flags
