"""paddle.v2.event analog (counterpart of `paddle_tpu/v2/event.py`;
python/paddle/v2/event.py:45-88): the trainer's events and `TestResult`."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from paddle_tpu_torch.trainer.events import (  # noqa: F401
    BeginIteration,
    BeginPass,
    EndIteration,
    EndPass,
)


@dataclasses.dataclass
class TestResult:
    """Result of a test-period evaluation (v2/event.py TestResult)."""

    pass_id: int
    cost: float
    metrics: Optional[Dict[str, Any]] = None
