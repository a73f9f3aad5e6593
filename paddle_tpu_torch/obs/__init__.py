"""Observability for the port, the counterparts of `paddle_tpu/obs/`: spans
(`obs.trace`), metrics (`obs.metrics`, with the master's fleet aggregate),
the pass profiler and step cost report over torch.profiler and torch's
FLOP counter (`obs.profile`), and the operator CLI `python -m
paddle_tpu_torch.obs export|trace`."""

from paddle_tpu_torch.obs import metrics, trace  # noqa: F401
from paddle_tpu_torch.obs.metrics import REGISTRY  # noqa: F401
from paddle_tpu_torch.obs.trace import (  # noqa: F401
    TRACER,
    enable_tracing,
    export_chrome,
    record_span,
    span,
)

__all__ = [
    "REGISTRY",
    "TRACER",
    "enable_tracing",
    "export_chrome",
    "metrics",
    "record_span",
    "span",
    "trace",
]
