"""Observability for the port: spans (`obs.trace`) and metrics
(`obs.metrics`), the counterparts of `paddle_tpu/obs/`. Profiling waits for a
later slice (torch.profiler takes the place of jax.profiler there)."""

from paddle_tpu_torch.obs import metrics, trace  # noqa: F401
from paddle_tpu_torch.obs.metrics import REGISTRY  # noqa: F401
from paddle_tpu_torch.obs.trace import TRACER, enable_tracing, span  # noqa: F401

__all__ = ["REGISTRY", "TRACER", "enable_tracing", "metrics", "span", "trace"]
