"""The paged-KV serving engine, ported: the counterpart of
`paddle_tpu/serving/`, in process or behind its RPC server.

    from paddle_tpu_torch.serving import make_demo_session
    s = make_demo_session(max_slots=8)          # on CUDA; device="cpu" to ask for the CPU
    h = s.submit([1, 5, 9], max_new_tokens=16)
    s.run_until_idle()
    print(h.result())

    from paddle_tpu_torch.serving import ServingClient, ServingServer
    srv = ServingServer(make_demo_session(), port=0).start()
    print(ServingClient(srv.address).generate([1, 5, 9], 16)["tokens"])

(or `python -m paddle_tpu_torch serve --demo`). The router and fleet wait
for a later slice (ROADMAP.md)."""

from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.serving.model import LMConfig, ServableLM
from paddle_tpu_torch.serving.quota import QuotaExceeded, TenantQuotas
from paddle_tpu_torch.serving.scheduler import (
    FinishReason,
    RequestHandle,
    Scheduler,
)
from paddle_tpu_torch.serving.server import Rejected, ServingClient, ServingServer
from paddle_tpu_torch.serving.session import (
    SERVING_EVENTS,
    ServingSession,
    make_demo_session,
)
from paddle_tpu_torch.serving.speculation import PromptLookupDrafter

__all__ = [
    "PagedKVCache",
    "LMConfig",
    "ServableLM",
    "QuotaExceeded",
    "TenantQuotas",
    "FinishReason",
    "RequestHandle",
    "Scheduler",
    "Rejected",
    "ServingClient",
    "ServingServer",
    "PromptLookupDrafter",
    "SERVING_EVENTS",
    "ServingSession",
    "make_demo_session",
]
