"""Admission control: per-tenant token quotas + concurrency caps.

The port's copy of `paddle_tpu/serving/quota.py` (pure host code, kept
identical so both engines say no to the same requests).

The front door says no *before* any device work is queued ("admission
control"): a request is charged its worst case
(prompt + max_new_tokens) against its tenant's token bucket at submit time,
and rejected — never silently queued forever — when the tenant is over
budget, over its concurrency cap, or the global queue is full. The token
bucket refills continuously (tokens_per_s up to a burst capacity), the
standard shape for "heavy traffic from millions of users" fairness; the
clock is injectable so tests are deterministic.

This is also where request *deadlines* get their defaults:
a tenant may carry a default total-latency and/or TTFT deadline
(`set_quota(deadline_s=, ttft_deadline_s=)`), applied to any request that
does not name its own — the scheduler enforces them at admission, in the
queue, and at decode-step boundaries."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class QuotaExceeded(Exception):
    """Rejected by admission control; `reason` is machine-readable
    ('tokens' | 'concurrency' | 'queue' | 'overload' | 'deadline' |
    'unregistered'). `retry_after_ms` — set on load sheds — is the server's
    estimate of when retrying could succeed, derived from the current queue
    wait and free-page pressure; a client that honors it converts a goodput
    collapse into bounded backoff."""

    def __init__(self, msg: str, reason: str,
                 retry_after_ms: Optional[int] = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class _Bucket:
    __slots__ = ("capacity", "rate", "level", "last", "in_flight")

    def __init__(self, capacity: float, rate: float, now: float):
        self.capacity = capacity
        self.rate = rate
        self.level = capacity
        self.last = now
        self.in_flight = 0


class TenantQuotas:
    """Per-tenant token buckets + concurrency caps.

    `token_capacity` is the burst size and `tokens_per_s` the refill rate;
    either may be None (unlimited). Unknown tenants get the defaults, so a
    fleet-wide cap needs no per-tenant config."""

    def __init__(
        self,
        token_capacity: Optional[float] = None,
        tokens_per_s: float = 0.0,
        max_concurrent: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        default_deadline_s: Optional[float] = None,
        default_ttft_deadline_s: Optional[float] = None,
    ):
        self._default = (token_capacity, float(tokens_per_s), max_concurrent)
        # tenant-configurable request deadlines: requests that do
        # not name their own total-latency / time-to-first-token deadline
        # inherit the tenant's, falling back to these fleet-wide defaults
        self._default_deadlines = (default_deadline_s, default_ttft_deadline_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, _Bucket] = {}
        self._caps: Dict[str, Optional[int]] = {}
        self._deadlines: Dict[str, tuple] = {}
        # concurrency holds for tenants with no token bucket
        self._hold_counts: Dict[str, int] = {}

    def set_quota(
        self,
        tenant: str,
        token_capacity: Optional[float] = None,
        tokens_per_s: float = 0.0,
        max_concurrent: Optional[int] = None,
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
    ) -> None:
        with self._lock:
            if token_capacity is not None:
                b = _Bucket(token_capacity, float(tokens_per_s), self._clock())
                self._buckets[tenant] = b
            self._caps[tenant] = max_concurrent
            if deadline_s is not None or ttft_deadline_s is not None:
                self._deadlines[tenant] = (deadline_s, ttft_deadline_s)

    def deadlines_for(self, tenant: str) -> tuple:
        """(total_deadline_s, ttft_deadline_s) this tenant's requests default
        to — per-tenant override where set, else the fleet-wide defaults;
        either element may be None (no deadline)."""
        with self._lock:
            d, td = self._deadlines.get(tenant, (None, None))
            dd, dtd = self._default_deadlines
            return (d if d is not None else dd, td if td is not None else dtd)

    def _bucket(self, tenant: str) -> Optional[_Bucket]:
        b = self._buckets.get(tenant)
        if b is None and self._default[0] is not None:
            b = _Bucket(self._default[0], self._default[1], self._clock())
            self._buckets[tenant] = b
        return b

    def _cap(self, tenant: str) -> Optional[int]:
        return self._caps.get(tenant, self._default[2])

    def admit(self, tenant: str, tokens: int) -> None:
        """Charge `tokens` against the tenant or raise QuotaExceeded. The
        concurrency hold is released by release(); the tokens are consumed."""
        with self._lock:
            b = self._bucket(tenant)
            cap = self._cap(tenant)
            # concurrency first: a capped tenant must not drain its bucket
            # with requests that would be refused anyway
            holds = b.in_flight if b is not None else self._holds(tenant)
            if cap is not None and holds >= cap:
                raise QuotaExceeded(
                    f"tenant {tenant!r} at max_concurrent={cap}", "concurrency"
                )
            if b is not None:
                now = self._clock()
                b.level = min(b.capacity, b.level + (now - b.last) * b.rate)
                b.last = now
                if tokens > b.level:
                    raise QuotaExceeded(
                        f"tenant {tenant!r} over token quota: wanted {tokens}, "
                        f"{b.level:.0f} of {b.capacity:.0f} available",
                        "tokens",
                    )
                b.level -= tokens
                b.in_flight += 1
            else:
                self._hold_counts[tenant] = self._holds(tenant) + 1

    def _holds(self, tenant: str) -> int:
        return self._hold_counts.get(tenant, 0)

    def release(self, tenant: str, unused_tokens: int = 0) -> None:
        """Drop the concurrency hold; refund tokens the request reserved but
        never generated (a request that stops at EOS early should not keep
        paying for its worst case)."""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is not None:
                b.in_flight = max(0, b.in_flight - 1)
                if unused_tokens:
                    b.level = min(b.capacity, b.level + unused_tokens)
            elif self._holds(tenant):
                self._hold_counts[tenant] -= 1

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                t: {
                    "level": round(b.level, 1),
                    "capacity": b.capacity,
                    "in_flight": b.in_flight,
                }
                for t, b in self._buckets.items()
            }
