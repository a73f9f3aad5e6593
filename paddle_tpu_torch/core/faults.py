"""Deterministic chaos-injection harness.

The port's copy of `paddle_tpu/core/faults.py`, same spec grammar and same
environment switches, so one `PADDLE_TPU_FAULTS` spec drives both engines.

Spec grammar (env `PADDLE_TPU_FAULTS` or `configure()`/`inject()`):

    site:value[,site:value...]

where `value` is one of
    0.05        fire with probability 0.05 per hit (seeded per-site RNG)
    5ms / 0.5s  fire on every hit, with that delay (for *_delay sites)
    step=37     fire exactly once, on the site's 37th hit (0-based)

Sites the ported code polls (hooks live next to the code they sabotage):
    decode_raise   serving engine raises mid-decode or mid-   (serving.session._decode_once,
                   speculation — the supervisor restarts the   serving.session._speculate)
                   engine, re-initialises the page pools and
                   replays in-flight requests
    page_exhaust   KV page pool fails at admission           (serving.session._admit)
    engine_stall   serving engine thread wedges between      (serving.session._engine_loop)
                   steps — the supervisor's stall watchdog
                   must supersede it; stall length via
                   PADDLE_TPU_SERVING_STALL_S (default 300)
    conn_reset     the RPC client's socket resets after      (runtime.master.MasterClient)
                   connect; the reconnect/failover path
                   must absorb it

Seeding: `PADDLE_TPU_FAULTS_SEED` (or the `seed` argument). Each site gets
its own `random.Random(f"{seed}:{site}")` stream, so the fire pattern of one
site is independent of how often the others are polled."""

from __future__ import annotations

import contextlib
import logging
import os
import random
import re
import threading
import time
from typing import Dict, Iterator, Optional


class InjectedFault(RuntimeError):
    """A fault raised on purpose by the chaos harness."""


class InjectedKill(InjectedFault):
    """Simulated process death (SIGKILL analog)."""


_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)$")


class FaultSpec:
    """One parsed `site:value` entry."""

    __slots__ = ("site", "prob", "step", "delay_s")

    def __init__(self, site: str, prob=None, step=None, delay_s=None):
        self.site = site
        self.prob = prob
        self.step = step
        self.delay_s = delay_s

    def __repr__(self):
        for k in ("prob", "step", "delay_s"):
            v = getattr(self, k)
            if v is not None:
                return f"FaultSpec({self.site}:{k}={v})"
        return f"FaultSpec({self.site})"


def parse_spec(spec: str) -> Dict[str, FaultSpec]:
    out: Dict[str, FaultSpec] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, value = entry.partition(":")
        site = site.strip()
        value = value.strip()
        if not sep or not site or not value:
            raise ValueError(
                f"bad fault entry {entry!r}: want site:prob, site:<N>ms|<N>s "
                f"or site:step=<N>"
            )
        m = _DURATION_RE.match(value)
        if m:
            if not site.endswith("_delay"):
                raise ValueError(
                    f"duration value {value!r} only makes sense for *_delay "
                    f"sites, not {site!r} (use a probability or step=N)"
                )
            scale = 1e-3 if m.group(2) == "ms" else 1.0
            out[site] = FaultSpec(site, delay_s=float(m.group(1)) * scale)
        elif site.endswith("_delay"):
            raise ValueError(
                f"*_delay site {site!r} needs a duration value "
                f"(<N>ms or <N>s), got {value!r}"
            )
        elif value.startswith("step="):
            out[site] = FaultSpec(site, step=int(value[len("step="):]))
        else:
            try:
                prob = float(value)
            except ValueError:
                raise ValueError(f"bad fault value {value!r} for site {site!r}")
            if not 0.0 <= prob <= 1.0:
                raise ValueError(
                    f"fault probability for {site!r} must be in [0,1], got {prob}"
                )
            out[site] = FaultSpec(site, prob=prob)
    return out


class FaultInjector:
    """Seeded, thread-safe fault decision engine.

    `fire(site)` counts a hit and decides whether the fault triggers; hits
    and trigger counts are exposed (`hits` / `fired`) so tests can assert
    both "the fault happened" and "the hook point was actually reached"."""

    def __init__(self, spec: str = "", seed: Optional[int] = None):
        self._lock = threading.Lock()
        self.configure(spec, seed)

    def configure(self, spec: str = "", seed: Optional[int] = None) -> None:
        with self._lock:
            self.spec_str = spec or ""
            self.seed = (
                seed
                if seed is not None
                else int(os.environ.get("PADDLE_TPU_FAULTS_SEED", "0"))
            )
            self.spec = parse_spec(self.spec_str)
            self._rngs = {
                site: random.Random(f"{self.seed}:{site}") for site in self.spec
            }
            self.hits: Dict[str, int] = {site: 0 for site in self.spec}
            self.fired: Dict[str, int] = {}

    @property
    def active(self) -> bool:
        return bool(self.spec)

    def fire(self, site: str) -> bool:
        """Count one hit of `site`; True when the fault should trigger now."""
        if site not in self.spec:  # racy pre-check: cheap fast path only
            return False
        with self._lock:
            fs = self.spec.get(site)
            if fs is None:
                return False
            n = self.hits[site]
            self.hits[site] = n + 1
            if fs.step is not None:
                hit = n == fs.step
            elif fs.prob is not None:
                hit = self._rngs[site].random() < fs.prob
            else:  # pure-delay spec: fires every hit
                hit = True
            if hit:
                self.fired[site] = self.fired.get(site, 0) + 1
        return hit

    def maybe_raise(self, site: str) -> None:
        if self.fire(site):
            raise InjectedFault(f"injected fault {site!r} (chaos harness)")

    def reset(self) -> None:
        self.configure(self.spec_str, self.seed)


ACTIVE = FaultInjector(os.environ.get("PADDLE_TPU_FAULTS", ""))


def get() -> FaultInjector:
    return ACTIVE


def maybe_stall(
    site: str,
    env: str = "PADDLE_TPU_SERVING_STALL_S",
    default_s: float = 300.0,
) -> bool:
    """Wedge-the-thread hook of the stall sites: when `site` fires, sleep
    for `$env` seconds (default `default_s`) — long enough for the watchdog
    that owns this thread (the serving supervisor) to supersede it — then
    return True."""
    if not (ACTIVE.active and ACTIVE.fire(site)):
        return False
    stall_s = float(os.environ.get(env, str(default_s)))
    logging.getLogger("paddle_tpu_torch.faults").warning(
        "chaos: %s fired — wedging %.0fs (no progress; the owning watchdog "
        "must supersede this thread)", site, stall_s,
    )
    time.sleep(stall_s)
    return True


@contextlib.contextmanager
def inject(spec: str, seed: int = 0) -> Iterator[FaultInjector]:
    """Temporarily activate a fault spec (tests):

        with faults.inject("decode_raise:step=3") as inj:
            session.run_until_idle()
        assert inj.fired["decode_raise"] == 1
    """
    prev_spec, prev_seed = ACTIVE.spec_str, ACTIVE.seed
    ACTIVE.configure(spec, seed)
    try:
        yield ACTIVE
    finally:
        ACTIVE.configure(prev_spec, prev_seed)
