"""The request plane of the master's RPC stack: endpoints, tenant leases and
the blocking client.

The port's slice of `paddle_tpu/runtime/master.py`, the part the serving
front end rides on:

- `parse_endpoints`: one endpoint or a failover list ("a:p1,b:p2").
- `_Membership`: soft-state leases. Any RPC bearing an id renews (or
  adopts) its lease, so RPCs stay retry-exact; the owner's reaper evicts
  ids silent past the lease.
- `MasterClient`: reconnect, endpoint failover, bounded exponential
  backoff with jitter, the line-JSON `_hello` negotiation up to the binary
  frame layer (`runtime/frames.py`), pipelined `call_many`, push-stream
  `call_stream`, and the seeded `conn_reset` chaos site.

The task plane (`TaskMaster` over the native dispatcher, `MasterServer`,
elastic resize, `cluster_reader`, recordio) is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

from paddle_tpu_torch.core import faults, stats
from paddle_tpu_torch.obs import trace as obs_trace
from paddle_tpu_torch.runtime import frames

log = logging.getLogger("paddle_tpu_torch.master")

Endpoint = Tuple[str, int]
EndpointsLike = Union[str, Endpoint, Sequence[Union[str, Endpoint]]]


def parse_endpoints(address: EndpointsLike) -> List[Endpoint]:
    """Normalize one endpoint or a failover list into [(host, port), ...].

    Accepts a (host, port) tuple, "host:port", the CLI's comma form
    "a:p1,b:p2", or any sequence mixing those."""
    if isinstance(address, str):
        parts = [p.strip() for p in address.split(",") if p.strip()]
    elif (
        isinstance(address, (tuple, list))
        and len(address) == 2
        and isinstance(address[0], str)
        and isinstance(address[1], int)
    ):
        parts = [address]
    else:
        parts = list(address)
    out: List[Endpoint] = []
    for p in parts:
        if isinstance(p, str):
            host, sep, port = p.rpartition(":")
            if not sep:
                raise ValueError(f"bad master endpoint {p!r}: want host:port")
            out.append((host, int(port)))
        else:
            host, port = p
            out.append((str(host), int(port)))
    if not out:
        raise ValueError(f"no master endpoints in {address!r}")
    return out



class _Membership:
    """Soft-state leases, in process.

    Any RPC bearing an id renews — or adopts — its lease, so a failover to
    a peer that never saw `register` heals itself on the next request
    instead of erroring (retry-exact RPCs). The owner's reaper polls
    `expired()` and `drop`s what it evicts. (The JAX package's copy also
    tracks which trainer holds which task, for the task plane.)"""

    def __init__(self, lease_s: float):
        self.lease_s = float(lease_s)
        self._lock = threading.Lock()
        self._last_seen: Dict[str, float] = {}
        self._next = 0
        # server-unique prefix: ids minted by two servers never collide, so
        # an adopted lease is unambiguous
        self._prefix = uuid.uuid4().hex[:6]
        self.evicted = 0

    def register(self) -> str:
        with self._lock:
            tid = f"tr-{self._prefix}-{self._next}"
            self._next += 1
            self._last_seen[tid] = time.monotonic()
            return tid

    def note_seen(self, tid: Optional[str]) -> None:
        if not tid:
            return
        with self._lock:
            self._last_seen[tid] = time.monotonic()

    def drop(self, tid: str) -> None:
        """Forget an id (graceful deregister or eviction)."""
        with self._lock:
            self._last_seen.pop(tid, None)

    def expired(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return [
                tid for tid, seen in self._last_seen.items()
                if now - seen > self.lease_s
            ]

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._last_seen)



class _CountingReader:
    """Buffered-reader wrapper that counts received bytes into its owning
    MasterClient — the wire-economics observability (bytes per delivered
    token, bytes per task) the benches report rides on these counters."""

    __slots__ = ("_f", "_owner")

    def __init__(self, f, owner: "MasterClient"):
        self._f = f
        self._owner = owner

    def read(self, n: int = -1) -> bytes:
        b = self._f.read(n)
        self._owner.bytes_received += len(b)
        return b

    def readline(self) -> bytes:
        b = self._f.readline()
        self._owner.bytes_received += len(b)
        return b

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        b = self.readline()
        if not b:
            raise StopIteration
        return b

    def close(self) -> None:
        self._f.close()


class MasterClient:
    """Blocking RPC client with reconnect + endpoint failover
    (the Go master client's contract), speaking either wire.

    `address` may be one endpoint or a failover list ((h, p), "h:p",
    "a:p1,b:p2", or a sequence of those — the CLI's --master_endpoints form).
    Failed calls reconnect and retry with bounded exponential backoff plus
    jitter (the Go client's backoff discipline; jitter keeps a restarted
    master from being stampeded by every trainer retrying in lockstep),
    rotating to the next endpoint on every reconnect so a dead primary's
    standby is found inside the same loop. After `retries` attempts
    (default: enough for several full rotations) the terminal ConnectionError
    names the method, the endpoints, the attempt count and the last
    underlying error.

    Wire: each connection opens with the line-JSON `_hello`
    probe; a frames-capable server upgrades the connection to the binary
    frame layer (runtime/frames.py — pipelining via `call_many`, binary
    token payloads, header trace context), a
    legacy server refuses and the client stays line-JSON (memoized per
    endpoint so later reconnects skip the probe). `wire` /
    `PADDLE_TPU_WIRE` selects: "auto" (default), "json" (never probe),
    "frames" (downgrade is an error). All traffic rides ONE socket per
    endpoint; `close()` releases the buffered reader and writer with it."""

    def __init__(
        self,
        address: EndpointsLike,
        timeout: float = 30.0,
        retries: Optional[int] = None,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        wire: Optional[str] = None,
    ):
        self.endpoints = parse_endpoints(address)
        self.timeout = timeout
        self.retries = (
            max(1, int(retries))
            if retries is not None
            else max(5, 4 * len(self.endpoints))
        )
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.wire = (wire or os.environ.get("PADDLE_TPU_WIRE", "auto")).lower()
        self._i = 0
        self._sock: Optional[socket.socket] = None
        self._rfile: Optional[_CountingReader] = None
        self._wfile = None
        self._framed = False
        self._req_seq = 0
        # endpoints that refused the hello probe: line-JSON forever (well,
        # until this client object dies) — no re-probe per reconnect
        self._legacy: Set[Endpoint] = set()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.round_trips = 0

    @property
    def address(self) -> Endpoint:
        """The endpoint currently in use (compat with the single-address API)."""
        return self.endpoints[self._i]

    @property
    def wire_framed(self) -> bool:
        """True when the CURRENT connection negotiated the frame layer."""
        return self._framed

    def _connect(self):
        if self._sock is not None:
            return
        self._sock = socket.create_connection(self.address, timeout=self.timeout)
        # requests are small single writes: NODELAY keeps one from waiting
        # behind the server's delayed ACK of the last (Nagle)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = _CountingReader(self._sock.makefile("rb"), self)
        self._wfile = self._sock.makefile("wb")
        self._framed = False
        if self.wire != "json" and self.address not in self._legacy:
            self._hello()

    def _hello(self) -> None:
        """Wire negotiation: one line-JSON probe per fresh connection. A
        legacy server answers unknown-method (memoized: later reconnects to
        that endpoint skip the probe), a frames-capable one answers
        {"frames": 1} and this connection switches to the frame layer."""
        probe = json.dumps({"method": "_hello", "frames": 1}).encode() + b"\n"
        self._sock.sendall(probe)
        self.bytes_sent += len(probe)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("master closed connection during hello")
        if json.loads(line).get("frames") == 1:
            self._framed = True
            return
        if self.wire == "frames":
            raise ConnectionError(
                f"endpoint {self.address} refused the frame layer and "
                f"wire='frames' forbids the line-JSON downgrade"
            )
        self._legacy.add(self.address)

    def _rotate(self) -> None:
        if len(self.endpoints) > 1:
            self._i = (self._i + 1) % len(self.endpoints)
            stats.FT_EVENTS.incr("master_failover")
            log.warning("master failover: trying endpoint %s:%d", *self.address)

    def _send(self, req: dict) -> int:
        """Write one request on the current wire; returns its req_id (0 on
        line JSON). frames.write_frame is THE frame-encode site — no
        json.dumps on the framed path (hot-loop lint)."""
        if self._framed:
            self._req_seq = ((self._req_seq + 1) & 0xFFFFFFFF) or 1
            self.bytes_sent += frames.write_frame(
                self._wfile, req, req_id=self._req_seq
            )
            return self._req_seq
        msg = json.dumps(req).encode() + b"\n"
        self._sock.sendall(msg)
        self.bytes_sent += len(msg)
        return 0

    def _recv(self, want_rid: int) -> dict:
        if self._framed:
            got = frames.read_frame(self._rfile)
            if got is None:
                raise ConnectionError("master closed connection")
            resp, rid, flags, blob = got
            if rid != want_rid:
                raise frames.FrameError(
                    f"reply id {rid} does not match request {want_rid}"
                )
            return frames.decode_payload(resp, rid, flags, blob)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("master closed connection")
        return json.loads(line)

    def call(self, method: str, **kw) -> dict:
        """One RPC (with reconnect/failover/backoff). With tracing enabled
        the call runs inside a client span and piggybacks its context on the
        frame (`_trace` — moved into the binary header on a framed
        connection), so the server's handler span joins this trace."""
        if obs_trace.TRACER.enabled:
            with obs_trace.span("rpc." + method, side="client") as sp:
                kw["_trace"] = {"t": sp.trace_id, "s": sp.span_id}
                return self._call(method, kw)
        return self._call(method, kw)

    def call_many(self, calls: Sequence[Tuple[str, dict]]) -> List[dict]:
        """Pipelined batch: write every request back-to-back on
        the ONE socket, then collect the replies in order, matched by
        request id — N calls for one round trip of latency (the server
        processes a connection's frames sequentially and answers in
        arrival order). On a line-JSON connection this degrades to serial
        `call`s. A connection failure retries the WHOLE batch through the
        same reconnect/failover/backoff path as `call`, so callers pass
        retry-exact requests (idempotency keys) — the discipline every RPC
        here already follows."""
        if not calls:
            return []
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                self._connect()
                if not self._framed:
                    return [self._call(m, dict(kw)) for m, kw in calls]
                if faults.get().fire("conn_reset"):
                    # chaos hook: the socket resets with the batch in
                    # flight — the retry must re-send ALL of it
                    raise ConnectionResetError("injected conn_reset (chaos)")
                rids = [self._send({"method": m, **kw}) for m, kw in calls]
                out = [self._recv(rid) for rid in rids]
                self.round_trips += 1
                return out
            except (OSError, ConnectionError, json.JSONDecodeError) as e:
                last_err = e
                self.close()
                stats.FT_EVENTS.incr("master_reconnect")
                self._rotate()
                if attempt + 1 < self.retries:
                    delay = min(self.backoff_max, self.backoff_base * 2 ** attempt)
                    delay *= 0.5 + random.random() / 2
                    log.warning(
                        "pipelined batch of %d failed (%s: %s); reconnecting "
                        "in %.0fms (attempt %d/%d)", len(calls),
                        type(e).__name__, e, delay * 1e3, attempt + 1,
                        self.retries,
                    )
                    time.sleep(delay)
        raise ConnectionError(
            f"pipelined batch of {len(calls)} to {self.endpoints} failed "
            f"after {self.retries} attempts; giving up (last error: "
            f"{type(last_err).__name__}: {last_err})"
        ) from last_err

    def _call(self, method: str, kw: dict) -> dict:
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                self._connect()
                if faults.get().fire("conn_reset"):
                    # chaos hook: network partition/RST between client and
                    # server — the reconnect/failover path must absorb it
                    raise ConnectionResetError("injected conn_reset (chaos)")
                rid = self._send({"method": method, **kw})
                resp = self._recv(rid)
                self.round_trips += 1
                return resp
            except (OSError, ConnectionError, json.JSONDecodeError) as e:
                last_err = e
                self.close()
                stats.FT_EVENTS.incr("master_reconnect")
                self._rotate()
                if attempt + 1 < self.retries:
                    delay = min(self.backoff_max, self.backoff_base * 2 ** attempt)
                    delay *= 0.5 + random.random() / 2  # full-jitter in [.5d, d)
                    log.warning(
                        "master RPC %r failed (%s: %s); reconnecting in %.0fms "
                        "(attempt %d/%d)", method, type(e).__name__, e,
                        delay * 1e3, attempt + 1, self.retries,
                    )
                    time.sleep(delay)
        raise ConnectionError(
            f"master RPC {method!r} to {self.endpoints} failed after "
            f"{self.retries} attempts; giving up (last error: "
            f"{type(last_err).__name__}: {last_err})"
        ) from last_err

    def call_stream(self, method: str, **kw) -> Iterator[dict]:
        """One request whose reply is a FRAME STREAM (serving push
        streaming): the request and its FIRST reply line go
        through the normal reconnect/backoff path, then every subsequent
        line on the same connection is yielded as a frame until one
        carries `done` (or the first reply was an error). Delivered
        frames are never replayed — a mid-stream failure raises
        ConnectionError and resumable callers reattach with their token
        cursor (the serving `from` cursor), on a FRESH call. The
        connection is reusable after a clean `done`; an abandoned or
        broken stream drops it (frames may still be buffered). On a framed
        connection the pushed frames are BINARY (compact token deltas,
        runtime/frames.py) — decoded here back to the exact dicts a
        line-JSON peer would see."""
        first = self._call(method, kw)
        yield first
        if "err" in first:
            return
        clean = False
        try:
            if self._framed:
                while True:
                    got = frames.read_frame(self._rfile)
                    if got is None:
                        raise ConnectionError(
                            "stream closed before its final frame"
                        )
                    obj, rid, flags, blob = got
                    frame = frames.decode_payload(obj, rid, flags, blob)
                    if frame.get("done"):
                        clean = True
                        yield frame
                        return
                    yield frame
            for line in self._rfile:
                try:
                    frame = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ConnectionError(f"bad stream frame: {e}") from e
                if frame.get("done"):
                    clean = True
                    yield frame
                    return
                yield frame
            raise ConnectionError("stream closed before its final frame")
        except OSError as e:
            raise ConnectionError(f"stream broke mid-flight: {e}") from e
        finally:
            if not clean:
                self.close()

    def close(self) -> None:
        # hygiene: the buffered reader/writer makefile objects
        # are closed WITH the socket — the old path nulled the reader
        # without closing it, leaking the buffer until GC on every
        # reconnect of a long-lived client
        for f in (self._rfile, self._wfile):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        self._rfile = None
        self._wfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._framed = False
