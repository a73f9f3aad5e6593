"""Serving front end: the request plane over TCP.

The port's counterpart of `paddle_tpu/serving/server.py`, on the same wire,
so either package's client talks to either package's server:

  * transport — the newline-delimited line-JSON protocol, upgraded per
    connection to the binary frames of `runtime/frames.py` when the client
    negotiates them; `ServingClient` wraps `runtime.master.MasterClient`,
    inheriting reconnect, endpoint failover, bounded backoff + jitter and
    the `conn_reset` chaos site.
  * tenancy — `_Membership` register/heartbeat leases: a client `register`s
    for a tenant lease and renews it implicitly on every RPC; a tenant
    silent past the lease is evicted by the reaper and its QUEUED requests
    are cancelled (running sequences finish — their KV work is paid for).
  * quotas — per-tenant token buckets + concurrency caps (quota.py) checked
    at `submit`/`generate` time; a rejection is an RPC-level error naming
    the reason, not a timeout.

Methods: register | heartbeat | deregister | submit | poll | poll_many |
cancel | stream | generate (blocking submit+wait) | stats | metrics |
trace_export. `generate_config` (a v1-config `GenerationSession` beside the
token engine) needs beam search, which is not ported yet: it answers an RPC
error naming ROADMAP.md's item.

Threads: the handler threads parse, queue and read handles; they never touch
the device. Only the session's engine thread does."""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import threading
import time
import uuid
from typing import Any, Dict, Optional

from paddle_tpu_torch.core import stats
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace as obs_trace
from paddle_tpu_torch.runtime import frames
from paddle_tpu_torch.runtime.master import (
    EndpointsLike,
    MasterClient,
    _Membership,
)
from paddle_tpu_torch.serving.quota import QuotaExceeded
from paddle_tpu_torch.serving.scheduler import RequestHandle
from paddle_tpu_torch.serving.session import SERVING_EVENTS, ServingSession

log = logging.getLogger("paddle_tpu_torch.serving")

GENERATE_CONFIG_NOT_PORTED = (
    "generate_config is not ported to paddle_tpu_torch yet: it serves a "
    "v1-config GenerationSession, which needs beam search (ROADMAP.md, "
    "queue 1, item 3.3: generation)"
)


def encode_frame(obj: Any, framed: bool = False) -> bytes:
    """Wire encoding for ONE push-stream frame — the single stream-encode
    seam. On a
    legacy connection it is the line-JSON framing the request/reply plane
    already speaks; on a negotiated framed connection it delegates to
    `frames.encode_stream`, whose compact delta form costs 4 bytes per
    token plus a 20-byte header instead of a JSON object per frame."""
    if framed:
        return frames.encode_stream(obj)
    return json.dumps(obj).encode() + b"\n"


# Coalescing rules for the FRAMED push wire: under fan-out the
# per-stream header cost dominates, so a pusher holding a small delta waits
# a few engine steps for more tokens before emitting — one frame, one
# header, many tokens. Below the fan-out threshold latency wins and every
# delta flushes immediately; `done` frames ALWAYS flush; the legacy
# line-JSON wire is never held (its cadence must stay bit-for-bit what
# pre-frames clients observed).
COALESCE_FANOUT = 8      # active pushers at/above which coalescing arms
COALESCE_MIN_TOKENS = 8  # target tokens per binary delta under fan-out
COALESCE_MAX_HOLDS = 7   # engine steps a partial delta may be held


def clamp_cursor(val: Any, n: int) -> int:
    """Clamp a client-supplied delta-poll/stream cursor into [0, n]: a
    stale, negative or garbage cursor degrades to a bigger (or full)
    token suffix, never an error or an out-of-range slice."""
    try:
        c = int(val or 0)
    except (TypeError, ValueError):
        return 0
    return max(0, min(c, n))


class _Handler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        # every reply and pushed frame is one small write: without NODELAY,
        # Nagle holds a write behind the peer's delayed ACK of the previous
        # one (tens of ms on Linux), which a first token or a stream frame
        # would wait out. The bytes on the wire are unchanged.
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def handle(self):
        srv: ServingServer = self.server.ctx  # type: ignore[attr-defined]
        for line in self.rfile:
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                self._reply({"err": "bad json"})
                continue
            if req.get("method") == "_hello":
                # wire negotiation — deliberately line-JSON: a
                # frame-capable client probes, this connection upgrades to
                # the framed loop; a legacy client never sends the probe
                # and is served bit-for-bit by this unchanged line path
                if req.get("frames") == 1:
                    self._reply({"frames": 1})
                    self._serve_frames(srv)
                    return
                self._reply({"frames": 0})
                continue
            resp, stream = self._dispatch(srv, req)
            self._reply(resp)
            if stream is not None:
                # push mode: this connection becomes a frame stream for one
                # request (until its final frame, then the read loop resumes)
                self._push_frames(srv, *stream)

    def _dispatch(self, srv: Any, req: dict) -> tuple:
        tenant_id = req.get("tenant_id")
        srv.membership.note_seen(tenant_id)
        try:
            # handler span adopts the client's piggybacked trace context
            # (ServingClient rides on MasterClient, which injects
            # `_trace`) — and is itself the parent the session's
            # queue-wait/prefill/ttft spans stitch under
            with obs_trace.server_span(
                "rpc." + str(req.get("method")), req.get("_trace"),
                side="server",
            ):
                resp = srv.dispatch(req.get("method"), req, tenant_id)
        except QuotaExceeded as e:
            resp = {"err": str(e), "rejected": e.reason}
            if getattr(e, "retry_after_ms", None) is not None:
                # load-shed hint: when retrying could plausibly succeed,
                # derived from queue wait + free-page pressure
                resp["retry_after_ms"] = e.retry_after_ms
        except Exception as e:  # a bad request must not kill the server
            log.warning("serving RPC failed: %r", e)
            resp = {"err": f"{type(e).__name__}: {e}"}
        stream = (
            resp.pop("_stream", None) if isinstance(resp, dict) else None
        )
        return resp, stream

    def _serve_frames(self, srv: Any) -> None:
        """Framed loop for one negotiated connection: same dispatch, but
        replies are frames with token runs packed binary, and push streams
        cut compact binary deltas instead of JSON lines."""
        while True:
            try:
                got = frames.read_frame(self.rfile)
            except frames.FrameError as e:
                # a malformed frame severs THIS connection with a named
                # error instead of wedging the handler thread mid-read
                self._reply_frame({"err": f"{type(e).__name__}: {e}"}, 0, 0)
                return
            except OSError:
                return
            if got is None:
                return
            obj, rid, flags, blob = got
            req = frames.decode_payload(obj, rid, flags, blob)
            resp, stream = self._dispatch(srv, req)
            rflags = 0
            bin_out = b""
            if isinstance(resp, dict):
                resp, bin_out = frames.pack_tokens(resp)
                if bin_out:
                    rflags |= frames.FLAG_BIN_TOKENS
            self._reply_frame(resp, rid, rflags, bin_out)
            if stream is not None:
                self._push_frames(srv, *stream, framed=True)

    def _reply_frame(self, obj: Any, req_id: int, flags: int,
                     bin_payload: bytes = b"") -> None:
        try:
            frames.write_frame(
                self.wfile, obj, req_id=req_id, flags=flags,
                bin_payload=bin_payload,
            )
        except (OSError, ValueError):
            pass  # peer vanished; its retry path handles it

    def _reply(self, obj: Any) -> None:
        try:
            self.wfile.write(json.dumps(obj).encode() + b"\n")
            self.wfile.flush()
        except (OSError, ValueError):
            pass  # peer vanished; its retry path handles it

    def _push_frames(self, srv: Any, handle: Any, cursor: int,
                     framed: bool = False) -> None:
        """Push token frames for one request until it finishes or the peer
        vanishes. Frames are DELTAS from `cursor` (the same cursor contract
        delta-poll uses, so a reattach after a dropped connection resumes
        mid-stream without re-sending tokens). All socket writes happen on
        THIS handler thread — the engine only bumps a step sequence
        (`stream_wait`); a slow or dead client stalls its own pusher, never
        a decode step. Polling the same request stays authoritative: a
        stream is a fast path, not the source of truth."""
        seq = 0
        held = 0
        grown = cursor  # high-water mark: counts THIS stream's decode steps,
        # not global wakes (every pusher shares one notify sequence)
        srv.note_stream(1)
        try:
            while True:
                next_seq = srv.stream_wait(seq)
                # done BEFORE tokens: completion is latched after the final
                # append, so a True here guarantees the token read is complete
                # (the reverse order could stamp `done` on a truncated frame)
                done = handle.done
                toks = list(handle.tokens)
                n = len(toks)
                if n > cursor or done:
                    delta = n - cursor
                    if (framed and not done
                            and delta < COALESCE_MIN_TOKENS
                            and held < COALESCE_MAX_HOLDS
                            and srv.stream_active >= COALESCE_FANOUT):
                        if n > grown:
                            held += 1
                            grown = n
                        seq = next_seq
                        continue
                    held = 0
                    grown = n
                    frame = {
                        "request_id": handle.request_id,
                        "from": cursor,
                        "tokens": toks[cursor:],
                        "tokens_so_far": n,
                    }
                    cursor = n
                    if done:
                        frame.update(srv._stream_final(handle))
                    buf = encode_frame(frame, framed)
                    try:
                        self.wfile.write(buf)
                        self.wfile.flush()
                    except (OSError, ValueError):
                        # peer went away; poll/reattach picks it back up
                        return
                    # coalescing observability: a multi-token
                    # delta IS the coalesced frame — a subscriber that fell
                    # behind (or was held under fan-out) gets the whole
                    # backlog in one frame, one encode
                    srv.note_frames(1, nbytes=len(buf), ntokens=delta,
                                    coalesced=1 if delta > 1 else 0)
                    if done:
                        return
                seq = next_seq
        finally:
            srv.note_stream(-1)


class ServingServer:
    """Threaded TCP wrapper around a ServingSession. start()/stop(); port 0
    picks a free port. `start()` starts the session's supervised engine
    (`serve_forever`) unless it already runs."""

    def __init__(
        self,
        session: ServingSession,
        host: str = "127.0.0.1",
        port: int = 0,
        lease_s: float = 30.0,
        require_register: bool = False,
        handle_ttl_s: float = 600.0,
    ):
        if session is None:
            raise ValueError("need a ServingSession")
        self.session = session
        self.membership = _Membership(lease_s)
        self.require_register = require_register
        # ids THIS server minted via register: require_register must check
        # against these, not membership — note_seen adopts any id on sight
        # (the master's retry-exact discipline), so a fabricated tenant_id
        # would otherwise pass as registered and mint itself a fresh quota
        # bucket per request
        self._minted: set = set()
        self._minted_lock = threading.Lock()
        # finished handles are garbage-collected this long after completion
        # (submit-and-vanish clients must not grow a long-lived server; poll
        # is deliberately NON-destructive so the retrying transport can
        # re-read a completion whose response was lost on the wire)
        self.handle_ttl_s = float(handle_ttl_s)
        self._handles: Dict[int, RequestHandle] = {}
        # client-supplied idempotency keys, scoped (tenant, key): a retried
        # submit/generate with the same client_req_id reattaches to the
        # ORIGINAL request instead of queueing (and quota-charging) a
        # duplicate — the transport is MasterClient, whose whole contract is
        # retry-with-reconnect
        self._by_client_id: Dict[tuple, int] = {}
        self._handles_lock = threading.Lock()
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._srv.daemon_threads = True
        self._srv.ctx = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._reaper: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # push-streaming observability: frames written by pusher threads
        # (exported via stats + the obs counter; the engine never writes)
        self.stream_frames = 0
        self.stream_bytes = 0
        self.stream_tokens = 0
        self.stream_coalesced = 0
        self.stream_active = 0  # pushers currently attached (fan-out gauge)
        self._stream_lock = threading.Lock()

    @property
    def address(self) -> tuple:
        return self._srv.server_address

    # -- RPC dispatch -------------------------------------------------------
    def dispatch(self, method: str, req: dict, tenant_id: Optional[str]) -> dict:
        if method == "register":
            tid = self.membership.register()
            with self._minted_lock:
                self._minted.add(tid)
            return {"tenant_id": tid, "lease_s": self.membership.lease_s}
        if method == "heartbeat":
            return {"ok": bool(tenant_id)}
        if method == "deregister":
            if tenant_id:
                self._forget_tenant(tenant_id)
            return {"ok": bool(tenant_id)}
        if method == "stats":
            out = dict(self.session.stats())
            out["live_tenants"] = self.membership.live
            out["evicted_tenants"] = self.membership.evicted
            out["stream_frames_pushed"] = self.stream_frames
            out["stream_bytes_pushed"] = self.stream_bytes
            out["stream_tokens_pushed"] = self.stream_tokens
            out["stream_frames_coalesced"] = self.stream_coalesced
            return out
        if method == "metrics":
            return {"text": obs_metrics.to_prometheus_text()}
        if method == "trace_export":
            return {"chrome_trace": obs_trace.export_chrome()}
        if method in ("submit", "generate"):
            tenant = self._tenant_for(tenant_id)
            # idempotency keys are scoped PER TENANT: two tenants using the
            # same key must not alias (that would hand one tenant the other's
            # tokens — the same leak the poll tenancy check closes)
            client_req_id = req.get("client_req_id")
            req_key = (tenant, str(client_req_id)) if client_req_id else None
            handle = None
            if req_key is not None:
                with self._handles_lock:
                    rid = self._by_client_id.get(req_key)
                    handle = self._handles.get(rid) if rid is not None else None
            if handle is None:
                handle = self.session.submit(
                    req["prompt"],
                    req.get("max_new_tokens"),
                    tenant=tenant,
                    deadline_s=req.get("deadline_s"),
                    ttft_deadline_s=req.get("ttft_deadline_s"),
                    temperature=req.get("temperature"),
                    top_k=req.get("top_k"),
                    seed=req.get("seed"),
                )
                with self._handles_lock:
                    self._handles[handle.request_id] = handle
                    if req_key is not None:
                        self._by_client_id[req_key] = handle.request_id
            if method == "submit":
                out: Dict[str, Any] = {"request_id": handle.request_id}
                if req.get("stream"):
                    # opt-in push streaming: the ack carries the
                    # request id as usual, then token frames follow on this
                    # SAME connection until the final frame — submit and
                    # first-frame latency share one round trip
                    out["stream"] = True
                    out["_stream"] = (handle, 0)
                return out
            try:
                # cancel_on_timeout=False: the blocking-generate contract is
                # "still running; poll request_id later" — the caller chose
                # to wait, not to abandon (ServingClient abandonment goes
                # through result()'s default cancel path / the cancel RPC)
                handle.result(timeout=float(req.get("timeout_s", 120.0)),
                              cancel_on_timeout=False)
            except TimeoutError:
                # the request keeps running; the handle stays registered so
                # the caller can poll for the tokens it already paid for
                return {
                    "err": "generate timed out server-side; still running",
                    "request_id": handle.request_id,
                    "done": False,
                }
            except RuntimeError:
                pass  # cancelled: _completion below names the reason
            return dict(self._completion(handle),
                        request_id=handle.request_id)
        if method in ("poll", "cancel", "stream"):
            with self._handles_lock:
                if req.get("client_req_id"):
                    # identity is the (tenant, client_req_id) key, NOT the
                    # rid: across a server restart or router
                    # takeover the rid counter restarted, so a stale rid may
                    # name a DIFFERENT request — never fall back to it when
                    # the caller supplied its key. Keys are GC'd together
                    # with their handles, so a key miss means the request
                    # is not in these books.
                    rid = self._by_client_id.get(
                        (self._tenant_for(tenant_id),
                         str(req["client_req_id"]))
                    )
                    handle = (
                        self._handles.get(rid) if rid is not None else None
                    )
                else:
                    handle = self._handles.get(int(req["request_id"]))
            if handle is None:
                return {"err": f"unknown request_id {req['request_id']}"}
            # request ids are sequential — poll/cancel/stream must enforce
            # the SAME tenancy as submit, or guessing ids reads (or kills)
            # other tenants' requests
            if handle.tenant != self._tenant_for(tenant_id):
                return {"err": "request belongs to another tenant"}
            if method == "cancel":
                return {"cancelled": handle.cancel(), "done": handle.done}
            if method == "stream":
                # (re)attach a push stream mid-request: the client's `from`
                # cursor (tokens it already holds) resumes the frame stream
                # exactly where a dropped connection left off
                cur = clamp_cursor(req.get("from"), len(handle.tokens))
                return {
                    "request_id": handle.request_id, "stream": True,
                    "from": cur, "_stream": (handle, cur),
                }
            if not handle.done:
                # incremental delivery: the tokens generated SO FAR ride
                # every poll, from the client's `from` cursor on — a
                # delta-poll re-sends only the unseen suffix (`from` absent
                # = 0 = today's full-list reply, bit-for-bit)
                toks = list(handle.tokens)
                cur = clamp_cursor(req.get("from"), len(toks))
                return {
                    "done": False,
                    "tokens_so_far": len(toks),
                    "tokens": toks[cur:],
                    "from": cur,
                }
            # non-destructive: a lost response must be re-readable; the
            # reaper GCs finished handles after handle_ttl_s
            return self._completion(handle)
        if method == "poll_many":
            # the router pump's batch poll: ONE round trip answers
            # for every in-flight request on this replica, so result delivery
            # never costs an RPC per request per cycle ("RPC Considered
            # Harmful" — and the shape ROADMAP item 4's batched control
            # plane generalizes). Per-item tenancy: the router is a proxy
            # for many tenants, so each item names the tenant it polls as.
            out = []
            for it in req.get("items", []):
                try:
                    rid = int(it["request_id"])
                except (KeyError, TypeError, ValueError):
                    out.append({"err": "bad request_id"})
                    continue
                with self._handles_lock:
                    handle = self._handles.get(rid)
                if handle is None:
                    out.append({"request_id": rid, "err": "unknown"})
                elif handle.tenant != self._tenant_for(it.get("tenant_id")):
                    out.append({"request_id": rid, "err": "tenant"})
                elif handle.done:
                    # completions stay FULL-token replies (no cursor): the
                    # terminal result is the authoritative record the
                    # router's dedup latch delivers exactly once
                    out.append(dict(self._completion(handle),
                                    request_id=rid))
                else:
                    toks = list(handle.tokens)
                    cur = clamp_cursor(it.get("from"), len(toks))
                    out.append({
                        "request_id": rid, "done": False,
                        "tokens": toks[cur:], "from": cur,
                        "tokens_so_far": len(toks),
                    })
            return {"results": out}
        if method == "generate_config":
            return {"err": GENERATE_CONFIG_NOT_PORTED}
        return {"err": f"unknown method {method!r}"}

    def _tenant_for(self, tenant_id: Optional[str]) -> str:
        if self.require_register:
            with self._minted_lock:
                known = tenant_id in self._minted
            if not known:
                # a fabricated or expired id must not pass: each unknown id
                # would mint itself a fresh full quota bucket
                raise QuotaExceeded(
                    "register first: this server requires a live tenant "
                    "lease (unknown or expired tenant_id)",
                    "unregistered",
                )
            return tenant_id
        return tenant_id or "default"

    def _forget_tenant(self, tid: str) -> int:
        """Drop a tenant's lease + minted id and cancel its queued work
        (deregister and lease-expiry share this path)."""
        self.membership.drop(tid)
        with self._minted_lock:
            self._minted.discard(tid)
        return self.session.cancel_tenant(tid)

    @staticmethod
    def _completion(handle: RequestHandle) -> dict:
        return {
            "done": True,
            "tokens": handle.tokens,
            "finish_reason": handle.finish_reason,
            "cancelled": handle.status == RequestHandle.CANCELLED,
        }

    # -- push-stream plumbing (shared with _Handler._push_frames) -----------
    def stream_wait(self, seq: int, timeout: float = 0.25) -> int:
        """Pusher-thread wait for the next engine step boundary (delegates
        to the session's step-sequence condition; the timeout doubles as
        the liveness tick for cancellations that finish without a step)."""
        return self.session.stream_wait(seq, timeout)

    @staticmethod
    def _stream_final(handle: RequestHandle) -> dict:
        """Terminal fields for a stream's final frame — delta-shaped (the
        client accumulated the tokens), completion metadata inline."""
        return {
            "done": True,
            "finish_reason": handle.finish_reason,
            "cancelled": handle.status == RequestHandle.CANCELLED,
        }

    def note_frames(self, n: int, nbytes: int = 0, ntokens: int = 0,
                    coalesced: int = 0) -> None:
        with self._stream_lock:
            self.stream_frames += n
            self.stream_bytes += nbytes
            self.stream_tokens += ntokens
            self.stream_coalesced += coalesced
        SERVING_EVENTS.incr("serving_stream_frames", n)

    def note_stream(self, delta: int) -> None:
        with self._stream_lock:
            self.stream_active += delta

    # -- lifecycle ----------------------------------------------------------
    def _reap_loop(self) -> None:
        period = max(0.05, min(1.0, self.membership.lease_s / 4.0))
        while not self._stop_evt.wait(period):
            for tid in self.membership.expired():
                self.membership.evicted += 1
                stats.FT_EVENTS.incr("tenant_evicted")
                n = self._forget_tenant(tid)
                log.warning(
                    "tenant %s lease expired (%gs); evicted, %d queued "
                    "request(s) cancelled", tid, self.membership.lease_s, n,
                )
            # GC handles whose client submitted and never polled — a
            # long-lived server must not retain every completion forever
            cutoff = time.monotonic() - self.handle_ttl_s
            with self._handles_lock:
                stale = [
                    rid for rid, h in self._handles.items()
                    if h.done and (h.t_done or 0) < cutoff
                ]
                for rid in stale:
                    del self._handles[rid]
                if stale:
                    dead = set(stale)
                    self._by_client_id = {
                        k: v for k, v in self._by_client_id.items()
                        if v not in dead
                    }
            if stale:
                log.info("GC'd %d unpolled finished request handle(s)", len(stale))

    def start(self) -> "ServingServer":
        if self.session._thread is None:
            self.session.serve_forever()
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
        self._reaper.start()
        return self

    def stop(self) -> None:
        """Stop listening, stop the reaper and stop the session's engine
        (a stopped server's session is retired with it)."""
        self._stop_evt.set()
        if self._thread is not None:
            self._srv.shutdown()
        self._srv.server_close()
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)
        self.session.stop()


class Rejected(RuntimeError):
    """A submit/generate the server refused with a named reason; on load
    sheds `retry_after_ms` carries the server's backoff hint."""

    def __init__(self, msg: str, reason: Optional[str] = None,
                 retry_after_ms: Optional[int] = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class ServingClient:
    """Ergonomic wrapper over MasterClient (which supplies reconnect,
    failover lists, backoff and the conn_reset chaos site for free).

    MasterClient's contract is retry-with-reconnect, so every mutating call
    carries a client-generated idempotency key (`client_req_id`): a retry
    whose original DID reach the server reattaches to the same request
    instead of queueing and quota-charging a duplicate. `generate` is
    implemented as submit + poll — short retry-exact RPCs — rather than one
    long blocking read that would trip the socket timeout on a loaded
    server. The same dedup key is what makes HEDGING safe: `generate` with
    `hedge_ttft_s` re-issues the submit when no token has arrived by that
    deadline — if the original landed, the server reattaches (exactly one
    engine execution); if it was lost in a partition/failover, the hedge IS
    the request."""

    def __init__(self, address: EndpointsLike, **client_kw):
        # `address` may be a LIST ("primary:p1,standby:p2" or a sequence of
        # endpoints): MasterClient rotates on connection failure,
        # so a router primary + warm standby is one constructor argument and
        # every path below (generate/submit/poll/cancel/stream) fails over
        self._client = MasterClient(address, **client_kw)
        self.tenant_id: Optional[str] = None
        self.lease_s: float = 30.0
        # wire accounting for the dedicated stream connections:
        # each stream() conn folds its byte/round-trip counters in here when
        # it closes, so a bench can compute bytes per delivered token across
        # the request/reply client AND every push stream it ran
        self.stream_bytes_in = 0
        self.stream_bytes_out = 0
        self.stream_round_trips = 0
        self.hedges = 0  # hedged retries issued (TTFT-deadline misses)
        self.shed_retries = 0  # submits retried after a shed's retry_after_ms
        self.stream_reattaches = 0  # dropped push-streams resumed by cursor
        # submits re-issued under the same key after the server forgot the
        # request id (router takeover, failover to a peer): dedup reattaches
        # when the request still runs anywhere, so this is recovery, not
        # duplication
        self.reattach_resubmits = 0

    def register(self) -> str:
        resp = self._client.call("register")
        self.tenant_id = resp["tenant_id"]
        self.lease_s = float(resp.get("lease_s", 30.0))
        return self.tenant_id

    def _id_kw(self) -> dict:
        return {"tenant_id": self.tenant_id} if self.tenant_id else {}

    def generate(
        self,
        prompt,
        max_new_tokens: Optional[int] = None,
        timeout_s: float = 120.0,
        poll_interval_s: float = 0.02,
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
        hedge_ttft_s: Optional[float] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
        max_retries: int = 2,
        retry_sleep_cap_s: float = 2.0,
    ) -> dict:
        key = uuid.uuid4().hex
        if seed is None:
            # pin the sampling identity CLIENT-side: if every
            # server-side holder of this request dies in one window (replica
            # + router), the re-submit under the same key below must re-draw
            # the same tokens — a server-minted seed dies with the server
            seed = int.from_bytes(uuid.uuid4().bytes[:4], "little")
        # sampling identity rides the idempotency envelope: a hedged retry
        # re-submits the SAME (seed, temperature, top_k), so even when the
        # original was lost and the hedge IS the request, tokens match what
        # the original would have produced (seeded per-request sampling)
        kw = dict(deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
                  temperature=temperature, top_k=top_k, seed=seed,
                  client_req_id=key)
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        # shed → sleep-and-retry: a server shed carrying retry_after_ms is a
        # promise, not a verdict — honor it (capped, and never past the
        # caller's own timeout budget) up to max_retries times before
        # surfacing Rejected. A shed without a hint stays terminal: the
        # server said nothing about when retrying could work.
        attempts = 0
        while True:
            try:
                rid = self.submit(prompt, max_new_tokens, **kw)
                break
            except Rejected as e:
                now = time.monotonic()
                if (e.retry_after_ms is None or attempts >= max_retries
                        or now >= deadline):
                    raise
                attempts += 1
                self.shed_retries += 1
                time.sleep(min(
                    e.retry_after_ms / 1e3, retry_sleep_cap_s,
                    max(0.0, deadline - now),
                ))
        hedged = False
        resubmits = 0
        while True:
            resp = self.poll(rid, client_req_id=key)
            if "err" in resp:
                # the server no longer knows rid (failover to a peer, router
                # takeover, handle GC): re-issue the submit under the SAME
                # idempotency key — dedup reattaches when the request still
                # runs anywhere; only a genuinely lost request becomes a
                # fresh one (and the client-pinned seed keeps even THAT
                # token-identical). Bounded: a persistent error surfaces.
                if resubmits >= max(1, max_retries):
                    raise RuntimeError(f"generate failed: {resp['err']}")
                try:
                    rid = self.submit(prompt, max_new_tokens, **kw)
                except Rejected as e:
                    now = time.monotonic()
                    if e.retry_after_ms is not None and now < deadline:
                        # a SHED, not a verdict: a just-took-over router is
                        # alive before its replicas have re-registered —
                        # honor the hint and retry without burning the
                        # resubmit budget (bounded by the caller's timeout)
                        self.shed_retries += 1
                        time.sleep(min(e.retry_after_ms / 1e3,
                                        retry_sleep_cap_s,
                                        max(0.0, deadline - now)))
                        continue
                    raise RuntimeError(
                        f"generate failed: {resp['err']} (re-submit under "
                        f"the same key was then rejected: {e})"
                    )
                resubmits += 1
                if hedge_ttft_s is not None and not hedged:
                    hedged = True
                    self.hedges += 1
                else:
                    self.reattach_resubmits += 1
                continue
            if resp.get("done"):
                return resp
            now = time.monotonic()
            if (hedge_ttft_s is not None and not hedged
                    and not resp.get("tokens_so_far")
                    and now - t0 > hedge_ttft_s):
                # TTFT deadline missed with zero tokens delivered: hedge by
                # re-issuing the submit under the SAME idempotency key. The
                # server's (tenant, client_req_id) dedup reattaches when the
                # original landed — exactly one engine execution — and only
                # a lost original makes this a fresh request.
                hedged = True
                self.hedges += 1
                try:
                    rid = self.submit(prompt, max_new_tokens, **kw)
                except Rejected:
                    pass  # shed hedge: keep polling the original
            if now > deadline:
                raise TimeoutError(
                    f"generate: request {rid} not done after {timeout_s}s "
                    f"({resp.get('tokens_so_far', 0)} tokens so far); poll "
                    f"request_id {rid} to retrieve it later"
                )
            time.sleep(poll_interval_s)

    def submit(
        self,
        prompt,
        max_new_tokens: Optional[int] = None,
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
        client_req_id: Optional[str] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> int:
        resp = self._client.call(
            "submit", prompt=list(prompt), max_new_tokens=max_new_tokens,
            deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
            temperature=temperature, top_k=top_k, seed=seed,
            client_req_id=client_req_id or uuid.uuid4().hex, **self._id_kw(),
        )
        if "err" in resp:
            raise Rejected(
                f"submit rejected: {resp['err']}",
                reason=resp.get("rejected"),
                retry_after_ms=resp.get("retry_after_ms"),
            )
        return int(resp["request_id"])

    def poll(self, request_id: int, from_: Optional[int] = None,
             client_req_id: Optional[str] = None) -> dict:
        """Poll a request; with `from_` set, the not-done reply carries only
        tokens[from_:] (delta poll — `tokens_so_far` still counts them all,
        and `from` echoes the clamped cursor the suffix starts at). With
        `client_req_id` set the server falls back to resolving the request
        by its (tenant, key) identity when the id is unknown — the identity
        that survives a router takeover."""
        kw: Dict[str, Any] = {"request_id": request_id, **self._id_kw()}
        if from_ is not None:
            kw["from"] = int(from_)
        if client_req_id is not None:
            kw["client_req_id"] = str(client_req_id)
        return self._client.call("poll", **kw)

    def stream(
        self,
        prompt=None,
        max_new_tokens: Optional[int] = None,
        request_id: Optional[int] = None,
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
        client_req_id: Optional[str] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
        reattach_retries: int = 4,
    ):
        """Push-streaming generator: yields token frames as the server emits
        them (each a dict with the `tokens` delta; the final frame carries
        `done`/`finish_reason`). With `prompt` given this is submit with
        `stream=True` — the ack and the first frame share one connection and
        one round trip; with `request_id` it attaches to an in-flight
        request. Runs on a DEDICATED connection (the request/reply client
        stays usable concurrently). A dropped stream reattaches up to
        `reattach_retries` times via the `stream` RPC with the token cursor,
        so delivered tokens are never re-sent and never lost; the submit
        leg rides the usual idempotency key, so a retried attach after a
        lost ack reattaches to the original request.

        Self-healing across a ROUTER death: the dedicated
        connection rotates the endpoint list, the reattach names the
        idempotency key (so the new incarnation resolves the request even
        though its ids restarted), and when the new router doesn't know the
        request at all (its replica died too) the reattach degrades to a
        re-submit under the same key + client-pinned seed. Frames are
        trimmed against the tokens already YIELDED — a takeover target
        whose mirror is still behind may re-send a prefix, and the consumer
        must see every token exactly once."""
        if (prompt is None) == (request_id is None):
            raise ValueError("stream() needs exactly one of prompt/request_id")
        key = client_req_id or uuid.uuid4().hex
        if prompt is not None and seed is None:
            # client-pinned sampling identity (see generate()): survives the
            # every-server-side-holder-died window token-identically
            seed = int.from_bytes(uuid.uuid4().bytes[:4], "little")
        delivered = 0  # tokens this generator has yielded — the one cursor
        failures = 0
        conn = MasterClient(
            self._client.endpoints, timeout=self._client.timeout, retries=2,
            wire=self._client.wire,
        )
        try:
            while True:
                if request_id is None:
                    frames = conn.call_stream(
                        "submit", prompt=list(prompt),
                        max_new_tokens=max_new_tokens, stream=True,
                        deadline_s=deadline_s,
                        ttft_deadline_s=ttft_deadline_s,
                        temperature=temperature, top_k=top_k, seed=seed,
                        client_req_id=key, **self._id_kw(),
                    )
                else:
                    frames = conn.call_stream(
                        "stream", **{"from": delivered},
                        request_id=request_id, client_req_id=key,
                        **self._id_kw(),
                    )
                try:
                    ack = next(frames)
                    if "err" in ack:
                        if (prompt is not None
                                and ack.get("retry_after_ms") is not None):
                            # a shed, not a verdict (e.g. a just-took-over
                            # router whose replicas are still re-joining):
                            # honor the hint within the reattach budget
                            failures += 1
                            if failures > max(0, int(reattach_retries)):
                                raise Rejected(
                                    f"stream rejected: {ack['err']}",
                                    reason=ack.get("rejected"),
                                    retry_after_ms=ack.get("retry_after_ms"),
                                )
                            time.sleep(
                                min(ack["retry_after_ms"] / 1e3, 2.0)
                            )
                            continue
                        if request_id is not None and prompt is not None:
                            # the (possibly new) router knows neither the id
                            # nor the key: the request died with its holders
                            # — re-issue it under the same key; dedup makes
                            # this attach-or-execute, never a duplicate
                            request_id = None
                            self.reattach_resubmits += 1
                            continue
                        raise Rejected(
                            f"stream rejected: {ack['err']}",
                            reason=ack.get("rejected"),
                            retry_after_ms=ack.get("retry_after_ms"),
                        )
                    request_id = int(ack["request_id"])
                    for frame in frames:
                        toks = list(frame.get("tokens") or [])
                        base = int(frame.get("from", delivered))
                        # trim what this generator already yielded: a frame
                        # from a reattached (or takeover) stream may overlap
                        # the delivered prefix — exactly-once to the consumer
                        unseen = toks[max(0, delivered - base):]
                        if unseen or frame.get("done"):
                            out = dict(frame)
                            out["tokens"] = unseen
                            out["from"] = delivered
                            delivered += len(unseen)
                            out["tokens_so_far"] = max(
                                int(frame.get("tokens_so_far", delivered)),
                                delivered,
                            )
                            yield out
                            if out.get("done"):
                                return
                except OSError:
                    # ConnectionError AND recv timeouts: a killed-in-place
                    # router leaves the push socket open but silent — the
                    # cursor makes a spurious-timeout reattach harmless
                    failures += 1
                    if failures > max(0, int(reattach_retries)):
                        raise
                    self.stream_reattaches += 1
                    conn.close()  # reattach from `delivered` on a fresh socket
        finally:
            conn.close()
            self.stream_bytes_in += conn.bytes_received
            self.stream_bytes_out += conn.bytes_sent
            self.stream_round_trips += conn.round_trips

    def cancel(self, request_id: int) -> dict:
        """Cancel a submitted request server-side (pages recycle at the next
        decode-step boundary); idempotent once the request finished."""
        return self._client.call(
            "cancel", request_id=request_id, **self._id_kw()
        )

    def heartbeat(self) -> dict:
        return self._client.call("heartbeat", **self._id_kw())

    def stats(self) -> dict:
        return self._client.call("stats", **self._id_kw())

    def metrics(self) -> str:
        """The server's Prometheus metrics text (the `metrics` RPC)."""
        return self._client.call("metrics", **self._id_kw()).get("text", "")

    def trace_export(self) -> dict:
        """The server's span ring buffer as Chrome trace JSON — merge with
        the local export via obs.trace.merge_chrome for one stitched view."""
        return self._client.call(
            "trace_export", **self._id_kw()
        ).get("chrome_trace", {})

    @property
    def wire_framed(self) -> bool:
        """True once the request/reply connection negotiated binary frames."""
        return self._client.wire_framed

    def wire_totals(self) -> dict:
        """Bytes and round trips this client has spent on the wire — the
        request/reply connection plus every finished push stream (bench
        food: bytes per delivered token, round trips per token)."""
        return {
            "bytes_in": self._client.bytes_received + self.stream_bytes_in,
            "bytes_out": self._client.bytes_sent + self.stream_bytes_out,
            "round_trips": self._client.round_trips + self.stream_round_trips,
        }

    def close(self) -> None:
        self._client.close()
