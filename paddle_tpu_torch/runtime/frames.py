"""Binary control-plane framing: the length-prefixed frame layer under the
line-JSON RPC surface.

The port's copy of `paddle_tpu/runtime/frames.py` (json and struct only),
byte for byte the same wire, so either package's client talks to either
package's server. The same dicts go in and come out, so handlers and
clients are wire-agnostic above this seam.

Frame layout (little-endian, 16-byte fixed header)::

    u8  magic      0xF7 — rejects a line-JSON peer that skipped negotiation
    u8  version    1
    u8  flags      FLAG_* below
    u8  method_id  compact id for well-known methods (0 = name in JSON)
    u32 req_id     request id: pipelining match key; stream frames reuse it
                   as the serving request id
    u32 json_len   length of the JSON control payload (0 allowed)
    u32 bin_len    length of the raw binary payload (0 allowed)
    [24-byte trace block when FLAG_TRACE]
    [json_len bytes JSON]
    [bin_len bytes raw]

Control fields stay JSON (schema-free, debuggable); BULK bodies ride the
raw binary payload: token runs as packed int32 (FLAG_BIN_TOKENS), opaque
blobs like master snapshots (FLAG_BIN_BLOB), and the compact stream-delta
form (FLAG_STREAM with json_len == 0: req_id is the serving request id and
the binary payload is `<u32 from><int32 tokens...>` — a pushed token costs
4 bytes plus its share of a 20-byte frame, not a JSON object). A stream's
common ending (finish_reason "length", not cancelled) stays compact too:
FLAG_EOS on the delta replaces the whole JSON `done` tail.

Trace context moves INTO the header: the `_trace` dict that used to ride
every JSON object becomes a fixed 24-byte block (8-byte raw trace id +
16-byte NUL-padded span id) gated by FLAG_TRACE, so tracing-enabled runs
stop re-encoding two hex strings per RPC; an id that does not fit the fixed
block falls back to the JSON field, transparently.

Negotiation is deliberately NOT framed: a client opens with the line-JSON
`{"method": "_hello", "frames": 1}` probe; a frame-capable server answers
`{"frames": 1}` and switches THAT connection to the framed loop, a legacy
server answers unknown-method and the client stays on line JSON (memoized
per endpoint). A legacy client never sends the probe, so it is served
bit-for-bit by the unchanged line path. `PADDLE_TPU_WIRE` picks the client
policy: `auto` (default — probe, fall back), `json` (never probe),
`frames` (downgrade is an error).

The decoder REJECTS garbage with named errors instead of wedging a handler
thread: `BadMagic`, `BadVersion`, `FrameTooLarge` (length caps below —
a hostile/corrupt length field must not allocate gigabytes), and
`TruncatedFrame` (EOF mid-frame). All subclass `FrameError`, itself a
`ConnectionError`, so every existing reconnect/failover path absorbs them.

`write_frame` is THE control-frame encode site (the hot-loop lint pins it:
clients and handlers call here instead of sprinkling `json.dumps` over the
pump/heartbeat paths); `encode_stream` is the stream-frame twin behind
serving's `encode_frame` seam."""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "FLAG_BIN_BLOB",
    "FLAG_BIN_TOKENS",
    "FLAG_EOS",
    "FLAG_PIGGY",
    "FLAG_STREAM",
    "FLAG_TRACE",
    "BadMagic",
    "BadVersion",
    "FrameError",
    "FrameTooLarge",
    "TruncatedFrame",
    "decode_payload",
    "encode_stream",
    "pack_tokens",
    "read_frame",
    "unpack_tokens",
    "write_frame",
]

MAGIC = 0xF7
VERSION = 1

# <BBBBIII: magic, version, flags, method_id, req_id, json_len, bin_len
_HEADER = struct.Struct("<BBBBIII")
HEADER_SIZE = _HEADER.size  # 16

FLAG_BIN_TOKENS = 0x01  # bin payload backs the JSON's "_ntok" markers
FLAG_TRACE = 0x02       # 24-byte trace block follows the header
FLAG_PIGGY = 0x04       # reply carries a piggybacked control signal (_rz)
FLAG_STREAM = 0x08      # push-stream frame; json_len == 0 => compact delta
FLAG_BIN_BLOB = 0x10    # bin payload is an opaque blob (resp["_bin"])
FLAG_EOS = 0x20         # compact stream delta is FINAL: done, length-capped

# length caps: a corrupt/hostile length field must fail NAMED, not allocate
MAX_JSON = 16 << 20   # 16 MiB of control fields is already a bug
MAX_BIN = 256 << 20   # snapshots/param blobs; far above anything real

_TRACE_ID_BYTES = 8    # trace ids are os.urandom(8).hex() — 8 raw bytes
_SPAN_ID_BYTES = 16    # "<pid hex>.<n>", NUL-padded
TRACE_BLOCK_SIZE = _TRACE_ID_BYTES + _SPAN_ID_BYTES

# well-known methods get a 1-byte id and drop the JSON "method" field;
# id 0 means the method name (if any) stays in the JSON payload
METHOD_IDS: Dict[str, int] = {
    "get_task": 1, "task_finished": 2, "task_failed": 3, "get_tasks": 4,
    "heartbeat": 5, "register": 6, "deregister": 7, "set_dataset": 8,
    "pass_finished": 9, "stats": 10, "resize": 11, "resize_drained": 12,
    "resize_status": 13, "metrics": 14, "trace_export": 15,
    "snapshot_fetch": 16, "submit": 17, "generate": 18, "poll": 19,
    "poll_many": 20, "cancel": 21, "stream": 22, "replica_register": 23,
    "replica_heartbeat": 24, "replica_deregister": 25, "outstanding": 26,
    "generate_config": 27, "drain": 28, "replicas": 29,
}
METHOD_NAMES = {v: k for k, v in METHOD_IDS.items()}


class FrameError(ConnectionError):
    """Any framed-wire protocol violation. A ConnectionError on purpose:
    every client retry/failover path and every handler's sever-on-error
    path already knows what to do with one."""


class BadMagic(FrameError):
    """First byte was not MAGIC — a line-JSON peer (or garbage) on a framed
    connection."""


class BadVersion(FrameError):
    """Frame version this build does not speak."""


class FrameTooLarge(FrameError):
    """Declared payload length exceeds the caps (corrupt length field)."""


class TruncatedFrame(FrameError):
    """EOF mid-frame: the peer died between header and payload."""


# -- trace block --------------------------------------------------------------


def _encode_trace(ctx: Any) -> Optional[bytes]:
    """`_trace` dict -> fixed 24-byte block, or None when it does not fit
    (caller leaves the JSON field in place — the fallback path)."""
    if not isinstance(ctx, dict):
        return None
    t, s = ctx.get("t"), str(ctx.get("s") or "")
    if not isinstance(t, str) or len(t) != 2 * _TRACE_ID_BYTES:
        return None
    if len(s) > _SPAN_ID_BYTES:
        return None
    try:
        raw = bytes.fromhex(t)
        span = s.encode("ascii")
    except (ValueError, UnicodeEncodeError):
        return None
    return raw + span.ljust(_SPAN_ID_BYTES, b"\0")


def _decode_trace(block: bytes) -> Dict[str, str]:
    return {
        "t": block[:_TRACE_ID_BYTES].hex(),
        "s": block[_TRACE_ID_BYTES:].rstrip(b"\0").decode("ascii", "replace"),
    }


# -- token packing ------------------------------------------------------------


def _int32s(toks: Any) -> bool:
    """True when every element is a plain int that fits int32 — anything
    else (numpy scalars, bools, out-of-range ids) stays JSON rather than
    raising struct.error mid-reply."""
    return (
        isinstance(toks, list) and bool(toks)
        and all(
            type(t) is int and -0x80000000 <= t <= 0x7FFFFFFF for t in toks
        )
    )


def _pack_one(d: dict, segs: list) -> dict:
    toks = d.get("tokens")
    if _int32s(toks):
        d = dict(d)
        d["_ntok"] = len(toks)
        del d["tokens"]
        segs.append(struct.pack(f"<{len(toks)}i", *toks))
    return d


def pack_tokens(obj: dict) -> Tuple[dict, bytes]:
    """Strip token runs out of a reply into one packed-int32 binary payload.

    Walks the top-level "tokens" list and each item of a top-level
    "results" list (the poll / poll_many / stream shapes), replacing each
    with an "_ntok" count; `unpack_tokens` reverses in the same order.
    Returns (new obj, bin payload) — (obj, b"") when nothing packed."""
    segs: list = []
    out = _pack_one(obj, segs)
    res = out.get("results")
    if isinstance(res, list):
        packed = [
            _pack_one(it, segs) if isinstance(it, dict) else it for it in res
        ]
        if segs:
            out = dict(out) if out is obj else out
            out["results"] = packed
    return out, b"".join(segs)


def _unpack_one(d: dict, blob: bytes, off: int) -> Tuple[dict, int]:
    n = d.get("_ntok")
    if not isinstance(n, int):
        return d, off
    end = off + 4 * n
    if end > len(blob):
        raise TruncatedFrame(
            f"token payload short: need {end} bytes, have {len(blob)}"
        )
    d = dict(d)
    del d["_ntok"]
    d["tokens"] = list(struct.unpack_from(f"<{n}i", blob, off))
    return d, end


def unpack_tokens(obj: dict, blob: bytes) -> dict:
    """Reverse pack_tokens: fold the binary token runs back into the dict
    (same walk order: top-level first, then results items)."""
    out, off = _unpack_one(obj, blob, 0)
    res = out.get("results")
    if isinstance(res, list):
        items = []
        for it in res:
            if isinstance(it, dict):
                it, off = _unpack_one(it, blob, off)
            items.append(it)
        out = dict(out) if out is obj else out
        out["results"] = items
    return out


# -- encode / decode ----------------------------------------------------------


def write_frame(
    wfile,
    obj: dict,
    req_id: int = 0,
    flags: int = 0,
    bin_payload: bytes = b"",
) -> int:
    """THE control-frame encode site (hot-loop lint pins call sites): pack
    one dict (+ optional binary payload) as a frame onto `wfile` and flush.
    Returns bytes written. Well-known methods and a fitting `_trace` move
    out of the JSON into the header/trace block."""
    method_id = 0
    trace_block = b""
    if "method" in obj or "_trace" in obj:
        obj = dict(obj)
        mid = METHOD_IDS.get(obj.get("method"))
        if mid:
            method_id = mid
            del obj["method"]
        tb = _encode_trace(obj.get("_trace"))
        if tb is not None:
            trace_block = tb
            flags |= FLAG_TRACE
            del obj["_trace"]
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > MAX_JSON:
        raise FrameTooLarge(f"json payload {len(payload)}B exceeds cap")
    if len(bin_payload) > MAX_BIN:
        raise FrameTooLarge(f"binary payload {len(bin_payload)}B exceeds cap")
    buf = (
        _HEADER.pack(
            MAGIC, VERSION, flags & 0xFF, method_id,
            req_id & 0xFFFFFFFF, len(payload), len(bin_payload),
        )
        + trace_block + payload + bin_payload
    )
    wfile.write(buf)
    wfile.flush()
    return len(buf)


def encode_stream(obj: dict) -> bytes:
    """Stream-frame encode seam (serving's `encode_frame(framed=True)` body):
    a pure token delta becomes the compact header-only form (req_id = the
    serving request id, bin = `<u32 from><int32 tokens...>`, NO JSON); a
    final/irregular frame keeps its JSON with tokens packed binary."""
    rid = obj.get("request_id")
    toks = obj.get("tokens")
    frm = obj.get("from", 0)
    if (
        isinstance(rid, int) and 0 <= rid <= 0xFFFFFFFF
        and isinstance(frm, int) and 0 <= frm <= 0xFFFFFFFF
        and _int32s(toks)
        and obj.get("tokens_so_far") == frm + len(toks)
    ):
        compact = None
        if not obj.get("done") and len(obj) <= 4:
            # request_id, from, tokens, tokens_so_far only
            compact = FLAG_STREAM | FLAG_BIN_TOKENS
        elif (
            obj.get("done") is True
            and obj.get("finish_reason") == "length"
            and obj.get("cancelled") is False
            and len(obj) == 7  # base four + done/finish_reason/cancelled
        ):
            # the overwhelmingly common ending (max_new reached, not
            # cancelled) needs no JSON either: FLAG_EOS stands in for the
            # whole `_stream_final` dict and the decoder reconstitutes it
            compact = FLAG_STREAM | FLAG_BIN_TOKENS | FLAG_EOS
        if compact is not None:
            blob = struct.pack(f"<I{len(toks)}i", frm, *toks)
            return _HEADER.pack(
                MAGIC, VERSION, compact, 0,
                rid, 0, len(blob),
            ) + blob
    packed, blob = pack_tokens(obj)
    payload = json.dumps(packed, separators=(",", ":")).encode()
    flags = FLAG_STREAM | (FLAG_BIN_TOKENS if blob else 0)
    return _HEADER.pack(
        MAGIC, VERSION, flags, 0,
        (rid or 0) & 0xFFFFFFFF, len(payload), len(blob),
    ) + payload + blob


def _read_exact(rfile, n: int, what: str) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = rfile.read(n - got)
        if not chunk:
            raise TruncatedFrame(f"EOF after {got}/{n} bytes of {what}")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(rfile) -> Optional[Tuple[dict, int, int, bytes]]:
    """Read one frame -> (obj, req_id, flags, bin_payload); None on clean
    EOF (no bytes at a frame boundary). Raises the named FrameError
    subclasses on anything malformed — a garbage or truncated frame must
    sever the connection, never wedge the reader."""
    first = rfile.read(1)
    if not first:
        return None
    head = first + _read_exact(rfile, HEADER_SIZE - 1, "frame header")
    magic, version, flags, method_id, req_id, json_len, bin_len = (
        _HEADER.unpack(head)
    )
    if magic != MAGIC:
        raise BadMagic(f"bad frame magic 0x{magic:02x} (want 0x{MAGIC:02x})")
    if version != VERSION:
        raise BadVersion(f"frame version {version} (speak {VERSION})")
    if json_len > MAX_JSON or bin_len > MAX_BIN:
        raise FrameTooLarge(
            f"declared lengths json={json_len} bin={bin_len} exceed caps"
        )
    trace = None
    if flags & FLAG_TRACE:
        trace = _decode_trace(_read_exact(rfile, TRACE_BLOCK_SIZE, "trace block"))
    obj: Dict[str, Any] = {}
    if json_len:
        raw = _read_exact(rfile, json_len, "json payload")
        try:
            obj = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise FrameError(f"unparseable json payload: {e}") from e
        if not isinstance(obj, dict):
            raise FrameError(
                f"json payload is {type(obj).__name__}, not an object"
            )
    blob = _read_exact(rfile, bin_len, "binary payload") if bin_len else b""
    if method_id and "method" not in obj:
        name = METHOD_NAMES.get(method_id)
        if name is None:
            raise FrameError(f"unknown method id {method_id}")
        obj["method"] = name
    if trace is not None and "_trace" not in obj:
        obj["_trace"] = trace
    return obj, req_id, flags, blob


def decode_payload(obj: dict, req_id: int, flags: int, blob: bytes) -> dict:
    """Fold a frame's binary payload back into its dict: the compact stream
    delta reconstitutes the full frame shape, FLAG_BIN_TOKENS unpacks token
    runs, FLAG_BIN_BLOB attaches the raw blob as `_bin`. Callers above this
    line see exactly what a line-JSON peer would have seen."""
    if flags & FLAG_STREAM and not obj and blob:
        if len(blob) < 4 or (len(blob) - 4) % 4:
            raise TruncatedFrame(
                f"compact stream delta has odd length {len(blob)}"
            )
        n = (len(blob) - 4) // 4
        frm, *toks = struct.unpack(f"<I{n}i", blob)
        out = {
            "request_id": req_id,
            "from": frm,
            "tokens": list(toks),
            "tokens_so_far": frm + n,
        }
        if flags & FLAG_EOS:
            out["done"] = True
            out["finish_reason"] = "length"
            out["cancelled"] = False
        return out
    if flags & FLAG_BIN_TOKENS and blob:
        return unpack_tokens(obj, blob)
    if flags & FLAG_BIN_BLOB and blob:
        obj = dict(obj)
        obj["_bin"] = blob
        return obj
    return obj
