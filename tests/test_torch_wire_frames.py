"""The port's wire (`paddle_tpu_torch/runtime/`) against the JAX package's.

The frame layer is a copy of `paddle_tpu/runtime/frames.py`, so the claims
are the reference's (tests/test_wire_frames.py) plus byte equality with it:

  * codec — frames round-trip exactly (header methods, trace block, packed
    token runs, the compact stream delta), and for the same objects the
    port's encoded bytes EQUAL the reference's, framed and legacy line-JSON;
  * the decoder rejects garbage with the named `FrameError` subclasses
    (`BadMagic`, `BadVersion`, `FrameTooLarge`, `TruncatedFrame`), fuzzed;
  * negotiation — the port's `MasterClient` falls back to line JSON
    against a legacy peer (memoized), refuses it when pinned to frames, and
    upgrades against the port's `ServingServer`;
  * pipelining — `call_many` ships N requests in ONE round trip, and a
    mid-pipeline `conn_reset` retries the whole batch;
  * serving over both wires gives identical tokens, and binary stream
    frames cost fewer bytes than JSON ones.

Every server binds 127.0.0.1 port 0."""

import io
import json
import random
import socket
import struct
import threading
import time

import pytest

from paddle_tpu_torch.core import faults
from paddle_tpu_torch.runtime import frames
from paddle_tpu_torch.runtime.master import MasterClient, parse_endpoints

pytestmark = [pytest.mark.serving, pytest.mark.timeout(60)]

PROMPT = [1, 5, 9, 11]

# the objects both codecs encode: control requests (well-known and unknown
# methods, trace contexts that fit the header block and one that does not),
# replies with token runs, and the stream-frame shapes
CONTROL = [
    ({"method": "submit", "prompt": [1, 5, 9], "max_new_tokens": 8,
      "client_req_id": "k1"}, 7, 0, b""),
    ({"method": "poll", "request_id": 3, "from": 2,
      "_trace": {"t": "ab" * 8, "s": "12.3"}}, 1, 0, b""),
    ({"method": "made_up", "x": 1}, 0, 0, b""),
    ({"method": "heartbeat", "_trace": {"t": "00" * 8, "s": "x" * 40}}, 2, 0,
     b""),
    ({"done": True, "finish_reason": "length", "cancelled": False,
      "_ntok": 2}, 9, frames.FLAG_BIN_TOKENS, struct.pack("<2i", 4, 5)),
]
STREAM = [
    {"request_id": 9, "from": 4, "tokens": [11, 12, 13], "tokens_so_far": 7},
    {"request_id": 9, "from": 4, "tokens": [11], "tokens_so_far": 5,
     "done": True, "finish_reason": "length", "cancelled": False},
    {"request_id": 2, "from": 0, "tokens": [3], "tokens_so_far": 1,
     "done": True, "finish_reason": "eos", "cancelled": False},
    {"request_id": 2, "from": 1, "tokens": [], "tokens_so_far": 1,
     "done": True, "finish_reason": "cancelled", "cancelled": True},
]
REPLIES = [
    {"done": True, "tokens": [3, -1, 2**31 - 1, 0],
     "results": [{"request_id": 1, "tokens": [5, 6]},
                 {"request_id": 2, "err": "unknown"}]},
    {"done": False, "tokens": [], "tokens_so_far": 0, "from": 0},
    {"tokens": [2**31]},
]


def _roundtrip(obj, **kw):
    buf = io.BytesIO()
    frames.write_frame(buf, dict(obj), **kw)
    buf.seek(0)
    got = frames.read_frame(buf)
    assert got is not None
    out, rid, flags, blob = got
    return frames.decode_payload(out, rid, flags, blob), rid, flags


# -- byte equality with the reference ------------------------------------------


@pytest.mark.parametrize("obj,rid,flags,blob", CONTROL)
def test_control_frames_byte_equal_to_reference(obj, rid, flags, blob):
    from paddle_tpu.runtime import frames as ref

    mine, theirs = io.BytesIO(), io.BytesIO()
    n = frames.write_frame(mine, dict(obj), req_id=rid, flags=flags,
                           bin_payload=blob)
    ref.write_frame(theirs, dict(obj), req_id=rid, flags=flags,
                    bin_payload=blob)
    assert mine.getvalue() == theirs.getvalue() and n == len(mine.getvalue())
    # and each side decodes the other's bytes to the same dict
    theirs.seek(0)
    got = ref.read_frame(theirs)
    mine.seek(0)
    assert frames.decode_payload(*frames.read_frame(mine)) == \
        ref.decode_payload(*got)


@pytest.mark.parametrize("frame", STREAM)
def test_stream_frames_byte_equal_to_reference(frame):
    from paddle_tpu.serving import server as ref_server
    from paddle_tpu_torch.serving import server as port_server

    for framed in (True, False):
        mine = port_server.encode_frame(dict(frame), framed)
        theirs = ref_server.encode_frame(dict(frame), framed)
        assert mine == theirs
    # the legacy line wire is the default json.dumps of the dict, one line
    assert port_server.encode_frame(dict(frame)) == \
        json.dumps(frame).encode() + b"\n"


@pytest.mark.parametrize("reply", REPLIES)
def test_token_packing_byte_equal_to_reference(reply):
    from paddle_tpu.runtime import frames as ref

    packed, blob = frames.pack_tokens(dict(reply))
    assert (packed, blob) == ref.pack_tokens(dict(reply))
    assert frames.unpack_tokens(packed, blob) == reply


def test_parse_endpoints_forms():
    assert parse_endpoints(("h", 1)) == [("h", 1)]
    assert parse_endpoints("a:1,b:2") == [("a", 1), ("b", 2)]
    assert parse_endpoints(["a:1", ("b", 2)]) == [("a", 1), ("b", 2)]
    with pytest.raises(ValueError):
        parse_endpoints("nohost")


# -- codec --------------------------------------------------------------------


def test_control_frame_roundtrip_exact():
    req = {"method": "poll_many", "items": [{"request_id": 7}],
           "tenant_id": "t-1"}
    out, rid, _ = _roundtrip(req, req_id=42)
    assert out == req and rid == 42
    out, _, _ = _roundtrip({"method": "made_up", "x": 1})
    assert out == {"method": "made_up", "x": 1}


def test_trace_context_moves_into_the_header():
    ctx = {"t": "00" * 8, "s": "abc.7"}
    buf = io.BytesIO()
    frames.write_frame(buf, {"method": "heartbeat", "_trace": dict(ctx)})
    assert b"_trace" not in buf.getvalue()
    buf.seek(0)
    out, rid, flags, blob = frames.read_frame(buf)
    assert flags & frames.FLAG_TRACE
    assert frames.decode_payload(out, rid, flags, blob)["_trace"] == ctx
    fat = {"method": "heartbeat", "_trace": {"t": "00" * 8, "s": "x" * 40}}
    assert _roundtrip(dict(fat))[0] == fat


def test_compact_stream_delta_roundtrip():
    frame = STREAM[0]
    raw = frames.encode_stream(dict(frame))
    assert len(raw) == frames.HEADER_SIZE + 4 + 4 * 3  # no JSON at all
    obj, rid, flags, blob = frames.read_frame(io.BytesIO(raw))
    assert flags & frames.FLAG_STREAM and obj == {}
    assert frames.decode_payload(obj, rid, flags, blob) == frame
    capped = STREAM[1]
    raw = frames.encode_stream(dict(capped))
    obj, rid, flags, blob = frames.read_frame(io.BytesIO(raw))
    assert flags & frames.FLAG_EOS and obj == {}
    assert frames.decode_payload(obj, rid, flags, blob) == capped
    for final in STREAM[2:]:
        raw = frames.encode_stream(dict(final))
        obj, rid, flags, blob = frames.read_frame(io.BytesIO(raw))
        assert not flags & frames.FLAG_EOS
        assert frames.decode_payload(obj, rid, flags, blob) == final


def _good_frame() -> bytes:
    buf = io.BytesIO()
    frames.write_frame(buf, {"method": "stats"}, req_id=1)
    return buf.getvalue()


@pytest.mark.parametrize("name,mutate,err", [
    ("bad_magic", lambda raw: b"{" + raw[1:], frames.BadMagic),
    ("bad_version", lambda raw: raw[:1] + b"\x63" + raw[2:], frames.BadVersion),
    ("json_too_large", lambda raw: struct.pack(
        "<BBBBIII", frames.MAGIC, frames.VERSION, 0, 0, 1,
        frames.MAX_JSON + 1, 0), frames.FrameTooLarge),
    ("bin_too_large", lambda raw: struct.pack(
        "<BBBBIII", frames.MAGIC, frames.VERSION, 0, 0, 1, 0,
        frames.MAX_BIN + 1), frames.FrameTooLarge),
    ("eof_mid_payload", lambda raw: raw[:-3], frames.TruncatedFrame),
    ("eof_mid_header", lambda raw: raw[:7], frames.TruncatedFrame),
    ("bad_json", lambda raw: raw[:-2] + b"!" + raw[-1:], frames.FrameError),
])
def test_decoder_rejects_garbage_with_named_errors(name, mutate, err):
    with pytest.raises(err):
        frames.read_frame(io.BytesIO(mutate(_good_frame())))
    assert issubclass(err, ConnectionError)


def test_clean_eof_is_none():
    assert frames.read_frame(io.BytesIO(b"")) is None


def test_fuzzed_frames_never_escape_frameerror():
    base = io.BytesIO()
    frames.write_frame(
        base, {"method": "poll_many", "results": [{"tokens": [1, 2]}]},
        req_id=3, flags=frames.FLAG_BIN_TOKENS, bin_payload=b"\x01\0\0\0",
    )
    raw = bytearray(base.getvalue())
    rng = random.Random(20)
    for _ in range(400):
        mut = bytearray(raw)
        for _ in range(rng.randint(1, 4)):
            mut[rng.randrange(len(mut))] = rng.randrange(256)
        mut = bytes(mut)[: rng.randint(1, len(mut))]
        try:
            got = frames.read_frame(io.BytesIO(mut))
            if got is not None:
                frames.decode_payload(*got)
        except frames.FrameError:
            pass  # named rejection is the contract


# -- negotiation, pipelining, hygiene -------------------------------------------


class _LegacyLineServer:
    """A minimal pre-frames peer: line JSON only, unknown-method for
    anything it does not speak — including `_hello`."""

    def __init__(self):
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.address = self._srv.getsockname()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with conn:
                f = conn.makefile("rwb")
                for line in f:
                    req = json.loads(line)
                    if req.get("method") == "ping":
                        resp = {"pong": True}
                    else:
                        resp = {"err": f"unknown method {req.get('method')!r}"}
                    f.write(json.dumps(resp).encode() + b"\n")
                    f.flush()

    def close(self):
        self._srv.close()


def test_downgrade_negotiation_against_legacy_server():
    legacy = _LegacyLineServer()
    try:
        c = MasterClient(legacy.address, wire="auto", retries=2)
        assert c.call("ping")["pong"] is True
        assert not c.wire_framed
        c.close()
        assert c.call("ping")["pong"] is True  # memoized: no second probe
        assert legacy.address in c._legacy or tuple(legacy.address) in c._legacy
        c.close()
        pinned = MasterClient(legacy.address, wire="frames", retries=1)
        with pytest.raises(ConnectionError):
            pinned.call("ping")
        pinned.close()
    finally:
        legacy.close()


@pytest.fixture(scope="module")
def port_server():
    from paddle_tpu_torch.serving import ServingServer, make_demo_session

    sess = make_demo_session(vocab=96, n_layers=2, d_model=32, n_heads=2,
                             max_len=96, max_slots=4, page_size=8,
                             prefill_buckets=(8, 16, 32), max_new_limit=16,
                             device="cpu")
    srv = ServingServer(sess, port=0).start()
    yield srv
    srv.stop()


def test_framed_negotiation_and_json_pin(port_server):
    cf = MasterClient(port_server.address, wire="frames")
    cj = MasterClient(port_server.address, wire="json")
    try:
        assert "decode_steps" in cf.call("stats") and cf.wire_framed
        assert "decode_steps" in cj.call("stats") and not cj.wire_framed
        assert set(cf.call("stats")) == set(cj.call("stats"))
    finally:
        cf.close()
        cj.close()


def test_call_many_pipelines_one_round_trip_one_socket(port_server):
    c = MasterClient(port_server.address, wire="frames")
    try:
        c.call("stats")
        sock = c._sock
        before = c.round_trips
        out = c.call_many([("heartbeat", {})] * 8 + [("stats", {})])
        assert len(out) == 9 and "decode_steps" in out[-1]
        assert c.round_trips == before + 1
        assert c._sock is sock
    finally:
        c.close()


def test_mid_pipeline_conn_reset_retries_whole_batch(port_server):
    c = MasterClient(port_server.address, wire="frames", retries=4)
    try:
        c.call("stats")
        with faults.inject("conn_reset:step=0", seed=3) as inj:
            out = c.call_many([("heartbeat", {})] * 6)
            assert inj.fired.get("conn_reset", 0) == 1
        assert len(out) == 6 and all("err" not in r for r in out)
        assert c.wire_framed
    finally:
        c.close()


def test_close_closes_buffered_reader_and_writer(port_server):
    c = MasterClient(port_server.address, wire="frames")
    c.call("stats")
    rfile, wfile, sock = c._rfile, c._wfile, c._sock
    c.close()
    assert wfile.closed and sock.fileno() == -1 and c._rfile is None
    assert rfile.close() is None
    assert "decode_steps" in c.call("stats") and c.wire_framed
    c.close()


def test_serving_tokens_identical_across_wires(port_server):
    from paddle_tpu_torch.serving import ServingClient

    cj = ServingClient(port_server.address, wire="json")
    cf = ServingClient(port_server.address, wire="frames")
    try:
        assert cj.generate(PROMPT, 8)["tokens"] == cf.generate(PROMPT, 8)["tokens"]
        assert cf.wire_framed and not cj.wire_framed
        kw = dict(seed=77, temperature=0.8, top_k=8)
        assert (cj.generate(PROMPT, 8, **kw)["tokens"]
                == cf.generate(PROMPT, 8, **kw)["tokens"])
    finally:
        cj.close()
        cf.close()


def test_push_stream_identical_and_smaller_binary(port_server):
    from paddle_tpu_torch.serving import ServingClient

    cj = ServingClient(port_server.address, wire="json")
    cf = ServingClient(port_server.address, wire="frames")
    try:
        tj = [t for fr in cj.stream(PROMPT, 8, seed=5) for t in fr["tokens"]]
        tf = [t for fr in cf.stream(PROMPT, 8, seed=5) for t in fr["tokens"]]
        assert tj == tf and len(tf) == 8
        assert 0 < cf.stream_bytes_in < cj.stream_bytes_in
        # the pusher counts a frame after writing it: the client may hold
        # the last frame a moment before the server's count moves
        deadline = time.monotonic() + 5.0
        while port_server.stream_tokens < 16 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert port_server.stream_frames > 0 and port_server.stream_tokens >= 16
    finally:
        cj.close()
        cf.close()
