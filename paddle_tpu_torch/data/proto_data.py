"""DataFormat.proto binary shards: reader, writer, and builtin provider
(the port's copy of `paddle_tpu/data/proto_data.py`; numpy only).

The reference stores training data as varint-length-delimited protobuf
messages (gserver/dataproviders/ProtoReader.h:96 read): one DataHeader
followed by DataSamples until EOF (ProtoDataProvider.cpp:210 loadDataFile),
schema in proto/DataFormat.proto. Only varint / length-delimited / fixed32
wire types occur, so the messages are decoded by hand here — no protobuf
codegen — letting the reference's in-tree shards (mnist_bin_part,
data_bin_part, compare_sparse_data) feed trainers unmodified.

Provider semantics mirror the two registered C++ providers:
- `proto` (ProtoDataProvider): instances grouped into sequences by
  DataSample.is_beginning; every-sample-is-a-sequence degrades to iid
  (ProtoDataProvider.cpp:59-69).
- `proto_sequence` (ProtoSequenceDataProvider): iid only; each sample IS a
  sequence — SPARSE_NON_VALUE ids are the tokens, INDEX is the per-sequence
  label (ProtoDataProvider.cpp:750-906; an empty token slot yields the
  reference's single -1 placeholder, :834-840).
"""

from __future__ import annotations

import gzip
import os
import random
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# SlotDef.SlotType (proto/DataFormat.proto:50)
VECTOR_DENSE = 0
VECTOR_SPARSE_NON_VALUE = 1
VECTOR_SPARSE_VALUE = 2
INDEX = 3
VAR_MDIM_DENSE = 4
VAR_MDIM_INDEX = 5
STRING = 6


# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, payload). Payload is int for varint /
    fixed32, memoryview for length-delimited."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            yield fnum, wire, v
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            if pos + n > end:
                raise ValueError(
                    f"truncated length-delimited field {fnum}: need {n} "
                    f"bytes, {end - pos} left"
                )
            yield fnum, wire, buf[pos : pos + n]
            pos += n
        elif wire == 5:
            if pos + 4 > end:
                raise ValueError(
                    f"truncated fixed32 field {fnum}: {end - pos} bytes left"
                )
            yield fnum, wire, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire == 1:
            if pos + 8 > end:
                raise ValueError(
                    f"truncated fixed64 field {fnum}: {end - pos} bytes left"
                )
            yield fnum, wire, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _packed_varints(payload: Any, wire: int) -> List[int]:
    """A `repeated uint32 [packed=true]` field: packed block (wire 2) or a
    single unpacked element (wire 0) — both legal on the wire."""
    if wire == 0:
        return [payload]
    out: List[int] = []
    pos = 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        out.append(v)
    return out


def _packed_floats(payload: Any, wire: int) -> np.ndarray:
    if wire == 5:
        return np.frombuffer(struct.pack("<I", payload), np.float32)
    return np.frombuffer(bytes(payload), "<f4")


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


@dataclass
class SlotDef:
    type: int = VECTOR_DENSE
    dim: int = 0


@dataclass
class VectorSlot:
    values: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    ids: List[int] = field(default_factory=list)
    dims: List[int] = field(default_factory=list)
    strs: List[str] = field(default_factory=list)


@dataclass
class SubseqSlot:
    slot_id: int = 0
    lens: List[int] = field(default_factory=list)


@dataclass
class DataSample:
    is_beginning: bool = True
    vector_slots: List[VectorSlot] = field(default_factory=list)
    id_slots: List[int] = field(default_factory=list)
    var_id_slots: List[VectorSlot] = field(default_factory=list)
    subseq_slots: List[SubseqSlot] = field(default_factory=list)


def _parse_slot_def(buf: memoryview) -> SlotDef:
    sd = SlotDef()
    for fnum, _w, v in _iter_fields(buf):
        if fnum == 1:
            sd.type = v
        elif fnum == 2:
            sd.dim = v
    return sd


def _parse_vector_slot(buf: memoryview) -> VectorSlot:
    vs = VectorSlot()
    vals: List[np.ndarray] = []
    for fnum, w, v in _iter_fields(buf):
        if fnum == 1:
            vals.append(_packed_floats(v, w))
        elif fnum == 2:
            vs.ids.extend(_packed_varints(v, w))
        elif fnum == 3:
            vs.dims.extend(_packed_varints(v, w))
        elif fnum == 4:
            vs.strs.append(bytes(v).decode("utf-8"))
    if vals:
        vs.values = np.concatenate(vals) if len(vals) > 1 else vals[0]
    return vs


def _parse_subseq_slot(buf: memoryview) -> SubseqSlot:
    ss = SubseqSlot()
    for fnum, w, v in _iter_fields(buf):
        if fnum == 1:
            ss.slot_id = v
        elif fnum == 2:
            ss.lens.extend(_packed_varints(v, w))
    return ss


def parse_header(buf: memoryview) -> List[SlotDef]:
    return [
        _parse_slot_def(v) for fnum, _w, v in _iter_fields(buf) if fnum == 1
    ]


def parse_sample(buf: memoryview) -> DataSample:
    s = DataSample()
    for fnum, w, v in _iter_fields(buf):
        if fnum == 1:
            s.is_beginning = bool(v)
        elif fnum == 2:
            s.vector_slots.append(_parse_vector_slot(v))
        elif fnum == 3:
            s.id_slots.extend(_packed_varints(v, w))
        elif fnum == 4:
            s.var_id_slots.append(_parse_vector_slot(v))
        elif fnum == 5:
            s.subseq_slots.append(_parse_subseq_slot(v))
    return s


def read_shard(path: str) -> Tuple[List[SlotDef], List[DataSample]]:
    """One shard file → (slot_defs, samples). `.gz` handled like the
    reference (ProtoReader GzipInputStream). A truncated or corrupt shard
    raises ValueError naming the file — the reference's ProtoReader fails on
    ParseFromZeroCopyStream too, rather than training on partial samples."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    buf = memoryview(raw)
    try:
        pos = 0
        n, pos = _read_varint(buf, pos)
        if pos + n > len(buf):
            raise ValueError("truncated header")
        header = parse_header(buf[pos : pos + n])
        pos += n
        samples: List[DataSample] = []
        while pos < len(buf):
            n, pos = _read_varint(buf, pos)
            if pos + n > len(buf):
                raise ValueError(
                    f"truncated sample {len(samples)}: need {n} bytes, "
                    f"{len(buf) - pos} left"
                )
            samples.append(parse_sample(buf[pos : pos + n]))
            pos += n
    except (ValueError, struct.error, IndexError) as e:
        raise ValueError(f"corrupt proto data shard {path!r}: {e}") from e
    return header, samples


# ---------------------------------------------------------------------------
# writer (gen_proto_data.py / ProtoWriter parity; also the round-trip oracle)
# ---------------------------------------------------------------------------


def _emit_field(out: bytearray, fnum: int, wire: int, payload: Any) -> None:
    _write_varint(out, (fnum << 3) | wire)
    if wire == 0:
        _write_varint(out, payload)
    elif wire == 2:
        _write_varint(out, len(payload))
        out.extend(payload)


def _emit_packed_varints(out: bytearray, fnum: int, vals: Sequence[int]) -> None:
    if not vals:
        return
    body = bytearray()
    for v in vals:
        _write_varint(body, v)
    _emit_field(out, fnum, 2, body)


def _encode_slot_def(sd: SlotDef) -> bytes:
    out = bytearray()
    _emit_field(out, 1, 0, sd.type)
    _emit_field(out, 2, 0, sd.dim)
    return bytes(out)


def _encode_vector_slot(vs: VectorSlot) -> bytes:
    out = bytearray()
    if len(vs.values):
        _emit_field(
            out, 1, 2, np.asarray(vs.values, "<f4").tobytes()
        )
    _emit_packed_varints(out, 2, vs.ids)
    _emit_packed_varints(out, 3, vs.dims)
    for s in vs.strs:
        _emit_field(out, 4, 2, s.encode("utf-8"))
    return bytes(out)


def _encode_sample(s: DataSample) -> bytes:
    out = bytearray()
    if not s.is_beginning:  # default true; the reference always writes it,
        _emit_field(out, 1, 0, 0)  # but omitting the default is wire-equal
    else:
        _emit_field(out, 1, 0, 1)
    for vs in s.vector_slots:
        _emit_field(out, 2, 2, _encode_vector_slot(vs))
    _emit_packed_varints(out, 3, s.id_slots)
    for vs in s.var_id_slots:
        _emit_field(out, 4, 2, _encode_vector_slot(vs))
    for ss in s.subseq_slots:
        body = bytearray()
        _emit_field(body, 1, 0, ss.slot_id)
        _emit_packed_varints(body, 2, ss.lens)
        _emit_field(out, 5, 2, bytes(body))
    return bytes(out)


def write_shard(
    path: str, slot_defs: Sequence[SlotDef], samples: Sequence[DataSample]
) -> None:
    out = bytearray()
    header = bytearray()
    for sd in slot_defs:
        _emit_field(header, 1, 2, _encode_slot_def(sd))
    _write_varint(out, len(header))
    out.extend(header)
    for s in samples:
        enc = _encode_sample(s)
        _write_varint(out, len(enc))
        out.extend(enc)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# builtin providers (DataConfig type "proto" / "proto_sequence")
# ---------------------------------------------------------------------------


def resolve_data_path(path: Optional[str], config_dir: str) -> Optional[str]:
    """The reference resolves data paths against its run directory; configs
    name them relative to the source root (e.g. 'trainer/tests/x'). Try the
    path itself, then the config dir and its ancestors. None when nothing
    exists (or when no path was configured — DataConfig.files defaults to
    None). Shared by the shard loader and the cli's file-list resolution."""
    if not path:
        return None
    cands = [path]
    d = config_dir
    for _ in range(4):
        if d:
            cands.append(os.path.join(d, path))
            d = os.path.dirname(d)
    return next((c for c in cands if os.path.exists(c)), None)


def _resolve_files(files: Sequence[str], config_dir: str) -> List[str]:
    out = []
    for f in files:
        hit = resolve_data_path(f, config_dir)
        if hit is None:
            raise FileNotFoundError(f"proto data shard {f!r} not found")
        out.append(hit)
    return out


class ProtoProvider:
    """Builtin provider with the PyDataProvider2 object surface the cli's
    reader/binder expect: make_settings() declares input_types, __call__
    yields sample tuples, calc_batch_size counts instances per sequence (the
    reference batches by instance count, ProtoDataProvider.cpp:395
    sequenceLoop)."""

    can_over_batch_size = True

    def __init__(self, seq_mode: bool, config_dir: str = "", seed: int = 0):
        self.seq_mode = seq_mode
        self.config_dir = config_dir
        self.seed = seed
        self._slot_defs: Optional[List[SlotDef]] = None
        self._sequences: Optional[List[List[DataSample]]] = None
        self._iid = True
        self._epoch = 0  # reshuffles differently each training pass

    # -- loading ------------------------------------------------------------
    def _load(self, file_list: Sequence[str]) -> None:
        if self._sequences is not None:
            return
        slot_defs: Optional[List[SlotDef]] = None
        samples: List[DataSample] = []
        seq_starts: List[int] = []
        for path in _resolve_files(file_list, self.config_dir):
            header, shard = read_shard(path)
            if slot_defs is None:
                slot_defs = header
            else:
                assert len(slot_defs) == len(header) and all(
                    a.type == b.type and a.dim == b.dim
                    for a, b in zip(slot_defs, header)
                ), "inconsistent shard headers"
            for s in shard:
                if s.is_beginning:
                    seq_starts.append(len(samples))
                samples.append(s)
        if slot_defs is None:
            raise ValueError(
                "no proto data shards given — is DataConfig.files set and "
                "resolvable from the config directory?"
            )
        self._slot_defs = slot_defs
        self._iid = len(seq_starts) == len(samples)
        seq_starts.append(len(samples))
        self._sequences = [
            samples[a:b] for a, b in zip(seq_starts, seq_starts[1:])
        ]

    # -- input types --------------------------------------------------------
    def _input_types(self):
        from paddle_tpu_torch.v2 import data_type as dt

        assert self._slot_defs is not None
        grouped = not self.seq_mode and not self._iid
        types = []
        for sd in self._slot_defs:
            if sd.type == VECTOR_DENSE:
                types.append(
                    dt.dense_vector_sequence(sd.dim)
                    if grouped
                    else dt.dense_vector(sd.dim)
                )
            elif sd.type == VECTOR_SPARSE_NON_VALUE:
                if self.seq_mode:
                    # tokens of the sequence (ids over time)
                    types.append(dt.integer_value_sequence(sd.dim))
                elif grouped:
                    types.append(dt.sparse_binary_vector_sequence(sd.dim))
                else:
                    types.append(dt.sparse_binary_vector(sd.dim))
            elif sd.type == VECTOR_SPARSE_VALUE:
                types.append(dt.sparse_value_slot(sd.dim))
            elif sd.type == INDEX:
                types.append(
                    dt.integer_value_sequence(sd.dim)
                    if grouped
                    else dt.integer_value(sd.dim)
                )
            else:
                raise NotImplementedError(
                    f"proto slot type {sd.type} not supported by the provider"
                )
        return types

    def make_settings(self, obj=None, file_list: Sequence[str] = (), **_kw):
        from paddle_tpu_torch.data.provider import Settings

        self._load(file_list)
        return Settings(input_types=self._input_types())

    # -- batching cost ------------------------------------------------------
    def calc_batch_size(self, sample) -> int:
        if self.seq_mode or self._iid:
            return 1
        first = sample[0]
        return len(first) if isinstance(first, (list, tuple)) else 1

    # -- iteration ----------------------------------------------------------
    def _instance_fields(self, s: DataSample) -> List[Any]:
        assert self._slot_defs is not None
        fields: List[Any] = []
        vec_i = 0
        idx_i = 0
        for sd in self._slot_defs:
            if sd.type == VECTOR_DENSE:
                fields.append(np.asarray(s.vector_slots[vec_i].values, np.float32))
                vec_i += 1
            elif sd.type == VECTOR_SPARSE_NON_VALUE:
                fields.append([int(x) for x in s.vector_slots[vec_i].ids])
                vec_i += 1
            elif sd.type == VECTOR_SPARSE_VALUE:
                vs = s.vector_slots[vec_i]
                fields.append(list(zip([int(x) for x in vs.ids], vs.values)))
                vec_i += 1
            elif sd.type == INDEX:
                v = int(s.id_slots[idx_i])
                # the generator writes OOV-ignored ids as 0xffffffff; the
                # reference's int32 IVector holds that as -1 (gen_proto_data
                # OOV_POLICY_IGNORE) — keep the signed view
                fields.append(v - (1 << 32) if v >= (1 << 31) else v)
                idx_i += 1
        return fields

    def __call__(self, obj=None, file_list=None, is_train=True, **_kw):
        self._load(file_list or ())
        assert self._sequences is not None
        sequences = self._sequences
        if is_train:
            # ProtoDataProvider::reset() shuffles sequence order every
            # training pass (ProtoDataProvider.cpp:372-385); seeded per pass
            # so runs stay reproducible. Test/generation readers keep file
            # order. Shuffles a copy — the loaded corpus stays pristine.
            self._epoch += 1
            rnd = random.Random(self.seed * 1000003 + self._epoch)
            sequences = list(sequences)
            rnd.shuffle(sequences)
        for seq in sequences:
            if self.seq_mode:
                # each sample is one sequence: token ids per sparse slot,
                # one label per INDEX slot (an empty token slot yields the
                # reference's -1 placeholder)
                for s in seq:
                    fields = self._instance_fields(s)
                    out = []
                    for sd, fv in zip(self._slot_defs, fields):
                        if sd.type == VECTOR_SPARSE_NON_VALUE:
                            out.append(fv if fv else [-1])
                        else:
                            out.append(fv)
                    yield tuple(out)
            elif self._iid:
                for s in seq:
                    yield tuple(self._instance_fields(s))
            else:
                # one yielded sample per sequence; each slot a list over time
                cols = [self._instance_fields(s) for s in seq]
                yield tuple(list(col) for col in zip(*cols))


def make_proto_provider(dc) -> ProtoProvider:
    """DataConfig (type proto / proto_sequence / *_group) → builtin provider.
    The per-pass shuffle seed follows the global --seed flag."""
    from paddle_tpu_torch.core.init_ctx import flags

    seq_mode = "sequence" in (dc.type or "")
    return ProtoProvider(
        seq_mode, config_dir=dc.config_dir or "", seed=flags().seed
    )
