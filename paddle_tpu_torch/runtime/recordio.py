"""RecordIO chunked dataset files (counterpart of
`paddle_tpu/runtime/recordio.py`; the native `csrc/native/recordio.cc`, Go
recordio parity), the on-disk format of the JAX package's files, byte for
byte:

    chunk  := magic u32 "PTRC" | n_records u32 | data_len u32 | crc32(data) u32 | data
    record := len u32 | bytes        (little-endian)

`Writer` and `Reader` always run the native library; a corrupt chunk (CRC)
is skipped whole and counted in `Reader.errors`, and broken framing (a bad
magic, a data_len over the format limit, a short read) ends the file.
`convert` shards a sample reader into files of `records_per_file`
pickled samples, the v2 dataset pipeline's `convert`; `read_shards` reads
them back. `_PyWriter` and `_py_read` are the same format in Python: the
oracle the tests hold the native code to, never a fallback."""

from __future__ import annotations

import ctypes as C
import os
import pickle
import struct
import zlib
from typing import Any, Callable, Iterable, Iterator, List, Optional

from paddle_tpu_torch.runtime import native

_MAGIC = 0x50545243  # "PTRC"
_HEAD = struct.Struct("<IIII")
_LEN = struct.Struct("<I")

# the format's limit, kMaxChunkBytes in csrc/native/recordio.cc: writers
# refuse a record it cannot hold, readers take a larger data_len as corruption
MAX_CHUNK_BYTES = 1 << 30


class Writer:
    """Writes length-prefixed records into CRC-checked chunks of at most
    `chunk_records` records or about `chunk_bytes` bytes."""

    def __init__(self, path: str, chunk_records: int = 1000, chunk_bytes: int = 8 << 20):
        self._lib = native.lib()
        self._h = self._lib.pt_recordio_writer_open(path.encode(), chunk_records, chunk_bytes)
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    def write(self, record: bytes) -> None:
        rc = self._lib.pt_recordio_write(self._h, record, len(record))
        if rc == -2:
            raise ValueError(f"record of {len(record)} bytes exceeds the recordio format "
                             f"limit ({MAX_CHUNK_BYTES} bytes per chunk)")
        if rc != 0:
            raise OSError("recordio write failed")

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, None
            if self._lib.pt_recordio_writer_close(h) != 0:
                raise OSError("recordio close failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Reader:
    """Iterates a file's records; corrupt chunks are skipped and counted."""

    def __init__(self, path: str):
        self.path = path
        self._lib = native.lib()
        self._h = self._lib.pt_recordio_reader_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def __iter__(self) -> Iterator[bytes]:
        out = C.c_void_p()
        while self._h:
            n = self._lib.pt_recordio_next(self._h, C.byref(out))
            if n < 0:
                return
            yield C.string_at(out.value, n)

    @property
    def errors(self) -> int:
        return int(self._lib.pt_recordio_errors(self._h))

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, None
            self._lib.pt_recordio_reader_close(h)


class _PyWriter:
    """The format in Python (the tests' oracle)."""

    def __init__(self, path: str, chunk_records: int, chunk_bytes: int):
        self.f = open(path, "wb")
        self.chunk_records = chunk_records
        self.chunk_bytes = chunk_bytes
        self.pending: List[bytes] = []
        self.pending_bytes = 0

    def write(self, record: bytes) -> None:
        if len(record) + _LEN.size > MAX_CHUNK_BYTES:
            raise ValueError(f"record of {len(record)} bytes exceeds the recordio format "
                             f"limit ({MAX_CHUNK_BYTES} bytes per chunk)")
        self.pending.append(record)
        self.pending_bytes += len(record)
        if len(self.pending) >= self.chunk_records or self.pending_bytes >= self.chunk_bytes:
            self._flush()

    def _flush(self) -> None:
        if not self.pending:
            return
        data = b"".join(_LEN.pack(len(r)) + r for r in self.pending)
        self.f.write(_HEAD.pack(_MAGIC, len(self.pending), len(data), zlib.crc32(data)))
        self.f.write(data)
        self.pending, self.pending_bytes = [], 0

    def close(self) -> None:
        self._flush()
        self.f.close()


def _py_read(path: str, error_box: Optional[List[int]] = None) -> Iterator[bytes]:
    """The reader in Python (the tests' oracle), with the native reader's
    skip-and-count semantics; error_box[0] counts the bad chunks."""

    def bad() -> None:
        if error_box is not None:
            error_box[0] += 1

    with open(path, "rb") as f:
        while True:
            head = f.read(_HEAD.size)
            if len(head) < _HEAD.size:
                return
            magic, n_rec, data_len, crc = _HEAD.unpack(head)
            if magic != _MAGIC or data_len > MAX_CHUNK_BYTES:
                bad()  # framing lost: stop rather than scan
                return
            data = f.read(data_len)
            if len(data) < data_len:
                bad()
                return
            if zlib.crc32(data) != crc:
                bad()
                continue
            off = 0
            for _ in range(n_rec):
                (ln,) = _LEN.unpack_from(data, off)
                off += _LEN.size
                yield data[off:off + ln]
                off += ln


def convert(output_dir: str, reader: Callable[[], Iterable[Any]], records_per_file: int = 4096,
            prefix: str = "shard",
            serialize: Callable[[Any], bytes] = lambda s: pickle.dumps(s, protocol=4)
            ) -> List[str]:
    """Shard a sample reader into recordio files `<prefix>-NNNNN.recordio`
    of `records_per_file` samples each; returns their paths."""
    os.makedirs(output_dir, exist_ok=True)
    paths: List[str] = []
    w: Optional[Writer] = None
    count = 0
    for sample in reader():
        if w is None:
            paths.append(os.path.join(output_dir, f"{prefix}-{len(paths):05d}.recordio"))
            w = Writer(paths[-1])
        w.write(serialize(sample))
        count += 1
        if count >= records_per_file:
            w.close()
            w, count = None, 0
    if w is not None:
        w.close()
    return paths


def read_shards(paths: Iterable[str],
                deserialize: Callable[[bytes], Any] = pickle.loads) -> Iterator[Any]:
    """Every sample of the shards, in order."""
    for p in paths:
        r = Reader(p)
        try:
            for rec in r:
                yield deserialize(rec)
        finally:
            r.close()
