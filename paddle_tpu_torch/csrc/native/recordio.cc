// RecordIO-style chunked record file — parity with the Go recordio library
// the reference's master/pserver data path shards datasets into
// (SURVEY §2.2 go/master "chunks of RecordIO"; python v2/dataset `convert`).
//
// On-disk layout (little-endian), one file = N chunks:
//   chunk := magic:u32 | num_records:u32 | data_len:u32 | crc32(data):u32
//            | data (records back to back)
//   record := len:u32 | bytes
//
// Corrupt chunks are detected by CRC and skipped record-exactly (the reader
// reports them via pt_recordio_errors), which is what makes chunk-granular
// task re-dispatch safe in the elastic master.

#include <cstdio>
#include <new>
#include <string>
#include <vector>

#include "common.h"

namespace pt {
namespace {

constexpr uint32_t kMagic = 0x50545243u;  // "PTRC"
// Shared format limit (writers enforce, readers treat violations as
// corruption; mirrored by _PyWriter/_py_read in runtime/recordio.py). Keeps a
// corrupted data_len from driving a multi-GiB allocation whose bad_alloc
// would escape the extern-C ABI.
constexpr uint32_t kMaxChunkBytes = 1u << 30;  // 1 GiB

struct Writer {
  FILE* f = nullptr;
  std::vector<std::string> pending;
  size_t pending_bytes = 0;
  int chunk_records;
  size_t chunk_bytes;

  int flush() {
    if (pending.empty()) return 0;
    std::string data;
    data.reserve(pending_bytes + 4 * pending.size());
    for (auto& r : pending) {
      uint32_t len = static_cast<uint32_t>(r.size());
      data.append(reinterpret_cast<const char*>(&len), 4);
      data.append(r);
    }
    uint32_t head[4] = {kMagic, static_cast<uint32_t>(pending.size()),
                        static_cast<uint32_t>(data.size()),
                        crc32(data.data(), data.size())};
    if (fwrite(head, sizeof(head), 1, f) != 1) return -1;
    if (!data.empty() && fwrite(data.data(), data.size(), 1, f) != 1) return -1;
    pending.clear();
    pending_bytes = 0;
    return 0;
  }
};

struct Reader {
  FILE* f = nullptr;
  std::vector<std::string> chunk;  // decoded records of current chunk
  size_t next = 0;                 // next record index in chunk
  uint64_t bad_chunks = 0;

  // loads the next valid chunk; false on EOF
  bool load_chunk() {
    for (;;) {
      uint32_t head[4];
      if (fread(head, sizeof(head), 1, f) != 1) return false;  // EOF
      if (head[0] != kMagic) {
        // stream corrupt beyond chunk framing: stop rather than scan
        ++bad_chunks;
        return false;
      }
      // A data_len beyond the format limit (which writers enforce) is
      // corruption — never a legitimate chunk.
      if (head[2] > kMaxChunkBytes) {
        ++bad_chunks;
        return false;  // framing untrustworthy: stop rather than scan
      }
      std::string data(head[2], '\0');
      if (head[2] && fread(&data[0], head[2], 1, f) != 1) {
        ++bad_chunks;
        return false;  // truncated tail
      }
      if (crc32(data.data(), data.size()) != head[3]) {
        ++bad_chunks;
        continue;  // skip corrupt chunk, try next
      }
      chunk.clear();
      size_t off = 0;
      bool ok = true;
      for (uint32_t i = 0; i < head[1]; ++i) {
        if (off + 4 > data.size()) { ok = false; break; }
        uint32_t len;
        std::memcpy(&len, data.data() + off, 4);
        off += 4;
        if (off + len > data.size()) { ok = false; break; }
        chunk.emplace_back(data.data() + off, len);
        off += len;
      }
      if (!ok) {
        ++bad_chunks;
        continue;
      }
      next = 0;
      if (!chunk.empty()) return true;
    }
  }
};

}  // namespace
}  // namespace pt

using pt::Reader;
using pt::Writer;

PT_EXPORT void* pt_recordio_writer_open(const char* path, int chunk_records,
                                        size_t chunk_bytes) {
  auto* w = new (std::nothrow) Writer();
  if (!w) return nullptr;
  w->f = fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  w->chunk_records = chunk_records > 0 ? chunk_records : 1000;
  w->chunk_bytes = chunk_bytes > 0 ? chunk_bytes : (8u << 20);
  return w;
}

PT_EXPORT int pt_recordio_write(void* wp, const void* buf, uint64_t len) {
  auto* w = static_cast<Writer*>(wp);
  // reject records the format cannot represent in a readable chunk
  if (len + 4 > pt::kMaxChunkBytes) return -2;
  w->pending.emplace_back(static_cast<const char*>(buf), len);
  w->pending_bytes += len;
  if (w->pending.size() >= static_cast<size_t>(w->chunk_records) ||
      w->pending_bytes >= w->chunk_bytes)
    return w->flush();
  return 0;
}

PT_EXPORT int pt_recordio_writer_close(void* wp) {
  auto* w = static_cast<Writer*>(wp);
  int rc = w->flush();
  if (fclose(w->f) != 0) rc = -1;
  delete w;
  return rc;
}

PT_EXPORT void* pt_recordio_reader_open(const char* path) {
  auto* r = new (std::nothrow) Reader();
  if (!r) return nullptr;
  r->f = fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  return r;
}

// Returns record length and sets *out to an internal buffer valid until the
// next call; -1 on EOF.
PT_EXPORT int64_t pt_recordio_next(void* rp, const void** out) {
  auto* r = static_cast<Reader*>(rp);
  if (r->next >= r->chunk.size() && !r->load_chunk()) return -1;
  const std::string& rec = r->chunk[r->next++];
  *out = rec.data();
  return static_cast<int64_t>(rec.size());
}

PT_EXPORT uint64_t pt_recordio_errors(void* rp) {
  return static_cast<Reader*>(rp)->bad_chunks;
}

PT_EXPORT void pt_recordio_reader_close(void* rp) {
  auto* r = static_cast<Reader*>(rp);
  fclose(r->f);
  delete r;
}
