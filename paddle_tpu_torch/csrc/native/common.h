// Shared bits for the native runtime library of paddle_tpu_torch.
//
// The device compute path is PyTorch/CUDA; this library is the host runtime
// around it: host memory pooling, dataset chunk IO, the task master and the
// host-side optimizer, the pieces the reference implements in C++/Go
// (paddle/memory buddy allocator, Go recordio + go/master task queues,
// paddle/optimizer). Built by g++ with paddle_tpu_torch/runtime/build.py.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(_WIN32)
#define PT_EXPORT extern "C" __declspec(dllexport)
#else
#define PT_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace pt {

// CRC-32 (IEEE 802.3 polynomial, reflected) — table-driven.
inline uint32_t crc32(const void* data, size_t n, uint32_t seed = 0) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = seed ^ 0xFFFFFFFFu;
  const uint8_t* p = static_cast<const uint8_t*>(data);
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // namespace pt
