// Buddy allocator over a host arena — paddle/memory parity
// (memory/detail/buddy_allocator.h:33, system_allocator.h:28).
//
// The reference pools cudaMalloc'd device memory; here PyTorch's caching
// allocator owns the device heap, so the pool serves the host side: staging
// buffers for feeder output, recordio chunk buffers, and prefetch queues. Classic power-of-two
// buddy scheme: one mmap'd arena, split on demand, coalesce on free.

#include <sys/mman.h>

#include <cstdio>
#include <map>
#include <mutex>
#include <new>
#include <vector>

#include "common.h"

namespace pt {
namespace {

struct Pool {
  std::mutex mu;
  uint8_t* arena = nullptr;
  size_t arena_bytes = 0;
  size_t min_order = 0;   // log2 of smallest block
  size_t max_order = 0;   // log2 of arena
  // free_lists[k] holds offsets of free blocks of size 2^(min_order+k)
  std::vector<std::vector<size_t>> free_lists;
  // offset -> order for allocated blocks
  std::map<size_t, size_t> allocated;
  // stats
  uint64_t in_use = 0, peak = 0, n_allocs = 0, n_frees = 0;
};

size_t ceil_log2(size_t n) {
  size_t k = 0;
  while ((size_t(1) << k) < n) ++k;
  return k;
}

}  // namespace
}  // namespace pt

using pt::Pool;

PT_EXPORT void* pt_pool_create(size_t min_block, size_t total_bytes) {
  auto* p = new (std::nothrow) Pool();
  if (!p) return nullptr;
  if (min_block < 64) min_block = 64;
  p->min_order = pt::ceil_log2(min_block);
  p->max_order = pt::ceil_log2(total_bytes);
  if (p->max_order < p->min_order) p->max_order = p->min_order;
  p->arena_bytes = size_t(1) << p->max_order;
  void* mem = mmap(nullptr, p->arena_bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (mem == MAP_FAILED) {
    delete p;
    return nullptr;
  }
  p->arena = static_cast<uint8_t*>(mem);
  p->free_lists.resize(p->max_order - p->min_order + 1);
  p->free_lists.back().push_back(0);  // whole arena free
  return p;
}

PT_EXPORT void* pt_pool_alloc(void* pool, size_t n) {
  auto* p = static_cast<Pool*>(pool);
  if (!p || n == 0) return nullptr;
  size_t order = pt::ceil_log2(n);
  if (order < p->min_order) order = p->min_order;
  if (order > p->max_order) return nullptr;
  size_t k = order - p->min_order;
  std::lock_guard<std::mutex> g(p->mu);
  // find the smallest free block >= requested, splitting down
  size_t j = k;
  while (j < p->free_lists.size() && p->free_lists[j].empty()) ++j;
  if (j >= p->free_lists.size()) return nullptr;  // exhausted
  size_t off = p->free_lists[j].back();
  p->free_lists[j].pop_back();
  while (j > k) {
    --j;
    size_t half = size_t(1) << (p->min_order + j);
    p->free_lists[j].push_back(off + half);  // right buddy stays free
  }
  p->allocated[off] = k;
  p->in_use += size_t(1) << (p->min_order + k);
  if (p->in_use > p->peak) p->peak = p->in_use;
  ++p->n_allocs;
  return p->arena + off;
}

PT_EXPORT int pt_pool_free(void* pool, void* ptr) {
  auto* p = static_cast<Pool*>(pool);
  if (!p || !ptr) return -1;
  size_t off = static_cast<uint8_t*>(ptr) - p->arena;
  std::lock_guard<std::mutex> g(p->mu);
  auto it = p->allocated.find(off);
  if (it == p->allocated.end()) return -1;  // double free / foreign pointer
  size_t k = it->second;
  p->allocated.erase(it);
  p->in_use -= size_t(1) << (p->min_order + k);
  ++p->n_frees;
  // coalesce with buddy while possible
  while (p->min_order + k < p->max_order) {
    size_t size = size_t(1) << (p->min_order + k);
    size_t buddy = off ^ size;
    auto& fl = p->free_lists[k];
    bool merged = false;
    for (size_t i = 0; i < fl.size(); ++i) {
      if (fl[i] == buddy) {
        fl[i] = fl.back();
        fl.pop_back();
        off = off < buddy ? off : buddy;
        ++k;
        merged = true;
        break;
      }
    }
    if (!merged) break;
  }
  p->free_lists[k].push_back(off);
  return 0;
}

// out[0..4] = arena_bytes, in_use, peak, n_allocs, n_frees
PT_EXPORT void pt_pool_stats(void* pool, uint64_t* out) {
  auto* p = static_cast<Pool*>(pool);
  std::lock_guard<std::mutex> g(p->mu);
  out[0] = p->arena_bytes;
  out[1] = p->in_use;
  out[2] = p->peak;
  out[3] = p->n_allocs;
  out[4] = p->n_frees;
}

PT_EXPORT void pt_pool_destroy(void* pool) {
  auto* p = static_cast<Pool*>(pool);
  if (!p) return;
  munmap(p->arena, p->arena_bytes);
  delete p;
}
