// Ragged paged-attention decode for Hopper (sm_90a), f32.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:108 paged_attention_decode
// (Pallas body _paged_decode_kernel, :54) — one decode step of attention over
// the paged KV cache for every serving slot at once.
//
//   q            [S, KD]        one query token per slot (KD = H * hd)
//   k/v_pages    [NP, PS, KD]   one layer's physical page pool
//   block_table  [S, P] int32   logical page j of slot s -> physical page id
//   positions    [S] int32      slot s attends logical tokens 0..positions[s]
//   out          [S, KD]        softmax(q k^T * scale) v per head, f32
//
// Bound: bytes. Each visible K and V row is read once (2 * 4 * KD bytes per
// token) for 4 * KD flops, about half a flop per byte — far under the H100's
// f32 ridge, so the least time is the visible K/V bytes over the card's
// memory rate.
//
// Design (a simple, right first kernel; speed is later work):
//   * one block per (slot, head): grid (S, H), 8 warps. The block reads its
//     own block-table row and position — the TPU kernel's scalar prefetch
//     becomes a plain load;
//   * the TPU grid visits all P pages and masks the ones past the position
//     (they add exp(-1e9 - m) = 0). Here the loop stops at the slot's last
//     visible token, which computes the same values and reads only the
//     bytes the bound counts;
//   * tokens are dealt round-robin to the warps. Lanes split head_dim
//     (lane d, d + 32, ...: neighbouring lanes read neighbouring floats), a
//     dot product is a warp-shuffle sum, and each warp keeps its own online
//     softmax (running max, denominator, weighted-value accumulator) in
//     registers;
//   * at the end the warps' partial states merge through shared memory and
//     the block writes its head's hd outputs.
//   q is scaled before the dot, as the TPU kernel does; the plain version
//   scales the scores after, so the two agree to float tolerance.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// PER_LANE = ceil(head_dim / 32) rounded up to a power of two (1, 2, 4, 8)
template <int PER_LANE>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ block_table,
                    const int* __restrict__ positions,
                    float* __restrict__ out,
                    int n_heads, int head_dim, int page_size,
                    int pages_per_seq, float scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kd = n_heads * head_dim;
  const int* bt = block_table + (size_t)s * pages_per_seq;

  // visible tokens: logical 0..position, kept inside the table's reach
  // (logical token 0 is visible to every slot, so n_tok >= 1 always)
  const int max_tok = pages_per_seq * page_size;
  int n_tok = positions[s] + 1;
  n_tok = n_tok < 1 ? 1 : (n_tok > max_tok ? max_tok : n_tok);

  const float* qrow = q + (size_t)s * kd + (size_t)h * head_dim;
  float qv[PER_LANE];
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < head_dim ? qrow[d] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;  // running max; exp(-inf - x) = 0 on the first token
  float l = 0.f;        // running denominator

  for (int t = warp; t < n_tok; t += kWarps) {
    const int page = bt[t / page_size];
    const size_t row =
        ((size_t)page * page_size + (t % page_size)) * kd + (size_t)h * head_dim;
    float kv[PER_LANE];
    float vv[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int d = lane + 32 * i;
      const bool ok = d < head_dim;
      kv[i] = ok ? k_pages[row + d] : 0.f;
      vv[i] = ok ? v_pages[row + d] : 0.f;
    }
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) part = fmaf(qv[i], kv[i], part);
    const float sc = warp_sum(part);
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] = acc[i] * alpha + p * vv[i];
    m = m_new;
  }

  // merge the warps' online-softmax states
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][PER_LANE * 32];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  // warp 0 saw token 0, so the max is finite; idle warps (m = -inf, l = 0)
  // weigh exp(-inf) = 0
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wt[kWarps];
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(sm_m[w] - mx);
    den += sm_l[w] * wt[w];
  }
  float* orow = out + (size_t)s * kd + (size_t)h * head_dim;
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sm_acc[w][d] * wt[w];
    orow[d] = o / den;
  }
}

template <int PER_LANE>
void launch(const float* q, const float* k_pages, const float* v_pages,
            const int* block_table, const int* positions, float* out,
            int n_slots, int n_heads, int head_dim, int page_size,
            int pages_per_seq, float scale, cudaStream_t stream) {
  const dim3 grid(n_slots, n_heads);
  paged_decode_kernel<PER_LANE><<<grid, kThreads, 0, stream>>>(
      q, k_pages, v_pages, block_table, positions, out, n_heads, head_dim,
      page_size, pages_per_seq, scale);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch surfaces.
extern "C" int paged_attention_decode_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_table, const int* positions, float* out, int n_slots,
    int n_heads, int head_dim, int page_size, int pages_per_seq, float scale,
    void* stream) {
  if (n_slots <= 0 || n_heads <= 0 || n_heads > 65535 || head_dim <= 0 ||
      page_size <= 0 || pages_per_seq <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim <= 32) {
    launch<1>(q, k_pages, v_pages, block_table, positions, out, n_slots,
              n_heads, head_dim, page_size, pages_per_seq, scale, st);
  } else if (head_dim <= 64) {
    launch<2>(q, k_pages, v_pages, block_table, positions, out, n_slots,
              n_heads, head_dim, page_size, pages_per_seq, scale, st);
  } else if (head_dim <= 128) {
    launch<4>(q, k_pages, v_pages, block_table, positions, out, n_slots,
              n_heads, head_dim, page_size, pages_per_seq, scale, st);
  } else if (head_dim <= 256) {
    launch<8>(q, k_pages, v_pages, block_table, positions, out, n_slots,
              n_heads, head_dim, page_size, pages_per_seq, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
