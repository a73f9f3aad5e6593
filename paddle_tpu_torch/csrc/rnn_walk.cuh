// The reverse walk's recurrent product, shared by the LSTM and GRU backward
// kernels (lstm_seq.cu, gru_seq.cu), for Hopper (sm_90a), f32.
//
// Each block of a backward walk owns a group of rows (batch entries) and a
// group of U hidden units. Per step it needs, for the valid rows of its
// group only,
//
//     out[r, j] = sum_k a[rows[r], k] * w[j, k]      r < nv, j < U
//
// where `a` is a [B, K] operand written by the other blocks of the same
// row group earlier in the step (dproj[t] for the LSTM, dgc and dgzr for
// the GRU) and w the block's U rows of the recurrent weight (resident in
// shared memory, or staged per k tile where they do not fit).
//
// What bounds it: the operand comes from L2 every step (a block reads only
// its own rows, so L2 traffic per step is B x K x 4 bytes per unit group),
// and the FMAs are fed from shared memory. The design: k tiles of the
// operand (and of w when it is not resident) come in through a ring of
// kStages cp.async.cg copies (L2 only: the operand was written by other
// blocks of this launch), so a tile's loads overlap the previous tile's
// FMAs. A thread computes a kTR rows x kTU units register tile over a
// slice of the k tile; the lanes of a warp hold neighbouring tiles of one
// slice, so each 16-byte shared load is a broadcast of a few rows (or
// units) to several lanes, and those rows sit in distinct banks. The k
// slices are summed through shared memory in a fixed order. Masked rows
// were dropped from `rows` by the caller: their product is exactly zero.

#pragma once

#include <cuda_runtime.h>

namespace rnn {

constexpr int kWalkThreads = 256;          // threads of a walk block
constexpr int kKT = 256;                   // k per staged tile
constexpr int kLD = kKT + 4;               // staged row stride: 8 rows x 16 B hit 32 banks
constexpr int kStages = 2;                 // cp.async ring depth
constexpr int kChunkRows = 64;             // rows per pass over k (ring size)
constexpr int kTR = 4, kTU = 4;            // rows x units of a thread's tile
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int cdiv(int x, int m) { return (x + m - 1) / m; }

// leading dimension of a resident weight row of width K: zero-padded to
// whole k tiles, +4 so that rows of different units start in other banks
__host__ __device__ constexpr int res_ld(int K) { return round_up(K, kKT) + 4; }

// rows of one pass over k, rounded to the register tiles
__host__ __device__ constexpr int chunk_rows(int R) {
  return round_up(R < kChunkRows ? R : kChunkRows, kTR);
}

// floats of one ring stage: the operand's chunk rows, and the weight rows
// when they are staged
__host__ __device__ constexpr int stage_floats(int U, int R, bool w_res) {
  return (chunk_rows(R) + (w_res ? 0 : U)) * kLD;
}

// floats of the product's own shared memory: the ring and the k-slice
// partials
__host__ __device__ constexpr size_t product_floats(int U, int R, bool w_res) {
  return (size_t)kStages * stage_floats(U, R, w_res) + (size_t)kWalkThreads * kTR * kTU;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy columns [k0, k0 + kKT) of `n` rows into dst[n][kLD]; row i comes
// from src(i) (a pointer to column 0 of that row), columns >= K are 0.
// kVec: 16-byte cp.async.cg (rows and K 16-byte aligned); else 4-byte
// __ldcg loads stored at once (no overlap, for odd widths only).
template <bool kVec, typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, int n, RowFn src, int k0, int K) {
  constexpr int kQ = kKT / 4;
  for (int i = threadIdx.x; i < n * kQ; i += kWalkThreads) {
    const int r = i / kQ, k = k0 + (i % kQ) * 4;
    const float* s = src(r);
    float* d = dst + r * kLD + (i % kQ) * 4;
    if (kVec) {
      cp_async16(d, k < K ? s + k : s, k < K);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = k + e < K ? __ldcg(s + k + e) : 0.f;
    }
  }
}

// epilogue(r, j, s) for r < nv, j < nu, with s = sum_k a[rows[r] * lda + k]
// * w[j, k], each (r, j) once, by one thread. Weights: resident (kResW) in
// w_s[j * ld_ws + k], zero past K and for j >= nu; else rows w_g + (u0 +
// j) * ld_wg, staged with the operand. `ring` and `part` are this
// product's shared memory (see product_floats). U is a multiple of kTU.
// Called by all threads of the block with the same arguments; it ends in
// a __syncthreads.
template <int U, bool kResW, bool kVec, typename Epilogue>
__device__ void group_product(const int* rows, int nv, const float* a, int lda, int K,
                              const float* w_s, int ld_ws, const float* w_g, int ld_wg,
                              int u0, int nu, int R, float* ring, float* part,
                              Epilogue epilogue) {
  constexpr int UB = U / kTU;
  const int rc_max = chunk_rows(R);
  const int sf = stage_floats(U, R, kResW);
  const int n_kt = cdiv(K, kKT);
  for (int c0 = 0; c0 < nv; c0 += rc_max) {
    const int nvc = min(rc_max, nv - c0);
    // thread tile (rb, ub) holds rows rb + RB*i and units ub + UB*j: the
    // lanes of a warp read neighbouring rows (and units), kLD (or ld_ws)
    // = 4 mod 32 floats apart, so their 16-byte loads fall in distinct
    // banks; tiles sharing a row share its load
    const int RB = cdiv(nvc, kTR), tiles = RB * UB;
    const int ks_n = min(kWalkThreads / tiles, kKT / 4);  // k slices
    const int tile = threadIdx.x % tiles, ks = threadIdx.x / tiles;
    const bool active = ks < ks_n;
    const int rb = tile / UB, ub = tile % UB;
    float acc[kTR][kTU] = {};
    auto arow = [&](int r) { return a + (size_t)rows[c0 + min(r, nvc - 1)] * lda; };
    auto wrow = [&](int j) { return w_g + (size_t)(u0 + min(j, nu - 1)) * ld_wg; };
    auto load_tile = [&](int kt) {
      float* st = ring + (kt % kStages) * sf;
      stage_rows<kVec>(st, nvc, arow, kt * kKT, K);
      if (!kResW) stage_rows<kVec>(st + rc_max * kLD, U, wrow, kt * kKT, K);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_kt) load_tile(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile kt landed for all; tile kt-1's slot is free
      if (kt + kStages - 1 < n_kt) load_tile(kt + kStages - 1);
      cp_async_commit();
      if (active) {
        const float* st = ring + (kt % kStages) * sf;
        const float* at = st + rb * kLD;
        const int ldw = kResW ? ld_ws : kLD;
        const float* wt = kResW ? w_s + ub * ld_ws + kt * kKT : st + (rc_max + ub) * kLD;
        for (int q = ks; q < kKT / 4; q += ks_n) {
          float4 av[kTR], wv[kTU];
#pragma unroll
          for (int i = 0; i < kTR; ++i)
            av[i] = *reinterpret_cast<const float4*>(at + i * RB * kLD + q * 4);
#pragma unroll
          for (int j = 0; j < kTU; ++j)
            wv[j] = *reinterpret_cast<const float4*>(wt + j * UB * ldw + q * 4);
#pragma unroll
          for (int i = 0; i < kTR; ++i)
#pragma unroll
            for (int j = 0; j < kTU; ++j) {
              acc[i][j] = fmaf(av[i].x, wv[j].x, acc[i][j]);
              acc[i][j] = fmaf(av[i].y, wv[j].y, acc[i][j]);
              acc[i][j] = fmaf(av[i].z, wv[j].z, acc[i][j]);
              acc[i][j] = fmaf(av[i].w, wv[j].w, acc[i][j]);
            }
        }
      }
    }
    if (active) {
      float* p = part + (ks * tiles + tile) * (kTR * kTU);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTU; ++j) p[i * kTU + j] = acc[i][j];
    }
    __syncthreads();  // partials written; every slot of the ring is free
    for (int o = threadIdx.x; o < nvc * U; o += kWalkThreads) {
      const int r = o / U, j = o % U;
      const int tl = (r % RB) * UB + j % UB, e = (r / RB) * kTU + j / UB;
      float s = 0.f;
      for (int k = 0; k < ks_n; ++k) s += part[(k * tiles + tl) * (kTR * kTU) + e];
      if (j < nu) epilogue(c0 + r, j, s);
    }
    __syncthreads();  // partials read before the next chunk writes them
  }
}

// Valid rows of a row group at one step: rows_s[0 .. *nv) = the b in
// [b0, b0 + n) with mask[b] != 0, in order. Called by warp 0 only.
__device__ __forceinline__ void compact_rows(const float* m_s, int b0, int n, int* rows_s,
                                             int* nv) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    const bool v = r < n && m_s[r] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (v) rows_s[base + __popc(bal & ((1u << lane) - 1u))] = b0 + r;
    base += __popc(bal);
  }
  if (lane == 0) *nv = base;
}

// How a backward walk is laid out for (H, B) on this device.
struct WalkPlan {
  int units;        // U: hidden units per block (a power of two, kTU to 32)
  int unit_groups;  // ceil(H / U)
  int row_groups;   // ceil(B / rows)
  int rows;         // R: rows per group
  int blocks;       // unit_groups x row_groups <= the SM count
  bool w_res;       // the block's W rows resident in shared memory
  size_t smem;      // dynamic shared memory of the launch
};

// Pick U (and with it the row groups) for a walk whose block keeps
// `w_floats` floats of resident weights per unit and `cell_floats`
// floats per (row, unit) of its own state. The least work per block wins
// (R rounded up to kTR, times U), a resident W before a staged one, and
// on a tie the larger U (fewer unit groups, so fewer L2 reads of the
// operand per step).
// Returns cudaErrorInvalidValue where no U fits.
inline cudaError_t make_walk_plan(int H, int B, int w_floats, int cell_floats,
                                  int row_floats, WalkPlan* best) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  bool found = false;
  long best_cost = 0;
  for (int U = kTU; U <= 32; U *= 2) {
    const int ug = cdiv(H, U);
    if (ug > sms) continue;
    int rg = sms / ug < B ? sms / ug : B;
    const int R = cdiv(B, rg);
    rg = cdiv(B, R);
    const size_t own = (size_t)R * U * cell_floats + (size_t)R * row_floats + 4;
    for (int res = 1; res >= 0; --res) {
      const size_t floats = (res ? (size_t)U * w_floats : 0) + product_floats(U, R, res) + own;
      if (floats * sizeof(float) > kSmemMax) continue;
      const long cost = (long)round_up(R, kTR) * U;
      const bool better = !found || (res && !best->w_res) ||
                          (res == (int)best->w_res && cost <= best_cost);
      if (better) {
        *best = WalkPlan{U, ug, rg, R, ug * rg, (bool)res, floats * sizeof(float)};
        best_cost = cost;
        found = true;
      }
      break;  // the resident layout, if it fits, is this U's layout
    }
  }
  return found ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace rnn
