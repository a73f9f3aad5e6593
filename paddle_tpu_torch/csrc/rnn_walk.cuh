// The recurrences' shared product, used by the forward kernels and the
// backward walks of the LSTM and the GRU (lstm_seq.cu, gru_seq.cu), for
// Hopper (sm_90a), f32.
//
// Each block of a recurrent launch owns a group of rows (batch entries)
// and a group of U hidden units. Per step it needs, for a list of rows of
// its group,
//
//     out[r, j] = sum_k a[rows[r], k] * w[j, k]      r < nv, j < N
//
// where `a` is a [B, K] operand written by the other blocks of the same
// row group earlier in the launch (h_{t-1} or r*h_{t-1} in a forward,
// dproj[t] in a backward) and w the N weight columns of the block's units
// (N = 4U gate columns in the LSTM forward, 2U or U in the GRU's, U in a
// backward), resident in shared memory or staged per k tile where they do
// not fit.
//
// What bounds it: the operand comes from L2 every step (a block reads only
// its own rows, so L2 traffic per step is B x K x 4 bytes per unit group),
// and the FMAs are fed from shared memory. The design: k tiles of the
// operand (and of w when it is not resident) come in through a ring of
// kStages cp.async copies (the operand by cp.async.cg, L2 only: other
// blocks of this launch wrote it), so a tile's loads overlap the previous
// tile's FMAs. A thread computes a kTR rows x kTU columns register tile
// over a slice of the k tile; the lanes of a warp hold neighbouring tiles
// of one slice, so each 16-byte shared load is a broadcast of a few rows
// (or columns) to several lanes, and those rows sit in distinct banks.
// The k slices are summed through shared memory in a fixed order, so
// results repeat bit for bit. A backward drops masked rows from `rows`
// (their product is exactly zero). A forward lists the rows that were
// valid at the step before (all of them at the first): a masked step
// carries h through, so a row's sums from its last product still hold.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace rnn {

constexpr int kWalkThreads = 256;          // threads of a recurrent block
constexpr int kKT = 256;                   // k per staged tile in the backward walks
constexpr int kFwdKT = 128;                // k per staged tile in the forwards
constexpr int kStages = 2;                 // cp.async ring depth
constexpr int kChunkRows = 64;             // rows per pass over k (ring size)
constexpr int kTR = 4, kTU = 4;            // rows x columns of a thread's tile
constexpr int kPartFloats = kWalkThreads * kTR * kTU;  // the k-slice partials
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int cdiv(int x, int m) { return (x + m - 1) / m; }

// staged row stride for k tiles of KT: +4 floats, so 8 rows x 16 B hit 32 banks
__host__ __device__ constexpr int tile_ld(int KT) { return KT + 4; }

// leading dimension of a resident weight row of width K: zero-padded to
// whole k tiles, +4 so that rows of different columns start in other banks
__host__ __device__ constexpr int res_ld(int K, int KT) { return round_up(K, KT) + 4; }

// rows of one pass over k for N columns: at most kChunkRows, and few
// enough that every register tile has a thread; rounded to the tiles
__host__ __device__ constexpr int chunk_rows(int R, int N) {
  const int fit = kTR * (kWalkThreads * kTU / N);
  const int cap = kChunkRows < fit ? kChunkRows : fit;
  return round_up(R < cap ? R : cap, kTR);
}

// floats of one ring stage: the operand's chunk rows, and the N weight
// rows when they are staged
__host__ __device__ constexpr int stage_floats(int N, int R, bool w_res, int KT) {
  return (chunk_rows(R, N) + (w_res ? 0 : N)) * tile_ld(KT);
}

// floats of the product's own shared memory: the ring and the k-slice
// partials
__host__ __device__ constexpr size_t product_floats(int N, int R, bool w_res, int KT) {
  return (size_t)kStages * stage_floats(N, R, w_res, KT) + kPartFloats;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// 4 bytes through L1: only for data no block of the launch writes
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy columns [k0, k0 + KT) of `n` rows into dst[n][tile_ld(KT)]; row i
// comes from src(i) (a pointer to column 0 of that row), columns >= K are
// 0. kVec: 16-byte cp.async.cg (rows and K 16-byte aligned); else 4-byte
// __ldcg loads stored at once (no overlap, for odd widths only).
template <int KT, bool kVec, typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, int n, RowFn src, int k0, int K) {
  constexpr int kQ = KT / 4;
  for (int i = threadIdx.x; i < n * kQ; i += kWalkThreads) {
    const int r = i / kQ, k = k0 + (i % kQ) * 4;
    const float* s = src(r);
    float* d = dst + r * tile_ld(KT) + (i % kQ) * 4;
    if (kVec) {
      cp_async16(d, k < K ? s + k : s, k < K);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = k + e < K ? __ldcg(s + k + e) : 0.f;
    }
  }
}

// Column c = g * U + j of a forward's weights: column g * H + u0 + j of a
// row-major [K, ldw] matrix (gate block g, unit u0 + j); j >= nu reads
// unit nu - 1 (its results are dropped).
__device__ __forceinline__ int gate_col(int c, int U, int H, int u0, int nu) {
  const int j = c % U;
  return (c / U) * H + u0 + (j < nu ? j : nu - 1);
}

// Stage k tile [k0, k0 + KT) of a forward's N weight columns (see
// gate_col) into dst[N][tile_ld(KT)], zero past K: 4-byte cp.async.ca (the
// weights are never written by the launch). A warp copies 4 k x 8
// columns: 4 rows x 32 bytes of w, 32 distinct banks of dst.
template <int KT, int N, int U>
__device__ __forceinline__ void stage_cols(float* dst, const float* w, int ldw, int H, int u0,
                                           int nu, int k0, int K) {
  for (int e = threadIdx.x; e < N * KT; e += kWalkThreads) {
    const int c = (e >> 2) % N, kk = (e & 3) + 4 * ((e >> 2) / N), k = k0 + kk;
    cp_async4(dst + c * tile_ld(KT) + kk,
              w + (size_t)(k < K ? k : 0) * ldw + gate_col(c, U, H, u0, nu), k < K);
  }
}

// A forward's N weight columns (see gate_col), resident: w_s[c * ld + k],
// zero past K and for units >= nu. Once, at launch.
template <int U>
__device__ __forceinline__ void load_cols(float* w_s, int ld, int N, const float* w, int ldw,
                                          int H, int u0, int nu, int K) {
  for (int e = threadIdx.x; e < N * ld; e += kWalkThreads) {
    const int c = e % N, k = e / N;
    w_s[c * ld + k] = k < K && c % U < nu ? w[(size_t)k * ldw + gate_col(c, U, H, u0, nu)] : 0.f;
  }
}

// epilogue(r, j, s) for r < nv, j < N, with s = sum_k a[rows[r] * lda + k]
// * w[j, k], each (r, j) once, by one thread; the caller drops columns of
// units it does not own. Weights: resident (kResW) in w_s[j * ld_ws + k],
// zero past K; else stage_w(dst, k0) stages rows [k0, k0 + KT) of all N
// columns into dst[N][tile_ld(KT)] with the operand. `ring` and `part` are
// this product's shared memory (see product_floats). N is a multiple of
// kTU. Called by all threads of the block with the same arguments; it ends
// in a __syncthreads.
template <int N, int KT, bool kResW, bool kVec, typename StageW, typename Epilogue>
__device__ void group_product(const int* rows, int nv, const float* a, int lda, int K,
                              const float* w_s, int ld_ws, StageW stage_w, int R, float* ring,
                              float* part, Epilogue epilogue) {
  constexpr int UB = N / kTU, LD = tile_ld(KT);
  const int rc_max = chunk_rows(R, N);
  const int sf = stage_floats(N, R, kResW, KT);
  const int n_kt = cdiv(K, KT);
  for (int c0 = 0; c0 < nv; c0 += rc_max) {
    const int nvc = min(rc_max, nv - c0);
    // thread tile (rb, ub) holds rows rb + RB*i and columns ub + UB*j: the
    // lanes of a warp read neighbouring rows (and columns), LD (or ld_ws)
    // = 4 mod 32 floats apart, so their 16-byte loads fall in distinct
    // banks; tiles sharing a row share its load
    const int RB = cdiv(nvc, kTR), tiles = RB * UB;
    const int ks_n = min(kWalkThreads / tiles, KT / 4);  // k slices
    const int tile = threadIdx.x % tiles, ks = threadIdx.x / tiles;
    const bool active = ks < ks_n;
    const int rb = tile / UB, ub = tile % UB;
    float acc[kTR][kTU] = {};
    auto arow = [&](int r) { return a + (size_t)rows[c0 + min(r, nvc - 1)] * lda; };
    auto load_tile = [&](int kt) {
      float* st = ring + (kt % kStages) * sf;
      stage_rows<KT, kVec>(st, nvc, arow, kt * KT, K);
      if (!kResW) stage_w(st + rc_max * LD, kt * KT);
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
        const float* at = st + rb * LD;
        const int ldw = kResW ? ld_ws : LD;
        const float* wt = kResW ? w_s + ub * ld_ws + kt * KT : st + (rc_max + ub) * LD;
        for (int q = ks; q < KT / 4; q += ks_n) {
          float4 av[kTR], wv[kTU];
#pragma unroll
          for (int i = 0; i < kTR; ++i)
            av[i] = *reinterpret_cast<const float4*>(at + i * RB * LD + q * 4);
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
    for (int o = threadIdx.x; o < nvc * N; o += kWalkThreads) {
      const int r = o / N, j = o % N;
      const int tl = (r % RB) * UB + j % UB, e = (r / RB) * kTU + j / UB;
      float s = 0.f;
      for (int k = 0; k < ks_n; ++k) s += part[(k * tiles + tl) * (kTR * kTU) + e];
      epilogue(c0 + r, j, s);
    }
    __syncthreads();  // partials read before the next chunk writes them
  }
}

// Valid rows of a row group at one step: rows_s[0 .. *nv) = the b in
// [b0, b0 + n) with m_s[b - b0] != 0, in order; m_s in shared or global
// memory. Called by warp 0 only.
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

// Only the step loop's grid syncs, `per_step` for each of T steps: what a
// forward's synchronisation costs alone at its own grid and shared memory
// (so one block sits on each SM as the forward's do), with none of its
// memory traffic (chip_smoke.py times it beside the forward).
__global__ void __launch_bounds__(kWalkThreads, 1) sync_steps_kernel(int T, int per_step) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < T * per_step; ++s) grid.sync();
}

// How a recurrent launch is laid out for (H, B) on this device.
struct WalkPlan {
  int units;        // U: hidden units per block (a power of two, kTU to 32)
  int unit_groups;  // ceil(H / U)
  int row_groups;   // ceil(B / rows)
  int rows;         // R: rows per group
  int blocks;       // unit_groups x row_groups <= the SM count
  bool w_res;       // the block's weight columns resident in shared memory
  size_t smem;      // dynamic shared memory of the launch
};

// Pick U (and with it the row groups) for a launch whose widest product
// has `cols` columns per unit and k tiles of KT, whose block keeps
// `w_floats` floats of resident weights per unit and `cell_floats` floats
// per (row, unit) and `row_floats` per row of its own state. The least
// work per block wins (R rounded up to kTR, times U), a resident W before
// a staged one, and on a tie the larger U (fewer unit groups, so fewer L2
// reads of the operand per step).
// Returns cudaErrorInvalidValue where no U fits.
inline cudaError_t make_walk_plan(int H, int B, int cols, int KT, int w_floats,
                                  int cell_floats, int row_floats, WalkPlan* best) {
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
      const size_t floats =
          (res ? (size_t)U * w_floats : 0) + product_floats(cols * U, R, res, KT) + own;
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

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// dynamic shared memory above 48 KB must be opted into per kernel
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A persistent recurrent launch: all `blocks` co-resident, or refused
// (cudaErrorCooperativeLaunchTooLarge), never run in part.
inline cudaError_t launch(const void* fn, int blocks, size_t smem, void** args,
                          cudaStream_t st) {
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kWalkThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The template arguments of a recurrent kernel's instance: units per block,
// weights resident, 16-byte operand copies.
template <int U, bool kResW, bool kVec>
struct Inst {};

template <int U, typename Pick>
const void* pick_layout(bool w_res, bool vec, Pick pick) {
  if (w_res) return vec ? pick(Inst<U, true, true>{}) : pick(Inst<U, true, false>{});
  return vec ? pick(Inst<U, false, true>{}) : pick(Inst<U, false, false>{});
}

// The kernel instance for a plan: pick(Inst<U, kResW, kVec>{}) returns the
// address of a kernel template's instance for those arguments.
template <typename Pick>
const void* pick_kernel(const WalkPlan& p, bool vec, Pick pick) {
  switch (p.units) {
    case 4: return pick_layout<4>(p.w_res, vec, pick);
    case 8: return pick_layout<8>(p.w_res, vec, pick);
    case 16: return pick_layout<16>(p.w_res, vec, pick);
    default: return pick_layout<32>(p.w_res, vec, pick);
  }
}

}  // namespace rnn
