// Masked whole-sequence LSTM (no peepholes), forward and backward, for
// Hopper (sm_90a), f32.
//
// Replaces: paddle_tpu/ops/pallas/rnn_kernels.py:175 lstm_seq_fused — the
// forward pallas_call of _lstm_fwd (:133, call :147, body _lstm_fwd_kernel
// :39) and the backward pallas_call of _lstm_vjp_bwd (:191, call :207, body
// _lstm_bwd_kernel :72).
//
//   proj   [T, B, 4H]  x_t already projected, gate blocks i, f, c, o
//   mask   [T, B]      1 = valid step, 0 = padding (h and c carry through)
//   w_hh   [H, 4H]     recurrent weights, the same block order
//   bias   [4H]
//   h0, c0 [B, H]
//
//   i = sig(p_i + b_i + h W_i)   f = sig(p_f + b_f + h W_f)
//   g = tanh(p_c + b_c + h W_c)  o = sig(p_o + b_o + h W_o)
//   c~ = f c + i g               h~ = o tanh(c~)
//   h' = m h~ + (1-m) h          c' = m c~ + (1-m) c
//
// Forward writes hs [T,B,H], gates [T,B,4H] (post-activation i, f, g, o),
// ct [T,B,H] (c~, before the mask) and cs [T,B,H] (the masked c sequence):
// the backward's residuals, as the TPU kernel saves them. Backward takes
// them with h0, c0, the mask, W, dhs [T,B,H], dh_last and dc_last [B,H] and
// writes dproj [T,B,4H], dW [H,4H], db [4H], dh0 and dc0. `reverse` walks
// time T-1 .. 0 with every array in original time order, which equals the
// JAX package's flip-run-flip (_run_fused, paddle_tpu/ops/rnn.py:55).
//
// Bound: operations. At the text-classification shape (T=100, B=128,
// H=512) the forward does 2*T*B*H*4H = 26.8 GFLOP (0.40 ms at 67 TFLOP/s
// f32) on ~0.3 GB of reads and writes (0.09 ms at 3.35 TB/s); the backward
// twice the operations (0.80 ms). But the recurrence is serial: step t+1
// needs all of h_t. The TPU runs its grid over T in order with h, c and W
// in VMEM; Hopper's blocks run in no order, and W (4 MB at H=512) does not
// fit in one block's 227 KB of shared memory.
//
// Design:
//   * Recurrence: one persistent cooperative launch (all blocks resident,
//     cudaLaunchCooperativeKernel) whose block j owns U hidden units. U is
//     the smallest power of two that keeps the grid within one block per
//     SM (U=2 at H=256, U=4 at H=512 on 132 SMs). The block keeps its
//     units' 4 gate columns of W (forward) or its units' rows of W (the
//     columns of W^T, backward) in shared memory for the whole sequence —
//     32 KB at H=512 — and its units' cell state (or dc carry) on chip.
//     Where that slice does not fit beside the staging tile (H=1280:
//     U=16, 327 KB), the block stages it through shared memory per k tile
//     with the operand it multiplies (W then comes from L2 every step).
//   * Forward, per step: all of h_{t-1} (hs[t-1] is the exchange buffer)
//     is staged from L2 in k tiles (128 wide at U >= 4), each tile's loads
//     issued at once into registers while the previous tile is computed;
//     thread (row, unit) forms the unit's four gate sums, the cell update
//     and the masked outputs; then ONE grid.sync() (the GRU needs two, for
//     r*h).
//   * Backward, per step (reverse walk): the elementwise cotangents of the
//     block's units go to dproj[t], dc is carried in shared memory; one
//     grid.sync(); then dh_prev of the block's units = dproj[t] W^T over
//     the staged [B, 4H] row + (1-m) dh. dproj[t] and hs[t] written by other
//     blocks of the same launch are read with __ldcg (L2, never a stale L1
//     line).
//   * dW = h_prev^T dproj over the T*B rows and db (a column sum) are not
//     carried across the walk as the TPU kernel's VMEM scratch is: after
//     the walk a tiled reduction kernel (64x64 output tiles, 4x4 per
//     thread, the next 32 rows prefetched) and a column-sum kernel compute
//     them. All three kernels launch from the one backward entry point.
//   * What still bounds the walks (PERF.md): each FMA of the recurrent
//     products needs about a third of a 16-byte shared-memory load (a
//     thread computes one row of one unit), and a grid sync per step: at
//     H=512 the forward's time per step hardly changes from B=8 to B=128
//     (chip_smoke.py's `fwd_kernel_ms_by_batch`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;             // recurrence block size
// k per staged tile, so that a tile (kThreads / U rows x k) holds 8 float4
// per thread in flight: 128 for U >= 4, 64 for U = 2, 32 for U = 1. Fewer,
// wider tiles mean fewer round trips between loads and compute per step.
__host__ __device__ constexpr int tile_k(int U) { return U >= 4 ? 128 : 32 * U; }
// a staged tile's row stride: 16-byte rows, and 8 rows of float4 hit 32 banks
__host__ __device__ constexpr int tile_ld(int kt) { return kt + 4; }
constexpr int kTile = 64;                 // dW output tile
constexpr int kDepth = 32;                // rows of the T*B axis per dW stage
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// forward time index of processing step s
__device__ __forceinline__ int time_of(int s, int T, int reverse) {
  return reverse ? T - 1 - s : s;
}

// state before original time t: x0 at the first processed step, else the
// state written by the step processed just before ([B, H] rows)
__device__ __forceinline__ const float* prev_of(const float* seq, const float* x0, int t,
                                                int T, int B, int H, int reverse) {
  const bool first = reverse ? (t == T - 1) : (t == 0);
  if (first) return x0;
  return seq + (size_t)(reverse ? t + 1 : t - 1) * B * H;
}

// One [ROWS x KT] tile of a row-major operand (leading dimension ld,
// width `width`; rows [b0, b0 + ROWS), columns [kt, kt + KT)), held in
// registers: `load` issues every load of the tile at once, so a tile is
// fetched while the previous one is computed, and `store` writes it to
// tile[ROWS][tile_ld(KT)]. Entries out of range are 0. __ldcg (L2): another
// block of this launch may have written the operand. 16-byte loads when ld
// and width are multiples of 4 (every base pointer is 16-byte aligned).
template <int ROWS, int KT>
struct RowTile {
  static constexpr int kQ = KT / 4;
  static constexpr int kPer = (ROWS * kQ + kThreads - 1) / kThreads;
  float4 v[kPer];

  __device__ __forceinline__ void load(const float* src, int ld, int width, int b0, int kt,
                                       int B) {
    const bool vec = ((ld | width) & 3) == 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads;
      const int b = b0 + i / kQ, k = kt + (i % kQ) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < ROWS * kQ && b < B) {
        const float* s = src + (size_t)b * ld + k;
        if (vec) {
          if (k < width) x = __ldcg(reinterpret_cast<const float4*>(s));
        } else {
          if (k < width) x.x = __ldcg(s);
          if (k + 1 < width) x.y = __ldcg(s + 1);
          if (k + 2 < width) x.z = __ldcg(s + 2);
          if (k + 3 < width) x.w = __ldcg(s + 3);
        }
      }
      v[p] = x;
    }
  }

  __device__ __forceinline__ void store(float* tile) const {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads;
      if (i < ROWS * kQ) {
        *reinterpret_cast<float4*>(tile + (i / kQ) * tile_ld(KT) + (i % kQ) * 4) = v[p];
      }
    }
  }
};

// The forward's slice of W for k tile kt when it is not resident: rows
// [kt, kt + KT) of the block's U units' 4 gate columns, laid out
// [KT][U][4] like the resident copy. Consecutive threads read consecutive
// units (64-byte runs of one gate). W is never written: __ldg.
template <int U, int KT>
struct FwdWTile {
  static constexpr int kN = KT * U * 4;
  static constexpr int kPer = (kN + kThreads - 1) / kThreads;
  float v[kPer];

  __device__ __forceinline__ void load(const float* w_hh, int kt, int H, int u0, int nu) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int e = threadIdx.x + p * kThreads;
      const int j = e % U, g = (e / U) & 3, k = kt + e / (4 * U);
      v[p] = (e < kN && j < nu && k < H) ? __ldg(w_hh + (size_t)k * 4 * H + g * H + u0 + j)
                                         : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* w) const {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int e = threadIdx.x + p * kThreads;
      if (e < kN) w[((e / (4 * U)) * U + e % U) * 4 + ((e / U) & 3)] = v[p];
    }
  }
};

// The backward's slice of W for k tile kt of the 4H axis when it is not
// resident: the block's U rows of W, columns [kt, kt + KT), laid out
// [U][tile_ld(KT)] (padded: rows of different units hit different banks).
// 16-byte loads (4H is a multiple of 4).
template <int U, int KT>
struct BwdWTile {
  static constexpr int kQ = KT / 4;
  static constexpr int kPer = (U * kQ + kThreads - 1) / kThreads;
  float4 v[kPer];

  __device__ __forceinline__ void load(const float* w_hh, int kt, int H, int u0, int nu) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads;
      const int j = i / kQ, k = kt + (i % kQ) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < U * kQ && j < nu && k < 4 * H) {
        x = __ldg(reinterpret_cast<const float4*>(w_hh + (size_t)(u0 + j) * 4 * H + k));
      }
      v[p] = x;
    }
  }

  __device__ __forceinline__ void store(float* w) const {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads;
      if (i < U * kQ) {
        *reinterpret_cast<float4*>(w + (i / kQ) * tile_ld(KT) + (i % kQ) * 4) = v[p];
      }
    }
  }
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// leading dimension of the resident W^T rows in the backward: padded so
// that rows of different units start in different banks
__host__ __device__ constexpr int bwd_w_ld(int H) { return 4 * H + 4; }

template <int U, bool kSmemW>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* proj, const float* mask, const float* w_hh, const float* bias,
                const float* h0, const float* c0, float* hs, float* gates, float* ct,
                float* cs, int T, int B, int H, int reverse) {
  constexpr int R = kThreads / U;           // rows per pass
  constexpr int KT = tile_k(U), LD = tile_ld(KT);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int Hp = round_up(H, KT);
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  float* w_s = smem;  // resident: [Hp][U][4]; else one k tile, [KT][U][4]
  float* tile = smem + (size_t)(kSmemW ? Hp : KT) * U * 4;  // [R][LD]
  float* c_s = tile + R * LD;                                 // [B][U] cell state

  if (kSmemW) {
    for (int i = threadIdx.x; i < Hp * U * 4; i += kThreads) {
      const int g = i & 3, j = (i >> 2) % U, k = (i >> 2) / U;
      w_s[i] = (k < H && j < nu) ? w_hh[(size_t)k * H4 + g * H + u0 + j] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < B * U; i += kThreads) {
    const int b = i / U, j = i % U;
    c_s[i] = j < nu ? c0[(size_t)b * H + u0 + j] : 0.f;
  }
  __syncthreads();

  const int r = threadIdx.x / U, j = threadIdx.x % U;
  const int n = u0 + min(j, nu - 1);  // a valid unit; results of j >= nu are dropped
  RowTile<R, KT> ht;
  FwdWTile<U, KT> wt;
  for (int s = 0; s < T; ++s) {
    const int t = time_of(s, T, reverse);
    const float* hp = prev_of(hs, h0, t, T, B, H, reverse);
    for (int b0 = 0; b0 < B; b0 += R) {
      const int b = b0 + r;
      const bool mine = b < B && j < nu;
      const size_t row = (size_t)t * B + min(b, B - 1);
      ht.load(hp, H, H, b0, 0, B);
      if (!kSmemW) wt.load(w_hh, 0, H, u0, nu);
      // the epilogue's inputs do not depend on h: fetch them now
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // gate sums i, f, c, o
      float m = 0.f, h_prev = 0.f;
      if (mine) {
        const float* pr = proj + row * H4;
        a0 = pr[n] + bias[n];
        a1 = pr[H + n] + bias[H + n];
        a2 = pr[2 * H + n] + bias[2 * H + n];
        a3 = pr[3 * H + n] + bias[3 * H + n];
        m = mask[row];
        h_prev = __ldcg(hp + (size_t)b * H + n);
      }
      for (int kt = 0; kt < H; kt += KT) {
        ht.store(tile);
        if (!kSmemW) wt.store(w_s);
        __syncthreads();
        if (kt + KT < H) {  // the next tile is in flight during this one
          ht.load(hp, H, H, b0, kt + KT, B);
          if (!kSmemW) wt.load(w_hh, kt + KT, H, u0, nu);
        }
        const float* trow = tile + r * LD;
        const float4* w4 =
            reinterpret_cast<const float4*>(w_s) + (size_t)(kSmemW ? kt : 0) * U + j;
#pragma unroll 4
        for (int kk = 0; kk < KT; kk += 4) {  // zero past H in both operands
          const float4 hv = *reinterpret_cast<const float4*>(trow + kk);
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w = w4[(kk + q) * U];
            a0 = fmaf(hk[q], w.x, a0);
            a1 = fmaf(hk[q], w.y, a1);
            a2 = fmaf(hk[q], w.z, a2);
            a3 = fmaf(hk[q], w.w, a3);
          }
        }
        __syncthreads();
      }
      if (mine) {
        const float ig = sigmoidf_(a0);
        const float fg = sigmoidf_(a1);
        const float gg = tanhf(a2);
        const float og = sigmoidf_(a3);
        const float c_prev = c_s[b * U + j];
        const float c_t = fg * c_prev + ig * gg;
        const float h_t = og * tanhf(c_t);
        float* gr = gates + row * H4;
        gr[n] = ig;
        gr[H + n] = fg;
        gr[2 * H + n] = gg;
        gr[3 * H + n] = og;
        ct[row * H + n] = c_t;
        const float c_new = m * c_t + (1.f - m) * c_prev;
        cs[row * H + n] = c_new;
        hs[row * H + n] = m * h_t + (1.f - m) * h_prev;
        c_s[b * U + j] = c_new;
      }
    }
    grid.sync();
  }
}

template <int U, bool kSmemW>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* gates, const float* ct, const float* hs, const float* cs,
                const float* h0, const float* c0, const float* mask, const float* w_hh,
                const float* dhs, const float* dh_last, const float* dc_last, float* dproj,
                float* dh0, float* dc0, int T, int B, int H, int reverse) {
  constexpr int R = kThreads / U;
  constexpr int KT = tile_k(U), LD = tile_ld(KT);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int ldw = kSmemW ? bwd_w_ld(H) : LD;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  float* w_t = smem;  // resident: [U][ldw] rows of W; else one k tile, [U][LD]
  float* tile = smem + (size_t)U * ldw;                       // [R][LD]
  float* dh_c = tile + R * LD;                                // [B][U] dh carry
  float* dc_c = dh_c + B * U;                                 // [B][U] dc carry
  float* dh_r = dc_c + B * U;                                 // [B][U] (1-m) dh of the step

  if (kSmemW) {
    for (int i = threadIdx.x; i < U * H4; i += kThreads) {
      const int j = i / H4, k = i % H4;
      w_t[j * ldw + k] = j < nu ? w_hh[(size_t)(u0 + j) * H4 + k] : 0.f;
    }
  }
  // dh_last and dc_last are the carries into the first step of the walk
  // (the TPU kernel adds dh_last to dhs[-1] and starts dc from dc_last)
  for (int i = threadIdx.x; i < B * U; i += kThreads) {
    const int b = i / U, j = i % U;
    dh_c[i] = j < nu ? dh_last[(size_t)b * H + u0 + j] : 0.f;
    dc_c[i] = j < nu ? dc_last[(size_t)b * H + u0 + j] : 0.f;
  }
  __syncthreads();

  const int r = threadIdx.x / U, j = threadIdx.x % U;
  RowTile<R, KT> dt;
  BwdWTile<U, KT> wt;
  for (int s = T - 1; s >= 0; --s) {
    const int t = time_of(s, T, reverse);
    const float* cp = prev_of(cs, c0, t, T, B, H, reverse);
    // A: elementwise cotangents of the block's units
    for (int i = threadIdx.x; i < B * U; i += kThreads) {
      const int b = i / U, jj = i % U;
      if (jj >= nu) continue;
      const int nn = u0 + jj;
      const size_t row = (size_t)t * B + b;
      const float* g = gates + row * H4;
      const float ig = g[nn], fg = g[H + nn], gg = g[2 * H + nn], og = g[3 * H + nn];
      const float m = mask[row];
      const float dh = dh_c[i] + dhs[row * H + nn];
      const float dc = dc_c[i];
      const float tc = tanhf(ct[row * H + nn]);
      const float dht = m * dh;
      const float dct = m * dc + dht * og * (1.f - tc * tc);
      float* dp = dproj + row * H4;
      dp[nn] = dct * gg * ig * (1.f - ig);
      dp[H + nn] = dct * cp[(size_t)b * H + nn] * fg * (1.f - fg);
      dp[2 * H + nn] = dct * ig * (1.f - gg * gg);
      dp[3 * H + nn] = dht * tc * og * (1.f - og);
      dc_c[i] = dct * fg + (1.f - m) * dc;
      dh_r[i] = (1.f - m) * dh;
    }
    grid.sync();
    // B: dh_prev[b, n] = sum_k dproj[t, b, k] W[n, k] + (1-m) dh
    const float* dp_t = dproj + (size_t)t * B * H4;
    for (int b0 = 0; b0 < B; b0 += R) {
      const int b = b0 + r;
      float acc = 0.f;
      dt.load(dp_t, H4, H4, b0, 0, B);
      if (!kSmemW) wt.load(w_hh, 0, H, u0, nu);
      for (int kt = 0; kt < H4; kt += KT) {
        dt.store(tile);
        if (!kSmemW) wt.store(w_t);
        __syncthreads();
        if (kt + KT < H4) {  // the next tile is in flight during this one
          dt.load(dp_t, H4, H4, b0, kt + KT, B);
          if (!kSmemW) wt.load(w_hh, kt + KT, H, u0, nu);
        }
        const int kn = min(KT, H4 - kt);  // a multiple of 4
        const float* trow = tile + r * LD;
        const float* wrow = w_t + j * ldw + (kSmemW ? kt : 0);
#pragma unroll 4
        for (int kk = 0; kk < kn; kk += 4) {
          const float4 a = *reinterpret_cast<const float4*>(trow + kk);
          const float4 w = *reinterpret_cast<const float4*>(wrow + kk);
          acc = fmaf(a.x, w.x, acc);
          acc = fmaf(a.y, w.y, acc);
          acc = fmaf(a.z, w.z, acc);
          acc = fmaf(a.w, w.w, acc);
        }
        __syncthreads();
      }
      if (b < B && j < nu) dh_c[b * U + j] = acc + dh_r[b * U + j];
    }
    __syncthreads();  // the next step's A reads dh_c by another mapping
  }
  for (int i = threadIdx.x; i < B * U; i += kThreads) {
    const int b = i / U, jj = i % U;
    if (jj < nu) {
      dh0[(size_t)b * H + u0 + jj] = dh_c[i];
      dc0[(size_t)b * H + u0 + jj] = dc_c[i];
    }
  }
}

// dW [H, 4H] = h_prev^T dproj over the [T*B]-deep row axis. One 64x64
// output tile per block, 256 threads, 4x4 each; the next kDepth rows of
// both operands are loaded into registers while the current ones are
// multiplied.
__global__ void __launch_bounds__(256)
lstm_dw_kernel(const float* __restrict__ hs, const float* __restrict__ h0,
               const float* __restrict__ dproj, float* __restrict__ dw,
               int T, int B, int H, int reverse) {
  constexpr int kPer = kDepth * kTile / 256;
  const int H4 = 4 * H;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int n_rows = T * B;

  __shared__ __align__(16) float a_s[kDepth][kTile];
  __shared__ __align__(16) float b_s[kDepth][kTile];
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  float acc[4][4] = {};
  float ra[kPer], rb[kPer];
  // element p of this thread's share of a stage: row kk, column c
  auto load = [&](int base) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * 256;
      const int kk = i / kTile, c = i % kTile;
      const int row = base + kk;
      float a = 0.f, b = 0.f;
      if (row < n_rows) {
        const int t = row / B, bb = row % B;
        const int m = m0 + c;
        if (m < H) a = prev_of(hs, h0, t, T, B, H, reverse)[(size_t)bb * H + m];
        const int n = n0 + c;
        if (n < H4) b = dproj[(size_t)row * H4 + n];
      }
      ra[p] = a;
      rb[p] = b;
    }
  };

  load(0);
  for (int base = 0; base < n_rows; base += kDepth) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * 256;
      a_s[i / kTile][i % kTile] = ra[p];
      b_s[i / kTile][i % kTile] = rb[p];
    }
    __syncthreads();
    if (base + kDepth < n_rows) load(base + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int m = m0 + ty * 4 + ii;
    if (m >= H) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < H4) dw[(size_t)m * H4 + n] = acc[ii][jj];
    }
  }
}

// db[j] = sum over the T*B rows of dproj[:, j]: 32 columns per block, 32
// row lanes, a shared-memory sum over the lanes
__global__ void __launch_bounds__(1024)
lstm_db_kernel(const float* __restrict__ dproj, float* __restrict__ db, int n_rows, int H4) {
  __shared__ float part[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (col < H4) {
    for (int row = threadIdx.y; row < n_rows; row += 32) acc += dproj[(size_t)row * H4 + col];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < H4) {
    float s = 0.f;
    for (int y = 0; y < 32; ++y) s += part[y][threadIdx.x];
    db[col] = s;
  }
}

// How the recurrence is laid out for (H, B) on this device.
struct Plan {
  int units;        // hidden units per block (a power of two, <= 16)
  int blocks;       // ceil(H / units) <= the SM count: one block per SM
  bool smem_w;      // W slice in shared memory (else read through L1/L2)
  size_t fwd_smem;  // dynamic shared memory of each launch
  size_t bwd_smem;
};

size_t fwd_smem_bytes(int U, int H, int B, bool smem_w) {
  const int kt = tile_k(U);
  const size_t w = (size_t)(smem_w ? round_up(H, kt) : kt) * U * 4;
  return (w + (size_t)(kThreads / U) * tile_ld(kt) + (size_t)B * U) * sizeof(float);
}

size_t bwd_smem_bytes(int U, int H, int B, bool smem_w) {
  const int kt = tile_k(U);
  const size_t w = (size_t)U * (smem_w ? bwd_w_ld(H) : tile_ld(kt));
  return (w + (size_t)(kThreads / U) * tile_ld(kt) + (size_t)3 * B * U) * sizeof(float);
}

cudaError_t make_plan(int H, int B, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (int U = 1; U <= 16; U *= 2) {
    const int blocks = (H + U - 1) / U;
    if (blocks > sms) continue;
    const bool smem_w = fwd_smem_bytes(U, H, B, true) <= kSmemMax &&
                        bwd_smem_bytes(U, H, B, true) <= kSmemMax;
    p->units = U;
    p->blocks = blocks;
    p->smem_w = smem_w;
    p->fwd_smem = fwd_smem_bytes(U, H, B, smem_w);
    p->bwd_smem = bwd_smem_bytes(U, H, B, smem_w);
    if (p->fwd_smem > kSmemMax || p->bwd_smem > kSmemMax) return cudaErrorInvalidValue;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;  // H > 16 units x the SM count
}

bool bad_shape(int T, int B, int H) {
  return T <= 0 || B <= 0 || H <= 0 || (size_t)T * B * 4 * H >= (size_t)1 << 31;
}

// dynamic shared memory above 48 KB must be opted into per kernel
cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch(const void* fn, const Plan& p, size_t smem, void** args, cudaStream_t st) {
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(fn, dim3(p.blocks), dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int U>
const void* fwd_fn(bool smem_w) {
  return smem_w ? (const void*)lstm_fwd_kernel<U, true> : (const void*)lstm_fwd_kernel<U, false>;
}

template <int U>
const void* bwd_fn(bool smem_w) {
  return smem_w ? (const void*)lstm_bwd_kernel<U, true> : (const void*)lstm_bwd_kernel<U, false>;
}

const void* pick(const Plan& p, bool fwd) {
  switch (p.units) {
    case 1: return fwd ? fwd_fn<1>(p.smem_w) : bwd_fn<1>(p.smem_w);
    case 2: return fwd ? fwd_fn<2>(p.smem_w) : bwd_fn<2>(p.smem_w);
    case 4: return fwd ? fwd_fn<4>(p.smem_w) : bwd_fn<4>(p.smem_w);
    case 8: return fwd ? fwd_fn<8>(p.smem_w) : bwd_fn<8>(p.smem_w);
    default: return fwd ? fwd_fn<16>(p.smem_w) : bwd_fn<16>(p.smem_w);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). They launch on `stream`, do not
// synchronise, and return the first CUDA error: a shape the plan cannot lay
// out is cudaErrorInvalidValue, and a cooperative grid that cannot be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge), never run.

// The layout chosen for (H, B): units per block, blocks, and whether W's
// slice lives in shared memory (1) or is read through L1/L2 (0).
extern "C" int lstm_seq_plan(int H, int B, int* units, int* blocks, int* smem_w) {
  Plan p;
  const cudaError_t err = make_plan(H, B, &p);
  if (err != cudaSuccess) return (int)err;
  *units = p.units;
  *blocks = p.blocks;
  *smem_w = p.smem_w ? 1 : 0;
  return 0;
}

extern "C" int lstm_seq_fwd_f32(const float* proj, const float* mask, const float* w_hh,
                                const float* bias, const float* h0, const float* c0,
                                float* hs, float* gates, float* ct, float* cs, int T, int B,
                                int H, int reverse, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(H, B, &p);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&proj, &mask, &w_hh, &bias, &h0, &c0, &hs, &gates, &ct, &cs,
                  &T, &B, &H, &reverse};
  return (int)launch(pick(p, true), p, p.fwd_smem, args, static_cast<cudaStream_t>(stream));
}

extern "C" int lstm_seq_bwd_f32(const float* gates, const float* ct, const float* hs,
                                const float* cs, const float* h0, const float* c0,
                                const float* mask, const float* w_hh, const float* dhs,
                                const float* dh_last, const float* dc_last, float* dproj,
                                float* dw, float* db, float* dh0, float* dc0, int T, int B,
                                int H, int reverse, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(H, B, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&gates, &ct, &hs, &cs, &h0, &c0, &mask, &w_hh, &dhs, &dh_last,
                  &dc_last, &dproj, &dh0, &dc0, &T, &B, &H, &reverse};
  err = launch(pick(p, false), p, p.bwd_smem, args, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 dw_grid((4 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  lstm_dw_kernel<<<dw_grid, 256, 0, st>>>(hs, h0, dproj, dw, T, B, H, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_db_kernel<<<(4 * H + 31) / 32, dim3(32, 32), 0, st>>>(dproj, db, T * B, 4 * H);
  return (int)cudaGetLastError();
}
