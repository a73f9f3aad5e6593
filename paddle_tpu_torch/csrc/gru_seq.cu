// Masked whole-sequence GRU, forward and backward, for Hopper (sm_90a), f32.
//
// Replaces: paddle_tpu/ops/pallas/rnn_kernels.py:378 gru_seq_fused — the
// forward pallas_call of _gru_fwd (:346, body _gru_fwd_kernel :261) and the
// backward pallas_call of _gru_vjp_bwd (:391, body _gru_bwd_kernel :286).
//
//   proj   [T, B, 3H]  x_t already projected, gate blocks z, r, c
//   mask   [T, B]      1 = valid step, 0 = padding (h carries through)
//   w_hzr  [H, 2H]     recurrent weights of the update and reset gates
//   w_hc   [H, H]      recurrent weight of the candidate
//   bias   [3H]
//   h0     [B, H]
//
//   z = sig(p_z + b_z + h W_z)      r = sig(p_r + b_r + h W_r)
//   c = tanh(p_c + b_c + (r*h) W_c)  (the reset gate multiplies the
//                                     recurrent candidate term)
//   h' = m * ((1-z) h + z c) + (1-m) h
//
// Forward writes hs [T,B,H] and zrc [T,B,3H] (post-activation z, r, c: the
// backward's residuals). Backward takes zrc, hs, h0, the mask, the weights,
// dhs [T,B,H] and dh_last [B,H] and writes dproj [T,B,3H], dW_zr, dW_c, db
// and dh0. `reverse` walks time T-1 .. 0 (the encoder's backward
// direction); every array stays in original time order, which equals the
// JAX package's flip-run-flip (_run_fused, paddle_tpu/ops/rnn.py:55).
//
// Bound: operations. At the seq2seq shape (T=50, B=128, H=512) the forward
// does 2*T*B*H*3H = 10.1 GFLOP on ~95 MB, the backward twice that on ~112
// MB: far above the f32 ridge of the card. But the recurrence is serial:
// step t+1 needs all of h_t, and the candidate product needs all of r*h_t.
// The TPU runs its grid over T in order with h and W in VMEM; Hopper's
// blocks run in no order, and W (3 MB at H=512) does not fit in one block's
// 227 KB of shared memory.
//
// Design:
//   * Forward: one persistent cooperative launch (all blocks resident,
//     cudaLaunchCooperativeKernel) whose block j owns kUnits hidden units
//     and keeps ITS columns of W_zr and W_c in shared memory for the whole
//     sequence: W is read from device memory once, not once per step. A
//     step needs all of h (and of r*h), so each phase stages the whole
//     [B, H] operand from L2 through shared memory in 64-wide k tiles, and
//     blocks meet at grid.sync() between phases (two per step). Per step:
//     z and r of the block's units for all B rows (one thread per (row,
//     gate)), r*h to a [B, H] scratch; sync; the candidate from the staged
//     r*h and the masked update; sync. Operands written by other blocks
//     during the launch are read with __ldcg (L2, never a stale L1 line).
//   * Backward walk (reverse): bounded by the operands it re-reads every
//     step (dgc [B,H] and dgzr [B,2H]) and by shared-memory loads per FMA.
//     Block (row group, unit group) owns R rows x U units (U and R from
//     the SM count and shared memory: 4 row groups of 32 rows x 32 groups
//     of 16 units at B=128, H=512), keeps its units' rows of W_c and W_zr
//     resident (96 KB at H=512; staged per k tile where they do not fit)
//     and its cells' dh carries. dproj[t] is the exchange buffer. Per
//     step: the elementwise cotangents of its cells (dgz, dgc); sync; d(r*h)
//     = dgc W_c^T and dgr over the valid rows of its row group; sync;
//     dh_prev = dht (1-z) + d(r*h) r + dgzr W_zr^T + (1-m) dh. The products
//     run through rnn_walk.cuh (cp.async ring, register tiles, masked
//     rows skipped: their dproj is exactly zero and dh passes through), so
//     a block reads R rows of each operand, not B.
//   * dW_zr = h_prev^T dproj[:, :2H], dW_c = (r*h_prev)^T dproj[:, 2H:]
//     and db (the TPU kernel's VMEM sums over the T*B rows) come from the
//     shared split-K f32 GEMM of rnn_reduce.cuh (both products in one
//     launch, r*h_prev formed as its tiles land, a deterministic second
//     pass over the splits, db folded in), from the same entry point.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_reduce.cuh"
#include "rnn_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 4;                 // hidden units per recurrence block
constexpr int kThreads = 256;             // recurrence block size
constexpr int kKT = 64;                   // k per staged tile
constexpr int kTileLd = kKT + 1;          // padded tile row (no bank conflicts)

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// forward time index of processing step s
__device__ __forceinline__ int time_of(int s, int T, int reverse) {
  return reverse ? T - 1 - s : s;
}

// h_prev of original time t: h0 at the first processed step, else the
// output of the step processed just before ([B, H] rows)
__device__ __forceinline__ const float* h_prev_of(const float* hs, const float* h0,
                                                  int t, int T, int B, int H,
                                                  int reverse) {
  const bool first = reverse ? (t == T - 1) : (t == 0);
  if (first) return h0;
  return hs + (size_t)(reverse ? t + 1 : t - 1) * B * H;
}

// stage rows [b0, b0 + rows) x columns [kt, kt + kKT) of a row-major
// operand with leading dimension ld and width `width` into tile[rows][kTileLd];
// out-of-range entries are 0. __ldcg: the operand may have been written by
// another block of this launch. 16-byte loads when ld and width are
// multiples of 4 (the caller keeps every base pointer 16-byte aligned).
__device__ __forceinline__ void stage(float* tile, const float* src, int ld, int width,
                                      int b0, int rows, int kt, int B) {
  if ((ld & 3) == 0 && (width & 3) == 0) {
    constexpr int q = kKT / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int r = i / q, c4 = (i % q) * 4;
      const int b = b0 + r, k = kt + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B && k < width) {
        v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)b * ld + k));
      }
      float* d = tile + r * kTileLd + c4;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    return;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * kKT; i += kThreads) {
    const int r = i / kKT, kk = i % kKT;
    const int b = b0 + r, k = kt + kk;
    tile[r * kTileLd + kk] = (b < B && k < width) ? __ldcg(src + (size_t)b * ld + k) : 0.f;
  }
}

// acc[j] += sum over the staged k tile of tile[row][kk] * w[(kt + kk) * kUnits + j]
__device__ __forceinline__ void tile_dot(float (&acc)[kUnits], const float* trow,
                                         const float* w, int kn) {
#pragma unroll 8
  for (int kk = 0; kk < kn; ++kk) {
    const float v = trow[kk];
    const float4 wv = *reinterpret_cast<const float4*>(w + kk * kUnits);
    acc[0] = fmaf(v, wv.x, acc[0]);
    acc[1] = fmaf(v, wv.y, acc[1]);
    acc[2] = fmaf(v, wv.z, acc[2]);
    acc[3] = fmaf(v, wv.w, acc[3]);
  }
}

// acc = row `threadIdx.x % rows` of src[b0:b0+rows, 0:width] times
// w[width][kUnits] (shared memory), streaming src through the tile
__device__ __forceinline__ void row_times_w(float (&acc)[kUnits], float* tile,
                                            const float* src, int ld, int width,
                                            const float* w, int b0, int rows, int B) {
#pragma unroll
  for (int j = 0; j < kUnits; ++j) acc[j] = 0.f;
  const float* trow = tile + (threadIdx.x % rows) * kTileLd;
  for (int kt = 0; kt < width; kt += kKT) {
    stage(tile, src, ld, width, b0, rows, kt, B);
    __syncthreads();
    tile_dot(acc, trow, w + (size_t)kt * kUnits, min(kKT, width - kt));
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const float* proj, const float* mask, const float* w_hzr,
               const float* w_hc, const float* bias, const float* h0, float* hs,
               float* zrc, float* rh, int T, int B, int H, int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H2 = 2 * H, H3 = 3 * H;
  const int u0 = blockIdx.x * kUnits;
  const int nu = min(kUnits, H - u0);
  float* w_s = smem;                        // [3][H][kUnits]: z, r, c columns
  float* z_s = w_s + 3 * H * kUnits;        // [B][kUnits]
  float* tile = z_s + B * kUnits;           // [kThreads][kTileLd]

  for (int i = threadIdx.x; i < 3 * H * kUnits; i += kThreads) {
    const int j = i % kUnits, k = (i / kUnits) % H, g = i / (kUnits * H);
    float w = 0.f;
    if (j < nu) {
      w = g < 2 ? w_hzr[(size_t)k * H2 + g * H + u0 + j] : w_hc[(size_t)k * H + u0 + j];
    }
    w_s[i] = w;
  }
  __syncthreads();

  const int half = kThreads / 2;
  for (int s = 0; s < T; ++s) {
    const int t = time_of(s, T, reverse);
    const float* hp = h_prev_of(hs, h0, t, T, B, H, reverse);
    // z (threads [0, half)) and r (threads [half, kThreads)) of the block's
    // units for `half` rows at a time
    for (int b0 = 0; b0 < B; b0 += half) {
      const int g = threadIdx.x / half;
      const int b = b0 + threadIdx.x % half;
      float acc[kUnits];
      row_times_w(acc, tile, hp, H, H, w_s + (size_t)g * H * kUnits, b0, half, B);
      if (b < B) {
        const size_t row = (size_t)t * B + b;
        for (int j = 0; j < nu; ++j) {
          const int n = u0 + j;
          const float gate = sigmoidf_(proj[row * H3 + g * H + n] + bias[g * H + n] + acc[j]);
          zrc[row * H3 + g * H + n] = gate;
          if (g == 0) {
            z_s[b * kUnits + j] = gate;
          } else {
            rh[(size_t)b * H + n] = gate * __ldcg(hp + (size_t)b * H + n);
          }
        }
      }
    }
    grid.sync();
    // the candidate from all of r*h, then the masked update, a row a thread
    for (int b0 = 0; b0 < B; b0 += kThreads) {
      const int b = b0 + threadIdx.x;
      float acc[kUnits];
      row_times_w(acc, tile, rh, H, H, w_s + (size_t)2 * H * kUnits, b0, kThreads, B);
      if (b < B) {
        const size_t row = (size_t)t * B + b;
        const float m = mask[row];
        for (int j = 0; j < nu; ++j) {
          const int n = u0 + j;
          const float c = tanhf(proj[row * H3 + H2 + n] + bias[H2 + n] + acc[j]);
          const float z = z_s[b * kUnits + j];
          const float h = __ldcg(hp + (size_t)b * H + n);
          const float h_tilde = (1.f - z) * h + z * c;
          zrc[row * H3 + H2 + n] = c;
          hs[row * H + n] = m * h_tilde + (1.f - m) * h;
        }
      }
    }
    grid.sync();
  }
}

// One cell's inputs to the backward's elementwise step: h_prev, the gates
// z, r, c and dhs of (t, b, n). None is written by the walk, so the walk
// fetches them a step ahead.
struct CellIn {
  float hp, z, r, c, dhs;
};

__device__ __forceinline__ CellIn load_cell(const float* zrc, const float* hs,
                                            const float* h0, const float* dhs, int t, int b,
                                            int n, int T, int B, int H, int reverse) {
  const size_t row = (size_t)t * B + b;
  const float* g = zrc + row * 3 * H;
  const float* hp = h_prev_of(hs, h0, t, T, B, H, reverse);
  return CellIn{hp[(size_t)b * H + n], g[n], g[H + n], g[2 * H + n], dhs[row * H + n]};
}

// cells per thread whose inputs are fetched a step ahead (the rest, at
// larger R x U, when the step needs them)
constexpr int kAhead = 2;

// The backward walk. Block (rg, ug) owns rows [b0, b0 + R) and units
// [u0, u0 + U): their dh carries stay in shared memory, and so do the
// units' rows of W_c and W_zr (or they are staged per k tile, kResW
// false). dproj[t] is the exchange buffer: its dgz and dgc columns are
// written in A, its dgr columns in B. Per step: A, the elementwise
// cotangents of the block's cells; sync; B, d(r*h) of the cells = dgc
// W_c^T over the valid rows of the row group, then dgr; sync; C, dh_prev
// += dgzr W_zr^T over the same rows. kVec: H a multiple of 4 (16-byte
// copies).
template <int U, bool kResW, bool kVec>
__global__ void __launch_bounds__(rnn::kWalkThreads, 1)
gru_bwd_kernel(const float* zrc, const float* hs, const float* h0, const float* mask,
               const float* w_hzr, const float* w_hc, const float* dhs, const float* dh_last,
               float* dproj, float* dh0, int T, int B, int H, int R, int unit_groups,
               int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H2 = 2 * H, H3 = 3 * H;
  const int ldc = rnn::res_ld(H), ldzr = rnn::res_ld(H2);
  const int u0 = (blockIdx.x % unit_groups) * U, nu = min(U, H - u0);
  const int b0 = (blockIdx.x / unit_groups) * R, nr = min(R, B - b0);
  float* wc_s = smem;                                           // [U][ldc]  W_c rows
  float* wzr_s = wc_s + U * ldc;                                // [U][ldzr] W_zr rows
  float* ring = smem + (kResW ? U * (ldc + ldzr) : 0);
  float* part = ring + rnn::kStages * rnn::stage_floats(U, R, kResW);
  float* dh_c = part + rnn::kWalkThreads * rnn::kTR * rnn::kTU;  // [R][U] dh carry
  float* r_s = dh_c + R * U;                                    // [R][U] reset gate
  float* hp_s = r_s + R * U;                                    // [R][U] h_prev
  float* m_s = hp_s + R * U;                                    // [R] mask of the step
  int* rows_s = reinterpret_cast<int*>(m_s + R);                // [R] valid rows
  int* nv_s = rows_s + R;

  if (kResW) {
    for (int i = threadIdx.x; i < U * ldc; i += rnn::kWalkThreads) {
      const int j = i / ldc, k = i % ldc;
      wc_s[i] = j < nu && k < H ? w_hc[(size_t)(u0 + j) * H + k] : 0.f;
    }
    for (int i = threadIdx.x; i < U * ldzr; i += rnn::kWalkThreads) {
      const int j = i / ldzr, k = i % ldzr;
      wzr_s[i] = j < nu && k < H2 ? w_hzr[(size_t)(u0 + j) * H2 + k] : 0.f;
    }
  }
  // dh_last folds into the first step of the reverse walk (the TPU kernel
  // adds it to dhs[-1])
  for (int i = threadIdx.x; i < R * U; i += rnn::kWalkThreads) {
    const int r = i / U, j = i % U;
    dh_c[i] = r < nr && j < nu ? dh_last[(size_t)(b0 + r) * H + u0 + j] : 0.f;
  }

  // the next step's mask and cell inputs, in registers: their loads are
  // in flight during the grid syncs and the products
  CellIn ahead[kAhead] = {};
  float m_ahead = 0.f;
  // A for cell i = (r, j) of the block at step t
  auto cell = [&](int t, int i, const CellIn& v) {
    const int r = i / U, j = i % U;
    if (j >= nu) return;
    const int n = u0 + j;
    float* dp = dproj + ((size_t)t * B + b0 + r) * H3;
    const float m = m_s[r];
    const float dh = dh_c[i] + v.dhs;
    const float dht = m * dh;
    dp[n] = dht * (v.c - v.hp) * v.z * (1.f - v.z);  // dgz
    dp[H2 + n] = dht * v.z * (1.f - v.c * v.c);     // dgc
    if (m == 0.f) dp[H + n] = 0.f;                  // dgr: B skips masked rows
    dh_c[i] = dht * (1.f - v.z) + (1.f - m) * dh;   // B and C add the products
    r_s[i] = v.r;
    hp_s[i] = v.hp;
  };
  {
    const int ta = time_of(T - 1, T, reverse);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = threadIdx.x + k * rnn::kWalkThreads, j = i % U;
      if (i < nr * U && j < nu)
        ahead[k] = load_cell(zrc, hs, h0, dhs, ta, b0 + i / U, u0 + j, T, B, H, reverse);
    }
    if (threadIdx.x < nr) m_ahead = mask[(size_t)ta * B + b0 + threadIdx.x];
  }

  for (int s = T - 1; s >= 0; --s) {
    const int t = time_of(s, T, reverse);
    float* dp_t = dproj + (size_t)t * B * H3;
    for (int r = threadIdx.x; r < nr; r += rnn::kWalkThreads)
      m_s[r] = r == threadIdx.x ? m_ahead : mask[(size_t)t * B + b0 + r];
    __syncthreads();
    if (threadIdx.x < 32) rnn::compact_rows(m_s, b0, nr, rows_s, nv_s);
    // A: elementwise cotangents of the block's cells
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = threadIdx.x + k * rnn::kWalkThreads;
      if (i < nr * U) cell(t, i, ahead[k]);
    }
    for (int i = threadIdx.x + kAhead * rnn::kWalkThreads; i < nr * U; i += rnn::kWalkThreads)
      cell(t, i, load_cell(zrc, hs, h0, dhs, t, b0 + i / U, u0 + i % U, T, B, H, reverse));
    if (s > 0) {  // the next step's inputs
      const int ta = time_of(s - 1, T, reverse);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int i = threadIdx.x + k * rnn::kWalkThreads, j = i % U;
        if (i < nr * U && j < nu)
          ahead[k] = load_cell(zrc, hs, h0, dhs, ta, b0 + i / U, u0 + j, T, B, H, reverse);
      }
      if (threadIdx.x < nr) m_ahead = mask[(size_t)ta * B + b0 + threadIdx.x];
    }
    grid.sync();
    const int nv = *nv_s;
    // B: d(r*h)[b, n] = sum_k dgc[b, k] W_c[n, k], then the reset gate
    rnn::group_product<U, kResW, kVec>(
        rows_s, nv, dp_t + H2, H3, H, wc_s, ldc, w_hc, H, u0, nu, R, ring,
        part, [&](int r, int j, float acc) {
          const int b = rows_s[r], i = (b - b0) * U + j;
          const float rg = r_s[i];
          dp_t[(size_t)b * H3 + H + u0 + j] = acc * hp_s[i] * rg * (1.f - rg);
          dh_c[i] += acc * rg;
        });
    grid.sync();
    // C: dh_prev[b, n] += sum_j dgzr[b, j] W_zr[n, j]
    rnn::group_product<U, kResW, kVec>(
        rows_s, nv, dp_t, H3, H2, wzr_s, ldzr, w_hzr, H2, u0, nu, R, ring,
        part, [&](int r, int j, float acc) { dh_c[(rows_s[r] - b0) * U + j] += acc; });
    __syncthreads();  // (nv == 0) the next step rewrites m_s and rows_s
  }
  for (int i = threadIdx.x; i < nr * U; i += rnn::kWalkThreads) {
    const int j = i % U;
    if (j < nu) dh0[(size_t)(b0 + i / U) * H + u0 + j] = dh_c[i];
  }
}

// dW_zr, dW_c and db: the shared split-K reduction of rnn_reduce.cuh
RNN_DW_KERNELS(gru_)

bool bad_shape(int T, int B, int H) {
  return T <= 0 || B <= 0 || H <= 0 || (size_t)T * B * 3 * H >= (size_t)1 << 31;
}

// dynamic shared memory above 48 KB must be opted into per kernel
cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes > rnn::kSmemMax) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t tile_bytes() { return (size_t)kThreads * kTileLd * sizeof(float); }

size_t fwd_smem_bytes(int H, int B) {
  return (size_t)(3 * H + B) * kUnits * sizeof(float) + tile_bytes();
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The backward walk's layout: W_c and W_zr rows per unit; dh carry, reset
// gate and h_prev per cell; the mask and the valid-row list per row
cudaError_t make_bwd_plan(int H, int B, rnn::WalkPlan* p) {
  return rnn::make_walk_plan(H, B, rnn::res_ld(H) + rnn::res_ld(2 * H), 3, 2, p);
}

// dW_zr = h_prev^T dproj[:, :2H] (and db[:2H]); dW_c = (r * h_prev)^T
// dproj[:, 2H:] (and db[2H:]), both over the valid (t, b) rows
rnn::DwArgs dw_args(const float* zrc, const float* hs, const float* h0, const float* mask,
                    const float* dproj, float* dwzr, float* dwc, float* db, int T, int B, int H,
                    int reverse) {
  rnn::DwArgs a{};
  a.hs = hs;
  a.h0 = h0;
  a.mask = mask;
  a.T = T;
  a.B = B;
  a.reverse = reverse;
  a.n_problems = 2;
  const int H3 = 3 * H;
  a.p[0] = rnn::DwProblem{nullptr, 0, dproj, H3, H, 2 * H, dwzr, db, nullptr};
  a.p[1] = rnn::DwProblem{zrc ? zrc + H : nullptr, H3, dproj ? dproj + 2 * H : nullptr, H3,
                          H, H, dwc, db ? db + 2 * H : nullptr, nullptr};
  return a;
}

template <int U, bool kResW>
const void* bwd_fn(bool vec) {
  return vec ? (const void*)gru_bwd_kernel<U, kResW, true>
             : (const void*)gru_bwd_kernel<U, kResW, false>;
}

const void* pick_bwd(const rnn::WalkPlan& p, bool vec) {
  switch (p.units * 2 + (p.w_res ? 1 : 0)) {
    case 8: return bwd_fn<4, false>(vec);
    case 9: return bwd_fn<4, true>(vec);
    case 16: return bwd_fn<8, false>(vec);
    case 17: return bwd_fn<8, true>(vec);
    case 32: return bwd_fn<16, false>(vec);
    case 33: return bwd_fn<16, true>(vec);
    case 64: return bwd_fn<32, false>(vec);
    default: return bwd_fn<32, true>(vec);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). They launch on `stream`, do not
// synchronise, and return the first CUDA error: a shape the plan cannot
// lay out is cudaErrorInvalidValue, and a cooperative grid that cannot be
// co-resident is refused with cudaErrorCooperativeLaunchTooLarge, never
// run. Scratch buffers come from the caller: rh [B, H] for the forward,
// and for the backward the dW reduction's partial sums and its list of
// valid rows (gru_seq_plan's last number of floats).

// The layouts chosen for (T, B, H), into out[10]: the forward's units per
// block, blocks and W in shared memory (always 1); the backward walk's
// units per block, row groups, rows per group, blocks and W resident (1)
// or staged per k tile (0); the dW reduction's splits of the T*B rows; and
// the floats of scratch the backward entry point takes.
extern "C" int gru_seq_plan(int T, int B, int H, long long* out) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan w;
  int sms = 0;
  cudaError_t err = make_bwd_plan(H, B, &w);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          T, B, H, 0);
  const size_t scratch = rnn::dw_prepare(&a, nullptr, sms);
  const long long v[10] = {kUnits, (H + kUnits - 1) / kUnits, 1, w.units,  w.row_groups,
                           w.rows, w.blocks, w.w_res, a.splits, (long long)scratch};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

extern "C" int gru_seq_fwd_f32(const float* proj, const float* mask, const float* w_hzr,
                               const float* w_hc, const float* bias, const float* h0,
                               float* hs, float* zrc, float* rh, int T, int B, int H,
                               int reverse, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(H, B);
  cudaError_t err = set_smem((const void*)gru_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&proj, &mask, &w_hzr, &w_hc, &bias, &h0, &hs, &zrc, &rh,
                  &T, &B, &H, &reverse};
  err = cudaLaunchCooperativeKernel((const void*)gru_fwd_kernel,
                                    dim3((H + kUnits - 1) / kUnits), dim3(kThreads),
                                    args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int gru_seq_bwd_f32(const float* zrc, const float* hs, const float* h0,
                               const float* mask, const float* w_hzr, const float* w_hc,
                               const float* dhs, const float* dh_last, float* dproj,
                               float* dwzr, float* dwc, float* db, float* dh0,
                               float* scratch, int T, int B, int H, int reverse,
                               void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan w;
  int sms = 0;
  cudaError_t err = make_bwd_plan(H, B, &w);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const void* fn = pick_bwd(w, (H & 3) == 0);
  err = set_smem(fn, w.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int R = w.rows, ug = w.unit_groups;
  void* args[] = {&zrc,   &hs,  &h0, &mask, &w_hzr, &w_hc, &dhs, &dh_last,
                  &dproj, &dh0, &T,  &B,    &H,     &R,    &ug,  &reverse};
  err = cudaLaunchCooperativeKernel(fn, dim3(w.blocks), dim3(rnn::kWalkThreads), args, w.smem,
                                    st);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(zrc, hs, h0, mask, dproj, dwzr, dwc, db, T, B, H, reverse);
  rnn::dw_prepare(&a, scratch, sms);
  return (int)gru_dw_launch(a, sms, st);
}
