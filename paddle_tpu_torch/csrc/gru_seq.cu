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
// backward's residuals, for every row, masked or not). Backward takes zrc,
// hs, h0, the mask, the weights, dhs [T,B,H] and dh_last [B,H] and writes
// dproj [T,B,3H], dW_zr, dW_c, db and dh0. `reverse` walks time T-1 .. 0
// (the encoder's backward direction); every array stays in original time
// order, which equals the JAX package's flip-run-flip (_run_fused,
// paddle_tpu/ops/rnn.py:55).
//
// Bound: operations. At the seq2seq shape (T=50, B=128, H=512) the forward
// does 2*T*B*H*3H = 10.1 GFLOP on ~95 MB, the backward twice that on ~112
// MB: far above the f32 ridge of the card. But the recurrence is serial:
// step t+1 needs all of h_t, and the candidate product needs all of r*h_t.
// The TPU runs its grid over T in order with h and W in VMEM; Hopper's
// blocks run in no order, and W (3 MB at H=512) does not fit in one block's
// 227 KB of shared memory.
//
// Design: both directions are one persistent cooperative launch each (all
// blocks resident, cudaLaunchCooperativeKernel) whose block (row group,
// unit group) owns R rows x U units, laid out by rnn::make_walk_plan from
// the SM count and shared memory (4 row groups of 32 rows x 32 groups of
// 16 units at B=128, H=512; every H whose unit groups fit the SMs), with
// two grid syncs per step. Both run their recurrent products through
// rnn_walk.cuh's group_product (cp.async ring, 4 x 4 register tiles fed
// from shared memory, k slices summed in a fixed order), so a block reads
// R rows of each operand per step, not B. Operands written by other blocks
// during the launch are read through L2 only (cp.async.cg, __ldcg).
//   * Forward: the block keeps its units' z, r and candidate columns of W
//     resident in shared memory, transposed to rows [3U][K] (96 KB at
//     U=16, H=512; staged per 128-wide k tile with the operand where they
//     do not fit), and its cells' h. Per step: z and r sums = h_{t-1}[rows]
//     W_zr[:, block's columns] (hs[t-1] is the exchange buffer) into a
//     small shared buffer, for the rows of the group that were valid at
//     the step before only (a masked step carries h through, so a row's
//     sums stay those of its h; rows >= B are never computed), then per
//     (row, unit) the gates and this block's slice of r*h to the [B, H]
//     scratch; sync; the candidate sums = (r*h)[rows] W_c[:, block's
//     columns] over every row of the group (r changes with x_t), then per
//     (row, unit) the candidate and the masked update; sync. The cells'
//     proj and mask for the next step are fetched into registers before
//     the sync. What bounds it on the card (PERF.md): the two products;
//     the two grid syncs take ~13 % of a step.
//   * Backward walk (reverse): bounded by the operands it re-reads every
//     step (dgc [B,H] and dgzr [B,2H]). The block keeps its units' rows of
//     W_c and W_zr resident (96 KB at H=512; staged per 256-wide k tile
//     where they do not fit) and its cells' dh carries. dproj[t] is the
//     exchange buffer. Per step: the elementwise cotangents of its cells
//     (dgz, dgc); sync; d(r*h) = dgc W_c^T and dgr over the valid rows of
//     its row group; sync; dh_prev = dht (1-z) + d(r*h) r + dgzr W_zr^T +
//     (1-m) dh. Masked rows are skipped: their dproj is exactly zero and
//     dh passes through.
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

// One cell's inputs to the forward's epilogues: proj of its z, r and c
// gates and the row's mask. None depends on a product, so the forward
// fetches them a step ahead.
struct FwdIn {
  float pz, pr, pc, m;
};

__device__ __forceinline__ FwdIn load_fwd_in(const float* proj, const float* mask, int t,
                                             int b, int n, int B, int H) {
  const size_t row = (size_t)t * B + b;
  const float* p = proj + row * 3 * H + n;
  return FwdIn{p[0], p[H], p[2 * H], mask[row]};
}

// cells per thread whose inputs are fetched a step ahead (the rest, at
// larger R x U, when the step needs them)
constexpr int kFwdAhead = 4;

// The forward. Block (rg, ug) owns rows [b0, b0 + R) and units [u0, u0 +
// U): their h stays in shared memory, and so do the units' columns of W
// as rows [z: 0, U) [r: U, 2U) [c: 2U, 3U) (else they are staged per k
// tile, kResW false). Per step: A, the z and r sums of the block's cells
// = h_{t-1} W_zr over the group's rows that were valid at the step before
// (rnn_walk.cuh), the gates and r*h; sync; B, the candidate sums = (r*h)
// W_c over all of the group's rows, the candidate and the masked update;
// sync. kVec: H a multiple of 4 (16-byte copies of h and r*h).
template <int U, bool kResW, bool kVec>
__global__ void __launch_bounds__(rnn::kWalkThreads, 1)
gru_fwd_kernel(const float* proj, const float* mask, const float* w_hzr, const float* w_hc,
               const float* bias, const float* h0, float* hs, float* zrc, float* rh, int T,
               int B, int H, int R, int unit_groups, int reverse) {
  constexpr int N2 = 2 * U;  // columns of the z and r product
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H2 = 2 * H, H3 = 3 * H;
  const int ldw = rnn::res_ld(H, rnn::kFwdKT);
  const int u0 = (blockIdx.x % unit_groups) * U, nu = min(U, H - u0);
  const int b0 = (blockIdx.x / unit_groups) * R, nr = min(R, B - b0);
  float* w_s = smem;                                                 // [3U][ldw] if kResW
  float* ring = w_s + (kResW ? 3 * U * ldw : 0);
  float* part = ring + rnn::kStages * rnn::stage_floats(N2, R, kResW, rnn::kFwdKT);
  float* pre = part + rnn::kPartFloats;                              // [R][2U] z and r sums
  float* pre_c = pre + R * N2;                                       // [R][U] candidate sums
  float* h_c = pre_c + R * U;                                        // [R][U] h of the cells
  float* z_s = h_c + R * U;                                          // [R][U] update gate
  int* all_s = reinterpret_cast<int*>(z_s + R * U);                  // [R] the group's rows
  int* rows_s = all_s + R;                                           // [2][R] rows for z, r
  int* nv_s = rows_s + 2 * R;                                        // [2] their counts

  if (kResW) {
    rnn::load_cols<U>(w_s, ldw, N2, w_hzr, H2, H, u0, nu, H);
    rnn::load_cols<U>(w_s + N2 * ldw, ldw, U, w_hc, H, H, u0, nu, H);
  }
  for (int i = threadIdx.x; i < R * U; i += rnn::kWalkThreads) {
    const int r = i / U, j = i % U;
    h_c[i] = r < nr && j < nu ? h0[(size_t)(b0 + r) * H + u0 + j] : 0.f;
  }
  for (int r = threadIdx.x; r < nr; r += rnn::kWalkThreads) all_s[r] = rows_s[r] = b0 + r;
  if (threadIdx.x == 0) nv_s[0] = nr;

  // every cell i = threadIdx.x + k * kWalkThreads of this thread has unit j
  const int j = threadIdx.x % U, n = u0 + min(j, nu - 1);
  const bool owns = j < nu;
  const float bz = bias[n], br = bias[H + n], bc = bias[H2 + n];
  FwdIn ahead[kFwdAhead] = {};
  auto fetch = [&](int t) {
#pragma unroll
    for (int k = 0; k < kFwdAhead; ++k) {
      const int i = threadIdx.x + k * rnn::kWalkThreads;
      if (owns && i < nr * U) ahead[k] = load_fwd_in(proj, mask, t, b0 + i / U, n, B, H);
    }
  };
  // A for cell i at step t: z, r and this cell's r*h
  auto gates_zr = [&](int t, int i, const FwdIn& v) {
    const float* a = pre + (i / U) * N2 + j;
    const float z = sigmoidf_(v.pz + bz + a[0]);
    const float r = sigmoidf_(v.pr + br + a[U]);
    const int b = b0 + i / U;
    float* g = zrc + ((size_t)t * B + b) * H3;
    g[n] = z;
    g[H + n] = r;
    rh[(size_t)b * H + n] = r * h_c[i];
    z_s[i] = z;
  };
  // B for cell i at step t: the candidate and the masked update
  auto update = [&](int t, int i, const FwdIn& v) {
    const float c = tanhf(v.pc + bc + pre_c[(i / U) * U + j]);
    const float h = h_c[i], z = z_s[i];
    const float h_new = v.m * ((1.f - z) * h + z * c) + (1.f - v.m) * h;
    const size_t row = (size_t)t * B + b0 + i / U;
    zrc[row * H3 + H2 + n] = c;
    hs[row * H + n] = h_new;
    h_c[i] = h_new;
  };
  // one cell pass over the block's cells, prefetched inputs first
  auto cells = [&](int t, auto fn) {
    if (!owns) return;
#pragma unroll
    for (int k = 0; k < kFwdAhead; ++k) {
      const int i = threadIdx.x + k * rnn::kWalkThreads;
      if (i < nr * U) fn(t, i, ahead[k]);
    }
    for (int i = threadIdx.x + kFwdAhead * rnn::kWalkThreads; i < nr * U; i += rnn::kWalkThreads)
      fn(t, i, load_fwd_in(proj, mask, t, b0 + i / U, n, B, H));
  };
  fetch(time_of(0, T, reverse));
  __syncthreads();  // W, the cells' state and the row list in place

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s, T, reverse);
    // A: z and r sums of the block's cells, h_{t-1}[rows] W_zr[:, columns],
    // for the rows valid at the step before (all at the first): a masked
    // step carries h through, so the other rows' sums in `pre` still hold
    const int* rows = rows_s + (s & 1) * R;
    rnn::group_product<N2, rnn::kFwdKT, kResW, kVec>(
        rows, nv_s[s & 1], h_prev_of(hs, h0, t, T, B, H, reverse), H, H, w_s, ldw,
        [&](float* dst, int k0) {
          rnn::stage_cols<rnn::kFwdKT, N2, U>(dst, w_hzr, H2, H, u0, nu, k0, H);
        },
        R, ring, part, [&](int r, int c, float acc) { pre[(rows[r] - b0) * N2 + c] = acc; });
    // the next step's rows, into the other list (read last before the
    // previous grid sync): those valid at this step
    if (s + 1 < T && threadIdx.x < 32)
      rnn::compact_rows(mask + (size_t)t * B + b0, b0, nr, rows_s + ((s + 1) & 1) * R,
                        nv_s + ((s + 1) & 1));
    cells(t, gates_zr);
    grid.sync();
    // B: candidate sums, (r*h)[rows] W_c[:, columns], for every row: r
    // changes with x_t
    rnn::group_product<U, rnn::kFwdKT, kResW, kVec>(
        all_s, nr, rh, H, H, w_s + N2 * ldw, ldw,
        [&](float* dst, int k0) {
          rnn::stage_cols<rnn::kFwdKT, U, U>(dst, w_hc, H, H, u0, nu, k0, H);
        },
        R, ring, part, [&](int r, int c, float acc) { pre_c[r * U + c] = acc; });
    cells(t, update);
    if (s + 1 < T) {
      fetch(time_of(s + 1, T, reverse));  // in flight during the sync
      grid.sync();
    }
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
  const int ldc = rnn::res_ld(H, rnn::kKT), ldzr = rnn::res_ld(H2, rnn::kKT);
  const int u0 = (blockIdx.x % unit_groups) * U, nu = min(U, H - u0);
  const int b0 = (blockIdx.x / unit_groups) * R, nr = min(R, B - b0);
  float* wc_s = smem;                                           // [U][ldc]  W_c rows
  float* wzr_s = wc_s + U * ldc;                                // [U][ldzr] W_zr rows
  float* ring = smem + (kResW ? U * (ldc + ldzr) : 0);
  float* part = ring + rnn::kStages * rnn::stage_floats(U, R, kResW, rnn::kKT);
  float* dh_c = part + rnn::kPartFloats;                        // [R][U] dh carry
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

  // k tile [k0, k0 + kKT) of the units' rows of a [H, ld] weight, staged
  // with the operand where they are not resident
  auto stage_w = [&](const float* w, int ld) {
    return [=](float* dst, int k0) {
      rnn::stage_rows<rnn::kKT, kVec>(
          dst, U, [=](int j) { return w + (size_t)(u0 + min(j, nu - 1)) * ld; }, k0, ld);
    };
  };
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
    rnn::group_product<U, rnn::kKT, kResW, kVec>(
        rows_s, nv, dp_t + H2, H3, H, wc_s, ldc, stage_w(w_hc, H), R, ring, part,
        [&](int r, int j, float acc) {
          if (j >= nu) return;
          const int b = rows_s[r], i = (b - b0) * U + j;
          const float rg = r_s[i];
          dp_t[(size_t)b * H3 + H + u0 + j] = acc * hp_s[i] * rg * (1.f - rg);
          dh_c[i] += acc * rg;
        });
    grid.sync();
    // C: dh_prev[b, n] += sum_j dgzr[b, j] W_zr[n, j]
    rnn::group_product<U, rnn::kKT, kResW, kVec>(
        rows_s, nv, dp_t, H3, H2, wzr_s, ldzr, stage_w(w_hzr, H2), R, ring, part,
        [&](int r, int j, float acc) {
          if (j < nu) dh_c[(rows_s[r] - b0) * U + j] += acc;
        });
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

// The forward's layout: z, r and candidate columns of W per unit (the
// widest product has 2 columns per unit); z, r and candidate sums, h and
// z per cell; three row lists per row
cudaError_t make_fwd_plan(int H, int B, rnn::WalkPlan* p) {
  return rnn::make_walk_plan(H, B, 2, rnn::kFwdKT, 3 * rnn::res_ld(H, rnn::kFwdKT), 5, 3, p);
}

// The backward walk's layout: W_c and W_zr rows per unit; dh carry, reset
// gate and h_prev per cell; the mask and the valid-row list per row
cudaError_t make_bwd_plan(int H, int B, rnn::WalkPlan* p) {
  return rnn::make_walk_plan(H, B, 1, rnn::kKT,
                             rnn::res_ld(H, rnn::kKT) + rnn::res_ld(2 * H, rnn::kKT), 3, 2, p);
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

// the kernels' instances, for rnn::pick_kernel
struct FwdKernel {
  template <int U, bool kResW, bool kVec>
  const void* operator()(rnn::Inst<U, kResW, kVec>) const {
    return (const void*)gru_fwd_kernel<U, kResW, kVec>;
  }
};

struct BwdKernel {
  template <int U, bool kResW, bool kVec>
  const void* operator()(rnn::Inst<U, kResW, kVec>) const {
    return (const void*)gru_bwd_kernel<U, kResW, kVec>;
  }
};

}  // namespace

// Plain C entry points (bound with ctypes). They launch on `stream`, do not
// synchronise, and return the first CUDA error: a shape the plan cannot
// lay out is cudaErrorInvalidValue, and a cooperative grid that cannot be
// co-resident is refused with cudaErrorCooperativeLaunchTooLarge, never
// run. Scratch buffers come from the caller: rh [B, H] for the forward,
// and for the backward the dW reduction's partial sums and its list of
// valid rows (gru_seq_plan's last number of floats).

// The layouts chosen for (T, B, H), into out[12]: the forward's units per
// block, row groups, rows per group, blocks and W resident (1) or staged
// per k tile (0); the same five for the backward walk; the dW reduction's
// splits of the T*B rows; and the floats of scratch the backward entry
// point takes.
extern "C" int gru_seq_plan(int T, int B, int H, long long* out) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan f, w;
  int sms = 0;
  cudaError_t err = make_fwd_plan(H, B, &f);
  if (err == cudaSuccess) err = make_bwd_plan(H, B, &w);
  if (err == cudaSuccess) err = rnn::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          T, B, H, 0);
  const size_t scratch = rnn::dw_prepare(&a, nullptr, sms);
  const long long v[12] = {f.units,  f.row_groups, f.rows,   f.blocks,   f.w_res,
                           w.units,  w.row_groups, w.rows,   w.blocks,   w.w_res,
                           a.splits, (long long)scratch};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

extern "C" int gru_seq_fwd_f32(const float* proj, const float* mask, const float* w_hzr,
                               const float* w_hc, const float* bias, const float* h0,
                               float* hs, float* zrc, float* rh, int T, int B, int H,
                               int reverse, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan p;
  cudaError_t err = make_fwd_plan(H, B, &p);
  if (err != cudaSuccess) return (int)err;
  int R = p.rows, ug = p.unit_groups;
  void* args[] = {&proj, &mask, &w_hzr, &w_hc, &bias, &h0, &hs, &zrc,
                  &rh,   &T,    &B,     &H,    &R,    &ug, &reverse};
  return (int)rnn::launch(rnn::pick_kernel(p, (H & 3) == 0, FwdKernel{}), p.blocks, p.smem,
                          args, static_cast<cudaStream_t>(stream));
}

// The forward's step loop with nothing but its grid syncs (two a step), at
// the forward's own grid for (T, B, H): the synchronisation's share of a
// forward step.
extern "C" int gru_seq_fwd_sync_f32(int T, int B, int H, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan p;
  cudaError_t err = make_fwd_plan(H, B, &p);
  if (err != cudaSuccess) return (int)err;
  int per_step = 2;
  void* args[] = {&T, &per_step};
  return (int)rnn::launch((const void*)rnn::sync_steps_kernel, p.blocks, p.smem, args,
                          static_cast<cudaStream_t>(stream));
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
  if (err == cudaSuccess) err = rnn::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int R = w.rows, ug = w.unit_groups;
  void* args[] = {&zrc,   &hs,  &h0, &mask, &w_hzr, &w_hc, &dhs, &dh_last,
                  &dproj, &dh0, &T,  &B,    &H,     &R,    &ug,  &reverse};
  err = rnn::launch(rnn::pick_kernel(w, (H & 3) == 0, BwdKernel{}), w.blocks, w.smem, args,
                    st);
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(zrc, hs, h0, mask, dproj, dwzr, dwc, db, T, B, H, reverse);
  rnn::dw_prepare(&a, scratch, sms);
  return (int)gru_dw_launch(a, sms, st);
}
