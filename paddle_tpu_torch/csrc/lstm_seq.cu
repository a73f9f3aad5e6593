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
// the backward's residuals, as the TPU kernel saves them, for every row,
// masked or not. Backward takes them with h0, c0, the mask, W, dhs
// [T,B,H], dh_last and dc_last [B,H] and writes dproj [T,B,4H], dW [H,4H],
// db [4H], dh0 and dc0. `reverse` walks time T-1 .. 0 with every array in
// original time order, which equals the JAX package's flip-run-flip
// (_run_fused, paddle_tpu/ops/rnn.py:55).
//
// Bound: operations. At the text-classification shape (T=100, B=128,
// H=512) the forward does 2*T*B*H*4H = 26.8 GFLOP (0.40 ms at 67 TFLOP/s
// f32) on ~0.3 GB of reads and writes (0.09 ms at 3.35 TB/s); the backward
// twice the operations (0.80 ms). But the recurrence is serial: step t+1
// needs all of h_t. The TPU runs its grid over T in order with h, c and W
// in VMEM; Hopper's blocks run in no order, and W (4 MB at H=512) does not
// fit in one block's 227 KB of shared memory.
//
// Design: both directions are one persistent cooperative launch each (all
// blocks resident, cudaLaunchCooperativeKernel) whose block (row group,
// unit group) owns R rows x U units, laid out by rnn::make_walk_plan from
// the SM count and shared memory (4 row groups of 32 rows x 32 groups of
// 16 units at B=128, H=512; 3 of 22 rows x 40 of 32 units at B=64,
// H=1280). Both run their recurrent product through rnn_walk.cuh's
// group_product (cp.async ring, 4 x 4 register tiles fed from shared
// memory, k slices summed in a fixed order), so a block reads R rows of
// the operand per step, not B.
//   * Forward: the block keeps its units' 4 gate columns of W resident in
//     shared memory, transposed to rows [4U][K] (128 KB at H=512; staged
//     per 128-wide k tile with the operand where they do not fit, as at
//     H=1280), and its cells' h and c. Per step: the recurrent sums
//     h_{t-1}[rows] W[:, block's columns] (hs[t-1] is the exchange buffer)
//     into a small shared buffer, for the rows of the group that were
//     valid at the step before only: a masked step carries h through, so
//     a row's sums stay those of its h until it is valid again (rows >= B
//     are never computed); then one pass per (row, unit) over every row:
//     activations, cell update, mask and every store; ONE grid.sync(). The
//     cells' proj and mask for the next step are fetched into registers
//     before the sync. What bounds it on the card (PERF.md): the product,
//     at about a third of the peak f32 FMA rate; the grid sync takes ~7 %
//     of a step.
//   * Backward walk (reverse): per step, the elementwise cotangents of the
//     block's cells to dproj[t]; ONE grid.sync(); then dh_prev of its
//     cells = dproj[t] W^T over the valid rows of its row group only
//     (masked rows skipped, since their dproj is exactly zero and their
//     carries pass through). The units' W rows stay resident (staged per
//     256-wide k tile where they do not fit), and so do the dh and dc
//     carries.
//   * dW = h_prev^T dproj over the T*B rows and db (the TPU kernel's VMEM
//     sums) come from the shared split-K f32 GEMM of rnn_reduce.cuh (128 x
//     128 tiles, 8x8 per thread, a deterministic second pass over the
//     splits, db folded in), launched from the same entry point.

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

// state before original time t: x0 at the first processed step, else the
// state written by the step processed just before ([B, H] rows)
__device__ __forceinline__ const float* prev_of(const float* seq, const float* x0, int t,
                                                int T, int B, int H, int reverse) {
  const bool first = reverse ? (t == T - 1) : (t == 0);
  if (first) return x0;
  return seq + (size_t)(reverse ? t + 1 : t - 1) * B * H;
}

// One cell's inputs to the forward's epilogue: proj of its four gates and
// the row's mask. Neither depends on the product, so the forward fetches
// them a step ahead.
struct FwdIn {
  float p[4], m;
};

__device__ __forceinline__ FwdIn load_fwd_in(const float* proj, const float* mask, int t,
                                             int b, int n, int B, int H) {
  const size_t row = (size_t)t * B + b;
  const float* p = proj + row * 4 * H + n;
  return FwdIn{{p[0], p[H], p[2 * H], p[3 * H]}, mask[row]};
}

// cells per thread whose inputs are fetched a step ahead (the rest, at
// larger R x U, when the step needs them)
constexpr int kFwdAhead = 4;

// The forward. Block (rg, ug) owns rows [b0, b0 + R) and units [u0, u0 +
// U): their h and c stay in shared memory, and so do the units' gate
// columns of W, as rows c = g * U + j (else they are staged per k tile,
// kResW false). Per step: the recurrent gate sums of the block's cells =
// h_{t-1} W over the group's rows that were valid at the step before
// (rnn_walk.cuh), then the cell update of each (row, unit), then one
// grid.sync(). kVec: H a multiple of 4 (16-byte copies of h).
template <int U, bool kResW, bool kVec>
__global__ void __launch_bounds__(rnn::kWalkThreads, 1)
lstm_fwd_kernel(const float* proj, const float* mask, const float* w_hh, const float* bias,
                const float* h0, const float* c0, float* hs, float* gates, float* ct,
                float* cs, int T, int B, int H, int R, int unit_groups, int reverse) {
  constexpr int N = 4 * U;  // product columns: the units' i, f, c, o gates
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int ldw = rnn::res_ld(H, rnn::kFwdKT);
  const int u0 = (blockIdx.x % unit_groups) * U, nu = min(U, H - u0);
  const int b0 = (blockIdx.x / unit_groups) * R, nr = min(R, B - b0);
  float* w_s = smem;                                                 // [N][ldw] if kResW
  float* ring = w_s + (kResW ? N * ldw : 0);
  float* part = ring + rnn::kStages * rnn::stage_floats(N, R, kResW, rnn::kFwdKT);
  float* pre = part + rnn::kPartFloats;                              // [R][N] gate sums
  float* h_c = pre + R * N;                                          // [R][U] h of the cells
  float* c_c = h_c + R * U;                                          // [R][U] c of the cells
  int* rows_s = reinterpret_cast<int*>(c_c + R * U);                 // [2][R] rows to compute
  int* nv_s = rows_s + 2 * R;                                        // [2] their counts

  if (kResW) rnn::load_cols<U>(w_s, ldw, N, w_hh, H4, H, u0, nu, H);
  for (int i = threadIdx.x; i < R * U; i += rnn::kWalkThreads) {
    const int r = i / U, j = i % U;
    const bool v = r < nr && j < nu;
    h_c[i] = v ? h0[(size_t)(b0 + r) * H + u0 + j] : 0.f;
    c_c[i] = v ? c0[(size_t)(b0 + r) * H + u0 + j] : 0.f;
  }
  for (int r = threadIdx.x; r < nr; r += rnn::kWalkThreads) rows_s[r] = b0 + r;
  if (threadIdx.x == 0) nv_s[0] = nr;

  // every cell i = threadIdx.x + k * kWalkThreads of this thread has unit j
  const int j = threadIdx.x % U, n = u0 + min(j, nu - 1);
  const bool owns = j < nu;
  const float bi = bias[n], bf = bias[H + n], bg = bias[2 * H + n], bo = bias[3 * H + n];
  FwdIn ahead[kFwdAhead] = {};
  auto fetch = [&](int t) {
#pragma unroll
    for (int k = 0; k < kFwdAhead; ++k) {
      const int i = threadIdx.x + k * rnn::kWalkThreads;
      if (owns && i < nr * U) ahead[k] = load_fwd_in(proj, mask, t, b0 + i / U, n, B, H);
    }
  };
  auto cell = [&](int t, int i, const FwdIn& v) {
    const float* a = pre + (i / U) * N + j;
    const float ig = sigmoidf_(v.p[0] + bi + a[0]);
    const float fg = sigmoidf_(v.p[1] + bf + a[U]);
    const float gg = tanhf(v.p[2] + bg + a[2 * U]);
    const float og = sigmoidf_(v.p[3] + bo + a[3 * U]);
    const float c_prev = c_c[i], h_prev = h_c[i];
    const float c_t = fg * c_prev + ig * gg;
    const float h_t = og * tanhf(c_t);
    const size_t row = (size_t)t * B + b0 + i / U;
    float* gr = gates + row * H4;
    gr[n] = ig;
    gr[H + n] = fg;
    gr[2 * H + n] = gg;
    gr[3 * H + n] = og;
    ct[row * H + n] = c_t;
    const float c_new = v.m * c_t + (1.f - v.m) * c_prev;
    const float h_new = v.m * h_t + (1.f - v.m) * h_prev;
    cs[row * H + n] = c_new;
    hs[row * H + n] = h_new;
    c_c[i] = c_new;
    h_c[i] = h_new;
  };
  fetch(time_of(0, T, reverse));
  __syncthreads();  // W, the cells' state and the row list in place

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s, T, reverse);
    // the gate sums of the block's cells, h_{t-1}[rows] W[:, columns], for
    // the rows valid at the step before (all at the first): a masked step
    // carries h through, so the other rows' sums in `pre` still hold
    const int* rows = rows_s + (s & 1) * R;
    rnn::group_product<N, rnn::kFwdKT, kResW, kVec>(
        rows, nv_s[s & 1], prev_of(hs, h0, t, T, B, H, reverse), H, H, w_s, ldw,
        [&](float* dst, int k0) {
          rnn::stage_cols<rnn::kFwdKT, N, U>(dst, w_hh, H4, H, u0, nu, k0, H);
        },
        R, ring, part, [&](int r, int c, float acc) { pre[(rows[r] - b0) * N + c] = acc; });
    // the next step's rows, into the other list (read last before the
    // previous grid sync): those valid at this step
    if (s + 1 < T && threadIdx.x < 32)
      rnn::compact_rows(mask + (size_t)t * B + b0, b0, nr, rows_s + ((s + 1) & 1) * R,
                        nv_s + ((s + 1) & 1));
    if (owns) {
#pragma unroll
      for (int k = 0; k < kFwdAhead; ++k) {
        const int i = threadIdx.x + k * rnn::kWalkThreads;
        if (i < nr * U) cell(t, i, ahead[k]);
      }
      for (int i = threadIdx.x + kFwdAhead * rnn::kWalkThreads; i < nr * U;
           i += rnn::kWalkThreads)
        cell(t, i, load_fwd_in(proj, mask, t, b0 + i / U, n, B, H));
    }
    if (s + 1 < T) {
      fetch(time_of(s + 1, T, reverse));  // in flight during the sync
      grid.sync();
    }
  }
}

// One cell's inputs to the backward's elementwise step: the gates, c~,
// c_prev and dhs of (t, b, n). None is written by the walk, so the walk
// fetches them a step ahead.
struct CellIn {
  float ig, fg, gg, og, ct, cp, dhs;
};

__device__ __forceinline__ CellIn load_cell(const float* gates, const float* ct,
                                            const float* cs, const float* c0, const float* dhs,
                                            int t, int b, int n, int T, int B, int H,
                                            int reverse) {
  const size_t row = (size_t)t * B + b;
  const float* g = gates + row * 4 * H;
  const float* cp = prev_of(cs, c0, t, T, B, H, reverse);
  return CellIn{g[n], g[H + n], g[2 * H + n], g[3 * H + n], ct[row * H + n],
                cp[(size_t)b * H + n], dhs[row * H + n]};
}

// cells per thread whose inputs are fetched a step ahead (the rest, at
// larger R x U, when the step needs them)
constexpr int kAhead = 2;

// The backward walk. Block (rg, ug) owns rows [b0, b0 + R) and units
// [u0, u0 + U): their dh and dc carries stay in shared memory, and so do
// the units' rows of W (or they are staged per k tile, kResW false).
// Per step: A, the elementwise cotangents of the block's (rows, units) to
// dproj[t] and the carries; one grid.sync(); B, dh_prev of the same cells
// = dproj[t] W^T over the valid rows of the row group (rnn_walk.cuh) +
// (1-m) dh.
template <int U, bool kResW>
__global__ void __launch_bounds__(rnn::kWalkThreads, 1)
lstm_bwd_kernel(const float* gates, const float* ct, const float* cs, const float* c0,
                const float* mask, const float* w_hh, const float* dhs, const float* dh_last,
                const float* dc_last, float* dproj, float* dh0, float* dc0, int T, int B,
                int H, int R, int unit_groups, int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int ldw = rnn::res_ld(H4, rnn::kKT);
  const int u0 = (blockIdx.x % unit_groups) * U, nu = min(U, H - u0);
  const int b0 = (blockIdx.x / unit_groups) * R, nr = min(R, B - b0);
  float* w_s = smem;                                            // [U][ldw] if kResW
  float* ring = w_s + (kResW ? U * ldw : 0);
  float* part = ring + rnn::kStages * rnn::stage_floats(U, R, kResW, rnn::kKT);
  float* dh_c = part + rnn::kPartFloats;                        // [R][U] dh carry
  float* dc_c = dh_c + R * U;                                   // [R][U] dc carry
  float* m_s = dc_c + R * U;                                    // [R] mask of the step
  int* rows_s = reinterpret_cast<int*>(m_s + R);                // [R] valid rows
  int* nv_s = rows_s + R;

  if (kResW) {
    for (int i = threadIdx.x; i < U * ldw; i += rnn::kWalkThreads) {
      const int j = i / ldw, k = i % ldw;
      w_s[i] = j < nu && k < H4 ? w_hh[(size_t)(u0 + j) * H4 + k] : 0.f;
    }
  }
  // dh_last and dc_last are the carries into the first step of the walk
  // (the TPU kernel adds dh_last to dhs[-1] and starts dc from dc_last)
  for (int i = threadIdx.x; i < R * U; i += rnn::kWalkThreads) {
    const int r = i / U, j = i % U;
    const bool v = r < nr && j < nu;
    dh_c[i] = v ? dh_last[(size_t)(b0 + r) * H + u0 + j] : 0.f;
    dc_c[i] = v ? dc_last[(size_t)(b0 + r) * H + u0 + j] : 0.f;
  }

  // the next step's mask and cell inputs, in registers: their loads are
  // in flight during the grid sync and the product
  CellIn ahead[kAhead] = {};
  float m_ahead = 0.f;
  // A for cell i = (r, j) of the block
  auto cell = [&](int t, int i, const CellIn& v) {
    const int r = i / U, j = i % U;
    if (j >= nu) return;
    const int n = u0 + j;
    const float m = m_s[r];
    const float dh = dh_c[i] + v.dhs;
    const float dc = dc_c[i];
    const float tc = tanhf(v.ct);
    const float dht = m * dh;
    const float dct = m * dc + dht * v.og * (1.f - tc * tc);
    float* dp = dproj + ((size_t)t * B + b0 + r) * H4;
    dp[n] = dct * v.gg * v.ig * (1.f - v.ig);
    dp[H + n] = dct * v.cp * v.fg * (1.f - v.fg);
    dp[2 * H + n] = dct * v.ig * (1.f - v.gg * v.gg);
    dp[3 * H + n] = dht * tc * v.og * (1.f - v.og);
    dc_c[i] = dct * v.fg + (1.f - m) * dc;
    dh_c[i] = (1.f - m) * dh;  // B adds dproj[t] W^T on valid rows
  };
  {
    const int ta = time_of(T - 1, T, reverse);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = threadIdx.x + k * rnn::kWalkThreads, j = i % U;
      if (i < nr * U && j < nu)
        ahead[k] = load_cell(gates, ct, cs, c0, dhs, ta, b0 + i / U, u0 + j, T, B, H, reverse);
    }
    if (threadIdx.x < nr) m_ahead = mask[(size_t)ta * B + b0 + threadIdx.x];
  }

  for (int s = T - 1; s >= 0; --s) {
    const int t = time_of(s, T, reverse);
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
      cell(t, i, load_cell(gates, ct, cs, c0, dhs, t, b0 + i / U, u0 + i % U, T, B, H, reverse));
    if (s > 0) {  // the next step's inputs
      const int ta = time_of(s - 1, T, reverse);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int i = threadIdx.x + k * rnn::kWalkThreads, j = i % U;
        if (i < nr * U && j < nu)
          ahead[k] = load_cell(gates, ct, cs, c0, dhs, ta, b0 + i / U, u0 + j, T, B, H, reverse);
      }
      if (threadIdx.x < nr) m_ahead = mask[(size_t)ta * B + b0 + threadIdx.x];
    }
    grid.sync();
    // B: dh_prev[b, n] += sum_k dproj[t, b, k] W[n, k] over the valid rows
    const int nv = *nv_s;
    rnn::group_product<U, rnn::kKT, kResW, true>(
        rows_s, nv, dproj + (size_t)t * B * H4, H4, H4, w_s, ldw,
        [&](float* dst, int k0) {
          rnn::stage_rows<rnn::kKT, true>(
              dst, U, [&](int j) { return w_hh + (size_t)(u0 + min(j, nu - 1)) * H4; }, k0, H4);
        },
        R, ring, part, [&](int r, int j, float acc) {
          if (j < nu) dh_c[(rows_s[r] - b0) * U + j] += acc;
        });
    __syncthreads();  // (nv == 0) the next step rewrites m_s and rows_s
  }
  for (int i = threadIdx.x; i < nr * U; i += rnn::kWalkThreads) {
    const int r = i / U, j = i % U;
    if (j < nu) {
      dh0[(size_t)(b0 + r) * H + u0 + j] = dh_c[i];
      dc0[(size_t)(b0 + r) * H + u0 + j] = dc_c[i];
    }
  }
}

// dW [H, 4H] and db [4H]: the shared split-K reduction of rnn_reduce.cuh
RNN_DW_KERNELS(lstm_)

// The forward's layout: 4 gate columns of W per unit; gate sums, h and c
// per cell; two row lists per row
cudaError_t make_fwd_plan(int H, int B, rnn::WalkPlan* p) {
  return rnn::make_walk_plan(H, B, 4, rnn::kFwdKT, 4 * rnn::res_ld(H, rnn::kFwdKT), 6, 2, p);
}

// The backward walk's layout: dh and dc carries per cell, the mask and the
// valid-row list per row
cudaError_t make_bwd_plan(int H, int B, rnn::WalkPlan* p) {
  return rnn::make_walk_plan(H, B, 1, rnn::kKT, rnn::res_ld(4 * H, rnn::kKT), 2, 2, p);
}

// dW and db as one reduction problem over the valid (t, b) rows
rnn::DwArgs dw_args(const float* hs, const float* h0, const float* mask, const float* dproj,
                    float* dw, float* db, int T, int B, int H, int reverse) {
  rnn::DwArgs a{};
  a.hs = hs;
  a.h0 = h0;
  a.mask = mask;
  a.T = T;
  a.B = B;
  a.reverse = reverse;
  a.n_problems = 1;
  a.p[0] = rnn::DwProblem{nullptr, 0, dproj, 4 * H, H, 4 * H, dw, db, nullptr};
  return a;
}

bool bad_shape(int T, int B, int H) {
  return T <= 0 || B <= 0 || H <= 0 || (size_t)T * B * 4 * H >= (size_t)1 << 31;
}

// the kernels' instances, for rnn::pick_kernel
struct FwdKernel {
  template <int U, bool kResW, bool kVec>
  const void* operator()(rnn::Inst<U, kResW, kVec>) const {
    return (const void*)lstm_fwd_kernel<U, kResW, kVec>;
  }
};

struct BwdKernel {  // no kVec: 4H is a multiple of 4
  template <int U, bool kResW, bool kVec>
  const void* operator()(rnn::Inst<U, kResW, kVec>) const {
    return (const void*)lstm_bwd_kernel<U, kResW>;
  }
};

}  // namespace

// Plain C entry points (bound with ctypes). They launch on `stream`, do not
// synchronise, and return the first CUDA error: a shape the plan cannot lay
// out is cudaErrorInvalidValue, and a cooperative grid that cannot be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge), never run.

// The layouts chosen for (T, B, H), into out[12]: the forward's units per
// block, row groups, rows per group, blocks and W resident (1) or staged
// per k tile (0); the same five for the backward walk; the dW reduction's
// splits of the T*B rows; and the floats of scratch the backward entry
// point takes.
extern "C" int lstm_seq_plan(int T, int B, int H, long long* out) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan f, w;
  int sms = 0;
  cudaError_t err = make_fwd_plan(H, B, &f);
  if (err == cudaSuccess) err = make_bwd_plan(H, B, &w);
  if (err == cudaSuccess) err = rnn::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, T, B, H, 0);
  const size_t scratch = rnn::dw_prepare(&a, nullptr, sms);
  const long long v[12] = {f.units,  f.row_groups, f.rows,   f.blocks,   f.w_res,
                           w.units,  w.row_groups, w.rows,   w.blocks,   w.w_res,
                           a.splits, (long long)scratch};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

extern "C" int lstm_seq_fwd_f32(const float* proj, const float* mask, const float* w_hh,
                                const float* bias, const float* h0, const float* c0,
                                float* hs, float* gates, float* ct, float* cs, int T, int B,
                                int H, int reverse, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan p;
  cudaError_t err = make_fwd_plan(H, B, &p);
  if (err != cudaSuccess) return (int)err;
  int R = p.rows, ug = p.unit_groups;
  void* args[] = {&proj, &mask, &w_hh, &bias, &h0, &c0, &hs, &gates, &ct,
                  &cs,   &T,    &B,    &H,    &R,  &ug, &reverse};
  return (int)rnn::launch(rnn::pick_kernel(p, (H & 3) == 0, FwdKernel{}), p.blocks, p.smem,
                          args, static_cast<cudaStream_t>(stream));
}

// The forward's step loop with nothing but its grid syncs (one a step),
// at the forward's own grid for (T, B, H): the synchronisation's share of
// a forward step.
extern "C" int lstm_seq_fwd_sync_f32(int T, int B, int H, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan p;
  cudaError_t err = make_fwd_plan(H, B, &p);
  if (err != cudaSuccess) return (int)err;
  int per_step = 1;
  void* args[] = {&T, &per_step};
  return (int)rnn::launch((const void*)rnn::sync_steps_kernel, p.blocks, p.smem, args,
                          static_cast<cudaStream_t>(stream));
}

// `scratch` holds the dW reduction's partial sums and its list of valid
// rows: as many floats as lstm_seq_plan's last number.
extern "C" int lstm_seq_bwd_f32(const float* gates, const float* ct, const float* hs,
                                const float* cs, const float* h0, const float* c0,
                                const float* mask, const float* w_hh, const float* dhs,
                                const float* dh_last, const float* dc_last, float* dproj,
                                float* dw, float* db, float* dh0, float* dc0, float* scratch,
                                int T, int B, int H, int reverse, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  rnn::WalkPlan w;
  int sms = 0;
  cudaError_t err = make_bwd_plan(H, B, &w);
  if (err == cudaSuccess) err = rnn::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int R = w.rows, ug = w.unit_groups;
  void* args[] = {&gates, &ct,  &cs,  &c0, &mask, &w_hh, &dhs, &dh_last, &dc_last,
                  &dproj, &dh0, &dc0, &T,  &B,    &H,    &R,   &ug,      &reverse};
  err = rnn::launch(rnn::pick_kernel(w, true, BwdKernel{}), w.blocks, w.smem, args, st);
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(hs, h0, mask, dproj, dw, db, T, B, H, reverse);
  rnn::dw_prepare(&a, scratch, sms);
  return (int)lstm_dw_launch(a, sms, st);
}
