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
//   * Forward: one persistent cooperative launch (all blocks resident,
//     cudaLaunchCooperativeKernel) whose block j owns U hidden units. U is
//     the smallest power of two that keeps the grid within one block per
//     SM (U=2 at H=256, U=4 at H=512 on 132 SMs). The block keeps its
//     units' 4 gate columns of W in shared memory for the whole sequence
//     — 32 KB at H=512 — and its units' cell state on chip.
//     Where that slice does not fit beside the staging tile (H=1280:
//     U=16, 327 KB), the block stages it through shared memory per k tile
//     with the operand it multiplies (W then comes from L2 every step).
//   * Forward, per step: all of h_{t-1} (hs[t-1] is the exchange buffer)
//     is staged from L2 in k tiles (128 wide at U >= 4), each tile's loads
//     issued at once into registers while the previous tile is computed;
//     thread (row, unit) forms the unit's four gate sums, the cell update
//     and the masked outputs; then ONE grid.sync() (the GRU needs two, for
//     r*h).
//   * Backward walk (reverse): bounded by the operand it
//     re-reads every step and by shared-memory loads per FMA. Block (row
//     group, unit group) owns R rows x U units (U and R from the SM count
//     and shared memory: 4 row groups of 32 rows x 32 groups of 16 units
//     at B=128, H=512), keeps its units' W rows resident (128 KB; staged
//     per k tile where they do not fit, as at H=1280) and its cells' dh
//     and dc carries. Per step: the elementwise cotangents of its cells to
//     dproj[t]; ONE grid.sync(); then dh_prev of its cells = dproj[t] W^T
//     over the valid rows of its row group only (rnn_walk.cuh: cp.async
//     ring, register tiles, masked rows skipped, since their dproj is
//     exactly zero and their carries pass through). A block reads R rows
//     of dproj[t], not B: a quarter of the old L2 traffic at B=128.
//   * dW = h_prev^T dproj over the T*B rows and db (the TPU kernel's VMEM
//     sums) come from the shared split-K f32 GEMM of rnn_reduce.cuh (128 x
//     128 tiles, 8x8 per thread, a deterministic second pass over the
//     splits, db folded in), launched from the same entry point.
//   * What still bounds the forward (PERF.md): each FMA of its recurrent
//     product needs about a third of a 16-byte shared-memory load (a
//     thread computes one row of one unit), and a grid sync per step: at
//     H=512 its time per step hardly changes from B=8 to B=128
//     (chip_smoke.py's `fwd_kernel_ms_by_batch`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_reduce.cuh"
#include "rnn_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;             // forward block size
// k per staged tile, so that a tile (kThreads / U rows x k) holds 8 float4
// per thread in flight: 128 for U >= 4, 64 for U = 2, 32 for U = 1. Fewer,
// wider tiles mean fewer round trips between loads and compute per step.
__host__ __device__ constexpr int tile_k(int U) { return U >= 4 ? 128 : 32 * U; }
// a staged tile's row stride: 16-byte rows, and 8 rows of float4 hit 32 banks
__host__ __device__ constexpr int tile_ld(int kt) { return kt + 4; }

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
  const int Hp = rnn::round_up(H, KT);
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
  const int ldw = rnn::res_ld(H4);
  const int u0 = (blockIdx.x % unit_groups) * U, nu = min(U, H - u0);
  const int b0 = (blockIdx.x / unit_groups) * R, nr = min(R, B - b0);
  float* w_s = smem;                                            // [U][ldw] if kResW
  float* ring = w_s + (kResW ? U * ldw : 0);
  float* part = ring + rnn::kStages * rnn::stage_floats(U, R, kResW);
  float* dh_c = part + rnn::kWalkThreads * rnn::kTR * rnn::kTU;  // [R][U] dh carry
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
    rnn::group_product<U, kResW, true>(
        rows_s, nv, dproj + (size_t)t * B * H4, H4, H4, w_s, ldw, w_hh, H4, u0, nu, R, ring,
        part, [&](int r, int j, float acc) { dh_c[(rows_s[r] - b0) * U + j] += acc; });
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

// How the forward recurrence is laid out for (H, B) on this device.
struct Plan {
  int units;        // hidden units per block (a power of two, <= 16)
  int blocks;       // ceil(H / units) <= the SM count: one block per SM
  bool smem_w;      // W slice in shared memory (else read through L1/L2)
  size_t fwd_smem;  // dynamic shared memory of the launch
};

size_t fwd_smem_bytes(int U, int H, int B, bool smem_w) {
  const int kt = tile_k(U);
  const size_t w = (size_t)(smem_w ? rnn::round_up(H, kt) : kt) * U * 4;
  return (w + (size_t)(kThreads / U) * tile_ld(kt) + (size_t)B * U) * sizeof(float);
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

cudaError_t make_plan(int H, int B, Plan* p) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  for (int U = 1; U <= 16; U *= 2) {
    const int blocks = (H + U - 1) / U;
    if (blocks > sms) continue;
    const bool smem_w = fwd_smem_bytes(U, H, B, true) <= rnn::kSmemMax;
    p->units = U;
    p->blocks = blocks;
    p->smem_w = smem_w;
    p->fwd_smem = fwd_smem_bytes(U, H, B, smem_w);
    if (p->fwd_smem > rnn::kSmemMax) return cudaErrorInvalidValue;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;  // H > 16 units x the SM count
}

// The backward walk's layout: dh and dc carries per cell, the mask and the
// valid-row list per row
cudaError_t make_bwd_plan(int H, int B, rnn::WalkPlan* p) {
  return rnn::make_walk_plan(H, B, rnn::res_ld(4 * H), 2, 2, p);
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

// dynamic shared memory above 48 KB must be opted into per kernel
cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch(const void* fn, int blocks, int threads, size_t smem, void** args,
                   cudaStream_t st) {
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int U>
const void* fwd_fn(bool smem_w) {
  return smem_w ? (const void*)lstm_fwd_kernel<U, true> : (const void*)lstm_fwd_kernel<U, false>;
}

const void* pick_fwd(const Plan& p) {
  switch (p.units) {
    case 1: return fwd_fn<1>(p.smem_w);
    case 2: return fwd_fn<2>(p.smem_w);
    case 4: return fwd_fn<4>(p.smem_w);
    case 8: return fwd_fn<8>(p.smem_w);
    default: return fwd_fn<16>(p.smem_w);
  }
}

template <int U>
const void* bwd_fn(bool w_res) {
  return w_res ? (const void*)lstm_bwd_kernel<U, true> : (const void*)lstm_bwd_kernel<U, false>;
}

const void* pick_bwd(const rnn::WalkPlan& p) {
  switch (p.units) {
    case 4: return bwd_fn<4>(p.w_res);
    case 8: return bwd_fn<8>(p.w_res);
    case 16: return bwd_fn<16>(p.w_res);
    default: return bwd_fn<32>(p.w_res);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). They launch on `stream`, do not
// synchronise, and return the first CUDA error: a shape the plan cannot lay
// out is cudaErrorInvalidValue, and a cooperative grid that cannot be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge), never run.

// The layouts chosen for (T, B, H), into out[10]: the forward's units per
// block, blocks and W in shared memory (1) or read through L1/L2 (0); the
// backward walk's units per block, row groups, rows per group, blocks and
// W resident (1) or staged per k tile (0); the dW reduction's splits of
// the T*B rows; and the floats of scratch the backward entry point takes.
extern "C" int lstm_seq_plan(int T, int B, int H, long long* out) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  Plan p;
  rnn::WalkPlan w;
  int sms = 0;
  cudaError_t err = make_plan(H, B, &p);
  if (err == cudaSuccess) err = make_bwd_plan(H, B, &w);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, T, B, H, 0);
  const size_t scratch = rnn::dw_prepare(&a, nullptr, sms);
  const long long v[10] = {p.units, p.blocks, p.smem_w, w.units,  w.row_groups,
                           w.rows,  w.blocks, w.w_res,  a.splits, (long long)scratch};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
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
  return (int)launch(pick_fwd(p), p.blocks, kThreads, p.fwd_smem, args,
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
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int R = w.rows, ug = w.unit_groups;
  void* args[] = {&gates, &ct,  &cs,  &c0, &mask, &w_hh, &dhs, &dh_last, &dc_last,
                  &dproj, &dh0, &dc0, &T,  &B,    &H,    &R,   &ug,      &reverse};
  err = launch(pick_bwd(w), w.blocks, rnn::kWalkThreads, w.smem, args, st);
  if (err != cudaSuccess) return (int)err;
  rnn::DwArgs a = dw_args(hs, h0, mask, dproj, dw, db, T, B, H, reverse);
  rnn::dw_prepare(&a, scratch, sms);
  return (int)lstm_dw_launch(a, sms, st);
}
