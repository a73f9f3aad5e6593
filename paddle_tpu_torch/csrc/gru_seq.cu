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
//   * Recurrence: one persistent cooperative launch (all blocks resident,
//     cudaLaunchCooperativeKernel) whose block j owns kUnits hidden units
//     and keeps ITS columns of W_zr and W_c (the rows of W^T for the
//     backward) in shared memory for the whole sequence: W is read from
//     device memory once, not once per step. A step needs all of h (and
//     of r*h, of the gate cotangents), so each phase stages the whole
//     [B, H] operand from L2 through shared memory in 64-wide k tiles, and
//     blocks meet at grid.sync() between phases (two per step). Operands
//     written by other blocks during the launch are read with __ldcg
//     (L2, never a stale L1 line).
//   * Forward, per step: z and r of the block's units for all B rows (one
//     thread per (row, gate)), r*h to a [B, H] scratch; sync; the candidate
//     from the staged r*h and the masked update; sync.
//   * Backward, per step (reverse walk): the elementwise cotangents of the
//     block's units, dgc and dgz to a double-buffered scratch; sync;
//     d(r*h) = dgc W_c^T and dgr; sync; dh_prev = dht (1-z) + d(r*h) r +
//     dgzr W_zr^T + (1-m) dh, kept per block in shared memory. The scratch
//     alternates between two buffers by step, so no third sync is needed.
//   * dW_zr, dW_c and db are sums over all T*B rows. The TPU kernel keeps
//     them in VMEM across its grid; here the recurrent walk only writes
//     dproj, and after it a tiled reduction kernel (64x64 output tiles, a
//     4x4 register tile per thread) computes h_prev^T dproj_zr and
//     (r*h_prev)^T dproj_c over the [T*B]-deep row axis, reading h_prev
//     from hs/h0 and r from zrc, and a column-sum kernel computes db. All
//     three kernels launch from the one backward entry point.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 4;                 // hidden units per recurrence block
constexpr int kThreads = 256;             // recurrence block size
constexpr int kKT = 64;                   // k per staged tile
constexpr int kTileLd = kKT + 1;          // padded tile row (no bank conflicts)
constexpr int kTile = 64;                 // dW output tile
constexpr int kDepth = 16;                // rows of the T*B axis per dW stage

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

__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* zrc, const float* hs, const float* h0, const float* mask,
               const float* w_hzr, const float* w_hc, const float* dhs,
               const float* dh_last, float* dproj, float* dh0, float* scratch,
               int T, int B, int H, int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H2 = 2 * H, H3 = 3 * H;
  const int u0 = blockIdx.x * kUnits;
  const int nu = min(kUnits, H - u0);
  float* wc_t = smem;                       // [H][kUnits]:  W_c[n, k]
  float* wzr_t = wc_t + H * kUnits;         // [2H][kUnits]: W_zr[n, j]
  float* dh_c = wzr_t + H2 * kUnits;        // [B][kUnits] running dh carry
  float* dh_f = dh_c + B * kUnits;          // [B][kUnits] dh of the step
  float* drh_s = dh_f + B * kUnits;         // [B][kUnits] d(r*h)
  float* tile = drh_s + B * kUnits;         // [kThreads][kTileLd]
  // double-buffered cross-block operands: dgc [2][B][H], dgzr [2][B][2H]
  float* dgc_g = scratch;
  float* dzr_g = scratch + (size_t)2 * B * H;

  for (int i = threadIdx.x; i < 3 * H * kUnits; i += kThreads) {
    const int j = i % kUnits, k = i / kUnits;  // k < H: W_c; else W_zr row
    float w = 0.f;
    if (j < nu) {
      const int n = u0 + j;
      w = k < H ? w_hc[(size_t)n * H + k] : w_hzr[(size_t)n * H2 + (k - H)];
    }
    wc_t[i] = w;  // wc_t and wzr_t are contiguous
  }
  // dh_last folds into the first step of the reverse walk (the TPU kernel
  // adds it to dhs[-1])
  for (int i = threadIdx.x; i < B * kUnits; i += kThreads) {
    const int b = i / kUnits, j = i % kUnits;
    dh_c[i] = j < nu ? dh_last[(size_t)b * H + u0 + j] : 0.f;
  }
  __syncthreads();

  for (int s = T - 1; s >= 0; --s) {
    const int t = time_of(s, T, reverse);
    const float* hp = h_prev_of(hs, h0, t, T, B, H, reverse);
    float* dgc_p = dgc_g + (size_t)(s & 1) * B * H;
    float* dzr_p = dzr_g + (size_t)(s & 1) * B * H2;
    // A: elementwise cotangents of the block's units
    for (int i = threadIdx.x; i < B * kUnits; i += kThreads) {
      const int b = i / kUnits, j = i % kUnits;
      if (j >= nu) continue;
      const int n = u0 + j;
      const size_t row = (size_t)t * B + b;
      const float h_prev = hp[(size_t)b * H + n];
      const float z = zrc[row * H3 + n];
      const float c = zrc[row * H3 + H2 + n];
      const float dh = dh_c[i] + dhs[row * H + n];
      const float dht = mask[row] * dh;
      const float dz = dht * (c - h_prev);
      const float dc = dht * z;
      const float dgc = dc * (1.f - c * c);
      const float dgz = dz * z * (1.f - z);
      dh_f[i] = dh;
      dgc_p[(size_t)b * H + n] = dgc;
      dzr_p[(size_t)b * H2 + n] = dgz;
      dproj[row * H3 + n] = dgz;
      dproj[row * H3 + H2 + n] = dgc;
    }
    grid.sync();
    // B: d(r*h)[b, n] = sum_k dgc[b, k] W_c[n, k], then the reset gate
    for (int b0 = 0; b0 < B; b0 += kThreads) {
      const int b = b0 + threadIdx.x;
      float acc[kUnits];
      row_times_w(acc, tile, dgc_p, H, H, wc_t, b0, kThreads, B);
      if (b < B) {
        const size_t row = (size_t)t * B + b;
        for (int j = 0; j < nu; ++j) {
          const int n = u0 + j;
          const float rg = zrc[row * H3 + H + n];
          const float dgr = acc[j] * hp[(size_t)b * H + n] * rg * (1.f - rg);
          drh_s[b * kUnits + j] = acc[j];
          dzr_p[(size_t)b * H2 + H + n] = dgr;
          dproj[row * H3 + H + n] = dgr;
        }
      }
    }
    grid.sync();
    // C: dh_prev = dht (1-z) + d(r*h) r + sum_j dgzr[b, j] W_zr[n, j] + (1-m) dh
    for (int b0 = 0; b0 < B; b0 += kThreads) {
      const int b = b0 + threadIdx.x;
      float acc[kUnits];
      row_times_w(acc, tile, dzr_p, H2, H2, wzr_t, b0, kThreads, B);
      if (b < B) {
        const size_t row = (size_t)t * B + b;
        const float m = mask[row];
        for (int j = 0; j < nu; ++j) {
          const int n = u0 + j;
          const float dh = dh_f[b * kUnits + j];
          const float dht = m * dh;
          const float z = zrc[row * H3 + n];
          const float rg = zrc[row * H3 + H + n];
          dh_c[b * kUnits + j] =
              dht * (1.f - z) + drh_s[b * kUnits + j] * rg + acc[j] + (1.f - m) * dh;
        }
      }
    }
    __syncthreads();  // the next step's A reads dh_c by another mapping
  }
  for (int i = threadIdx.x; i < B * kUnits; i += kThreads) {
    const int j = i % kUnits;
    if (j < nu) dh0[(size_t)(i / kUnits) * H + u0 + j] = dh_c[i];
  }
}

// dW over the [T*B]-deep row axis. blockIdx.z = 0: dW_zr [H, 2H] =
// h_prev^T dproj[:, :2H]; blockIdx.z = 1: dW_c [H, H] = (r*h_prev)^T
// dproj[:, 2H:]. One 64x64 output tile per block, 256 threads, 4x4 each.
__global__ void __launch_bounds__(256)
gru_dw_kernel(const float* __restrict__ zrc, const float* __restrict__ hs,
              const float* __restrict__ h0, const float* __restrict__ dproj,
              float* __restrict__ dwzr, float* __restrict__ dwc,
              int T, int B, int H, int reverse) {
  const int which = blockIdx.z;
  const int ncols = which == 0 ? 2 * H : H;
  const int col_off = which == 0 ? 0 : 2 * H;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  if (n0 >= ncols) return;  // the dW_c grid is narrower
  float* out = which == 0 ? dwzr : dwc;
  const int H3 = 3 * H;
  const int n_rows = T * B;

  __shared__ __align__(16) float a_s[kDepth][kTile];
  __shared__ __align__(16) float b_s[kDepth][kTile];
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  float acc[4][4] = {};

  for (int base = 0; base < n_rows; base += kDepth) {
    // stage kDepth rows of A (h_prev or r*h_prev) and of B (dproj)
    for (int i = threadIdx.x; i < kDepth * kTile; i += 256) {
      const int kk = i / kTile, c = i % kTile;
      const int row = base + kk;
      float a = 0.f, b = 0.f;
      if (row < n_rows) {
        const int t = row / B, bb = row % B;
        const int m = m0 + c;
        if (m < H) {
          a = h_prev_of(hs, h0, t, T, B, H, reverse)[(size_t)bb * H + m];
          if (which == 1) a *= zrc[(size_t)row * H3 + H + m];
        }
        const int n = n0 + c;
        if (n < ncols) b = dproj[(size_t)row * H3 + col_off + n];
      }
      a_s[kk][c] = a;
      b_s[kk][c] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < ncols) out[(size_t)m * ncols + n] = acc[i][j];
    }
  }
}

// db[j] = sum over the T*B rows of dproj[:, j]: 32 columns per block, 32
// row lanes, a shared-memory sum over the lanes
__global__ void __launch_bounds__(1024)
gru_db_kernel(const float* __restrict__ dproj, float* __restrict__ db,
              int n_rows, int H3) {
  __shared__ float part[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (col < H3) {
    for (int row = threadIdx.y; row < n_rows; row += 32) {
      acc += dproj[(size_t)row * H3 + col];
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < H3) {
    float s = 0.f;
    for (int y = 0; y < 32; ++y) s += part[y][threadIdx.x];
    db[col] = s;
  }
}

bool bad_shape(int T, int B, int H) {
  return T <= 0 || B <= 0 || H <= 0 || (size_t)T * B * 3 * H >= (size_t)1 << 31;
}

// dynamic shared memory above 48 KB must be opted into per kernel
cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t tile_bytes() { return (size_t)kThreads * kTileLd * sizeof(float); }

}  // namespace

// Plain C entry points (bound with ctypes). They launch on `stream`, do not
// synchronise, and return the first CUDA error (a cooperative grid that
// cannot be co-resident is refused with cudaErrorCooperativeLaunchTooLarge,
// never run). Scratch buffers come from the caller: rh [B, H] for the
// forward, 6 * B * H floats for the backward.

extern "C" int gru_seq_fwd_f32(const float* proj, const float* mask, const float* w_hzr,
                               const float* w_hc, const float* bias, const float* h0,
                               float* hs, float* zrc, float* rh, int T, int B, int H,
                               int reverse, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * H + B) * kUnits * sizeof(float) + tile_bytes();
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
  const size_t smem = (size_t)(3 * H + 3 * B) * kUnits * sizeof(float) + tile_bytes();
  cudaError_t err = set_smem((const void*)gru_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&zrc, &hs, &h0, &mask, &w_hzr, &w_hc, &dhs, &dh_last, &dproj,
                  &dh0, &scratch, &T, &B, &H, &reverse};
  err = cudaLaunchCooperativeKernel((const void*)gru_bwd_kernel,
                                    dim3((H + kUnits - 1) / kUnits), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 dw_grid((2 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile, 2);
  gru_dw_kernel<<<dw_grid, 256, 0, st>>>(zrc, hs, h0, dproj, dwzr, dwc, T, B, H, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gru_db_kernel<<<(3 * H + 31) / 32, dim3(32, 32), 0, st>>>(dproj, db, T * B, 3 * H);
  return (int)cudaGetLastError();
}
