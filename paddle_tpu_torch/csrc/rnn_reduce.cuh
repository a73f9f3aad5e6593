// The weight and bias gradients of the recurrent backward kernels (LSTM
// and GRU), for Hopper (sm_90a), f32: one split-K GEMM over the T*B rows,
// shared by lstm_seq.cu and gru_seq.cu.
//
//   dW[m, n] = sum_row A[row, m] * D[row, n]      db[n] = sum_row D[row, n]
//
// A is h_prev of each row (h0 at the first processed step, else the state
// written by the step processed before: the TPU kernels carry the same
// sums in VMEM across their grid), times a gate where one is given (the
// GRU's dW_c takes r * h_prev); D is the walk's dproj, already written
// by the time this runs.
//
// What bounds it: f32 operations (LSTM at T=100, B=128, H=512: 26.8
// GFLOP, 0.40 ms at 67 TFLOP/s; its operands, 50 MB, need 15 us). The
// design: 128x128 output tiles, 256 threads with 8x8 outputs each (4
// 16-byte shared loads per 64 FMAs), 32-row k tiles (16 where the GRU's
// gate tile is staged too) through a 3-stage cp.async ring, and split-K
// over the row axis so that one full wave of blocks, two per SM, covers
// the card (at H=512 only 64 tiles of 128x128 exist).
// Each split writes its partial tile; a second pass sums the partials in
// split order, so results repeat bit for bit (no atomics). db is folded in:
// the blocks of the first row of tiles also sum the staged D columns.
// Rows of masked steps hold zeros in D and add nothing, so a first pass
// lists the valid rows (mask != 0, in ascending order) and the product
// walks that list: the work is what the data needs.

#pragma once

#include <cuda_runtime.h>

namespace rnn {

constexpr int kBM = 128, kBN = 128;            // output tile
constexpr int kGStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kMaxProblems = 2;

// One product. A row `row` (= t * B + b) is h_prev of (t, b); `gate`, when
// not null, scales it elementwise by gate[row * gate_ld + m]; D row `row`
// is d + row * ldd. out [M, N] row-major; db [N] or null.
struct DwProblem {
  const float* gate;
  int gate_ld;
  const float* d;
  int ldd;
  int M, N;
  float* out;
  float* db;
  float* part;  // [splits][M * N + N] partial sums
};

struct DwArgs {
  const float* hs;  // [T, B, M] states; h0 [B, M]
  const float* h0;
  const float* mask;  // [T, B]
  int* rows;          // [1 + T * B]: the count of valid rows, then the rows
  int T, B, reverse;
  int splits, rows_per_split;
  int n_problems;
  DwProblem p[kMaxProblems];
};

__host__ __device__ inline int dw_tiles(const DwProblem& p) {
  return ((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
}

inline size_t dw_part_floats(const DwProblem& p, int splits) {
  return (size_t)splits * ((size_t)p.M * p.N + p.N);
}

// Choose the splits (as many blocks as fit one wave at two per SM, each
// split at least 256 rows deep, in whole k tiles) and lay the partials out in
// `scratch` (null: only count). Returns the scratch floats needed.
inline size_t dw_prepare(DwArgs* a, float* scratch, int sms) {
  int tiles = 0;
  for (int i = 0; i < a->n_problems; ++i) tiles += dw_tiles(a->p[i]);
  const int rows = a->T * a->B;
  int s = 2 * sms / tiles;
  const int cap = rows / 256 > 1 ? rows / 256 : 1;
  s = s < cap ? s : cap;
  s = s > 1 ? s : 1;
  const int per = ((rows + s - 1) / s + 31) / 32 * 32;  // whole k tiles
  a->rows_per_split = per;
  a->splits = (rows + per - 1) / per;
  size_t off = 0;
  for (int i = 0; i < a->n_problems; ++i) {
    a->p[i].part = scratch ? scratch + off : nullptr;
    off += dw_part_floats(a->p[i], a->splits);
  }
  a->rows = scratch ? reinterpret_cast<int*>(scratch + off) : nullptr;
  return off + 1 + (size_t)rows;
}

__device__ __forceinline__ void g_cp16(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

// block b of the launch -> (problem, split, tile row, tile column)
template <bool kVec, int kBK>
__device__ __forceinline__ void dw_block(const DwArgs& args, float* smem) {
  constexpr int kTileFloats = kBK * kBM;  // one staged operand tile
  int id = blockIdx.x, pi = 0;
  while (pi + 1 < args.n_problems && id >= dw_tiles(args.p[pi]) * args.splits) {
    id -= dw_tiles(args.p[pi]) * args.splits;
    ++pi;
  }
  const DwProblem& P = args.p[pi];
  const int tn = (P.N + kBN - 1) / kBN;
  const int tiles = dw_tiles(P);
  const int split = id / tiles, tm_i = (id % tiles) / tn, tn_i = id % tn;
  const int m0 = tm_i * kBM, n0 = tn_i * kBN;
  // this split's share of the valid rows (whole k tiles)
  const int n_rows = __ldcg(args.rows);
  const int* row_of = args.rows + 1;
  const int per = (n_rows + args.splits * kBK - 1) / (args.splits * kBK) * kBK;
  const int r0 = split * per;
  const int r1 = min(n_rows, r0 + per);
  const bool gate = P.gate != nullptr;
  const bool fold_db = P.db != nullptr && tm_i == 0;

  float* As = smem;                              // [kGStages][kBK][kBM]
  float* Ds = As + kGStages * kTileFloats;       // [kGStages][kBK][kBN]
  float* Gs = Ds + kGStages * kTileFloats;       // [kGStages][kBK][kBM] (gate)

  const int tid = threadIdx.x;
  // this thread's float4 slots of every staged tile: rows kk0 + 8h
  const int kk0 = tid >> 5, c = (tid & 31) * 4;
  auto a_row = [&](int row) -> const float* {
    const int t = row / args.B, b = row - t * args.B;
    const bool first = args.reverse ? t == args.T - 1 : t == 0;
    return first ? args.h0 + (size_t)b * P.M
                 : args.hs + (size_t)(args.reverse ? row + args.B : row - args.B) * P.M;
  };
  auto load_tile = [&](int kt) {
    const int slot = kt % kGStages;
#pragma unroll
    for (int h = 0; h < kBK / 8; ++h) {
      const int kk = kk0 + 8 * h, i = r0 + kt * kBK + kk;
      const bool rv = i < r1;
      const int rr = rv ? __ldcg(row_of + i) : 0;
      const int m = m0 + c, n = n0 + c;
      const float* ap = a_row(rr) + m;
      const float* dp = P.d + (size_t)rr * P.ldd + n;
      const float* gp = gate ? P.gate + (size_t)rr * P.gate_ld + m : nullptr;
      float* as = As + slot * kTileFloats + kk * kBM + c;
      float* ds = Ds + slot * kTileFloats + kk * kBN + c;
      float* gs = Gs + slot * kTileFloats + kk * kBM + c;
      if (kVec) {
        g_cp16(as, rv && m < P.M ? ap : args.h0, rv && m < P.M);
        g_cp16(ds, rv && n < P.N ? dp : P.d, rv && n < P.N);
        if (gate) g_cp16(gs, rv && m < P.M ? gp : P.gate, rv && m < P.M);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          as[e] = rv && m + e < P.M ? ap[e] : 0.f;
          ds[e] = rv && n + e < P.N ? dp[e] : 0.f;
          if (gate) gs[e] = rv && m + e < P.M ? gp[e] : 0.f;
        }
      }
    }
  };

  const int n_kt = r1 > r0 ? (r1 - r0 + kBK - 1) / kBK : 0;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8] = {};
  float db_acc = 0.f;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < n_kt) load_tile(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kGStages - 2));
    const int slot = kt % kGStages;
    if (gate) {  // A = gate * h_prev, on the slots this thread copied
#pragma unroll
      for (int h = 0; h < kBK / 8; ++h) {
        float4* a4 = reinterpret_cast<float4*>(As + slot * kTileFloats + (kk0 + 8 * h) * kBM + c);
        const float4 g4 = *reinterpret_cast<const float4*>(Gs + slot * kTileFloats +
                                                          (kk0 + 8 * h) * kBM + c);
        float4 v = *a4;
        v.x *= g4.x; v.y *= g4.y; v.z *= g4.z; v.w *= g4.w;
        *a4 = v;
      }
    }
    __syncthreads();  // tile kt landed for all; tile kt-1's slot is free
    if (kt + kGStages - 1 < n_kt) load_tile(kt + kGStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* as = As + slot * kTileFloats;
    const float* ds = Ds + slot * kTileFloats;
    if (fold_db && tid < kBN) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) db_acc += ds[kk * kBN + tid];
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kBM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kBM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ds + kk * kBN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(ds + kk * kBN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* part = P.part + (size_t)split * ((size_t)P.M * P.N + P.N);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= P.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      float* o = part + (size_t)m * P.N + n;
      if (kVec && n + 3 < P.N) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < P.N) o[j] = acc[i][4 * h + j];
      }
    }
  }
  if (fold_db && tid < kBN && n0 + tid < P.N) part[(size_t)P.M * P.N + n0 + tid] = db_acc;
}

// rows[0] = the count of valid rows (mask != 0), rows[1 ..] = those rows
// in ascending order: one block, each thread a contiguous run of the mask
__device__ __forceinline__ void dw_rows(const DwArgs& args) {
  __shared__ int counts[1024];
  const int n = args.T * args.B, per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += args.mask[i] != 0.f;
  counts[threadIdx.x] = c;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off *= 2) {  // inclusive scan
    const int v = threadIdx.x >= off ? counts[threadIdx.x - off] : 0;
    __syncthreads();
    counts[threadIdx.x] += v;
    __syncthreads();
  }
  int at = counts[threadIdx.x] - c;
  for (int i = lo; i < hi; ++i)
    if (args.mask[i] != 0.f) args.rows[1 + at++] = i;
  if (threadIdx.x == blockDim.x - 1) args.rows[0] = counts[threadIdx.x];
}

// out and db = the sum of the splits' partials, in split order
__device__ __forceinline__ void dw_sum(const DwArgs& args) {
  for (int pi = 0; pi < args.n_problems; ++pi) {
    const DwProblem& P = args.p[pi];
    const size_t mn = (size_t)P.M * P.N;
    const size_t n_out = mn + (P.db ? P.N : 0);
    const size_t stride = mn + P.N;
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_out;
         e += (size_t)gridDim.x * blockDim.x) {
      float s = 0.f;
      for (int k = 0; k < args.splits; ++k) s += P.part[k * stride + e];
      if (e < mn) {
        P.out[e] = s;
      } else {
        P.db[e - mn] = s;
      }
    }
  }
}

inline bool dw_gate(const DwArgs& a) {
  for (int i = 0; i < a.n_problems; ++i)
    if (a.p[i].gate != nullptr) return true;
  return false;
}

// k tile depth: 32 rows, or 16 where a gate tile is staged too (two
// blocks per SM either way)
inline int dw_bk(const DwArgs& a) { return dw_gate(a) ? 16 : 32; }

// dynamic shared memory of the product kernel
inline size_t dw_smem(const DwArgs& a) {
  return (size_t)(dw_gate(a) ? 3 : 2) * kGStages * dw_bk(a) * kBM * sizeof(float);
}

inline bool dw_vec(const DwArgs& a) {
  for (int i = 0; i < a.n_problems; ++i) {
    const DwProblem& p = a.p[i];
    if ((p.M | p.N | p.ldd | p.gate_ld) & 3) return false;
  }
  return true;
}

}  // namespace rnn

// Each including source instantiates the three kernels under its own prefix
// (lstm_ or gru_, so that a profile's per-prefix sums find them) with
// RNN_DW_KERNELS(prefix), and launches them with <prefix>dw_launch on
// arguments that dw_prepare has laid out.
#define RNN_DW_KERNELS(prefix)                                                         \
  template <bool kVec, int kBK>                                                        \
  __global__ void __launch_bounds__(rnn::kGemmThreads, 2) prefix##dw_kernel(           \
      const rnn::DwArgs args) {                                                        \
    extern __shared__ __align__(16) float smem[];                                      \
    rnn::dw_block<kVec, kBK>(args, smem);                                              \
  }                                                                                    \
  __global__ void __launch_bounds__(256) prefix##dw_sum_kernel(const rnn::DwArgs args) { \
    rnn::dw_sum(args);                                                                 \
  }                                                                                    \
  __global__ void __launch_bounds__(1024) prefix##dw_rows_kernel(const rnn::DwArgs args) { \
    rnn::dw_rows(args);                                                                \
  }                                                                                    \
  cudaError_t prefix##dw_launch(const rnn::DwArgs& args, int sms, cudaStream_t st) {    \
    int blocks = 0;                                                                    \
    for (int i = 0; i < args.n_problems; ++i) blocks += rnn::dw_tiles(args.p[i]);      \
    blocks *= args.splits;                                                             \
    const size_t smem = rnn::dw_smem(args);                                            \
    const bool vec = rnn::dw_vec(args), deep = rnn::dw_bk(args) == 32;                 \
    const void* fn = vec ? (deep ? (const void*)prefix##dw_kernel<true, 32>            \
                                 : (const void*)prefix##dw_kernel<true, 16>)           \
                         : (deep ? (const void*)prefix##dw_kernel<false, 32>           \
                                 : (const void*)prefix##dw_kernel<false, 16>);         \
    cudaError_t err = cudaFuncSetAttribute(                                            \
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);                   \
    if (err != cudaSuccess) return err;                                                \
    prefix##dw_rows_kernel<<<1, 1024, 0, st>>>(args);                                  \
    err = cudaGetLastError();                                                          \
    if (err != cudaSuccess) return err;                                                \
    void* kargs[] = {const_cast<rnn::DwArgs*>(&args)};                                 \
    err = cudaLaunchKernel(fn, dim3(blocks), dim3(rnn::kGemmThreads), kargs, smem, st); \
    if (err != cudaSuccess) return err;                                                \
    err = cudaGetLastError();                                                          \
    if (err != cudaSuccess) return err;                                                \
    prefix##dw_sum_kernel<<<2 * sms, 256, 0, st>>>(args);                              \
    return cudaGetLastError();                                                         \
  }
