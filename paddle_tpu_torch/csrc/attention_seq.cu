// Fused scaled-dot attention forward for Hopper (sm_90a), f32.
//
// Replaces: paddle_tpu/ops/pallas/rnn_kernels.py:534 attention_seq_fused —
// the pallas_call of _attn_fwd (:478, call :484, body _attn_fwd_kernel
// :463). Its backward is the autograd of the plain oracle there
// (_attn_vjp_bwd) and here, so there is no backward kernel.
//
//   q    [B, Tq, D]    k [B, Tk, D]    v [B, Tk, Dv]
//   mask [B, Mq, Tk]   Mq in {1, Tq}; a score is kept where mask > 0 and
//                      REPLACED by -1e9 elsewhere, so a fully masked row
//                      gets uniform weights over all Tk, as the oracle's
//   out  [B, Tq, Dv] = softmax(where(mask > 0, scale q k^T, -1e9)) v
//
// Bound: at B=32, Tq=Tk=512, D=Dv=64 the two products are 2*B*Tq*Tk*(D+Dv)
// = 2.15 GFLOP, 0.032 ms at 67 TFLOP/s f32; the bytes (17 MB of q, k, v,
// out plus the mask) take ~0.01 ms at 3.35 TB/s: operations bound it.
//
// Design: the TPU kernel keeps one batch row's whole [Tq, Tk] score tile in
// VMEM; at Tq = Tk = 512 that is 1 MB, far beyond a block's 227 KB. Here
// one block per (batch row, 64 query rows) walks Tk in tiles of 64 keys:
// the K and V tiles go through shared memory, the tile's scores are formed
// there, and each query row keeps a running max, denominator and
// accumulator in f32 (online softmax); out = acc / l at the end. Keys past
// Tk score -inf (no weight at all); masked keys score -1e9 (they share the
// weight of a fully masked row). The scores never reach device memory.
// Thread (ty, tx) of 16 x 16 holds a 4 x 4 register tile of the scores
// (rows ty + 16a, keys tx + 16c) and 4 x 4*NC of the accumulator (rows
// ty + 16a, columns tx + 16c): each shared-memory load feeds 2 or 4 FMAs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kLdp = kBK + 1;
constexpr int kMaxDv = 256;    // 4 column chunks of 64
constexpr float kNegInf = -1e9f;  // ops/sequence.NEG_INF

// an odd row stride: 16 consecutive rows read at one column hit 16 banks
__host__ __device__ constexpr int odd_ld(int d) { return d | 1; }

template <int NC>  // NC = ceil(Dv / 64)
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                float* __restrict__ out, int Tq, int Tk, int D, int Dv, int Mq,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int ldq = D, ldk = odd_ld(D), ldv = Dv;
  float* q_s = smem;                        // [kBQ][D]
  float* k_s = q_s + kBQ * ldq;             // [kBK][ldk]
  float* v_s = k_s + kBK * ldk;             // [kBK][Dv]
  float* p_s = v_s + kBK * ldv;             // [kBQ][kLdp] scores, then weights
  float* m_s = p_s + kBQ * kLdp;            // [kBQ] running max
  float* l_s = m_s + kBQ;                   // [kBQ] running denominator
  float* a_s = l_s + kBQ;                   // [kBQ] rescale of the tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = q0 + r < Tq ? q[((size_t)b * Tq + q0 + r) * D + d] : 0.f;
  }
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  float acc[4][4 * NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    const int kn = min(kBK, Tk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      k_s[j * ldk + d] = j < kn ? k[((size_t)b * Tk + k0 + j) * D + d] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * Dv; i += kThreads) {
      v_s[i] = i / Dv < kn ? v[((size_t)b * Tk + k0) * Dv + i] : 0.f;
    }
    __syncthreads();
    // scores: rows ty + 16a, keys tx + 16c
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(ty + 16 * a) * ldq + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = k_s[(tx + 16 * c) * ldk + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qa[a], kc[c], sc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float* mrow = mask + ((size_t)b * Mq + (Mq == 1 ? 0 : min(q0 + r, Tq - 1))) * Tk;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        float x = -INFINITY;  // past Tk: no weight at all
        if (j < kn) x = mrow[k0 + j] > 0.f ? sc[a][c] * scale : kNegInf;
        p_s[r * kLdp + j] = x;
      }
    }
    __syncthreads();
    // online softmax, one warp per row: new max, weights, rescale
    for (int r = warp; r < kBQ; r += kWarps) {
      float* pr = p_s + r * kLdp;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      pr[lane] = e0;
      pr[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 at the first tile
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + weights @ V over the tile's keys
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float al = a_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[a][c] *= al;
    }
    for (int j = 0; j < kn; ++j) {
      float pa[4], vc[4 * NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_s[(ty + 16 * a) * kLdp + j];
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) {
        const int col = tx + 16 * c;
        vc[c] = col < Dv ? v_s[j * ldv + col] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= Tq) continue;
    const float inv_l = 1.f / l_s[r];
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) out[((size_t)b * Tq + q0 + r) * Dv + col] = acc[a][c] * inv_l;
    }
  }
}

size_t smem_bytes(int D, int Dv) {
  return ((size_t)kBQ * D + (size_t)kBK * odd_ld(D) + (size_t)kBK * Dv +
          (size_t)kBQ * kLdp + 3 * kBQ) * sizeof(float);
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, const float* mask,
                   float* out, int B, int Tq, int Tk, int D, int Dv, int Mq, float scale,
                   size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)attn_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tq + kBQ - 1) / kBQ, B);
  attn_fwd_kernel<NC><<<grid, kThreads, smem, st>>>(q, k, v, mask, out, Tq, Tk, D, Dv, Mq,
                                                     scale);
  return cudaGetLastError();
}

}  // namespace

// The shared memory the kernel takes at (D, Dv), for the wrapper's fit test
// (ops/rnn_kernels.attention_seq_smem_bytes is its copy, held equal by the
// cuda tests).
extern "C" int attention_seq_smem_bytes(int D, int Dv) { return (int)smem_bytes(D, Dv); }

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, returns the first CUDA error. Dv above 256, or D and Dv
// whose tiles exceed 227 KB of shared memory, are cudaErrorInvalidValue.
extern "C" int attention_seq_fwd_f32(const float* q, const float* k, const float* v,
                                     const float* mask, float* out, int B, int Tq, int Tk,
                                     int D, int Dv, int Mq, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || Dv <= 0 || Dv > kMaxDv ||
      (Mq != 1 && Mq != Tq) || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(D, Dv);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (Dv + 63) / 64;
  const cudaError_t err =
      nc == 1 ? launch<1>(q, k, v, mask, out, B, Tq, Tk, D, Dv, Mq, scale, smem, st)
      : nc == 2 ? launch<2>(q, k, v, mask, out, B, Tq, Tk, D, Dv, Mq, scale, smem, st)
                : launch<4>(q, k, v, mask, out, B, Tq, Tk, D, Dv, Mq, scale, smem, st);
  return (int)err;
}
