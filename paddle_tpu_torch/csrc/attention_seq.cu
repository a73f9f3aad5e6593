// Fused scaled-dot attention forward for Hopper (sm_90a): f32 in and out,
// both products on the tensor cores in 3xTF32.
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
// Any B, Tq, Tk, D and Dv (the grid's blocks at most 2^31 - 1).
//
// Bound: at B=32, Tq=Tk=512, D=Dv=64 with a per-row mask the bytes are q,
// k, v and out (4 x 4.19 MB) plus the [32, 512, 512] f32 mask (33.5 MB):
// 50.3 MB, 0.0150 ms at 3.35 TB/s. The two products are 2*B*Tq*Tk*(D+Dv) =
// 2.15 GFLOP; 3xTF32 issues each three times on the tensor cores, 6.44
// GFLOP at 495 TFLOP/s dense TF32 = 0.0130 ms. So bytes bound it, the mask
// above all. (As f32 FMAs at 67 TFLOP/s the products alone take 0.032 ms.)
// With two blocks of 4 warps an SM the kernel runs at ~4x the bound: the
// products, the copies and the per-tile work each take a share and
// overlap little (PERF.md §6).
//
// Design (flash attention, forward only):
//   * a block owns 64 query rows of one batch row, a run of key tiles and
//     a run of Dv chunks of up to 64 columns; 4 warps, 16 query rows each.
//     It computes a tile's scores once and adds the tile's p v to each of
//     its chunks in turn. One chunk's accumulators stay in registers; a
//     block of several keeps them all in shared memory (each thread its
//     own, so no barrier) and holds one chunk in registers at a time. A
//     block takes as many chunks as fit beside q and the ring without
//     lowering the occupancy of a one-chunk block: five at D=512, whose
//     streamed q makes the ring large, mostly one at D <= 256. The other
//     chunks go to further Dv blocks, which recompute the scores.
//     Where (batch rows x query blocks x Dv blocks) would not fill the card
//     at that occupancy, the key tiles are split over as many blocks as
//     fill it; each writes its unnormalised accumulators and (max, sum) a
//     row to scratch, and a merge grid (a block a query row) sums the
//     splits in order, so two calls give bit-identical outputs. Grid x
//     folds (batch row, query block, key split, Dv block), Dv block
//     fastest.
//   * keys go by in tiles of 64. A tile is a sequence of ring items: its
//     mask rows, its k in chunks of 64 columns of D (so any D fits), then
//     its v chunks. Every item is one cp.async group (16-byte copies where
//     rows allow, else 4-byte; rows and columns past the edge are
//     zero-filled) into a 4-slot ring: three items are in flight while the
//     block computes one, one block barrier an item. q (D <= 256) stays in
//     shared memory for the whole walk; a wider q comes through the ring
//     beside each k chunk.
//   * both products are mma.sync m16n8k8 TF32 on 3xTF32 operands: x = hi +
//     lo and a b = lo*hi + hi*lo + hi*hi accumulated in f32 (lo*lo, about
//     2^-22 of a b, is left out). For the A operand (q, the weights) hi is
//     x rounded to TF32 and lo = x - hi; for the B operand (k, v) hi is x
//     itself, which the tensor core truncates to TF32, and lo = x - trunc(x),
//     one instruction cheaper. One TF32 pass keeps ~3 digits: at scores of
//     order 10 that misses 1e-4. Each term goes to all n-tiles before the
//     next, so consecutive mma are independent. Within a k-step of 8 the
//     order of the shared index is free, so thread (group g, lane t) takes
//     d = 16p + 4t .. 4t + 3 for the two k-steps of a 16-column pair (one
//     16-byte load of q and of k each), and the P v product takes keys 2t
//     and 2t + 1 as its k-step's columns t and t + 4: exactly the scores
//     the thread holds in its accumulator fragment, so the weights never
//     leave registers. Rows of the q and k chunks swap 16-column halves on
//     odd rows, so those loads hit 32 distinct banks; v rows are padded to
//     4 mod 8 floats, mask rows to 8 mod 32.
//   * the mask item becomes one 32-bit word a thread (its two rows x 16
//     keys) as it arrives. The softmax stays in registers, in base 2 (the
//     scale carries log2(e)): the row max takes two quad shuffles, the
//     running denominator stays per thread until the end. Keys past Tk
//     score -inf (no weight at all); masked keys -1e9.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;                      // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;               // query rows of a block
constexpr int kBK = 64;                        // keys of a tile
constexpr int kNK = kBK / 8;                   // n-tiles of a tile's scores
constexpr int kDK = 64;                        // q and k columns of a chunk
constexpr int kLDM = kBK + 8;                  // 8 mod 32: a quad's 8-byte mask loads hit 32 banks
constexpr int kStages = 4;                     // ring slots
constexpr int kQResident = 256;                // widest D (padded to kDK) kept in shared memory
constexpr float kNegInf = -1e9f;               // ops/sequence.NEG_INF
constexpr size_t kSmemMax = 227 * 1024;        // a block's shared memory

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Geo {
  int B, Tq, Tk, D, Dv, Mq;
  int nqb;       // query blocks
  int nvb, cpb;  // Dv blocks, Dv chunks of a block
  int nks, tps;  // key splits, key tiles of a split
  int nd;        // q/k chunks of D
  int dpad;      // nd * kDK
  int slot;      // floats of a ring slot
  bool q_res;    // q resident in shared memory (dpad <= kQResident)
  bool qk16;     // 16-byte copies of q and k rows
  bool v16;      // 16-byte copies of v rows
  bool m16;      // 16-byte copies of mask rows
  bool o8;       // 8-byte output stores
  float scale;   // the caller's scale times log2(e): the softmax runs in base 2
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols floats (cols a multiple of 4) of a row-major source with row
// stride lds to shared memory at at(r, c); rows >= rv and columns >= cv are
// zero-filled and read nothing (the copy then names `safe`, a valid address)
template <class At>
__device__ __forceinline__ void copy_tile(At at, const float* src, size_t lds, int rows,
                                          int cols, int rv, int cv, bool v16,
                                          const float* safe) {
  if (v16) {
    const int per = cols / 4;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = (i - r * per) * 4;
      const bool ok = r < rv && c < cv;
      cp16(at(r, c), ok ? src + (size_t)r * lds + c : safe, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < rv && c < cv;
      cp4(at(r, c), ok ? src + (size_t)r * lds + c : safe, ok);
    }
  }
}

// column c of row r of a q or k chunk: odd rows swap the 16-column halves
// of each 32 columns
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r & 1) << 4); }

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (half away from
// zero), lo the exact rest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the same for a B operand, one instruction cheaper: hi is x itself (the
// tensor core reads its top 19 bits, x truncated), lo = x - trunc(x)
__device__ __forceinline__ void split_b(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a b[n] in 3xTF32 for N n-tiles, b[n] = (b0[n], b1[n]): each of
// the three terms (the small cross terms first) goes to every n-tile before
// the next, so consecutive mma are independent
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float (&b0)[N],
                                     const float (&b1)[N]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_b(b0[n], bh[n][0], bl[n][0]);
    split_b(b1[n], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], ah, bh[n][0], bh[n][1]);
}

// s += q_chunk k_chunk^T for the warp's 16 rows (ra = 16 * warp + g and
// ra + 8) and the tile's keys. qs: the chunk's columns start at qoff of rows
// ldq floats apart; kc: [kBK][kDK].
__device__ __forceinline__ void qk_chunk(float (&s)[kNK][4], const float* qs, int ldq, int qoff,
                                         const float* kc, int ra, int g, int t) {
  const int rb = ra + 8;
#pragma unroll
  for (int p = 0; p < kDK / 16; ++p) {
    const int c = 16 * p + 4 * t;
    const float4 xa = *reinterpret_cast<const float4*>(qs + ra * ldq + swz(ra, qoff + c));
    const float4 xb = *reinterpret_cast<const float4*>(qs + rb * ldq + swz(rb, qoff + c));
    // k-step 2p: columns t, t + 4 are d = c, c + 1; k-step 2p + 1: c + 2, c + 3
    uint32_t h0[4], l0[4], h1[4], l1[4];
    split(xa.x, h0[0], l0[0]);
    split(xb.x, h0[1], l0[1]);
    split(xa.y, h0[2], l0[2]);
    split(xb.y, h0[3], l0[3]);
    split(xa.z, h1[0], l1[0]);
    split(xb.z, h1[1], l1[1]);
    split(xa.w, h1[2], l1[2]);
    split(xb.w, h1[3], l1[3]);
    float b[4][kNK];  // the k-steps' B fragments: d = c, c + 1, then c + 2, c + 3
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt) {
      const int key = nt * 8 + g;
      const float4 kb = *reinterpret_cast<const float4*>(kc + key * kDK + swz(key, c));
      b[0][nt] = kb.x, b[1][nt] = kb.y, b[2][nt] = kb.z, b[3][nt] = kb.w;
    }
    mma3<kNK>(s, h0, l0, b[0], b[1]);
    mma3<kNK>(s, h1, l1, b[2], b[3]);
  }
}

// o += p v over the tile's keys, v: [kBK][8 NT + 4] (4 mod 8: a B
// fragment's loads hit 32 banks). k-step kk's columns t and t + 4 are keys
// 8kk + 2t and 8kk + 2t + 1, the thread's own weights.
template <int NT>
__device__ __forceinline__ void pv_tile(float (&o)[NT][4], const float (&p)[kNK][4],
                                        const float* vs, int g, int t) {
  constexpr int LDV = 8 * NT + 4;
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    uint32_t ah[4], al[4];
    split(p[kk][0], ah[0], al[0]);
    split(p[kk][2], ah[1], al[1]);
    split(p[kk][1], ah[2], al[2]);
    split(p[kk][3], ah[3], al[3]);
    const float* vr = vs + (8 * kk + 2 * t) * LDV + g;
    float b0[NT], b1[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) b0[n] = vr[8 * n], b1[n] = vr[LDV + 8 * n];
    mma3<NT>(o, ah, al, b0, b1);
  }
}

// OS: the block keeps several Dv chunks, their accumulators in o_s
template <int NT, bool OS>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ part, Geo G) {
  constexpr int W = 8 * NT;  // v columns of a chunk
  constexpr int LDV = W + 4;
  extern __shared__ __align__(128) float smem[];
  unsigned bid = blockIdx.x;
  const int dvb = bid % G.nvb;
  bid /= G.nvb;
  const int ks = bid % G.nks;
  bid /= G.nks;
  const int qb = bid % G.nqb;
  const size_t b = bid / G.nqb;
  const int q0 = qb * kBQ, c0 = dvb * G.cpb * W;
  const int n_ch = min(G.cpb, cdiv(G.Dv - c0, W));  // the block's Dv chunks
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and lane in it
  const int ra = warp * 16 + g;           // the thread's first row in the block

  float* q_s = smem;                                           // [kBQ][dpad], resident q
  float* o_s = q_s + (G.q_res ? (size_t)kBQ * G.dpad : 0);     // [cpb][NT][4][kThreads]
  float* ring = o_s + (OS ? (size_t)G.cpb * kBQ * W : 0);    // [kStages][slot]
  const float* qb_ptr = q + (b * G.Tq + q0) * G.D;
  const float* kb_ptr = k + b * G.Tk * G.D;
  const float* vb_ptr = v + b * G.Tk * G.Dv;
  const float* mb_ptr = mask + (b * G.Mq + (G.Mq == 1 ? 0 : q0)) * (size_t)G.Tk;
  const int q_rows = min(kBQ, G.Tq - q0);
  const int kt0 = ks * G.tps;  // the split's key tiles
  const int n_tiles = min(G.tps, cdiv(G.Tk, kBK) - kt0);
  const int per_tile = 1 + G.nd + n_ch;  // mask rows, q/k chunks, then v chunks
  const int n_items = n_tiles * per_tile;

  auto issue = [&](int i) {
    if (i < n_items) {
      const int j = i / per_tile, r = i - j * per_tile;
      const int k0 = (kt0 + j) * kBK, kn = min(kBK, G.Tk - k0);
      float* st = ring + (size_t)(i % kStages) * G.slot;
      if (r == 0) {
        const int rows = G.Mq == 1 ? 1 : q_rows;
        copy_tile([st](int rr, int cc) { return st + rr * kLDM + cc; }, mb_ptr + k0, G.Tk,
                  rows, kBK, rows, kn, G.m16, mask);
      } else if (r <= G.nd) {
        const int d0 = (r - 1) * kDK;
        copy_tile([st](int rr, int cc) { return st + rr * kDK + swz(rr, cc); },
                  kb_ptr + (size_t)k0 * G.D + d0, G.D, kBK, kDK, kn, G.D - d0, G.qk16, k);
        if (!G.q_res) {
          float* qs = st + kBK * kDK;
          copy_tile([qs](int rr, int cc) { return qs + rr * kDK + swz(rr, cc); },
                    qb_ptr + d0, G.D, kBQ, kDK, q_rows, G.D - d0, G.qk16, q);
        }
      } else {
        const int cv = c0 + (r - 1 - G.nd) * W;
        copy_tile([st](int rr, int cc) { return st + rr * LDV + cc; },
                  vb_ptr + (size_t)k0 * G.Dv + cv, G.Dv, kBK, W, kn, G.Dv - cv, G.v16, v);
      }
    }
    cp_commit();
  };

  if (G.q_res) {  // joins item 0's group
    const int dp = G.dpad;
    copy_tile([q_s, dp](int rr, int cc) { return q_s + rr * dp + swz(rr, cc); }, qb_ptr, G.D,
              kBQ, dp, q_rows, G.D, G.qk16, q);
  }
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // rows past Tq compute on zeros and are not stored; a warp with none
  // below Tq only keeps the ring going
  const bool active = q0 + warp * 16 < G.Tq;
  float s[kNK][4];  // scores, then weights: rows ra, ra + 8 x keys 8nt + 2t, + 1
  float o[NT][4];   // the chunk's accumulators: rows ra, ra + 8 x columns 8n + 2t, + 1
  uint32_t keep = 0;  // the tile's mask at the scores: bit 4nt + e for s[nt][e]
  // a chunk's accumulators in o_s: the thread's own, [n][e] kThreads apart
  auto o_at = [&](int cc, int n, int e) { return o_s + ((cc * NT + n) * 4 + e) * kThreads + tid; };
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (OS && active) {
    for (int cc = 0; cc < n_ch; ++cc)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) *o_at(cc, n, e) = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float alpha[2] = {0.f, 0.f};  // this tile's rescale of the accumulators

  for (int i = 0; i < n_items; ++i) {
    cp_wait<kStages - 2>();  // this thread's copies of item i landed
    __syncthreads();         // everyone's; and item i - 1's slot is free
    issue(i + kStages - 1);
    if (!active) continue;
    const int j = i / per_tile, r = i - j * per_tile;
    const float* st = ring + (size_t)(i % kStages) * G.slot;
    if (r == 0) {  // the tile's mask rows, to bits
      keep = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = G.Mq == 1 ? 0 : ra + 8 * h;
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt) {
          const float2 x = *reinterpret_cast<const float2*>(st + row * kLDM + nt * 8 + 2 * t);
          keep |= (uint32_t)(x.x > 0.f) << (4 * nt + 2 * h);
          keep |= (uint32_t)(x.y > 0.f) << (4 * nt + 2 * h + 1);
        }
      }
      continue;
    }
    if (r > G.nd) {  // a v chunk: o = alpha o + p v
      const int cc = r - 1 - G.nd;
      if (OS) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = *o_at(cc, n, e);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      pv_tile<NT>(o, s, st, g, t);
      if (OS) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) *o_at(cc, n, e) = o[n][e];
      }
      continue;
    }
    const int rc = r - 1;  // the q/k chunk
    if (rc == 0) {
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
    if (G.q_res) {
      qk_chunk(s, q_s, G.dpad, rc * kDK, st, ra, g, t);
    } else {
      qk_chunk(s, st + kBK * kDK, kDK, 0, st, ra, g, t);
    }
    if (rc < G.nd - 1) continue;

    // the tile's scores are complete: mask, scale, and the online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (kt0 + j) * kBK + nt * 8 + 2 * t + (e & 1);
        const float x = col < G.Tk ? ((keep >> (4 * nt + e)) & 1u ? s[nt][e] * G.scale
                                                                  : kNegInf)
                                   : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);  // finite: every tile holds a key
      alpha[h] = exp2f(m_run[h] - m_new);           // 0 at the first tile
      m_run[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float w = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = w;
        ls[e >> 1] += w;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = fmaf(l_run[h], alpha[h], ls[h]);
  }

  if (!active) return;

  // one key split: the output, o / l. Several: the split's unnormalised o
  // and its (m, l) a row, for the merge
  float* part_ml = G.nks > 1 ? part + (size_t)G.B * G.Tq * G.nks * G.Dv : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + ra + 8 * h;
    if (row >= G.Tq) continue;
    const size_t grow = b * G.Tq + row;
    const float inv = G.nks == 1 ? 1.f / l : 1.f;
    float* orow = G.nks == 1 ? out + grow * G.Dv : part + (grow * G.nks + ks) * G.Dv;
    if (G.nks > 1 && dvb == 0 && t == 0) {
      part_ml[(grow * G.nks + ks) * 2] = m_run[h];
      part_ml[(grow * G.nks + ks) * 2 + 1] = l;
    }
    for (int cc = 0; cc < n_ch; ++cc) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = c0 + cc * W + n * 8 + 2 * t;
        const float x0 = (OS ? *o_at(cc, n, 2 * h) : o[n][2 * h]) * inv;
        const float x1 = (OS ? *o_at(cc, n, 2 * h + 1) : o[n][2 * h + 1]) * inv;
        if (G.o8 && col < G.Dv) {  // Dv even: col + 1 < Dv as well
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        } else {
          if (col < G.Dv) orow[col] = x0;
          if (col + 1 < G.Dv) orow[col + 1] = x1;
        }
      }
    }
  }
}

// One block a query row (grid B * Tq): out = sum_s 2^(m_s - M) o_s /
// sum_s 2^(m_s - M) l_s over the row's key splits s, in split order, so two
// calls give bit-identical outputs.
constexpr int kMergeThreads = 128;

__global__ void __launch_bounds__(kMergeThreads)
attn_merge_kernel(const float* __restrict__ part, float* __restrict__ out, Geo G) {
  const size_t row = blockIdx.x;
  const float* ml = part + (size_t)G.B * G.Tq * G.nks * G.Dv + row * G.nks * 2;
  float mx = -INFINITY;
  for (int c = 0; c < G.nks; ++c) mx = fmaxf(mx, ml[2 * c]);
  float den = 0.f;
  for (int c = 0; c < G.nks; ++c) den = fmaf(exp2f(ml[2 * c] - mx), ml[2 * c + 1], den);
  const float inv = 1.f / den;
  const float* o = part + row * G.nks * G.Dv;
  for (int d = threadIdx.x; d < G.Dv; d += kMergeThreads) {
    float num = 0.f;
    for (int c = 0; c < G.nks; ++c) num = fmaf(exp2f(ml[2 * c] - mx), o[(size_t)c * G.Dv + d], num);
    out[row * G.Dv + d] = num * inv;
  }
}

// the floats of a ring slot: the largest of a tile's items, mask rows, k
// (and q) or a v chunk
int slot_floats(bool q_res, int vw) {
  int n = kBQ * kLDM;
  const int kq = kBK * kDK + (q_res ? 0 : kBQ * kDK);
  n = n > kq ? n : kq;
  return n > kBK * (vw + 4) ? n : kBK * (vw + 4);
}

// Once per card and instantiation: allow a block all 227 KB of shared
// memory.
template <int NT, bool OS>
cudaError_t prepare() {
  constexpr int kCards = 64;
  static bool done[kCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kCards && done[dev])) return err;
  err = cudaFuncSetAttribute((const void*)attn_fwd_kernel<NT, OS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err == cudaSuccess && dev < kCards) done[dev] = true;
  return err;
}

// The launch's layout. Dv chunks: as many a block as its shared memory
// holds beside q and the ring without lowering the occupancy of a block of
// one chunk (so at D=512, whose streamed q takes a large ring, five; at
// D <= 256 mostly one), the rest in Dv blocks that recompute the scores.
// Key splits: where (batch rows x query blocks x Dv blocks) would not fill
// the card at that occupancy, each splits its key tiles over up to
// `occupancy * SMs / grid` blocks. *smem: the block's bytes.
template <int NT>
cudaError_t plan(int B, Geo& G, size_t* smem) {
  constexpr int W = 8 * NT;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = prepare<NT, false>();
  if (err != cudaSuccess) return err;
  G.B = B;
  G.slot = slot_floats(G.q_res, W);
  const size_t fixed =
      ((G.q_res ? (size_t)kBQ * G.dpad : 0) + (size_t)kStages * G.slot) * sizeof(float);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, attn_fwd_kernel<NT, false>,
                                                      kThreads, fixed);
  if (err != cudaSuccess) return err;
  const int ndv = cdiv(G.Dv, W);
  G.cpb = 1;
  if constexpr (NT == 8) {
    err = prepare<NT, true>();
    size_t avail = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyAvailableDynamicSMemPerBlock(&avail, attn_fwd_kernel<NT, true>, occ,
                                                      kThreads);
    if (err != cudaSuccess) return err;
    const int fit = avail > fixed ? (int)((avail - fixed) / (kBQ * W * sizeof(float))) : 0;
    if (fit >= 2) G.cpb = fit < ndv ? fit : ndv;
  }
  G.nvb = cdiv(ndv, G.cpb);
  G.cpb = cdiv(ndv, G.nvb);  // balance the Dv blocks
  *smem = fixed + (G.cpb > 1 ? (size_t)G.cpb * kBQ * W * sizeof(float) : 0);
  const long long grid = (long long)B * G.nqb * G.nvb;
  const int n_tiles = cdiv(G.Tk, kBK);
  long long nks = (long long)occ * sms / grid;
  nks = nks < 1 ? 1 : (nks > n_tiles ? n_tiles : nks);
  G.tps = cdiv(n_tiles, (int)nks);
  G.nks = cdiv(n_tiles, G.tps);
  return grid * G.nks > INT_MAX ? cudaErrorInvalidValue : cudaSuccess;
}

// scratch floats of a launch: the key splits' o and (m, l), none for one split
size_t scratch_floats(const Geo& G) {
  return G.nks == 1 ? 0 : (size_t)G.B * G.Tq * G.nks * (G.Dv + 2);
}

template <int NT>
cudaError_t launch(const float* q, const float* k, const float* v, const float* mask,
                   float* out, float* scratch, size_t scratch_n, int B, Geo G,
                   cudaStream_t st) {
  size_t smem = 0;
  cudaError_t err = plan<NT>(B, G, &smem);
  if (err != cudaSuccess) return err;
  if (scratch_floats(G) > scratch_n) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((long long)B * G.nqb * G.nks * G.nvb);
  if constexpr (NT == 8) {  // only a Dv over 64 has several chunks
    if (G.cpb > 1) {
      attn_fwd_kernel<NT, true><<<blocks, kThreads, smem, st>>>(q, k, v, mask, out, scratch, G);
    } else {
      attn_fwd_kernel<NT, false><<<blocks, kThreads, smem, st>>>(q, k, v, mask, out, scratch, G);
    }
  } else {
    attn_fwd_kernel<NT, false><<<blocks, kThreads, smem, st>>>(q, k, v, mask, out, scratch, G);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || G.nks == 1) return err;
  attn_merge_kernel<<<(unsigned)((long long)B * G.Tq), kMergeThreads, 0, st>>>(scratch, out, G);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// The geometry of a call; *err: cudaErrorInvalidValue for bad sizes.
Geo geometry(const float* q, const float* k, const float* v, const float* mask,
             const float* out, int B, int Tq, int Tk, int D, int Dv, int Mq, float scale,
             cudaError_t* err) {
  Geo G{};
  *err = B <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || Dv <= 0 || (Mq != 1 && Mq != Tq)
             ? cudaErrorInvalidValue
             : cudaSuccess;
  G.Tq = Tq, G.Tk = Tk, G.D = D, G.Dv = Dv, G.Mq = Mq;
  G.scale = scale * 1.4426950408889634f;
  G.nqb = cdiv(Tq, kBQ);
  G.nd = cdiv(D, kDK);
  G.dpad = G.nd * kDK;
  G.q_res = G.dpad <= kQResident;
  G.qk16 = D % 4 == 0 && aligned(q, 16) && aligned(k, 16);
  G.v16 = Dv % 4 == 0 && aligned(v, 16);
  G.m16 = Tk % 4 == 0 && aligned(mask, 16);
  G.o8 = Dv % 2 == 0 && aligned(out, 8);
  return G;
}

// a chunk's v columns: the fewest n-tiles of 8 that hold Dv, at most 8
// (wider v goes in several chunks)
template <class F>
cudaError_t dispatch(int Dv, F&& f) {
  return Dv <= 8 ? f(std::integral_constant<int, 1>{})
         : Dv <= 16 ? f(std::integral_constant<int, 2>{})
         : Dv <= 32 ? f(std::integral_constant<int, 4>{})
                    : f(std::integral_constant<int, 8>{});
}

}  // namespace

// Plain C entry points (bound with ctypes). The forward launches on
// `stream`, does not synchronise, and returns the first CUDA error.
// Non-positive sizes, Mq other than 1 or Tq, a grid of more than 2^31 - 1
// blocks or a scratch of fewer floats than attention_seq_scratch_floats
// says are cudaErrorInvalidValue.
extern "C" long long attention_seq_scratch_floats(int B, int Tq, int Tk, int D, int Dv,
                                                  int Mq) {
  cudaError_t err;
  Geo G = geometry(nullptr, nullptr, nullptr, nullptr, nullptr, B, Tq, Tk, D, Dv, Mq, 1.f,
                   &err);
  if (err != cudaSuccess) return -(long long)err;
  size_t smem = 0;
  err = dispatch(Dv, [&](auto nt) { return plan<decltype(nt)::value>(B, G, &smem); });
  return err != cudaSuccess ? -(long long)err : (long long)scratch_floats(G);
}

extern "C" int attention_seq_fwd_f32(const float* q, const float* k, const float* v,
                                     const float* mask, float* out, float* scratch,
                                     long long scratch_n, int B, int Tq, int Tk, int D,
                                     int Dv, int Mq, float scale, void* stream) {
  cudaError_t err;
  const Geo G = geometry(q, k, v, mask, out, B, Tq, Tk, D, Dv, Mq, scale, &err);
  if (err != cudaSuccess || scratch_n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dispatch(Dv, [&](auto nt) {
    return launch<decltype(nt)::value>(q, k, v, mask, out, scratch, (size_t)scratch_n, B, G,
                                       st);
  });
  return (int)err;
}
