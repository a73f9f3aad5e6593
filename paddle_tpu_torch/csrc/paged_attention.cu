// Ragged paged-attention decode for Hopper (sm_90a), f32: split-K over each
// slot's pages (flash-decoding), page rows copied asynchronously into a
// shared-memory ring, then a fixed-order merge of the splits.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:108 paged_attention_decode
// (Pallas body _paged_decode_kernel, :54) — one decode step of attention over
// the paged KV cache for every serving slot at once.
//
//   q            [S, KD]        one query token per slot (KD = H * hd)
//   k/v_pages    [NP, PS, KD]   one layer's physical page pool
//   block_table  [S, P] int32   logical page j of slot s -> physical page id
//   positions    [S] int32      slot s attends logical tokens 0..positions[s]
//                               (kept inside 1..P*PS tokens)
//   out          [S, KD]        softmax(q k^T * scale) v per head, f32
//
// Bound: bytes. Each visible K and V row is read once (2 * 4 * KD bytes per
// token) for 4 * KD flops, about half a flop per byte — far under the H100's
// f32 ridge, so the least time is the visible K/V bytes over the card's
// memory rate. The kernel's task is to keep enough bytes in flight.
//
// Design (the plan — heads per block, tiles per split at most, tokens per
// tile and the number of splits — comes from the wrapper,
// ops/paged_attention.py split_plan, a static function of S, H, hd, PS, P
// and the SM count; which tiles a split walks follows from the positions,
// on the device):
//   * split kernel, grid (head groups, slots, splits): a block owns HG heads
//     of one slot. A slot's visible tokens fall into ceil(n_tok / TT) tiles
//     of TT tokens. A short slot, of at most min(RT, NC) tiles, gives one
//     tile to each of its first splits; a longer one gives split c the run
//     of tiles c * RT .. c * RT + RT - 1, so ceil(tiles / RT) splits are
//     live. At the decode profile's contexts (16-34 tokens, 2-3 tiles) a
//     slot's tiles thus go to as many blocks; at long contexts the runs are
//     the plan's. The split is the slowest grid index, so the live blocks
//     (the first splits of every slot) are dispatched first. The tiles a
//     split may walk are fixed (its run and its short tile), so a block
//     loads their pool rows (page ids from the block table) beside the
//     slot's position and its query, all in flight together, and exits
//     once the position shows it has no tile; the host never reads
//     positions and a decode step keeps one launch shape. (Dealing every
//     slot's tiles round-robin over all NC splits, so that mid contexts
//     spread too, measured 13-15 % slower at S = 8 and 32: PERF.md §6.)
//   * a tile is TT consecutive tokens of the run; a token's HG*hd floats are
//     contiguous in the pool (one row of a page), so a tile of K and V is
//     2*TT row copies into a 2-stage ring; while the block computes a
//     tile, the next is in flight (at hd=64: HG=4, TT=16, a stage of 32 KB,
//     so 3 blocks an SM; deeper rings measured no faster, PERF.md §6).
//     Every thread copies its share of the rows by cp.async, 16 bytes a
//     copy where rows are aligned, else 4 (1-D TMA row copies, one
//     cp.async.bulk a row on a stage mbarrier, measured no faster at 1 KB
//     rows and slower at 64-byte rows: PERF.md §6).
//     One barrier a tile frees the older stage for the next copy, another
//     publishes the scores.
//   * per tile: the HG*TT scores from shared memory (LPT lanes per score,
//     each a few 16-byte loads, a shuffle sum); then a warp per head takes
//     the tile's max, turns the scores into weights exp(s - max) in place
//     and keeps the head's running (max, sum): ONE max and ONE rescale per
//     head and tile; then thread (column, token split) rescales its
//     accumulator once and adds w * v for its tokens. The token splits of a
//     column share the head's running max, so they add up exactly at the
//     end. A token's pool row is computed once per block (no division in
//     the copy loop).
//   * a slot with one live split gets its output from that block. Otherwise
//     each block writes its split's (m, l, acc) per head to scratch; the
//     merge kernel, grid (H, S), works out the same live split count from
//     the same position, weighs the splits in shared memory and sums them
//     in a fixed order (G interleaved groups of splits per column, then the
//     G partial sums). It is launched as a programmatic dependent of the
//     split kernel, so its launch overlaps the split kernel's tail, and
//     every merge block waits for the split grid before it reads or exits,
//     so the merge's end implies the split kernel's writes are visible. A
//     plan of one split launches no merge. No atomics: two calls on the
//     same inputs give bit-identical outputs. (Measured no faster: letting
//     the merge launch as the split blocks start; the default carveout; a
//     merge thread per column with no shared memory, which is slower at 64
//     splits: PERF.md §6. Merging in the split kernel's last block, by an
//     atomic ticket, measured slower: every block then pays a device-wide
//     fence, and one block merges a long slot's splits alone.)
//   q is scaled before the dot, as the TPU kernel does; the plain version
//   scales the scores after, so the two agree to float tolerance.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;        // tiles of the ring: one in flight, one computed
constexpr int kMaxWidth = 256;    // floats of a block's row: HG * hd
constexpr int kMinTile = 4;       // tokens of a tile
constexpr int kMaxTile = 64;
constexpr int kMaxSplits = 4096;  // the merge keeps a slot's weights in shared memory
constexpr int kMaxRun = 2048;     // tokens of a split at most: their pool rows stay in shared memory
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The launch's geometry: the plan's four numbers and what follows from them.
struct Split {
  int S, H, hd, PS, P, KD;
  int HG;   // heads of a block
  int RT;   // tiles of a split at most
  int TT;   // tokens of a tile, a power of two
  int TT_LOG;
  int NC;   // splits of a slot (NC * RT >= the table's tiles)
  int NV;   // vectors of a head's row (hd / VEC)
  int LPT;  // lanes of a score
  int ROW;  // floats of a ring row (HG * hd, padded)
  int C;    // accumulator columns: HG * NV vectors
  int TS;   // token splits of the accumulator: kThreads / C
  float scale;
};

inline int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// LPT lanes read neighbouring vectors of one score's row: as many as leave
// no thread idle over a tile's HG*TT scores, at most a row's vectors. Rows
// are padded so that the scores read in one shared-memory phase fall on
// disjoint banks.
Split make_split(int S, int H, int hd, int PS, int P, int HG, int RT, int TT, int NC,
                 int vec, float scale) {
  Split g{};
  g.S = S, g.H = H, g.hd = hd, g.PS = PS, g.P = P, g.KD = H * hd;
  g.HG = HG, g.RT = RT, g.TT = TT, g.NC = NC, g.scale = scale;
  g.TT_LOG = 0;
  while ((1 << g.TT_LOG) < TT) ++g.TT_LOG;
  g.NV = hd / vec;
  const int per_score = kThreads / (HG * TT);
  const int lpt = pow2_floor(per_score < g.NV ? per_score : g.NV);
  g.LPT = lpt > 32 ? 32 : lpt;
  const int width = HG * hd;
  const int pad = vec == 4 ? (g.LPT < 8 ? 4 * g.LPT : 0) : (g.LPT < 32 ? g.LPT : 0);
  g.ROW = cdiv(width, 32) * 32 + pad;
  g.C = HG * g.NV;
  g.TS = g.C >= kThreads ? 1 : kThreads / g.C;
  return g;
}

__host__ __device__ inline size_t ring_floats(const Split& g) {
  return (size_t)kStages * 2 * g.TT * g.ROW;
}

// the block's closing sums reuse the ring: [TS][C] vectors
size_t reduce_floats(const Split& g, int vec) { return (size_t)g.TS * g.C * vec; }

// pool rows a split block keeps: its run's RT tiles, then its short tile
__host__ __device__ inline int row_slots(const Split& g) { return (g.RT + 1) * g.TT; }

size_t split_smem_bytes(const Split& g) {
  // ring [kStages][K, V][TT][ROW], scores [HG][TT], q [HG*hd], (m, l, alpha)
  // [3][HG]; pool rows of the split's tiles [RT*TT]
  return (ring_floats(g) + (size_t)g.HG * g.TT + (size_t)g.HG * g.hd + 3 * (size_t)g.HG) *
             sizeof(float) + (size_t)row_slots(g) * sizeof(int);
}

template <int VEC> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<1> { using T = float; };

__device__ __forceinline__ float dot(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot(float a, float b, float acc) { return fmaf(a, b, acc); }

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void scale_by(float4& a, float s) {
  a.x *= s, a.y *= s, a.z *= s, a.w *= s;
}
__device__ __forceinline__ void scale_by(float& a, float s) { a *= s; }
__device__ __forceinline__ void axpy(float p, const float4& v, float4& a) {
  a.x = fmaf(p, v.x, a.x), a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z), a.w = fmaf(p, v.w, a.w);
}
__device__ __forceinline__ void axpy(float p, float v, float& a) { a = fmaf(p, v, a); }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// visible tokens of slot s: logical 0..position, kept inside the table's
// reach (token 0 is visible to every slot, so at least 1)
__device__ __forceinline__ int visible_tokens(const int* positions, int s, int max_tok) {
  const int n = positions[s] + 1;
  return n < 1 ? 1 : (n > max_tok ? max_tok : n);
}

// whether a slot of `tiles` visible tiles is short: one tile to a split
__host__ __device__ inline bool short_slot(int tiles, const Split& g) {
  return tiles <= (g.RT < g.NC ? g.RT : g.NC);
}

// live splits of a slot with n_tok visible tokens: one a tile when the slot
// is short, else one a run of RT tiles
__host__ __device__ inline int live_splits(int n_tok, const Split& g) {
  const int tiles = cdiv(n_tok, g.TT);
  return short_slot(tiles, g) ? tiles : cdiv(tiles, g.RT);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 4)
paged_decode_split(const float* __restrict__ q, const float* __restrict__ k_pages,
                   const float* __restrict__ v_pages, const int* __restrict__ block_table,
                   const int* __restrict__ positions, float* __restrict__ out,
                   float* __restrict__ part, Split g) {
  using V = typename VecOf<VEC>::T;
  // the ring starts on a 128-byte line: 16 bytes past one, the kernel
  // measured 10-15 % slower (PERF.md §6, PR 6)
  extern __shared__ __align__(128) float smem[];
  const int grp = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = g.HG * g.hd;
  const size_t col0 = (size_t)grp * width;

  float* ring = smem;                                    // [kStages][2][TT][ROW]
  float* s_sc = ring + ring_floats(g);                   // [HG][TT] scores, then weights
  float* s_q = s_sc + g.HG * g.TT;                       // [HG * hd]
  float* s_m = s_q + width;                              // [HG] running max
  float* s_l = s_m + g.HG;                               // [HG] running denominator
  float* s_alpha = s_l + g.HG;                           // [HG] this tile's rescale
  int* s_row = reinterpret_cast<int*>(s_alpha + g.HG);  // [(RT + 1) * TT] pool rows

  // the query and the pool rows of the tiles this split may walk (its run,
  // the slot's tiles c * RT .. c * RT + RT - 1, and its short tile c) are
  // loaded beside the position, whose value decides which of them it walks:
  // the loads are in flight together
  const float q_own = tid < width ? q[(size_t)s * g.KD + col0 + tid] : 0.f;  // width <= kThreads
  const int max_tok = g.P * g.PS;
  const int n_tok = visible_tokens(positions, s, max_tok);
  const int* bt = block_table + (size_t)s * g.P;
  for (int u = tid; u < row_slots(g); u += kThreads) {
    const int k = u >> g.TT_LOG;
    const int tile = k < g.RT ? c * g.RT + k : c;
    const int t = tile * g.TT + (u & (g.TT - 1));
    s_row[u] = t < max_tok ? bt[t / g.PS] * g.PS + t % g.PS : 0;
  }
  if (tid < width) s_q[tid] = q_own * g.scale;
  const int slot_tiles = cdiv(n_tok, g.TT);
  const int n_split = live_splits(n_tok, g);
  if (c >= n_split) return;  // this split has no tile: exit
  for (int i = tid; i < g.HG; i += kThreads) s_m[i] = -INFINITY, s_l[i] = 0.f;
  __syncthreads();

  const bool short_run = short_slot(slot_tiles, g);
  const int n_tiles = short_run ? 1 : min(g.RT, slot_tiles - c * g.RT);
  auto tile_of = [&](int j) { return short_run ? c : c * g.RT + j; };
  auto row_base = [&](int j) { return short_run ? g.RT * g.TT : j * g.TT; };
  // tokens of the split's tile j, cut at n_tok
  auto tile_rows = [&](int j) { return min(g.TT, n_tok - tile_of(j) * g.TT); };
  const size_t tile_floats = (size_t)g.TT * g.ROW;
  // tile j into stage j % kStages: every thread copies vectors tid,
  // tid + kThreads, ... of the tile's K and V rows x vpr by cp.async, walked
  // without a division; one commit group per call, empty past the last
  // tile, so the wait below counts tiles
  const int vpr = width / VEC;
  const int r_first = tid / vpr, v_first = tid - r_first * vpr;
  const int dr = kThreads / vpr, dv = kThreads - dr * vpr;
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int t0 = row_base(j);  // in s_row
      const int rows = tile_rows(j);
      float* k_st = ring + (size_t)(j % kStages) * 2 * tile_floats;
      float* v_st = k_st + tile_floats;
      int r = r_first, v = v_first;
      while (r < rows) {
        const size_t src = (size_t)s_row[t0 + r] * g.KD + col0 + (size_t)v * VEC;
        const int dst = r * g.ROW + v * VEC;
        cp_async<VEC>(k_st + dst, k_pages + src);
        cp_async<VEC>(v_st + dst, v_pages + src);
        r += dr, v += dv;
        if (v >= vpr) v -= vpr, ++r;
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  // score roles: LPT lanes per score, scores i = head * TT + token
  const int lane_in = tid & (g.LPT - 1);
  const int dgrp = tid / g.LPT;
  const int n_dgrp = kThreads / g.LPT;
  const int n_dots = g.HG * g.TT;
  const int dot_iters = cdiv(n_dots, n_dgrp);
  // accumulator roles: column `col` (head h) over tokens ts, ts + TS, ...
  const bool acc_thread = tid < g.C * g.TS;
  const int col = tid % g.C;
  const int ts = tid / g.C;
  const int h = col / g.NV;
  V acc;
  zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j landed
    // everyone's did, and everyone is done with tile j - 1: its stage and
    // the weights are free again
    __syncthreads();
    issue(j + kStages - 1);  // into tile j - 1's stage
    const float* k_st = ring + (size_t)(j % kStages) * 2 * tile_floats;
    const float* v_st = k_st + tile_floats;
    const int rows = tile_rows(j);

    for (int it = 0; it < dot_iters; ++it) {  // warp-uniform trip count
      const int i = dgrp + it * n_dgrp;
      const int hh = i >> g.TT_LOG;
      const int t = i & (g.TT - 1);
      float sc = 0.f;
      if (i < n_dots && t < rows) {
        const V* kr = reinterpret_cast<const V*>(k_st + t * g.ROW + hh * g.hd);
        const V* qr = reinterpret_cast<const V*>(s_q + hh * g.hd);
        for (int v = lane_in; v < g.NV; v += g.LPT) sc = dot(qr[v], kr[v], sc);
      }
      for (int o = g.LPT / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      if (lane_in == 0 && i < n_dots) s_sc[i] = sc;
    }
    __syncthreads();

    // a warp per head: the tile's max, ONE rescale of the running sums,
    // and the weights exp(score - max) in place of the scores
    for (int hh = warp; hh < g.HG; hh += kThreads / 32) {
      float* sc = s_sc + hh * g.TT;
      float mt = -INFINITY;
      for (int t = lane; t < rows; t += 32) mt = fmaxf(mt, sc[t]);
      const float m_old = s_m[hh];
      const float m_new = fmaxf(m_old, warp_max(mt));
      float ps = 0.f;
      for (int t = lane; t < rows; t += 32) {
        const float p = __expf(sc[t] - m_new);
        sc[t] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);  // 0 on the first tile
        s_alpha[hh] = alpha;
        s_m[hh] = m_new;
        s_l[hh] = fmaf(s_l[hh], alpha, ps);
      }
    }
    __syncthreads();

    if (acc_thread) {
      const float* w = s_sc + h * g.TT;
      scale_by(acc, s_alpha[h]);
      for (int t = ts; t < rows; t += g.TS)
        axpy(w[t], reinterpret_cast<const V*>(v_st + t * g.ROW)[col], acc);
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();  // the ring becomes scratch

  // sum the token splits in order; a slot with one live split has its
  // output here, any other gets this split's (m, l, acc)
  V* red = reinterpret_cast<V*>(ring);  // [TS][C]
  if (acc_thread) red[ts * g.C + col] = acc;
  __syncthreads();
  if (tid < g.C) {  // ts == 0, col == tid
    V sum = red[tid];
    for (int k = 1; k < g.TS; ++k) add(sum, red[k * g.C + tid]);
    if (n_split == 1) {
      scale_by(sum, 1.f / s_l[h]);
      reinterpret_cast<V*>(out + (size_t)s * g.KD + col0)[tid] = sum;
    } else {
      float* p_acc = part + ((size_t)s * g.NC + c) * g.KD + col0;
      reinterpret_cast<V*>(p_acc)[tid] = sum;
    }
    if (tid % g.NV == 0 && n_split > 1) {
      float* p_ml = part + (size_t)g.S * g.NC * g.KD +
                    (((size_t)s * g.NC + c) * g.H + (size_t)grp * g.HG + h) * 2;
      p_ml[0] = s_m[h];
      p_ml[1] = s_l[h];
    }
  }
}

// grid (H, S): head h of slot s from its splits' (m, l, acc), in split
// order. The splits' weights go to shared memory; thread (g, d) sums the
// splits g, g + G, ... of column d, and the G partial sums add up in order.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge(const float* __restrict__ part, const int* __restrict__ positions,
                   float* __restrict__ out, Split g) {
  extern __shared__ float s_w[];  // [n_split] weights, [n_split] weight x sum
  __shared__ float s_red[kMergeThreads];
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int n_tok = visible_tokens(positions, s, g.P * g.PS);  // an input: no wait needed
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its writes are visible, in every block, so the
  // merge's end implies the split's, whatever the slot needs
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n_split = live_splits(n_tok, g);
  if (n_split == 1) return;  // the split kernel wrote this slot's output
  const float* ml = part + (size_t)g.S * g.NC * g.KD + ((size_t)s * g.NC * g.H + h) * 2;
  float mx = -INFINITY;  // split 0 always sees token 0, so the max is finite
  for (int c = tid; c < n_split; c += kMergeThreads) mx = fmaxf(mx, ml[(size_t)c * g.H * 2]);
  mx = warp_max(mx);
  if ((tid & 31) == 0) s_red[tid >> 5] = mx;
  __syncthreads();
  mx = s_red[0];
  for (int w = 1; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, s_red[w]);
  for (int c = tid; c < n_split; c += kMergeThreads) {
    const float* e = ml + (size_t)c * g.H * 2;
    const float w = expf(e[0] - mx);
    s_w[c] = w;
    s_w[n_split + c] = w * e[1];
  }
  __syncthreads();  // also: every thread has read s_red[0]
  float den = 0.f;
  for (int c = 0; c < n_split; ++c) den += s_w[n_split + c];
  const int groups = kMergeThreads / g.hd;  // hd <= 256
  const int d = tid % g.hd, grp = tid / g.hd;
  const float* acc = part + (size_t)s * g.NC * g.KD + (size_t)h * g.hd + d;
  float num = 0.f;
  if (grp < groups) {
#pragma unroll 4
    for (int c = grp; c < n_split; c += groups) num = fmaf(s_w[c], acc[(size_t)c * g.KD], num);
    s_red[grp * g.hd + d] = num;
  }
  __syncthreads();
  if (tid < g.hd) {
    float o = 0.f;
    for (int k = 0; k < groups; ++k) o += s_red[k * g.hd + tid];
    out[(size_t)s * g.KD + (size_t)h * g.hd + tid] = o / den;
  }
}

// Once per card: let the split kernel take a block's 227 KB of shared
// memory and ask for the largest shared-memory carveout, so that as many
// blocks fit on an SM as their shared memory allows.
template <int VEC>
cudaError_t prepare() {
  constexpr int kCards = 64;
  static bool done[kCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kCards && done[dev])) return err;
  const void* fn = (const void*)paged_decode_split<VEC>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kCards) done[dev] = true;
  return err;
}

template <int VEC>
cudaError_t launch(const float* q, const float* k_pages, const float* v_pages,
                   const int* block_table, const int* positions, float* out, float* part,
                   const Split& g, cudaStream_t st) {
  const size_t smem = split_smem_bytes(g);
  if (smem > kSmemMax || reduce_floats(g, VEC) > ring_floats(g)) return cudaErrorInvalidValue;
  cudaError_t err = prepare<VEC>();
  if (err != cudaSuccess) return err;
  paged_decode_split<VEC><<<dim3(g.H / g.HG, g.S, g.NC), kThreads, smem, st>>>(
      q, k_pages, v_pages, block_table, positions, out, part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.NC == 1) return err;  // one split: nothing to merge
  // the merge may launch while the split kernel's last blocks run, and
  // waits for them at griddepcontrol.wait: its launch latency hides behind
  // their tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.H, g.S);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = 2 * g.NC * sizeof(float);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_decode_merge, (const float*)part, positions, out, g);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches the split kernel and the
// merge kernel on `stream`, does not synchronise, and returns the first CUDA
// error, so a refused launch surfaces. `heads_per_block`, `tiles_per_split`,
// `tile_tokens` and `n_splits` are the wrapper's plan; `scratch` holds
// S * n_splits * (KD + 2H) floats. A plan that does not cover the table's
// tiles, has a split that no position makes live, or does not fit the
// block is cudaErrorInvalidValue.
extern "C" int paged_attention_decode_f32(
    const float* q, const float* k_pages, const float* v_pages, const int* block_table,
    const int* positions, float* out, float* scratch, int n_slots, int n_heads,
    int head_dim, int page_size, int pages_per_seq, int heads_per_block,
    int tiles_per_split, int tile_tokens, int n_splits, float scale, void* stream) {
  if (n_slots <= 0 || n_slots > 65535 || n_heads <= 0 || head_dim <= 0 ||
      head_dim > kMaxWidth || page_size <= 0 || pages_per_seq <= 0 ||
      heads_per_block <= 0 || n_heads % heads_per_block ||
      heads_per_block * head_dim > kMaxWidth ||
      tile_tokens < kMinTile || tile_tokens > kMaxTile || (tile_tokens & (tile_tokens - 1)) ||
      (long long)pages_per_seq * page_size > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const long long table_tiles = ((long long)pages_per_seq * page_size + tile_tokens - 1) / tile_tokens;
  if (tiles_per_split <= 0 || tiles_per_split * tile_tokens > kMaxRun || n_splits <= 0 ||
      n_splits > kMaxSplits || n_splits > table_tiles ||
      (long long)n_splits * tiles_per_split < table_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte row copies need 16-byte aligned rows: hd a multiple of 4 and
  // aligned pools and scratch
  const bool vec4 = head_dim % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages) |
                      reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(out)) &
                     15) == 0;
  const Split g = make_split(n_slots, n_heads, head_dim, page_size, pages_per_seq,
                             heads_per_block, tiles_per_split, tile_tokens, n_splits,
                             vec4 ? 4 : 1, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec4 ? launch<4>(q, k_pages, v_pages, block_table, positions, out, scratch, g, st)
           : launch<1>(q, k_pages, v_pages, block_table, positions, out, scratch, g, st);
  return (int)err;
}
