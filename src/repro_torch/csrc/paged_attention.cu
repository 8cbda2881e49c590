// Paged-attention kernels for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// These replace the four Pallas TPU kernels of
// src/repro/kernels/paged_attention/kernel.py on the serving main path:
//
//   paged_decode            C1 (baseline) / C2 (GQA Q-Block) decode
//   paged_decode_segmented  C3 parallel tiled softmax, one block per segment
//   segment_reduce          C3 merge of the segment partials (Listing 5)
//   paged_prefill_qblock    Q-Block chunked prefill over the paged cache
//
// Decode (paged_decode, paged_decode_segmented, both dtypes): bounded by
// bytes.  A key costs 4*M*D FLOPs against 4*D bytes of bf16 K and V: 3
// FLOP/byte at smollm's M = 3, far below the ~295 at which the H100's
// tensor cores would be the limit.  So the design (`decode_stream_kernel`)
// spends nothing on tensor cores and everything on keeping many 16-byte
// loads in flight:
//
//   * a lane holds 8 consecutive head-dim elements of a key row (one
//     16-byte load in bf16, two in fp32); D / 8 lanes, rounded up to a
//     power of two, read one whole row, so a warp reads 32 * 8 / D rows
//     a load, coalesced, and completes its dots with log2(D / 8)
//     xor-shuffles.  A head dim whose row is no power-of-two multiple of
//     16 bytes (D 40, 24) runs with masked lanes;
//   * each lane keeps two steps of kU keys' K and V loads in flight (16
//     x 16 bytes; 8 at 8 rows a block): a step's loads are issued before
//     the step before it is consumed, and the pages of the step after
//     are fetched with them, so the loads never wait on the page-table
//     lookup; no page-table entry at or past ceil(context / page) is
//     read;
//   * the keys are split over the block's 4 warps, and within a warp over
//     its lane groups; each keeps its own running (m, l) and fp32
//     accumulator in registers; the key loop has no barrier.  After the
//     loop the lane groups merge by shuffles and the warps through shared
//     memory, with the same m_safe / alpha rules.  A block whose range
//     holds no live key skips all of it and writes the dead partial;
//   * a block takes up to RB in {1, 4, 8} query rows (more rows are
//     more blocks over the same keys, read again from L2), so M = 16 keeps
//     its accumulator in registers: there is no limit on M.  The cells of
//     one KV head are rows of one block, so the baseline (C1) reads each
//     page once, as C2 does;
//   * paged_decode takes one block per (sequence, KV head, row group)
//     over the whole context and normalises in it.  At smollm's 24 such
//     blocks on 132 SMs it is still well under gathering the pages for
//     scaled_dot_product_attention (PERF.md, section 6), so a context is
//     not split over a thread-block cluster.  The config's `tile` is
//     validated only: the kernel groups keys its own way.
//     paged_decode_segmented takes one block per segment, whose bounds
//     [g * tps * tile, min((g + 1) * tps * tile, ctx)) are part of its
//     contract, since segment_reduce merges the partials.
//
// segment_reduce (the C3 merge) is folded into the segmented launch on the
// serving path (`pa_paged_decode_segmented_merged`): a merge kernel of its
// own reads a few KB and costs a launch and its host enqueue a layer a
// decode step, most of its time on a host-bound path.  Each segment block
// writes its partial as before, then arrives on a counter of its
// (sequence, KV head, row group); the last of the nseg blocks to arrive
// merges every partial (from L2, with __ldcg) and writes the normalised
// output.  No block waits for another, so residency cannot deadlock the
// grid, and the last block re-arms its counter to 0, so no memset is
// launched and the next launch (or a graph replay) finds it zeroed.  The
// merge is one device function (`merge_segments`) shared with the
// standalone `segment_reduce_kernel`: on the same partials the two give
// the same bits.
//
// `attend` (the scalar routine that stages K/V through shared memory) is
// left only for the fp32 prefill.
//
// Prefill in bf16 (`prefill_mma_kernel`): a Q-Block of block_q * group
// rows does up to block_q * group FLOP-pairs per key byte, so at the
// serving shapes it is bounded by operations, and runs on the tensor
// cores through the tile of attention_tile.cuh.  The rows of every
// Q-block of one KV head are cut into 16-row warp slabs; a block of 4
// warps takes 4 consecutive slabs, so M = block_q * group of any size up
// to 512 keeps its accumulator in registers (no shared-memory limit on
// M), and where M < 64 one block spans several consecutive Q-blocks,
// which share their K/V tiles whenever they belong to one sequence.  The
// block walks its warps' runs of equal sequence one after another, each
// run's 64-key tiles up to the last live key of its rows, and finds each
// key row's page through the page table itself (page = pt[key / ps], row
// = key % ps), so a tile may span pages of any size, 24 included.  The
// config's `tile` (C4) stays the decode kernels' knob: the prefill entry
// point still validates it, but this kernel's key tile is its own 64.
// Prefill in fp32 (`prefill_kernel`, the card-versus-CPU checks) stays on
// `attend`: the tensor cores cannot give fp32 at 1e-4.  The entry point
// picks the kernel by dtype, a choice by type and never a fallback.
//
// Semantics kept exactly from the Pallas kernels: the mask value is
// -0.7 * FLT_MAX (not -inf), the m_safe guard and alpha = 0 while a row
// has seen no live key, p rounded to the value dtype before p.V, the
// finaliser's l == 0 -> 1 (so dead rows, blocks and segments give exact
// zeros), and segment_reduce's dead-segment test m <= NEG / 2.
//
// Each entry point is a plain C function (device pointers, shapes,
// strides in elements, the stream) returning cudaGetLastError(), loaded
// from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "attention_tile.cuh"

namespace AT = attn_tile;

namespace {

constexpr float kNeg = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;        // K/V rows staged in shared memory at once
constexpr int kMaxHeadDim = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on H100

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp's astype
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory carve-up (floats) of one attention block with M query
// rows: q [M*D] | acc [M*D] | s [M*tile] | m [M] | l [M] | alpha [M] |
// kv [kChunk*(D+1)] (the +1 pad keeps the score loop free of bank
// conflicts).
__host__ __device__ inline size_t attend_smem_floats(int M, int D, int tile) {
  return (size_t)M * D * 2 + (size_t)M * tile + (size_t)M * 3 +
         (size_t)kChunk * (D + 1);
}

// Online-softmax attention of M query rows over KV tiles
// [t_begin, t_end) of one sequence and one KV head (paper §4.1 tiled
// softmax; `_flash_tile_update` in the Pallas kernel).  Keys at absolute
// position >= limit are masked; with `causal`, so is every key past the
// row's own position pos0 + row / group.  Leaves acc / m / l in shared
// memory for the caller's epilogue.
template <typename T>
__device__ void attend(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, long long k_page_stride,
                       long long v_page_stride, const int* __restrict__ pt_row,
                       int ps, int tile, int t_begin, int t_end, int limit,
                       bool causal, int pos0, int group, int M, int D,
                       float scale, float* smem) {
  float* q_s = smem;
  float* acc_s = q_s + M * D;
  float* s_s = acc_s + M * D;
  float* m_s = s_s + M * tile;
  float* l_s = m_s + M;
  float* a_s = l_s + M;
  float* kv_s = a_s + M;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = D + 1;

  for (int e = tid; e < M * D; e += kThreads) {
    q_s[e] = to_f<T>(q[e]);
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < M; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int kv0 = t * tile;
    const int page = pt_row[kv0 / ps];
    const int row0 = kv0 % ps;
    const T* kt = k + (long long)page * k_page_stride + (long long)row0 * D;
    const T* vt = v + (long long)page * v_page_stride + (long long)row0 * D;

    // scores s[r, j] = q_r . k_j * scale, masked to kNeg
    for (int c0 = 0; c0 < tile; c0 += kChunk) {
      const int cn = min(kChunk, tile - c0);
      for (int e = tid; e < cn * D; e += kThreads) {
        const int j = e / D, d = e - j * D;
        kv_s[j * dp + d] = to_f<T>(kt[(long long)(c0 + j) * D + d]);
      }
      __syncthreads();
      for (int e = tid; e < M * cn; e += kThreads) {
        const int r = e / cn, j = e - r * cn;
        const float* qr = q_s + r * D;
        const float* kj = kv_s + j * dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
        const int pos = kv0 + c0 + j;
        bool live = pos < limit;
        if (causal) live = live && pos <= pos0 + r / group;
        s_s[r * tile + c0 + j] = live ? dot * scale : kNeg;
      }
      __syncthreads();
    }

    // per-row running max / exp-sum update; p overwrites s, rounded to
    // the value dtype (Pallas: p.astype(v.dtype)) for the p.V product
    for (int r = warp; r < M; r += kWarps) {
      float* sr = s_s + r * tile;
      float mx = -FLT_MAX;
      for (int j = lane; j < tile; j += 32) mx = fmaxf(mx, sr[j]);
      const float m_cur = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      const float m_safe = m_new <= kNeg ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < tile; j += 32) {
        const float sv = sr[j];
        const float p = sv != kNeg ? expf(sv - m_safe) : 0.f;
        sum += p;
        sr[j] = to_f<T>(from_f<T>(p));
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha =
            m_prev <= kNeg ? 0.f : expf(fminf(m_prev - m_safe, 0.f));
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V
    for (int c0 = 0; c0 < tile; c0 += kChunk) {
      const int cn = min(kChunk, tile - c0);
      for (int e = tid; e < cn * D; e += kThreads) {
        const int j = e / D, d = e - j * D;
        kv_s[j * dp + d] = to_f<T>(vt[(long long)(c0 + j) * D + d]);
      }
      __syncthreads();
      for (int e = tid; e < M * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        const float* pr = s_s + r * tile + c0;
        float a = c0 == 0 ? acc_s[e] * a_s[r] : acc_s[e];
        for (int j = 0; j < cn; ++j) a = fmaf(pr[j], kv_s[j * dp + d], a);
        acc_s[e] = a;
      }
      __syncthreads();
    }
  }
}

// out[r, d] = acc / l with the l == 0 -> 1 guard (exact zeros for rows
// that saw no live key).
template <typename T>
__device__ void finalize(T* __restrict__ out, int M, int D, int tile,
                         const float* smem) {
  const float* acc_s = smem + M * D;
  const float* l_s = acc_s + M * D + M * tile + M;
  for (int e = threadIdx.x; e < M * D; e += kThreads) {
    const float l = l_s[e / D];
    out[e] = from_f<T>(acc_s[e] / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// paged_decode (C1/C2) and paged_decode_segmented (C3): the streaming
// decode kernel, replacing kernel.py:paged_decode and
// kernel.py:paged_decode_segmented (design in the note at the top).
// ---------------------------------------------------------------------------
constexpr int kStreamWarps = 4;   // warps of a streaming block
constexpr int kStreamThreads = 32 * kStreamWarps;

// 8 consecutive head-dim elements of one K or V row, as loaded: one
// 16-byte vector in bf16, two in fp32.
template <typename T>
struct Chunk {
  static constexpr int kVecs = sizeof(T) / 2;
  uint4 w[kVecs];
};

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < Chunk<T>::kVecs; ++i) c.w[i] = __ldg(s + i);
}

template <typename T>
__device__ __forceinline__ void zero_chunk(Chunk<T>& c) {
#pragma unroll
  for (int i = 0; i < Chunk<T>::kVecs; ++i) c.w[i] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void widen(const Chunk<float>& c, float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[4 * i] = __uint_as_float(c.w[i].x);
    x[4 * i + 1] = __uint_as_float(c.w[i].y);
    x[4 * i + 2] = __uint_as_float(c.w[i].z);
    x[4 * i + 3] = __uint_as_float(c.w[i].w);
  }
}

// bf16 -> fp32 is exact: the bf16 bits are the fp32's upper half
__device__ __forceinline__ void widen(const Chunk<__nv_bfloat16>& c,
                                      float (&x)[8]) {
  const unsigned u[4] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// D / 8 lanes rounded up to a power of two read one key row
__host__ __device__ inline int lanes_per_key(int D) {
  int lanes = 1;
  while (lanes * 8 < D) lanes <<= 1;
  return lanes;
}

// Query rows a block takes: 1 (group 1, the baseline variant), up to 4 in
// one block of 4 (smollm's 3), more in blocks of 8 (qwen2.5-3b's 8,
// glm4-9b's 16).
inline int rows_per_block(int R) {
  return R <= 1 ? 1 : R <= 4 ? 4 : 8;
}

// Shared-memory carve-up (floats) of a streaming block of RB rows:
// q [RB][8 * lanes] (scaled, zero past D and past the live rows) | the
// warps' partials m [W][RB] | l [W][RB] | acc [W][RB][D].  At most 41 KB
// (RB 8, D 256): every head dim the kernel takes fits.
inline size_t stream_smem_bytes(int RB, int D) {
  const size_t dq = 8 * lanes_per_key(D);
  return sizeof(float) * (RB * dq + 2 * kStreamWarps * RB +
                          (size_t)kStreamWarps * RB * D);
}

// The C3 merge (paper Listing 5) of rows r0 .. r0 + nrows - 1 of one
// (sequence, KV head): o [nseg][M][D], m / l [nseg][M] its partials, out
// [M][D].  Each segment is rescaled by exp(m_g - max m), a dead one (m <=
// NEG / 2) dropped, the segments summed in order 0 .. nseg - 1 and the sum
// normalised with l == 0 -> 1 (all-dead rows give exact zeros).  Both the
// standalone kernel and the fused epilogue call it, so on the same
// partials they give the same bits.  Loads bypass L1 (__ldcg): in the
// fused kernel other blocks wrote the partials.  The segment loops are
// unrolled so that 8 segments' loads are in flight at once (the sums keep
// their order): rolled, the last block's merge was a chain of dependent
// L2 round trips that outlasted the standalone kernel.
template <typename T>
__device__ void merge_segments(const float* o, const float* m, const float* l,
                               T* out, int nseg, int M, int D, int r0,
                               int nrows) {
  for (int e = threadIdx.x; e < nrows * D; e += blockDim.x) {
    const int r = r0 + e / D, d = e % D;
    float m_star = -FLT_MAX;
#pragma unroll 8
    for (int g = 0; g < nseg; ++g) m_star = fmaxf(m_star, __ldcg(m + g * M + r));
    const float m_safe = m_star > kNeg / 2 ? m_star : 0.f;
    float l_tot = 0.f, o_tot = 0.f;
#pragma unroll 8
    for (int g = 0; g < nseg; ++g) {
      const float mg = __ldcg(m + g * M + r);
      const float w = mg > kNeg / 2 ? expf(mg - m_safe) : 0.f;
      l_tot = fmaf(__ldcg(l + g * M + r), w, l_tot);
      o_tot = fmaf(__ldcg(o + ((long long)g * M + r) * D + d), w, o_tot);
    }
    out[(long long)r * D + d] = from_f<T>(o_tot / (l_tot == 0.f ? 1.f : l_tot));
  }
}

struct StreamArgs {
  const void* q;  // [S * Hkv * R, D]: the R rows of (s, h) back to back
  const void* k;  // tile view of the pages; strides in elements
  const void* v;
  const int* page_table;    // [S, Np]
  const int* context_lens;  // [S]
  void* out;                // paged_decode, merged: q's layout and dtype
  float* o_seg;             // segmented: [S, Hkv, nseg, R, D]
  float* m_seg;             // [S, Hkv, nseg, R]
  float* l_seg;
  int* counters;            // merged: [S * Hkv * row groups], all 0
  int Hkv, R, D;
  int nseg;    // segments (1 for paged_decode)
  int span;    // keys of a segment (tps * tile); unused by paged_decode
  int ps, Np;
  long long khs, kps, vhs, vps;
  float scale;
};

// Block (x = (s * Hkv + h) * nseg + g, y) takes rows y * RB .. of
// (sequence s, KV head h) over one key range [k0, k1): the segment g
// (kSeg), or the whole context.  Keys at or past min(context, Np * ps) are
// never read.  kMerge (with kSeg): the last segment block of (s, h, y)
// also merges the segments into `out`.
template <typename T, int RB, bool kSeg, bool kMerge>
__global__ void __launch_bounds__(kStreamThreads, 2)
    decode_stream_kernel(const StreamArgs a) {
  static_assert(kSeg || !kMerge, "the merge follows the segment partials");
  // keys a lane loads per step: 8 x 16 bytes of K and V in flight over
  // two steps (4 at RB 8, whose accumulator takes the registers)
  constexpr int kU = (RB >= 8 ? 2 : 4) / Chunk<T>::kVecs;
  extern __shared__ __align__(16) float dsm[];
  const int D = a.D, R = a.R;
  const int lanes = lanes_per_key(D);
  const int dq = 8 * lanes;
  float* q_s = dsm;
  float* wm_s = q_s + RB * dq;
  float* wl_s = wm_s + kStreamWarps * RB;
  float* wacc_s = wl_s + kStreamWarps * RB;

  const int sh = blockIdx.x / a.nseg;
  const int g = blockIdx.x - sh * a.nseg;
  const int s = sh / a.Hkv, h = sh - s * a.Hkv;
  const int r0 = blockIdx.y * RB;
  const int nrows = min(RB, R - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int lim = max(0, min(a.context_lens[s], a.Np * a.ps));
  int k0 = 0, k1 = lim;
  if constexpr (kSeg) {
    const long long b = (long long)g * a.span;
    k0 = (int)min(b, (long long)lim);
    k1 = (int)min(b + a.span, (long long)lim);
  }

  // a range without a live key (most of a long page table's segments)
  // skips to its partial: exactly m = kNeg, l = 0, acc = 0, which
  // segment_reduce's dead test relies on; in paged_decode a context-0
  // row, which the l == 0 -> 1 guard turns into exact zeros
  const bool has_keys = k0 < k1;  // block-uniform
  const long long row_base = (long long)sh * R + r0;
  if (has_keys) {
    const T* qb = static_cast<const T*>(a.q) + row_base * D;
    for (int e = tid; e < RB * dq; e += kStreamThreads) {
      const int r = e / dq, d = e - r * dq;
      q_s[e] = r < nrows && d < D ? to_f<T>(qb[r * D + d]) * a.scale : 0.f;
    }
    __syncthreads();

    // lane = kg * lanes + c: key group kg, elements 8c .. 8c + 7 of a row
    const int c = lane & (lanes - 1), kg = lane / lanes;
    const int kpw = 32 / lanes;  // keys a warp reads per load
    const int step = kpw * kU;   // keys a warp takes per step
    const bool has = 8 * c < D;
    const T* kh = static_cast<const T*>(a.k) + h * a.khs + 8 * c;
    const T* vh = static_cast<const T*>(a.v) + h * a.vhs + 8 * c;
    const int* pt_row = a.page_table + (long long)s * a.Np;

    float acc[RB][8], m[RB], l[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
    }

    // page and row of this lane's keys of the step at `base`, fetched one
    // step ahead of their loads
    int page[kU], prow[kU];
    auto fetch = [&](int base) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int key = base + u * kpw + kg;
        const int pi = key / a.ps;
        page[u] = key < k1 ? __ldg(pt_row + pi) : 0;
        prow[u] = key - pi * a.ps;
      }
    };
    // K and V of this lane's keys of the step at `base` (fetched); zeros
    // past k1 and past the head dim
    auto issue = [&](Chunk<T>(&kc)[kU], Chunk<T>(&vc)[kU], int base) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (base + u * kpw + kg < k1 && has) {
          const long long row = (long long)prow[u] * D;
          load_chunk(kc[u], kh + page[u] * a.kps + row);
          load_chunk(vc[u], vh + page[u] * a.vps + row);
        } else {
          zero_chunk(kc[u]);
          zero_chunk(vc[u]);
        }
      }
    };
    // the online-softmax update of the step at `base` from its K and V
    auto consume = [&](const Chunk<T>(&kc)[kU], const Chunk<T>(&vc)[kU],
                       int base) {
      bool live[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) live[u] = base + u * kpw + kg < k1;

      // this lane's share of q_r . k_u, completed across the key's lanes
      float sc[RB][kU];
      {
        float kf[kU][8];
#pragma unroll
        for (int u = 0; u < kU; ++u) widen(kc[u], kf[u]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float* qp = q_s + r * dq + 8 * c;
          const float4 qa = *reinterpret_cast<const float4*>(qp);
          const float4 qz = *reinterpret_cast<const float4*>(qp + 4);
          const float qr[8] = {qa.x, qa.y, qa.z, qa.w, qz.x, qz.y, qz.z, qz.w};
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) dot = fmaf(qr[e], kf[u][e], dot);
            sc[r][u] = dot;
          }
        }
      }
      for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int u = 0; u < kU; ++u)
            sc[r][u] += __shfl_xor_sync(0xffffffffu, sc[r][u], o);
      }

      // online softmax over this step's keys; p rounded to the value dtype
      // for p.V, l sums the fp32 p
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float mc = kNeg;
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (live[u]) mc = fmaxf(mc, sc[r][u]);
        const float m_new = fmaxf(m[r], mc);
        const float m_safe = m_new <= kNeg ? 0.f : m_new;
        const float alpha =
            m[r] <= kNeg ? 0.f : __expf(fminf(m[r] - m_safe, 0.f));
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float p = live[u] ? __expf(sc[r][u] - m_safe) : 0.f;
          sum += p;
          sc[r][u] = to_f<T>(from_f<T>(p));
        }
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float vf[8];
        widen(vc[u], vf);
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[r][e] = fmaf(sc[r][u], vf[e], acc[r][e]);
      }
    };

    // two steps in flight: a step's loads are issued before the one before
    // it is consumed (buffers a and b in turn); warp-uniform, no barrier
    const int stride = kStreamWarps * step;
    int base = k0 + warp * step;
    Chunk<T> ka[kU], va[kU], kb[kU], vb[kU];
    fetch(base);
    issue(ka, va, base);
    fetch(base + stride);
    for (; base < k1; base += 2 * stride) {
      issue(kb, vb, base + stride);
      fetch(base + 2 * stride);
      consume(ka, va, base);
      if (base + stride >= k1) break;
      issue(ka, va, base + 2 * stride);
      fetch(base + 3 * stride);
      consume(kb, vb, base + stride);
    }

    // merge the warp's key groups (a state without keys has weight 0)
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mn = fmaxf(m[r], mo);
        const float wa = m[r] <= kNeg ? 0.f : __expf(m[r] - mn);
        const float wb = mo <= kNeg ? 0.f : __expf(mo - mn);
        l[r] = l[r] * wa + lo * wb;
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[r][e] = acc[r][e] * wa +
                      __shfl_xor_sync(0xffffffffu, acc[r][e], o) * wb;
      }
    }
    if (kg == 0 && has) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float* dst = wacc_s + (warp * RB + r) * D + 8 * c;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        wm_s[warp * RB + r] = m[r];
        wl_s[warp * RB + r] = l[r];
      }
    }
    __syncthreads();
  }  // has_keys

  // merge the warps (a warp without keys has weight 0) into the segment's
  // partial, or normalise with the l == 0 -> 1 guard (context 0 gives
  // exact zeros)
  for (int e = tid; e < nrows * D; e += kStreamThreads) {
    const int r = e / D, d = e - r * D;
    float mx = kNeg, lt = 0.f, at = 0.f;
    if (has_keys) {
#pragma unroll
      for (int w = 0; w < kStreamWarps; ++w) mx = fmaxf(mx, wm_s[w * RB + r]);
#pragma unroll
      for (int w = 0; w < kStreamWarps; ++w) {
        const float mw = wm_s[w * RB + r];
        const float wt = mw <= kNeg ? 0.f : __expf(mw - mx);
        lt += wl_s[w * RB + r] * wt;
        at += wacc_s[(w * RB + r) * D + d] * wt;
      }
    }
    if constexpr (kSeg) {
      const long long row = ((long long)sh * a.nseg + g) * R + r0 + r;
      a.o_seg[row * D + d] = at;
      if (d == 0) {
        a.m_seg[row] = mx;
        a.l_seg[row] = lt;
      }
    } else {
      static_cast<T*>(a.out)[row_base * D + e] =
          from_f<T>(at / (lt == 0.f ? 1.f : lt));
    }
  }

  if constexpr (kMerge) {
    // publish the partial (every thread's stores, then one arrival);
    // the last of the nseg arrivals merges and re-arms the counter
    __shared__ int last;
    __threadfence();
    __syncthreads();
    int* counter = a.counters + (long long)sh * gridDim.y + blockIdx.y;
    if (tid == 0) last = atomicAdd(counter, 1) == a.nseg - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const long long seg0 = (long long)sh * a.nseg * R;  // (s, h, g 0, row 0)
    merge_segments<T>(a.o_seg + seg0 * D, a.m_seg + seg0, a.l_seg + seg0,
                      static_cast<T*>(a.out) + (long long)sh * R * D, a.nseg,
                      R, D, r0, nrows);
    if (tid == 0) *counter = 0;
  }
}

// ---------------------------------------------------------------------------
// segment_reduce — replaces kernel.py:segment_reduce (paper Listing 5) as
// a launch of its own, one block per (sequence, KV head).  The serving
// path runs the same merge in the segmented launch instead (kMerge).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const float* __restrict__ o_seg,
                          const float* __restrict__ m_seg,
                          const float* __restrict__ l_seg, T* __restrict__ out,
                          int nseg, int M, int D) {
  const long long b = blockIdx.x;  // s * Hkv + h
  merge_segments<T>(o_seg + b * nseg * M * D, m_seg + b * nseg * M,
                    l_seg + b * nseg * M, out + b * M * D, nseg, M, D, 0, M);
}

// ---------------------------------------------------------------------------
// paged_prefill_qblock — replaces kernel.py:paged_prefill_qblock (§6.1).
// One block per (Q block, KV head) with block_q * group rows
// (row = tok * group + g).  The block reads its own qb_seq / qb_pos0 and
// walks KV tiles only up to last_pos = min(pos0 + block_q - 1, ctx - 1),
// causal at pos0 + row / group.  Dead blocks (qb_seq < 0) write zeros.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ qb_seq,
                   const int* __restrict__ qb_pos0,
                   const int* __restrict__ page_table,
                   const int* __restrict__ context_lens, T* __restrict__ out,
                   int Hkv, int M, int D, int block_q, int group,
                   long long k_head_stride, long long k_page_stride,
                   long long v_head_stride, long long v_page_stride, int ps,
                   int tile, int Np, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;  // qb * Hkv + h
  const int qb = b / Hkv;
  const int h = b - qb * Hkv;
  const int seq = qb_seq[qb];
  const int seq_c = seq > 0 ? seq : 0;
  const int pos0 = qb_pos0[qb];
  const int ctx = context_lens[seq_c];
  const int last_pos = min(pos0 + block_q - 1, ctx - 1);
  const int num_tiles = Np * (ps / tile);
  const int n_t =
      (seq >= 0 && last_pos >= 0) ? min(last_pos / tile + 1, num_tiles) : 0;
  attend<T>(q + (long long)b * M * D, k + h * k_head_stride,
            v + h * v_head_stride, k_page_stride, v_page_stride,
            page_table + (long long)seq_c * Np, ps, tile, 0, n_t, ctx, true,
            pos0, group, M, D, scale, smem);
  finalize<T>(out + (long long)b * M * D, M, D, tile, smem);
}

// ---------------------------------------------------------------------------
// paged_prefill_qblock in bf16, on the tensor cores.  Block (x, h) takes
// warp slabs L = 4 x' + w (x' = gridDim.x - 1 - x: the later slabs, whose
// rows sit deeper in their sequence, go first) of KV head h; slab L is
// rows 16 (L % nslab) .. of Q-block L / nslab.  Row r of a live Q-block
// sees keys < min(ctx, pos0 + r / group + 1).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(AT::kThreads)
    prefill_mma_kernel(const AT::bf16* __restrict__ q,
                       const AT::bf16* __restrict__ k,
                       const AT::bf16* __restrict__ v,
                       const int* __restrict__ qb_seq,
                       const int* __restrict__ qb_pos0,
                       const int* __restrict__ page_table,
                       const int* __restrict__ context_lens,
                       AT::bf16* __restrict__ out, int NQB, int Hkv, int M,
                       int group, long long k_head_stride,
                       long long k_page_stride, long long v_head_stride,
                       long long v_page_stride, int ps, int Np, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AT::bf16* smem = reinterpret_cast<AT::bf16*>(smem_raw);
  const int nslab = (M + AT::kSlab - 1) / AT::kSlab;
  const int total = NQB * nslab;
  const int first = (gridDim.x - 1 - blockIdx.x) * AT::kWarps;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int max_ctx = Np * ps;

  // every warp's sequence (-1 dead Q-block, -2 no slab) and tile count,
  // known to every thread: the runs of equal sequence are walked together
  int seqs[AT::kWarps], tiles[AT::kWarps];
#pragma unroll
  for (int i = 0; i < AT::kWarps; ++i) {
    const int L = first + i;
    seqs[i] = L < total ? qb_seq[L / nslab] : -2;
    tiles[i] = 0;
    if (seqs[i] < 0) continue;
    const int r_last = min((L % nslab) * AT::kSlab + AT::kSlab, M) - 1;
    const int lim_last = min(min(context_lens[seqs[i]], max_ctx),
                             qb_pos0[L / nslab] + r_last / group + 1);
    tiles[i] = lim_last > 0 ? (lim_last + AT::kKeys - 1) / AT::kKeys : 0;
  }

  // this warp's slab: rows r0 .. r0 + valid - 1 of Q-block qb
  const int L = first + warp;
  const int qb = L < total ? L / nslab : 0;
  const int r0 = L < total ? (L % nslab) * AT::kSlab : 0;
  const int valid = L < total ? min(AT::kSlab, M - r0) : 0;
  const long long row0 = ((long long)qb * Hkv + h) * M + r0;
  const bool live = L < total && qb_seq[qb] >= 0;
  const int pos0 = live ? qb_pos0[qb] : 0;
  const int ctx = live ? min(context_lens[qb_seq[qb]], max_ctx) : 0;
  const int g = lane >> 2;
  const int lim[2] = {min(ctx, pos0 + (r0 + g) / group + 1),
                      min(ctx, pos0 + (r0 + g + 8) / group + 1)};
  const int all_live = min(ctx, pos0 + r0 / group + 1);

  AT::load_q_slab<D>(AT::Layout<D>::q(smem, warp), q + row0 * D, valid);
  AT::cp_async_commit();
  AT::cp_async_wait<0>();
  __syncwarp();
  AT::Warp<D> w;
  w.init(AT::Layout<D>::q(smem, warp));

  const AT::bf16* kh = k + h * k_head_stride;
  const AT::bf16* vh = v + h * v_head_stride;
  for (int a = 0; a < AT::kWarps;) {  // block-uniform
    int b = a + 1, n_tiles = tiles[a];
    while (b < AT::kWarps && seqs[b] == seqs[a])
      n_tiles = max(n_tiles, tiles[b++]);
    if (seqs[a] >= 0) {
      const int* pt_row = page_table + (long long)seqs[a] * Np;
      auto key_rows = [&](int key, const AT::bf16*& kr,
                          const AT::bf16*& vr) {
        const int pi = key / ps;
        const long long row = (long long)(key - pi * ps) * D;
        const long long page = pt_row[pi];
        kr = kh + page * k_page_stride + row;
        vr = vh + page * v_page_stride + row;
      };
      AT::walk<D>(w, smem, n_tiles, min(context_lens[seqs[a]], max_ctx), kh,
                  key_rows, warp >= a && warp < b, tiles[warp], all_live,
                  lim, scale);
    }
    a = b;
  }
  if (valid > 0) w.store(out + row0 * D, nullptr, valid);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

bool bad_dims(int M, int D, int ps, int tile) {
  return M <= 0 || D <= 0 || D > kMaxHeadDim || D % 8 != 0 || tile <= 0 ||
         ps % tile != 0;
}

template <typename T, int RB, bool kSeg, bool kMerge>
cudaError_t stream_launch(const StreamArgs& a, dim3 grid,
                          cudaStream_t stream) {
  auto kernel = decode_stream_kernel<T, RB, kSeg, kMerge>;
  const size_t smem = stream_smem_bytes(RB, a.D);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kStreamThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline int row_groups(int R) {
  const int RB = rows_per_block(R);
  return (R + RB - 1) / RB;
}

// One launch: S * Hkv * nseg blocks along x times the row groups along y.
template <typename T, bool kSeg, bool kMerge = false>
int stream_impl(const StreamArgs& a, int S, cudaStream_t stream) {
  if (S * a.Hkv == 0) return cudaSuccess;
  const dim3 grid(S * a.Hkv * a.nseg, row_groups(a.R));
  switch (rows_per_block(a.R)) {
    case 1: return stream_launch<T, 1, kSeg, kMerge>(a, grid, stream);
    case 4: return stream_launch<T, 4, kSeg, kMerge>(a, grid, stream);
    default: return stream_launch<T, 8, kSeg, kMerge>(a, grid, stream);
  }
}

bool bad_segments(int M, int D, int ps, int tile, int nseg, int tps, int Np) {
  return bad_dims(M, D, ps, tile) || nseg <= 0 || tps <= 0 || Np < 0 ||
         (long long)tps * tile > 0x7fffffffLL;
}

template <typename T>
int reduce_impl(const void* o_seg, const void* m_seg, const void* l_seg,
                void* out, int S, int Hkv, int nseg, int M, int D,
                cudaStream_t stream) {
  if (M <= 0 || D <= 0 || D > kMaxHeadDim || D % 8 != 0 || nseg <= 0)
    return cudaErrorInvalidValue;
  if (S * Hkv == 0) return cudaSuccess;
  segment_reduce_kernel<T><<<S * Hkv, kThreads, 0, stream>>>(
      (const float*)o_seg, (const float*)m_seg, (const float*)l_seg, (T*)out,
      nseg, M, D);
  return cudaGetLastError();
}

int prefill_impl(const void* q, const void* k, const void* v,
                 const void* qb_seq, const void* qb_pos0,
                 const void* page_table, const void* context_lens, void* out,
                 int NQB, int Hkv, int M, int D, int block_q, int group,
                 long long khs, long long kps, long long vhs, long long vps,
                 int ps, int tile, int Np, float scale, cudaStream_t stream) {
  if (bad_dims(M, D, ps, tile) || group <= 0 || block_q <= 0)
    return cudaErrorInvalidValue;
  if (NQB * Hkv == 0) return cudaSuccess;
  const size_t smem = attend_smem_floats(M, D, tile) * sizeof(float);
  cudaError_t err = prepare(prefill_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  prefill_kernel<float><<<NQB * Hkv, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)qb_seq,
      (const int*)qb_pos0, (const int*)page_table, (const int*)context_lens,
      (float*)out, Hkv, M, D, block_q, group, khs, kps, vhs, vps, ps, tile,
      Np, scale);
  return cudaGetLastError();
}

template <int D>
int prefill_mma_launch(const void* q, const void* k, const void* v,
                       const void* qb_seq, const void* qb_pos0,
                       const void* page_table, const void* context_lens,
                       void* out, int NQB, int Hkv, int M, int group,
                       long long khs, long long kps, long long vhs,
                       long long vps, int ps, int Np, float scale,
                       cudaStream_t stream) {
  cudaError_t err = AT::prepare<D>(prefill_mma_kernel<D>);
  if (err != cudaSuccess) return err;
  const int slabs = NQB * ((M + AT::kSlab - 1) / AT::kSlab);
  const dim3 grid((slabs + AT::kWarps - 1) / AT::kWarps, Hkv);
  prefill_mma_kernel<D>
      <<<grid, AT::kThreads, AT::Layout<D>::kBytes, stream>>>(
          (const AT::bf16*)q, (const AT::bf16*)k, (const AT::bf16*)v,
          (const int*)qb_seq, (const int*)qb_pos0, (const int*)page_table,
          (const int*)context_lens, (AT::bf16*)out, NQB, Hkv, M, group, khs,
          kps, vhs, vps, ps, Np, scale);
  return cudaGetLastError();
}

int prefill_mma_impl(const void* q, const void* k, const void* v,
                     const void* qb_seq, const void* qb_pos0,
                     const void* page_table, const void* context_lens,
                     void* out, int NQB, int Hkv, int M, int D, int block_q,
                     int group, long long khs, long long kps, long long vhs,
                     long long vps, int ps, int tile, int Np, float scale,
                     cudaStream_t stream) {
  if (bad_dims(M, D, ps, tile) || (D != 64 && D != 128) || group <= 0 ||
      block_q <= 0 || block_q * group != M)
    return cudaErrorInvalidValue;
  if (NQB * Hkv == 0) return cudaSuccess;
  return D == 64
             ? prefill_mma_launch<64>(q, k, v, qb_seq, qb_pos0, page_table,
                                      context_lens, out, NQB, Hkv, M, group,
                                      khs, kps, vhs, vps, ps, Np, scale,
                                      stream)
             : prefill_mma_launch<128>(q, k, v, qb_seq, qb_pos0, page_table,
                                       context_lens, out, NQB, Hkv, M, group,
                                       khs, kps, vhs, vps, ps, Np, scale,
                                       stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes).  `bf16` selects __nv_bfloat16 over float for the
// q / k / v / out element type; strides are in elements; every entry point
// returns a cudaError_t code (0 = success).
// ---------------------------------------------------------------------------
extern "C" {

size_t pa_attend_smem_bytes(int M, int D, int tile) {
  return attend_smem_floats(M, D, tile) * sizeof(float);
}

int pa_paged_decode(const void* q, const void* k, const void* v,
                    const void* page_table, const void* context_lens,
                    void* out, int S, int n_cells, int M, int D,
                    int cells_per_kv, long long khs, long long kps,
                    long long vhs, long long vps, int ps, int tile, int Np,
                    float scale, int bf16, void* stream) {
  if (bad_dims(M, D, ps, tile) || cells_per_kv <= 0 ||
      n_cells % cells_per_kv != 0 || Np < 0)
    return cudaErrorInvalidValue;
  // the cells of one KV head are M * cells_per_kv rows back to back
  const int R = M * cells_per_kv, Hkv = n_cells / cells_per_kv;
  const StreamArgs a{q, k, v, (const int*)page_table,
                     (const int*)context_lens, out, nullptr, nullptr,
                     nullptr, nullptr, Hkv, R, D, 1, 0, ps, Np, khs, kps,
                     vhs, vps, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? stream_impl<__nv_bfloat16, false>(a, S, st)
              : stream_impl<float, false>(a, S, st);
}

int pa_paged_decode_segmented(const void* q, const void* k, const void* v,
                              const void* page_table, const void* context_lens,
                              void* o_seg, void* m_seg, void* l_seg, int S,
                              int Hkv, int nseg, int tps, int M, int D,
                              long long khs, long long kps, long long vhs,
                              long long vps, int ps, int tile, int Np,
                              float scale, int bf16, void* stream) {
  if (bad_segments(M, D, ps, tile, nseg, tps, Np)) return cudaErrorInvalidValue;
  const StreamArgs a{q, k, v, (const int*)page_table,
                     (const int*)context_lens, nullptr, (float*)o_seg,
                     (float*)m_seg, (float*)l_seg, nullptr, Hkv, M, D, nseg,
                     tps * tile, ps, Np, khs, kps, vhs, vps, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? stream_impl<__nv_bfloat16, true>(a, S, st)
              : stream_impl<float, true>(a, S, st);
}

// paged_decode_segmented followed by segment_reduce in one launch: the
// partials (o_seg, m_seg, l_seg as above) are workspace, `out` [S, Hkv, M,
// D] in q's dtype; `counters` holds at least S * Hkv * row groups int32
// zeros and is left zeroed.
int pa_paged_decode_segmented_merged(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* context_lens, void* o_seg, void* m_seg, void* l_seg,
    void* out, void* counters, long long n_counters, int S, int Hkv, int nseg,
    int tps, int M, int D, long long khs, long long kps, long long vhs,
    long long vps, int ps, int tile, int Np, float scale, int bf16,
    void* stream) {
  if (bad_segments(M, D, ps, tile, nseg, tps, Np) ||
      n_counters < (long long)S * Hkv * row_groups(M))
    return cudaErrorInvalidValue;
  const StreamArgs a{q, k, v, (const int*)page_table,
                     (const int*)context_lens, out, (float*)o_seg,
                     (float*)m_seg, (float*)l_seg, (int*)counters, Hkv, M, D,
                     nseg, tps * tile, ps, Np, khs, kps, vhs, vps, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? stream_impl<__nv_bfloat16, true, true>(a, S, st)
              : stream_impl<float, true, true>(a, S, st);
}

int pa_segment_reduce(const void* o_seg, const void* m_seg, const void* l_seg,
                      void* out, int S, int Hkv, int nseg, int M, int D,
                      int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? reduce_impl<__nv_bfloat16>(o_seg, m_seg, l_seg, out, S, Hkv,
                                           nseg, M, D, st)
              : reduce_impl<float>(o_seg, m_seg, l_seg, out, S, Hkv, nseg, M,
                                   D, st);
}

int pa_paged_prefill_qblock(const void* q, const void* k, const void* v,
                            const void* qb_seq, const void* qb_pos0,
                            const void* page_table, const void* context_lens,
                            void* out, int NQB, int Hkv, int M, int D,
                            int block_q, int group, long long khs,
                            long long kps, long long vhs, long long vps,
                            int ps, int tile, int Np, float scale, int bf16,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? prefill_mma_impl(q, k, v, qb_seq, qb_pos0, page_table,
                                 context_lens, out, NQB, Hkv, M, D, block_q,
                                 group, khs, kps, vhs, vps, ps, tile, Np,
                                 scale, st)
              : prefill_impl(q, k, v, qb_seq, qb_pos0, page_table,
                             context_lens, out, NQB, Hkv, M, D, block_q,
                             group, khs, kps, vhs, vps, ps, tile, Np, scale,
                             st);
}

}  // extern "C"
