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
// Decode (the three decode kernels, both dtypes): bounded by bytes.  Every
// kernel reads each live K/V row of its (sequence, KV head) once per block
// and does 4*D FLOPs per (query row, key) pair, far below the ~295
// FLOP/byte the H100 needs before its tensor cores would be the limit.
// So the design streams K/V through shared memory once per block and
// keeps everything else (scores, the online-softmax state, the fp32
// accumulator) on chip:
//
//   * one thread block per output cell; a loop INSIDE the block walks
//     the KV tiles (the Pallas grid's sequential "arbitrary" axis), and
//     the loop bound `ceil(context / tile)` replaces the Pallas index-map
//     clamp: dead tiles are never visited, so a short sequence in a
//     full-width page table costs nothing past its context;
//   * a tile (any divisor of page_size, including non-powers of two)
//     lies inside one page, found through the page table by the block
//     itself (no scalar prefetch on a GPU);
//   * K and V rows are staged through shared memory kChunk rows at a
//     time, so the shared-memory footprint does not grow with the tile;
//   * scalar fp32 FMAs on the CUDA cores (`attend`).
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
// paged_decode — replaces kernel.py:paged_decode (C1/C2).
// One block per (sequence, cell).  C2 (gqa): a cell is a KV head with its
// `group` query rows, so each K/V page is read once per KV head.  C1
// (baseline): a cell is a query head (M = 1) reading KV head
// cell / cells_per_kv.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ page_table,
                  const int* __restrict__ context_lens, T* __restrict__ out,
                  int n_cells, int M, int D, int cells_per_kv,
                  long long k_head_stride, long long k_page_stride,
                  long long v_head_stride, long long v_page_stride, int ps,
                  int tile, int Np, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int s = b / n_cells;
  const int kvh = (b - s * n_cells) / cells_per_kv;
  const int ctx = context_lens[s];
  const int num_tiles = Np * (ps / tile);
  const int n_t = ctx > 0 ? min((ctx + tile - 1) / tile, num_tiles) : 0;
  attend<T>(q + (long long)b * M * D, k + kvh * k_head_stride,
            v + kvh * v_head_stride, k_page_stride, v_page_stride,
            page_table + (long long)s * Np, ps, tile, 0, n_t, ctx, false, 0,
            1, M, D, scale, smem);
  finalize<T>(out + (long long)b * M * D, M, D, tile, smem);
}

// ---------------------------------------------------------------------------
// paged_decode_segmented — replaces kernel.py:paged_decode_segmented (C3).
// One block per (sequence, KV head, segment) over tiles
// [seg * tps, (seg + 1) * tps) that lie below the context; writes the
// UNNORMALISED fp32 accumulator, running max and exp-sum.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_segmented_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ page_table,
                            const int* __restrict__ context_lens,
                            float* __restrict__ o_seg, float* __restrict__ m_seg,
                            float* __restrict__ l_seg, int Hkv, int nseg,
                            int tps, int M, int D, long long k_head_stride,
                            long long k_page_stride, long long v_head_stride,
                            long long v_page_stride, int ps, int tile, int Np,
                            float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;  // (s * Hkv + h) * nseg + g
  const int g = b % nseg;
  const int sh = b / nseg;
  const int s = sh / Hkv;
  const int h = sh - s * Hkv;
  const int ctx = context_lens[s];
  const int num_tiles = Np * (ps / tile);
  const int live_tiles =
      ctx > 0 ? min((ctx + tile - 1) / tile, num_tiles) : 0;
  const int t0 = g * tps;
  const int t1 = max(t0, min(t0 + tps, live_tiles));
  attend<T>(q + (long long)sh * M * D, k + h * k_head_stride,
            v + h * v_head_stride, k_page_stride, v_page_stride,
            page_table + (long long)s * Np, ps, tile, t0, t1, ctx, false, 0,
            1, M, D, scale, smem);
  const float* acc_s = smem + M * D;
  const float* m_s = acc_s + M * D + M * tile;
  const float* l_s = m_s + M;
  for (int e = threadIdx.x; e < M * D; e += kThreads)
    o_seg[(long long)b * M * D + e] = acc_s[e];
  for (int r = threadIdx.x; r < M; r += kThreads) {
    m_seg[(long long)b * M + r] = m_s[r];
    l_seg[(long long)b * M + r] = l_s[r];
  }
}

// ---------------------------------------------------------------------------
// segment_reduce — replaces kernel.py:segment_reduce (paper Listing 5).
// One block per (sequence, KV head): rescale each segment by
// exp(m_seg - max m), drop dead segments (m <= NEG / 2), sum, normalise.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const float* __restrict__ o_seg,
                          const float* __restrict__ m_seg,
                          const float* __restrict__ l_seg, T* __restrict__ out,
                          int nseg, int M, int D) {
  const int b = blockIdx.x;  // s * Hkv + h
  const float* o = o_seg + (long long)b * nseg * M * D;
  const float* m = m_seg + (long long)b * nseg * M;
  const float* l = l_seg + (long long)b * nseg * M;
  for (int e = threadIdx.x; e < M * D; e += kThreads) {
    const int r = e / D;
    float m_star = -FLT_MAX;
    for (int g = 0; g < nseg; ++g) m_star = fmaxf(m_star, m[g * M + r]);
    const float m_safe = m_star > kNeg / 2 ? m_star : 0.f;
    float l_tot = 0.f, o_tot = 0.f;
    for (int g = 0; g < nseg; ++g) {
      const float mg = m[g * M + r];
      const float w = mg > kNeg / 2 ? expf(mg - m_safe) : 0.f;
      l_tot += l[g * M + r] * w;
      o_tot += o[(long long)g * M * D + e] * w;
    }
    out[(long long)b * M * D + e] = from_f<T>(o_tot / (l_tot == 0.f ? 1.f : l_tot));
  }
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

template <typename T>
int decode_impl(const void* q, const void* k, const void* v,
                const void* page_table, const void* context_lens, void* out,
                int S, int n_cells, int M, int D, int cells_per_kv,
                long long khs, long long kps, long long vhs, long long vps,
                int ps, int tile, int Np, float scale, cudaStream_t stream) {
  if (bad_dims(M, D, ps, tile) || cells_per_kv <= 0) return cudaErrorInvalidValue;
  if (S * n_cells == 0) return cudaSuccess;
  const size_t smem = attend_smem_floats(M, D, tile) * sizeof(float);
  cudaError_t err = prepare(decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T><<<S * n_cells, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)page_table,
      (const int*)context_lens, (T*)out, n_cells, M, D, cells_per_kv, khs,
      kps, vhs, vps, ps, tile, Np, scale);
  return cudaGetLastError();
}

template <typename T>
int segmented_impl(const void* q, const void* k, const void* v,
                   const void* page_table, const void* context_lens,
                   void* o_seg, void* m_seg, void* l_seg, int S, int Hkv,
                   int nseg, int tps, int M, int D, long long khs,
                   long long kps, long long vhs, long long vps, int ps,
                   int tile, int Np, float scale, cudaStream_t stream) {
  if (bad_dims(M, D, ps, tile) || nseg <= 0 || tps <= 0)
    return cudaErrorInvalidValue;
  if (S * Hkv == 0) return cudaSuccess;
  const size_t smem = attend_smem_floats(M, D, tile) * sizeof(float);
  cudaError_t err = prepare(decode_segmented_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_segmented_kernel<T><<<S * Hkv * nseg, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)page_table,
      (const int*)context_lens, (float*)o_seg, (float*)m_seg, (float*)l_seg,
      Hkv, nseg, tps, M, D, khs, kps, vhs, vps, ps, tile, Np, scale);
  return cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? decode_impl<__nv_bfloat16>(q, k, v, page_table, context_lens,
                                           out, S, n_cells, M, D, cells_per_kv,
                                           khs, kps, vhs, vps, ps, tile, Np,
                                           scale, st)
              : decode_impl<float>(q, k, v, page_table, context_lens, out, S,
                                   n_cells, M, D, cells_per_kv, khs, kps, vhs,
                                   vps, ps, tile, Np, scale, st);
}

int pa_paged_decode_segmented(const void* q, const void* k, const void* v,
                              const void* page_table, const void* context_lens,
                              void* o_seg, void* m_seg, void* l_seg, int S,
                              int Hkv, int nseg, int tps, int M, int D,
                              long long khs, long long kps, long long vhs,
                              long long vps, int ps, int tile, int Np,
                              float scale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? segmented_impl<__nv_bfloat16>(
                    q, k, v, page_table, context_lens, o_seg, m_seg, l_seg, S,
                    Hkv, nseg, tps, M, D, khs, kps, vhs, vps, ps, tile, Np,
                    scale, st)
              : segmented_impl<float>(q, k, v, page_table, context_lens, o_seg,
                                      m_seg, l_seg, S, Hkv, nseg, tps, M, D,
                                      khs, kps, vhs, vps, ps, tile, Np, scale,
                                      st);
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
