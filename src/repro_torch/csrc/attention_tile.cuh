// The tensor-core attention tile shared by the bf16 flash-attention forward
// (flash_attention.cu) and the bf16 Q-Block paged prefill
// (paged_attention.cu), for NVIDIA Hopper (sm_90a).
//
// Both kernels compute the same thing: 16-row slabs of query rows against
// 64-key tiles, an online softmax, then P.V.  They differ only in how a
// key row is found (dense [BH, Skv, D] or through a page table) and where
// each row's causal limit lies, so everything else lives here:
//
//   * products on the tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> fp32,
//     operands fed from shared memory by ldmatrix (K as stored, V
//     transposed on the fly); one warp owns 16 query rows, and S = Q.K^T,
//     the fp32 O accumulator and the row max / sum stay in its registers
//     (FlashAttention-2 layout; each quad of lanes shares two rows, and
//     row reductions are two shuffles inside the quad);
//   * K/V tiles of kKeys = 64 keys stream through a two-stage cp.async
//     ring in shared memory (16 bytes a thread per copy, zero-filled past
//     the keys that exist), so tile t + 1 is in flight while tile t runs;
//     shared-memory rows are padded by 16 bytes so ldmatrix is free of
//     bank conflicts;
//   * the fp32 softmax of the Pallas kernels' `_flash_tile_update`, kept
//     exactly: masked scores are -0.7 * FLT_MAX (not -inf), m_safe = 0
//     while a row has seen no live key and alpha = 0 then, l sums the
//     fp32 p, and p is rounded to bf16 for P.V (with bf16 MMA inputs this
//     rounding is the reference's own p.astype(v.dtype)); the finaliser
//     maps l == 0 to 1, so rows with no live key are exact zeros, and
//     writes lse = m + log(l) (kNeg where l == 0) when asked;
//   * element-wise masks only on tiles that cross a warp's limit: a tile
//     whose keys are live for every row of the slab skips the compares;
//   * the value width DV may differ from the key width D (MLA's expanded
//     prefill: D 192 = nope 128 + rope 64, DV 128); it defaults to D.
//
// bf16 only: the tensor cores cannot give fp32 at the 1e-4 the card-versus
// CPU checks hold, so fp32 stays on the scalar kernels of each .cu (a
// choice by dtype at the entry point, never a fallback on failure).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"

namespace attn_tile {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -0.7f * FLT_MAX;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSlab = 16;                     // query rows of one warp
constexpr int kBlockRows = kWarps * kSlab;    // 64
constexpr int kKeys = 64;                     // keys of one K/V tile
constexpr int kStages = 2;                    // K/V tiles in flight

// Shared memory, in bf16 elements: Q [kBlockRows][kStride] then kStages x
// (K [kKeys][kStride], V [kKeys][kVStride]).
template <int D, int DV = D>
struct Layout {
  static_assert(D % 16 == 0 && DV % 16 == 0,
                "head dims must be multiples of 16");
  // +16 B a row: the 8 rows of one ldmatrix hit 8 different bank groups
  static constexpr int kStride = D + 8;
  static constexpr int kVStride = DV + 8;
  static constexpr int kChunks = D / 8;    // 16-byte chunks per Q / K row
  static constexpr int kVChunks = DV / 8;  // per V row
  static constexpr int kTile = kKeys * kStride;
  static constexpr int kVTile = kKeys * kVStride;
  static constexpr int kQ = kBlockRows * kStride;
  static constexpr size_t kBytes =
      (size_t)(kQ + kStages * (kTile + kVTile)) * sizeof(bf16);
  __device__ static bf16* q(bf16* smem, int warp) {
    return smem + warp * kSlab * kStride;
  }
  __device__ static bf16* k(bf16* smem, int stage) {
    return smem + kQ + stage * (kTile + kVTile);
  }
  __device__ static bf16* v(bf16* smem, int stage) {
    return smem + kQ + stage * (kTile + kVTile) + kTile;
  }
};

// The PTX wrappers (cp.async, ldmatrix, mma.sync, bf16 packing, quad
// reductions) live in mma_bf16.cuh, shared with the SSM kernels.
using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::ldsm_x4;
using mma_bf16::ldsm_x4_t;
using mma_bf16::mma16816;
using mma_bf16::pack_bf16;
using mma_bf16::quad_max;
using mma_bf16::quad_sum;

// ---------------------------------------------------------------------------
// loads
// ---------------------------------------------------------------------------

// A warp's 16 query rows (rows >= valid zero-filled) into its Q slab.
template <int D>
__device__ __forceinline__ void load_q_slab(bf16* q_s, const bf16* q,
                                            int valid) {
  constexpr int C = Layout<D>::kChunks;
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < kSlab * C; e += 32) {
    const int r = e / C, c = e % C;
    const bool ok = r < valid;
    cp_async16(q_s + r * Layout<D>::kStride + c * 8,
               ok ? q + (long long)r * D + c * 8 : q, ok);
  }
}

// One K/V tile of kKeys rows starting at key kv0, by the whole block.
// rows(key, &k_row, &v_row) gives the global rows of a key < limit; keys
// >= limit are zero-filled, so P.V never touches memory past them.
template <int D, int DV = D, class Rows>
__device__ __forceinline__ void load_kv_tile(bf16* k_s, bf16* v_s, int kv0,
                                             int limit, const bf16* base,
                                             Rows rows) {
  using L = Layout<D, DV>;
  if constexpr (D == DV) {  // one row of K and one of V a thread a pass
    constexpr int C = L::kChunks;
    constexpr int kRowsPerPass = kThreads / C;
    const int c = threadIdx.x % C;
    for (int j = threadIdx.x / C; j < kKeys; j += kRowsPerPass) {
      const int key = kv0 + j;
      const bool ok = key < limit;
      const bf16* kr = base;
      const bf16* vr = base;
      if (ok) rows(key, kr, vr);
      cp_async16(k_s + j * L::kStride + c * 8, ok ? kr + c * 8 : base, ok);
      cp_async16(v_s + j * L::kVStride + c * 8, ok ? vr + c * 8 : base, ok);
    }
  } else {  // K and V rows of different widths: chunk by chunk
    for (int e = threadIdx.x; e < kKeys * (L::kChunks + L::kVChunks);
         e += kThreads) {
      const bool is_k = e < kKeys * L::kChunks;
      const int f = is_k ? e : e - kKeys * L::kChunks;
      const int C = is_k ? L::kChunks : L::kVChunks;
      const int j = f / C, c = f - j * C;
      const int key = kv0 + j;
      const bool ok = key < limit;
      const bf16* kr = base;
      const bf16* vr = base;
      if (ok) rows(key, kr, vr);
      const bf16* src = is_k ? kr : vr;
      cp_async16((is_k ? k_s + j * L::kStride : v_s + j * L::kVStride) +
                     c * 8,
                 ok ? src + c * 8 : base, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// one warp's 16 rows: registers and the tile step
// ---------------------------------------------------------------------------

// Thread (lane) holds rows g = lane / 4 and g + 8 of the slab; o[n] holds
// columns 8n + 2 (lane % 4) and + 1 of both rows (mma's C layout).
template <int D, int DV = D>
struct Warp {
  uint32_t qf[D / 16][4];  // Q as mma A fragments, one per 16 columns
  float o[DV / 8][4];
  float m[2], l[2];

  __device__ void init(const bf16* q_s) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qf[kk], q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                Layout<D>::kStride +
                          kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
  }

  // One 64-key tile at keys kv0..: lim[r] is the exclusive key limit of
  // this thread's row r (0: row g, 1: row g + 8); kMasked applies it.
  template <bool kMasked>
  __device__ __forceinline__ void step(const bf16* k_s, const bf16* v_s,
                                       float scale, int kv0,
                                       const int (&lim)[2]) {
    constexpr int S = Layout<D, DV>::kStride;
    constexpr int SV = Layout<D, DV>::kVStride;
    constexpr int NT = kKeys / 8;  // score n-tiles
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * S +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * jp], qf[kk], b[0], b[1]);
        mma16816(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask, running max
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (kMasked && kv0 + j * 8 + 2 * tq + (e & 1) >= lim[e >> 1]) x = kNeg;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_safe[r] = m_new <= kNeg ? 0.f : m_new;
      alpha[r] = m[r] <= kNeg ? 0.f : __expf(m[r] - m_safe[r]);
      m[r] = m_new;
    }

    // p in fp32 for l; rounded to bf16 as P.V's A fragments
    float sum[2] = {0.f, 0.f};
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (kMasked && s[j][e] == kNeg) ? 0.f
                                            : __expf(s[j][e] - m_safe[e >> 1]);
        sum[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P . V
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < DV / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                SV +
                         np * 16 + (lane >> 4) * 8);
        mma16816(o[2 * np], pa[kk], b[0], b[1]);
        mma16816(o[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }
  }

  // out rows (row-major [., DV], row 0 = the slab's first) = o / l with
  // l == 0 -> 1; rows >= valid are not written.  lse (may be null) gets
  // m + log(l), kNeg where l == 0.
  __device__ void store(bf16* out, float* lse, int valid) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= valid) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      bf16* dst = out + (long long)row * DV + 2 * tq;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf16(o[n][2 * r] / l_safe, o[n][2 * r + 1] / l_safe);
      if (lse != nullptr && tq == 0)
        lse[row] = l[r] == 0.f ? kNeg : m[r] + logf(l_safe);
    }
  }
};

// ---------------------------------------------------------------------------
// the block's walk over one key sequence
// ---------------------------------------------------------------------------

// Tiles [0, n_tiles) of one key sequence (n_tiles block-uniform), through
// the cp.async ring, by every warp of the block.  A warp with `on` set
// computes tiles t < tiles; the tile at kv0 is masked element-wise only
// when kv0 + kKeys > all_live (keys below all_live are live for every row
// of the warp).  Keys >= limit are zero-filled.  Ends with every copy
// landed and a barrier, so the ring is free for the next walk.
template <int D, int DV = D, class Rows>
__device__ __forceinline__ void walk(Warp<D, DV>& w, bf16* smem, int n_tiles,
                                     int limit, const bf16* base, Rows rows,
                                     bool on, int tiles, int all_live,
                                     const int (&lim)[2], float scale) {
  using L = Layout<D, DV>;
  if (n_tiles <= 0) return;
  load_kv_tile<D, DV>(L::k(smem, 0), L::v(smem, 0), 0, limit, base, rows);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    if (t + 1 < n_tiles) {
      const int nx = (t + 1) % kStages;
      load_kv_tile<D, DV>(L::k(smem, nx), L::v(smem, nx), (t + 1) * kKeys,
                          limit, base, rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kv0 = t * kKeys;
    if (on && t < tiles) {  // warp-uniform
      if (kv0 + kKeys > all_live)
        w.template step<true>(L::k(smem, st), L::v(smem, st), scale, kv0, lim);
      else
        w.template step<false>(L::k(smem, st), L::v(smem, st), scale, kv0,
                               lim);
    }
    __syncthreads();
  }
}

template <int D, int DV = D, class K>
cudaError_t prepare(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Layout<D, DV>::kBytes);
}

}  // namespace attn_tile
