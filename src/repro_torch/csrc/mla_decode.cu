// MLA latent paged decode for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no Pallas kernel: the reference decodes MLA (deepseek-v2) in the
// absorbed form through its pure-jnp path,
// src/repro/core/attention/backend.py:decode_attention("xla", q_eff,
// k_pages, None, ..., v_dim=r), outside any kernel of its own, and none of
// the port's paged kernels takes its shapes (one 576-wide "KV head" shared
// by every query head, V a 512-wide prefix of each K row).
//
// Inputs: q [S, H, D] (D = r + rope: the absorbed query [q_nope . wk_b |
// q_rope]), the layer's one page pool k_pages [P, ps, D] (rows [latent |
// k_rope]), page_table [S, Np] int32, context_lens [S] int32.  Output
// o_lat [S, H, DV] with DV = r, V being the first DV columns of each K row:
// o = softmax(scale * q . k^T) . k[:, :DV] over keys < context_lens[s].
// A row with context 0 is exact zeros.
//
// What bounds it on this card: bytes, just.  Each cached row (1,152 B in
// bf16 at deepseek-v2's r 512 + rope 64) is read once for the scores and
// once for P.V, by 128 heads: 128 x 2 x (576 + 512) = 278.5 kFLOP a row,
// ~242 FLOP a byte, near the H100's ridge (~295).  So the products belong
// on the tensor cores and each K tile must serve both products and as many
// heads as the registers allow:
//
//   bf16 (`mla_mma_kernel`, the serving dtype): one block per (32 heads,
//   KV segment, sequence), 8 warps.  The block streams its segment's keys
//   in 64-key tiles (73.7 KB each at D 576) through a two-stage cp.async
//   ring; every tile is read from memory once and used for Q.K^T and for
//   P.V.  Warp w owns slab w / 4 (16 heads) and quarter w % 4: for the
//   scores, a quarter of D (9 of its 36 k-steps, the Q fragments held in
//   registers), summed with the slab's other three quarters through shared
//   memory in a fixed order (so the four warps of a slab hold the same
//   scores, row max and row sum); for P.V, a quarter of DV (128 columns,
//   64 fp32 accumulators a thread, where all 512 would need 256).  Products
//   are mma.sync m16n8k16 bf16 x bf16 -> fp32 (mma_bf16.cuh), operands by
//   ldmatrix (V transposed on the fly from the same tile).  The softmax is
//   the Pallas kernels' `_flash_tile_update`: masked scores -0.7 * FLT_MAX,
//   m_safe, alpha = 0 before a row's first live key, l summing fp32 p, p
//   rounded to bf16 for P.V.  The block's heads of one sequence run side
//   by side (blockIdx.x is the head group), so the other head groups find
//   the tile in L2.
//
//   fp32 (`mla_fp32_kernel`, the card-versus-CPU checks): scalar fp32 FMAs,
//   16 heads and 32-key tiles a block, 256 threads: any D <= 576 and DV <=
//   min(D, 512).
//
// Split-KV segments.  A decode step of 8 sequences gives 8 x 4 = 32
// blocks, too few for 132 SMs, so the keys of a sequence are cut into
// `nseg` segments of `seg_keys` keys, chosen by the wrapper from the shapes
// alone (never from the context lengths: the launch captures into a CUDA
// graph).  With nseg > 1 each block writes its unnormalised fp32 partial
// (acc, m, l) and a second launch (`mla_merge_kernel`) merges a row's
// segments in order: o = sum acc_i e^(m_i - M) / sum l_i e^(m_i - M) over
// the segments that saw a live key.  With nseg == 1 the block writes o / l
// itself.  No host reads anywhere.
//
// wgmma over 64 heads a warpgroup and TMA page streaming are left to a
// later change.
//
// The entry point is a plain C function (device pointers, shapes, the
// stream) returning cudaGetLastError(), loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::bf16;
using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::ldsm_a;
using mma_bf16::ldsm_x4;
using mma_bf16::ldsm_x4_t;
using mma_bf16::mma16816;
using mma_bf16::pack_bf16;
using mma_bf16::quad_max;
using mma_bf16::quad_sum;

constexpr float kNeg = -0.7f * FLT_MAX;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on H100

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kKeys = 64;     // keys of one K tile
constexpr int kSlab = 16;     // heads of one warp's rows
constexpr int kSlabs = 2;     // slabs a block: 32 heads
constexpr int kQuarters = 4;  // warps a slab
constexpr int kWarps = kSlabs * kQuarters;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = kSlabs * kSlab;

template <int D, int DV>
struct Layout {
  static_assert(D % (16 * kQuarters) == 0 && DV % (16 * kQuarters) == 0,
                "D and DV split into four 16-wide quarters");
  static_assert(DV <= D, "V is a prefix of the K row");
  static constexpr int kStride = D + 8;  // bf16 row: +16 B against conflicts
  static constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  static constexpr int kTile = kKeys * kStride;
  static constexpr int kKSteps = D / 16 / kQuarters;  // a quarter's k-steps
  static constexpr int kVCols = DV / kQuarters;       // a warp's V columns
  static constexpr int kSStride = kKeys + 4;          // partial-score row
  static constexpr size_t kRing = 2 * (size_t)kTile * sizeof(bf16);
  static constexpr size_t kQ = (size_t)kHeads * kStride * sizeof(bf16);
  static constexpr size_t kPart =
      (size_t)kWarps * kSlab * kSStride * sizeof(float);
  // Q is read into registers before the first partial scores are written,
  // so the two share their bytes
  static constexpr size_t kBytes = kRing + (kQ > kPart ? kQ : kPart);
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// One K tile: keys kv0 .. kv0 + 63 of sequence row `pt` (its page-table
// row), those >= limit zero-filled.
template <int D, int DV>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* kp,
                                          const int* pt, int kv0, int limit,
                                          int ps) {
  using L = Layout<D, DV>;
  for (int e = threadIdx.x; e < kKeys * L::kChunks; e += kThreads) {
    const int j = e / L::kChunks, c = e - j * L::kChunks;
    const int key = kv0 + j;
    const bool ok = key < limit;
    const bf16* src = kp;
    if (ok) src = kp + ((long long)pt[key / ps] * ps + key % ps) * D + c * 8;
    cp_async16(dst + j * L::kStride + c * 8, src, ok);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    mla_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                   const int* __restrict__ page_table,
                   const int* __restrict__ context_lens,
                   bf16* __restrict__ out, float* __restrict__ part_o,
                   float* __restrict__ part_ml, int H, int Np, int ps,
                   int nseg, int seg_keys, float scale) {
  using L = Layout<D, DV>;
  constexpr int S_ = L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw + L::kRing);
  float* part = reinterpret_cast<float*>(smem_raw + L::kRing);

  const int h0 = blockIdx.x * kHeads, seg = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = warp / kQuarters, qt = warp % kQuarters;
  const int g = lane >> 2, tq = lane & 3;
  const int k_begin = seg * seg_keys;
  const int k_end = min(context_lens[s], k_begin + seg_keys);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                      : 0;
  const int head[2] = {h0 + slab * kSlab + g, h0 + slab * kSlab + g + 8};

  if (n_tiles == 0) {  // no live key in this segment (block-uniform)
    if (nseg == 1) {
      for (int e = threadIdx.x; e < kHeads * DV; e += kThreads) {
        const int hh = h0 + e / DV;
        if (hh < H) out[((long long)s * H + hh) * DV + e % DV] =
            __float2bfloat16(0.f);
      }
    } else if (threadIdx.x < kHeads && h0 + (int)threadIdx.x < H) {
      const long long r = ((long long)s * H + h0 + threadIdx.x) * nseg + seg;
      part_ml[2 * r] = kNeg;
      part_ml[2 * r + 1] = 0.f;
    }
    return;
  }

  // Q rows h0 .. h0 + 31 of sequence s (rows >= H zero-filled), then tile 0
  const bf16* qb = q + ((long long)s * H + h0) * D;
  for (int e = threadIdx.x; e < kHeads * L::kChunks; e += kThreads) {
    const int r = e / L::kChunks, c = e - r * L::kChunks;
    const bool ok = h0 + r < H;
    cp_async16(q_s + r * S_ + c * 8, ok ? qb + (long long)r * D + c * 8 : qb,
               ok);
  }
  cp_async_commit();
  const int* pt = page_table + (long long)s * Np;
  load_tile<D, DV>(ring, kp, pt, k_begin, k_end, ps);
  cp_async_commit();
  cp_async_wait<1>();  // Q landed
  __syncthreads();
  uint32_t qf[L::kKSteps][4];
#pragma unroll
  for (int i = 0; i < L::kKSteps; ++i)
    ldsm_a(qf[i], q_s + slab * kSlab * S_ + (qt * L::kKSteps + i) * 16, S_);

  float o[L::kVCols / 8][4];
#pragma unroll
  for (int n = 0; n < L::kVCols / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float* mine = part + warp * kSlab * L::kSStride;
  const float* slab_part = part + slab * kQuarters * kSlab * L::kSStride;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = k_begin + t * kKeys;
    if (t + 1 < n_tiles) {
      load_tile<D, DV>(ring + ((t + 1) & 1) * L::kTile, kp, pt, kv0 + kKeys,
                       k_end, ps);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed; Q / last tile's partials all read
    const bf16* k_s = ring + (t & 1) * L::kTile;

    // this warp's quarter of the scores: 16 heads x 64 keys over 9 k-steps
    float sp[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
      sp[j][0] = sp[j][1] = sp[j][2] = sp[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kKSteps; ++i) {
      const int kk = qt * L::kKSteps + i;
#pragma unroll
      for (int jp = 0; jp < kKeys / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * S_ +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(sp[2 * jp], qf[i], b[0], b[1]);
        mma16816(sp[2 * jp + 1], qf[i], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      *reinterpret_cast<float2*>(mine + g * L::kSStride + 8 * j + 2 * tq) =
          make_float2(sp[j][0], sp[j][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * L::kSStride + 8 * j +
                                 2 * tq) = make_float2(sp[j][2], sp[j][3]);
    }
    __syncthreads();

    // the slab's scores: its four quarters summed in order 0..3, scaled
    // and (last tile only) masked; then the online softmax
    const bool masked = kv0 + kKeys > k_end;
    float sc[kKeys / 8][4];
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = 8 * j + 2 * tq + (e & 1);
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < kQuarters; ++w)
          x += slab_part[(w * kSlab + row) * L::kSStride + col];
        x *= scale;
        if (masked && kv0 + col >= k_end) x = kNeg;
        sc[j][e] = x;
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
    float sum[2] = {0.f, 0.f};
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (masked && sc[j][e] == kNeg) ? 0.f
                                            : __expf(sc[j][e] - m_safe[e >> 1]);
        sum[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < L::kVCols / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P . V over this warp's V columns, V the tile's first DV columns
    const bf16* v_s = k_s + qt * L::kVCols;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < L::kVCols / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              S_ +
                         np * 16 + (lane >> 4) * 8);
        mma16816(o[2 * np], pa[kk], b[0], b[1]);
        mma16816(o[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // the tile and the partials are free again
  }

  // epilogue: o / l (one segment) or the fp32 partial (acc, m, l)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (head[r] >= H) continue;
    const long long row = (long long)s * H + head[r];
    const int c0 = qt * L::kVCols + 2 * tq;
    if (nseg == 1) {
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      bf16* dst = out + row * DV + c0;
#pragma unroll
      for (int n = 0; n < L::kVCols / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf16(o[n][2 * r] / l_safe, o[n][2 * r + 1] / l_safe);
    } else {
      const long long pr = row * nseg + seg;
      float* dst = part_o + pr * DV + c0;
#pragma unroll
      for (int n = 0; n < L::kVCols / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (qt == 0 && tq == 0) {
        part_ml[2 * pr] = m[r];
        part_ml[2 * pr + 1] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the scalar kernel (card-versus-CPU checks)
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;
constexpr int kF32Heads = 16;  // heads a block: one half-warp each
constexpr int kF32Keys = 32;   // keys a tile
constexpr int kF32MaxD = 576;
constexpr int kF32MaxDV = 512;  // two accumulator columns a thread

__host__ __device__ constexpr size_t f32_smem_floats(int D) {
  return (size_t)kF32Heads * D + (size_t)kF32Keys * (D + 1) +
         (size_t)kF32Heads * (kF32Keys + 1) + 3 * kF32Heads;
}

// max / sum over the 16 lanes (one half-warp) that share a row
__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kF32Threads)
    mla_fp32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                    const int* __restrict__ page_table,
                    const int* __restrict__ context_lens,
                    float* __restrict__ out, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int H, int D, int DV,
                    int Np, int ps, int nseg, int seg_keys, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int KS = D + 1;  // K row stride: the 16 keys of a half-warp on
                         // 16 different banks
  float* q_s = fsm;                              // [16][D]
  float* k_s = q_s + kF32Heads * D;              // [32][D + 1]
  float* p_s = k_s + kF32Keys * KS;              // [16][33]
  float* alpha_s = p_s + kF32Heads * (kF32Keys + 1);
  float* m_s = alpha_s + kF32Heads;
  float* l_s = m_s + kF32Heads;

  const int h0 = blockIdx.x * kF32Heads, seg = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 4, jj = tid & 15;  // scores: row r, keys jj, jj + 16
  const int k_begin = seg * seg_keys;
  const int k_end = min(context_lens[s], k_begin + seg_keys);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kF32Keys - 1) / kF32Keys : 0;
  const int nh = min(kF32Heads, H - h0);

  if (n_tiles == 0) {
    if (nseg == 1) {
      for (int e = tid; e < nh * DV; e += kF32Threads)
        out[((long long)s * H + h0 + e / DV) * DV + e % DV] = 0.f;
    } else if (tid < nh) {
      const long long pr = ((long long)s * H + h0 + tid) * nseg + seg;
      part_ml[2 * pr] = kNeg;
      part_ml[2 * pr + 1] = 0.f;
    }
    return;
  }

  for (int e = tid; e < kF32Heads * D; e += kF32Threads) {
    const int rr = e / D;
    q_s[e] = rr < nh ? q[((long long)s * H + h0 + rr) * D + e % D] : 0.f;
  }
  const int* pt = page_table + (long long)s * Np;
  float acc[kF32Heads][2];
#pragma unroll
  for (int i = 0; i < kF32Heads; ++i) acc[i][0] = acc[i][1] = 0.f;
  float m = kNeg, l = 0.f;  // row r's, the same in its 16 threads

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = k_begin + t * kF32Keys;
    __syncthreads();  // the previous tile's readers of k_s / p_s
    for (int e = tid; e < kF32Keys * D; e += kF32Threads) {
      const int j = e / D, d = e - j * D;
      const int key = kv0 + j;
      k_s[j * KS + d] =
          key < k_end
              ? kp[((long long)pt[key / ps] * ps + key % ps) * D + d]
              : 0.f;
    }
    __syncthreads();

    float sv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* kr = k_s + (jj + 16 * u) * KS;
      const float* qr = q_s + r * D;
      float x = 0.f;
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], kr[d], x);
      sv[u] = kv0 + jj + 16 * u < k_end ? x * scale : kNeg;
    }
    const float m_new = fmaxf(m, half_max(fmaxf(sv[0], sv[1])));
    const float m_safe = m_new <= kNeg ? 0.f : m_new;
    float p[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      p[u] = sv[u] == kNeg ? 0.f : expf(sv[u] - m_safe);
    const float alpha = m <= kNeg ? 0.f : expf(m - m_safe);
    l = l * alpha + half_sum(p[0] + p[1]);
    m = m_new;
    p_s[r * (kF32Keys + 1) + jj] = p[0];
    p_s[r * (kF32Keys + 1) + jj + 16] = p[1];
    if (jj == 0) alpha_s[r] = alpha;
    __syncthreads();

#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = tid + u * kF32Threads;
      if (c >= DV) continue;
#pragma unroll
      for (int i = 0; i < kF32Heads; ++i) {
        float a = acc[i][u] * alpha_s[i];
        for (int j = 0; j < kF32Keys; ++j)
          a = fmaf(p_s[i * (kF32Keys + 1) + j], k_s[j * KS + c], a);
        acc[i][u] = a;
      }
    }
  }
  if (jj == 0) {
    m_s[r] = m;
    l_s[r] = l;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = tid + u * kF32Threads;
    if (c >= DV) continue;
#pragma unroll
    for (int i = 0; i < kF32Heads; ++i) {
      if (i >= nh) continue;
      const long long row = (long long)s * H + h0 + i;
      if (nseg == 1) {
        const float l_safe = l_s[i] == 0.f ? 1.f : l_s[i];
        out[row * DV + c] = acc[i][u] / l_safe;
      } else {
        part_o[(row * nseg + seg) * DV + c] = acc[i][u];
      }
    }
  }
  if (nseg > 1 && tid < nh) {
    const long long pr = ((long long)s * H + h0 + tid) * nseg + seg;
    part_ml[2 * pr] = m_s[tid];
    part_ml[2 * pr + 1] = l_s[tid];
  }
}

// ---------------------------------------------------------------------------
// the merge of a row's segments (nseg > 1), both dtypes
// ---------------------------------------------------------------------------
constexpr int kMergeThreads = 128;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    mla_merge_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     int nseg, int DV) {
  const long long row = blockIdx.x;
  const float* ml = part_ml + row * nseg * 2;
  float mx = kNeg, den = 0.f;
  for (int i = 0; i < nseg; ++i)
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
  for (int i = 0; i < nseg; ++i)
    if (ml[2 * i + 1] > 0.f) den += ml[2 * i + 1] * expf(ml[2 * i] - mx);
  const float inv = den > 0.f ? 1.f / den : 0.f;
  for (int c = threadIdx.x; c < DV; c += kMergeThreads) {
    float a = 0.f;
    for (int i = 0; i < nseg; ++i)
      if (ml[2 * i + 1] > 0.f)
        a += part_o[(row * nseg + i) * DV + c] * expf(ml[2 * i] - mx);
    store(out + row * DV + c, a * inv);
  }
}

template <int D, int DV>
int launch_mma(const void* q, const void* kp, const int* pt, const int* ctx,
               void* out, float* part_o, float* part_ml, int S, int H,
               int Np, int ps, int nseg, int seg_keys, float scale,
               cudaStream_t st) {
  using L = Layout<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      mla_mma_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kHeads - 1) / kHeads, nseg, S);
  mla_mma_kernel<D, DV><<<grid, kThreads, L::kBytes, st>>>(
      (const bf16*)q, (const bf16*)kp, pt, ctx, (bf16*)out, part_o, part_ml,
      H, Np, ps, nseg, seg_keys, scale);
  return cudaGetLastError();
}

int launch_fp32(const void* q, const void* kp, const int* pt, const int* ctx,
                void* out, float* part_o, float* part_ml, int S, int H, int D,
                int DV, int Np, int ps, int nseg, int seg_keys, float scale,
                cudaStream_t st) {
  const size_t smem = f32_smem_floats(D) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      mla_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kF32Heads - 1) / kF32Heads, nseg, S);
  mla_fp32_kernel<<<grid, kF32Threads, smem, st>>>(
      (const float*)q, (const float*)kp, pt, ctx, (float*)out, part_o,
      part_ml, H, D, DV, Np, ps, nseg, seg_keys, scale);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (ctypes).  `use_bf16` selects the tensor-core kernel (D 576,
// DV 512: deepseek-v2's latent and rope widths; keys a segment a multiple
// of 64) over the scalar fp32 one (D <= 576, DV <= min(D, 512), keys a
// segment a multiple of 32).  part_o [S, H, nseg, DV] and part_ml [S, H,
// nseg, 2] fp32 are the segments' scratch (unused, may be null, when nseg
// is 1).  Returns a cudaError_t code.
// ---------------------------------------------------------------------------
extern "C" {

int mla_decode(const void* q, const void* k_pages, const void* page_table,
               const void* context_lens, void* out, void* part_o,
               void* part_ml, int S, int H, int D, int DV, int Np, int ps,
               int nseg, int seg_keys, float scale, int use_bf16,
               void* stream) {
  if (S < 0 || S > 65535 || H <= 0 || Np <= 0 || ps <= 0 || nseg <= 0 ||
      nseg > 65535 || seg_keys <= 0 || (long long)nseg * seg_keys <
      (long long)Np * ps || DV <= 0 || DV > D || DV % 8 || D % 8)
    return cudaErrorInvalidValue;
  if (use_bf16 ? (D != 576 || DV != 512 || seg_keys % kKeys)
           : (D > kF32MaxD || DV > kF32MaxDV || seg_keys % kF32Keys))
    return cudaErrorInvalidValue;
  if (nseg > 1 && (part_o == nullptr || part_ml == nullptr))
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* ctx = static_cast<const int*>(context_lens);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int err = use_bf16 ? launch_mma<576, 512>(q, k_pages, pt, ctx, out, po,
                                            pml, S, H, Np, ps, nseg,
                                            seg_keys, scale, st)
                     : launch_fp32(q, k_pages, pt, ctx, out, po, pml, S, H, D,
                                   DV, Np, ps, nseg, seg_keys, scale, st);
  if (err != cudaSuccess || nseg == 1) return err;
  if (use_bf16)
    mla_merge_kernel<bf16><<<S * H, kMergeThreads, 0, st>>>(
        po, pml, static_cast<bf16*>(out), nseg, DV);
  else
    mla_merge_kernel<float><<<S * H, kMergeThreads, 0, st>>>(
        po, pml, static_cast<float*>(out), nseg, DV);
  return cudaGetLastError();
}

}  // extern "C"
