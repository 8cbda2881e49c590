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
// What bounds it on this card: both rates at once.  Each cached row (1,152
// B in bf16 at deepseek-v2's r 512 + rope 64) is read once for the scores
// and once for P.V, by 128 heads: 128 x 2 x (576 + 512) = 278.5 kFLOP a
// row, ~242 FLOP a byte, just under the H100's ridge (~295).  So the pages
// have to stream at near HBM rate while the tensor cores run near their
// peak, and each K tile must serve both products and as many heads as the
// registers allow:
//
//   bf16 (`mla_wgmma_kernel`, the serving dtype): one block per (64 heads,
//   KV segment, sequence): one wgmma M tile.  64 heads is the most a block
//   can hold: O [64 x 512] fp32 is 128 KB, half the SM's register file,
//   split over two consumer warpgroups at 128 registers a thread (128 heads
//   would need all 256 KB).  Three warpgroups of 128 threads:
//     - the producer (warpgroup 0, setmaxnreg 40): one warp streams the
//       segment's keys in tiles of KT = 64 keys through a two-stage ring of
//       TMA loads, 128-byte swizzled, into the layout wgmma reads.  The
//       3-D tensor map over the pool [P, ps, D] has a box of 64 columns x
//       min(ps, KT) rows x 1 page: a tile is KT / min(ps, KT) page pieces x
//       9 column blocks, the lane of each piece reading its page-table
//       entry a tile ahead.  Pages wholly past the context are never
//       loaded (their entries may be stale);
//     - consumer 0 (warpgroup 1, setmaxnreg 232) loads Q [64 x 576] once
//       (cp.async, swizzled, rows >= H zero), then a tile: S = Q K^T [64 x
//       64] with 36 wgmma m64n64k16 (both operands in shared memory), the
//       online softmax on S in registers (a row's 64 keys lie in one quad
//       of lanes: no shared-memory score exchange; a full tile runs no mask
//       arithmetic), P (bf16) and each row's rescale factor to shared
//       memory, then O[:, 0:256] += P V;
//     - consumer 1 (warpgroup 2, setmaxnreg 232): O[:, 256:512] += P V.
//   V is the tile's first 512 columns read as wgmma's B with the transpose
//   bit (m64n256k16), so a tile leaves HBM once and shared memory once a
//   product.  mbarriers mark "tile full" (TMA bytes), "tile free" (both
//   consumers), "P ready" and "P free"; no block-wide barrier runs in the
//   loop, and the producer refills a stage while the consumers compute.
//   Keys past the context inside the last tile are masked in S and their
//   V rows zeroed in shared memory before P.V (a whole-page load brings in
//   the rest of the page, which may hold anything, NaN too: 0 x NaN is
//   NaN).  The softmax is the Pallas kernels' `_flash_tile_update`: masked
//   scores -0.7 * FLT_MAX, m_safe, alpha = 0 before a row's first live
//   key, l summing fp32 p, p rounded to bf16 for P.V.  The two 64-head
//   halves of a sequence run side by side (blockIdx.x), so the second
//   finds each tile in L2.
//
//   Shared memory: Q 73,728 B + 2 x 64-key tiles (147,456 B) + P 8,192 B =
//   229,376 of 232,448 B, so the ring holds two tiles and a tile's load
//   has one tile of compute to land in: the time a tile is the larger of
//   that load's latency and the consumers' S + softmax + P.V, which run in
//   sequence (S reads both operands from shared memory at about its
//   bandwidth).  32-key tiles in four stages would spend the same bytes
//   on a deeper ring; measured slower on the card (PERF.md), not built.
//
//   fp32 (`mla_fp32_kernel`, the card-versus-CPU checks): scalar fp32 FMAs,
//   16 heads and 32-key tiles a block, 256 threads: any D <= 576 and DV <=
//   min(D, 512).
//
// Split-KV segments.  A decode step of 8 sequences gives 8 x 2 = 16
// blocks, too few for 132 SMs, so the keys of a sequence are cut into
// `nseg` segments of `seg_keys` keys, chosen by the wrapper from the shapes
// alone (never from the context lengths: the launch captures into a CUDA
// graph).  With nseg > 1 each block writes its unnormalised fp32 partial
// (acc, m, l) and a second launch (`mla_merge_kernel`) merges a row's
// segments in order: o = sum acc_i e^(m_i - M) / sum l_i e^(m_i - M) over
// the segments that saw a live key.  With nseg == 1 the block writes o / l
// itself.  No host reads anywhere.
//
// The tensor map is encoded on the host by cuTensorMapEncodeTiled, an
// entry point looked up at run time (the library links no -lcuda), cached
// by (pool pointer, page size) in tma_map.cuh, and passed by value as a
// __grid_constant__ parameter, so a CUDA graph captures it.  Its page extent is left open:
// the kernel trusts the page table's entries below each context, as the
// plain version's gather does.
//
// Tests: on the CPU, `tests/test_torch_mla.py` holds the plain version
// against the reference; on the card, `python -m pytest -q -m cuda
// tests/test_torch_cuda_kernels.py -k mla` and `chip_smoke.py` phase 22.
//
// The entry point is a plain C function (device pointers, shapes, the
// stream) returning cudaGetLastError(), loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"
#include "tma_map.cuh"
#include "wgmma_tma.cuh"

namespace {

using mma_bf16::bf16;
using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::pack_bf16;
using mma_bf16::quad_max;
using mma_bf16::quad_sum;

constexpr float kNeg = -0.7f * FLT_MAX;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on H100

// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma kernel
// ---------------------------------------------------------------------------
constexpr int kD = 576;                // deepseek-v2: r 512 + rope 64
constexpr int kDV = 512;
constexpr int kHeads = 64;             // a block's heads: one wgmma M tile
constexpr int kBlocks = kD / 64;       // 64-column line blocks of a row: 9
constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kThreads = 3 * kWg;      // producer + two consumers
constexpr int kVCols = kDV / 2;        // a consumer's V columns: 256
constexpr int kQBytes = kBlocks * kHeads * 128;

constexpr int KT = 64;                 // keys a tile

// The shared-memory plan: Q, a ring of kStages tiles, P [64 x 64], alpha
// and the final (m, l) of the 64 rows, the barriers, and 1 KB to align the
// swizzled operands.
struct Tile {
  static constexpr int kStages = 2;
  static constexpr int kBlockBytes = KT * 128;  // one line block of a tile
  static constexpr int kBytes = kBlocks * kBlockBytes;
  static constexpr size_t kRing = kQBytes;
  static constexpr size_t kP = kRing + (size_t)kStages * kBytes;
  static constexpr size_t kAlpha = kP + kHeads * 128;
  static constexpr size_t kML = kAlpha + kHeads * sizeof(float);
  static constexpr size_t kBars = kML + 2 * kHeads * sizeof(float);
  static constexpr size_t kSmem = kBars + (2 * kStages + 2) * 8 + 1024;
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

// zero the V columns [c0 * 64, c0 * 64 + 256) of keys [live, KT) of a tile
// (whole 128-byte lines: the swizzle only permutes inside a line)
__device__ __forceinline__ void zero_dead_rows(unsigned char* tile, int live,
                                               int c0, int tid) {
  const int n = (KT - live) * 4 * 8;  // 16-byte units
  for (int e = tid; e < n; e += kWg) {
    const int row = live + e / 32, c = c0 + (e >> 3) % 4, u = e & 7;
    *reinterpret_cast<uint4*>(tile + c * Tile::kBlockBytes + row * 128 +
                              u * 16) = make_uint4(0, 0, 0, 0);
  }
}

// S = Q K^T [64 x KT] of one tile into `sc`: 36 k-steps of 16, both
// operands in shared memory; committed, not waited for
__device__ __forceinline__ void issue_scores(float (&sc)[KT / 2], uint64_t dq,
                                             const unsigned char* tile) {
  const uint64_t dk = hopper::desc_sw128(tile, 16, 1024);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) {
    const uint64_t a = dq + (((k >> 2) * kHeads * 128 + (k & 3) * 32) >> 4);
    const uint64_t b =
        dk + (((k >> 2) * Tile::kBlockBytes + (k & 3) * 32) >> 4);
    hopper::wgmma_m64n64k16(sc, a, b, k > 0);
  }
  hopper::wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Consumer 0's online softmax of one tile's scores, in place: sc becomes
// the fp32 p of this thread's rows r0 and r0 + 8 (a row's keys lie in one
// quad of lanes).  kMasked (the segment's last tile, keys >= live dead)
// is a template flag, so a full tile runs no mask arithmetic.  m is kept
// in the scores' units (scale . q k), the max taken over the scaled scores
// (the raw scores' max is theirs only for scale > 0); exp(x - m) runs as
// one FMA and one ex2 of the raw score.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[KT / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int live,
                                             float scale, int tq) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
    if (!kMasked || col < live)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i] * scale);
  }
  float neg[2];  // -m_safe, in ex2's units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // key 0 of every tile is live, so the quad's max is a live score
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    const float m_safe = m_new <= kNeg ? 0.f : m_new;
    alpha[r] = m[r] <= kNeg ? 0.f : ex2((m[r] - m_safe) * kLog2e);
    m[r] = m_new;
    neg[r] = -m_safe * kLog2e;
  }
  const float c = scale * kLog2e;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * tq + (i & 1), r = (i >> 1) & 1;
    const float p =
        kMasked && col >= live ? 0.f : ex2(fmaf(sc[i], c, neg[r]));
    sum[r] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
}

// P (bf16, 128-byte swizzled [64 x 64]) and each row's alpha to shared
// memory, visible to wgmma; then "P ready"
__device__ __forceinline__ void store_p(const float (&sc)[KT / 2],
                                        const float (&alpha)[2],
                                        unsigned char* p_s, float* alpha_s,
                                        int r0, int tq, uint64_t* p_full) {
#pragma unroll
  for (int i = 0; i < KT / 2; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * tq;
    *reinterpret_cast<uint32_t*>(p_s + row * 128 +
                                 (((col >> 3) ^ (row & 7)) << 4) +
                                 (col & 7) * 2) = pack_bf16(sc[i], sc[i + 1]);
  }
  if (tq == 0) {
    alpha_s[r0] = alpha[0];
    alpha_s[r0 + 8] = alpha[1];
  }
  hopper::fence_proxy_async();
  hopper::mbar_arrive(p_full);
}

// O *= alpha, row by row; skipped by a warp whose rows all keep their max
// (alpha 1: the same bits)
__device__ __forceinline__ void rescale(float (&o)[128],
                                        const float (&alpha)[2]) {
  if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                     const bf16* __restrict__ q,
                     const int* __restrict__ page_table,
                     const int* __restrict__ context_lens,
                     bf16* __restrict__ out, float* __restrict__ part_o,
                     float* __restrict__ part_ml, int H, int Np, int ps,
                     int box_rows, int nseg, int seg_keys, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(sm);
  unsigned char* ring = sm + Tile::kRing;
  unsigned char* p_s = sm + Tile::kP;
  float* alpha_s = reinterpret_cast<float*>(sm + Tile::kAlpha);
  float* ml_s = reinterpret_cast<float*>(sm + Tile::kML);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Tile::kBars);
  uint64_t* empty = full + Tile::kStages;
  uint64_t* p_full = empty + Tile::kStages;
  uint64_t* p_free = p_full + 1;

  const int h0 = blockIdx.x * kHeads, seg = blockIdx.y, s = blockIdx.z;
  const int k_begin = seg * seg_keys;
  const int k_end =
      min(min(context_lens[s], Np * ps), k_begin + seg_keys);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;

  if (n_tiles == 0) {  // no live key in this segment (block-uniform)
    if (nseg == 1) {
      for (int e = threadIdx.x; e < kHeads * kDV; e += kThreads) {
        const int hh = h0 + e / kDV;
        if (hh < H) out[((long long)s * H + hh) * kDV + e % kDV] =
            __float2bfloat16(0.f);
      }
    } else if (threadIdx.x < kHeads && h0 + (int)threadIdx.x < H) {
      const long long r = ((long long)s * H + h0 + threadIdx.x) * nseg + seg;
      part_ml[2 * r] = kNeg;
      part_ml[2 * r + 1] = 0.f;
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < Tile::kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 2 * kWg);
    }
    hopper::mbar_init(p_full, kWg);
    hopper::mbar_init(p_free, kWg);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  if (wg == 0) {
    // ---- producer: one warp streams the tiles ----------------------------
    hopper::setmaxnreg_dec<40>();
    if (tid < 32) {
      const int lane = tid;
      const int pieces = KT / box_rows;  // page pieces along a tile's keys
      const int* pt = page_table + (long long)s * Np;
      if (lane == 0) hopper::tma_prefetch_map(&k_map);
      // this lane's piece of tile t: its page (0 when past the context)
      auto page_of = [&](int t) {
        const int key = k_begin + t * KT + lane * box_rows;
        return lane < pieces && t < n_tiles && key < k_end
                   ? __ldg(pt + key / ps)
                   : 0;
      };
      int page = page_of(0);
      for (int t = 0; t < n_tiles; ++t) {
        const int next = page_of(t + 1);  // in flight during the wait
        const int st = t % Tile::kStages;
        hopper::mbar_wait(&empty[st], ((t / Tile::kStages) & 1) ^ 1);
        const int kv0 = k_begin + t * KT;
        const int live = min(pieces, (k_end - kv0 + box_rows - 1) / box_rows);
        if (lane == 0)
          hopper::mbar_arrive_expect_tx(&full[st],
                                        live * kBlocks * box_rows * 128);
        __syncwarp();
        if (lane < live) {
          unsigned char* dst =
              ring + st * Tile::kBytes + lane * box_rows * 128;
          const int row = (kv0 + lane * box_rows) % ps;
#pragma unroll
          for (int c = 0; c < kBlocks; ++c)
            hopper::tma_load_3d(dst + c * Tile::kBlockBytes, &k_map,
                                &full[st], c * 64, row, page);
        }
        page = next;
      }
    }
  } else {
    // ---- consumers: wg 1 the scores, softmax and O[:, :256]; wg 2 O[:, 256:]
    hopper::setmaxnreg_inc<232>();
    const int half = wg - 1;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
    const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];

    if (half == 0) {  // Q rows h0 .. h0 + 63 (>= H zero), swizzled
      const bf16* qb = q + ((long long)s * H + h0) * kD;
      for (int e = tid; e < kHeads * kD / 8; e += kWg) {
        const int r = e / (kD / 8), u = e % (kD / 8);
        const bool ok = h0 + r < H;
        cp_async16(q_s + (u >> 3) * kHeads * 64 + r * 64 +
                       (((u & 7) ^ (r & 7)) << 3),
                   ok ? qb + (long long)r * kD + u * 8 : qb, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      hopper::fence_proxy_async();
      hopper::named_sync(2, kWg);
    }
    const uint64_t dq = hopper::desc_sw128(q_s, 16, 1024);
    const uint64_t dp = hopper::desc_sw128(p_s, 16, 1024);

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % Tile::kStages;
      unsigned char* tile = ring + st * Tile::kBytes;
      const int live = k_end - (k_begin + t * KT);  // >= 1
      hopper::mbar_wait(&full[st], (t / Tile::kStages) & 1);
      if (half == 0) {
        float sc[KT / 2];
        issue_scores(sc, dq, tile);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (live < KT) {
          softmax_tile<true>(sc, m, l, alpha, live, scale, tq);
          zero_dead_rows(tile, live, 0, tid);
        } else {
          softmax_tile<false>(sc, m, l, alpha, live, scale, tq);
        }
        // P and alpha once consumer 1 is done with the last ones
        if (t > 0) hopper::mbar_wait(p_free, (t - 1) & 1);
        store_p(sc, alpha, p_s, alpha_s, r0, tq, p_full);
        hopper::mbar_wait(p_full, t & 1);
      } else {
        hopper::mbar_wait(p_full, t & 1);
        alpha[0] = alpha_s[r0];
        alpha[1] = alpha_s[r0 + 8];
        if (live < KT) {
          zero_dead_rows(tile, live, 4, tid);
          hopper::fence_proxy_async();
          hopper::named_sync(3, kWg);
        }
      }

      // O[:, half * 256 : +256] = alpha O + P V, V the tile's first 512
      // columns read as B with the transpose bit
      rescale(o, alpha);
      hopper::fence_regs(o);
      const uint64_t dv = hopper::desc_sw128(
          tile + 4 * half * Tile::kBlockBytes, Tile::kBlockBytes, 1024);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hopper::wgmma_m64n256k16_bt(o, dp + ((kk * 32) >> 4),
                                    dv + ((kk * 16 * 128) >> 4), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (half == 1) hopper::mbar_arrive(p_free);
      hopper::mbar_arrive(&empty[st]);
    }

    // epilogue: o / l (one segment) or the fp32 partial (acc, m, l)
    if (half == 0 && tq == 0) {
      ml_s[2 * r0] = m[0];
      ml_s[2 * r0 + 1] = l[0];
      ml_s[2 * (r0 + 8)] = m[1];
      ml_s[2 * (r0 + 8) + 1] = l[1];
    }
    hopper::named_sync(1, 2 * kWg);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (h0 + row >= H) continue;
      const float mr = ml_s[2 * row], lr = ml_s[2 * row + 1];
      const long long orow = (long long)s * H + h0 + row;
      const int c0 = half * kVCols + 2 * tq;
      if (nseg == 1) {
        const float l_safe = lr == 0.f ? 1.f : lr;
        bf16* dst = out + orow * kDV + c0;
#pragma unroll
        for (int n = 0; n < kVCols / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(
              o[4 * n + 2 * r] / l_safe, o[4 * n + 2 * r + 1] / l_safe);
      } else {
        const long long pr = orow * nseg + seg;
        float* dst = part_o + pr * kDV + c0;
#pragma unroll
        for (int n = 0; n < kVCols / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
        if (half == 0 && tq == 0) {
          part_ml[2 * pr] = mr;
          part_ml[2 * pr + 1] = lr;
        }
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

// ---------------------------------------------------------------------------
// host: the pool's tensor map (tma_map.cuh: encoded once, cached); the
// launches
// ---------------------------------------------------------------------------
// The tensor map of a pool of bf16 rows [pages, ps, 576]: a box of 64
// columns x box_rows rows x 1 page, 128-byte swizzle.  The page extent is
// left open (2^31 - 1): the kernel reads only the pages the table names.
cudaError_t pool_map(const void* pool, int ps, int box_rows,
                     CUtensorMap* map) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)ps, 0x7fffffffull};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2,
                                 (cuuint64_t)ps * kD * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return tma_map::bf16_sw128(pool, 3, dims, strides, box, map);
}

int launch_wgmma(const void* q, const void* kp, const int* pt, const int* ctx,
                 void* out, float* part_o, float* part_ml, int S, int H,
                 int Np, int ps, int nseg, int seg_keys, float scale,
                 cudaStream_t st) {
  const int box_rows = ps < KT ? ps : KT;
  CUtensorMap map;
  cudaError_t err = pool_map(kp, ps, box_rows, &map);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mla_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kHeads - 1) / kHeads, nseg, S);
  mla_wgmma_kernel<<<grid, kThreads, Tile::kSmem, st>>>(
      map, (const bf16*)q, pt, ctx, (bf16*)out, part_o, part_ml, H, Np, ps,
      box_rows, nseg, seg_keys, scale);
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
// C entry points (ctypes).  `use_bf16` selects the wgmma kernel (D 576, DV
// 512: deepseek-v2's latent and rope widths; a page size that is a power of
// two from 8 to 256; keys a segment a multiple of 64) over the scalar fp32
// one (D <= 576, DV <= min(D, 512), keys a segment a multiple of 32).
// part_o [S, H, nseg, DV] and part_ml [S, H, nseg, 2] fp32 are the
// segments' scratch (unused, may be null, when nseg is 1).  Return a
// cudaError_t code.
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
  if (use_bf16 ? (D != kD || DV != kDV || seg_keys % KT || ps < 8 ||
                  ps > 256 || (ps & (ps - 1)))
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
  const int err =
      use_bf16 ? launch_wgmma(q, k_pages, pt, ctx, out, po, pml, S, H, Np, ps,
                              nseg, seg_keys, scale, st)
               : launch_fp32(q, k_pages, pt, ctx, out, po, pml, S, H, D, DV,
                             Np, ps, nseg, seg_keys, scale, st);
  if (err != cudaSuccess || nseg == 1) return err;
  if (use_bf16)
    mla_merge_kernel<bf16><<<S * H, kMergeThreads, 0, st>>>(
        po, pml, static_cast<bf16*>(out), nseg, DV);
  else
    mla_merge_kernel<float><<<S * H, kMergeThreads, 0, st>>>(
        po, pml, static_cast<float*>(out), nseg, DV);
  return cudaGetLastError();
}

// the bf16 kernel's dynamic shared memory
int mla_decode_smem_bytes() { return (int)Tile::kSmem; }

}  // extern "C"
