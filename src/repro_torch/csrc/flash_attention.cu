// Dense GQA flash-attention forward for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (`_fwd_kernel`), the attention of the training path.  Same inputs:
// q packed as [B*Hkv, nq, M = block_q * group, D] (row = tok * group + g,
// so the `group` query heads that share a KV head are rows of one block,
// paper §4.4), k as [B*Hkv, Skv, D], v as [B*Hkv, Skv, DV].  Outputs o
// [B*Hkv, nq, M, DV] and, for the backward, lse = m + log(l) in fp32
// [B*Hkv, nq, M] (kNeg where a row saw no live key), as the reference's
// `_flash_fwd_core` returns.  Two widenings serve MLA's expanded prefill
// (deepseek-v2): a value width DV below the key width D (192 / 128), and
// an optional kv_len [B*Hkv] int32 that masks the keys at or past each
// slice's length, as `flash_attention_xla(kv_len=)` does (the padded
// rows of a uniform prefill batch); the training path passes DV = D and
// no kv_len and computes what it did.
//
// What bounds it on this card: operations.  A causal training call does
// 4 * D FLOPs per live (query, key) pair, S/2 keys per query on average,
// against 2 * D bytes of K/V per key read once per q-block: hundreds of
// FLOPs per byte at S = 2048, above the ~295 FLOP/byte where the H100's
// tensor cores stop waiting for memory.  So the work belongs on the
// tensor cores, and the design keeps them fed:
//
//   bf16 (`flash_mma_kernel`, the training path): the tensor-core tile of
//   attention_tile.cuh.  Since row R of a (b * Hkv) slice's flattened
//   [nq * M, D] rows is token R / group whatever block_q is, a block takes
//   64 consecutive flattened rows (4 warps x 16) of one slice: each K/V
//   tile it streams through the cp.async ring serves 64 query rows, and
//   the packed-q / lse layouts at the wrapper stay as they are.  Each
//   warp's row q_offset + R / group (and the slice's kv_len) fixes its
//   limit; tiles
//   strictly above the diagonal are never visited (the loop stops at the
//   block's last row, and a warp skips tiles past its own), and only the
//   tiles crossing a warp's diagonal compare element-wise.  The heaviest
//   row blocks are issued first.  D and DV are template parameters: 64 /
//   64, 128 / 128 (every head dim of the registry's GQA models) and 192 /
//   128 (deepseek-v2's MLA prefill); other widths in bf16 are refused,
//   never sent to a slower kernel.
//
//   fp32 (`flash_fwd_kernel`, the card-versus-CPU checks): scalar fp32
//   FMAs on the CUDA cores, since the tensor cores cannot give fp32 at
//   1e-4.  One 256-thread block per (b * Hkv, q-block), a loop inside the
//   block over 64-key tiles up to the causal diagonal q_offset + (qi + 1)
//   * block_q - 1; each thread owns a 4 x 4 register tile of the 64 x 64
//   score tile and a 4 x DB/16 tile of the accumulator; Q^T, K^T, V and
//   P^T in shared memory, padded against bank conflicts; D any multiple
//   of 8 up to 256, DV <= D (V zero-filled past DV).  The entry point picks the kernel by dtype: a choice
//   by type, not a fallback on failure.
//
// Semantics kept exactly from the Pallas kernel by both: the mask value
// -0.7 * FLT_MAX (not -inf), the m_safe guard, alpha = 0 before a row's
// first live key, p summed in fp32 but rounded to V's dtype before p.V,
// and l == 0 -> 1 in the finaliser.
//
// Each entry point is a plain C function (device pointers, shapes, the
// stream) returning cudaGetLastError(), loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "attention_tile.cuh"

namespace AT = attn_tile;

namespace {

constexpr float kNeg = -0.7f * FLT_MAX;
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kRows = 64;              // max query rows (block_q * group)
constexpr int kKeys = 64;              // keys per KV tile
constexpr int kRowStride = kRows + 4;  // Q^T / P^T rows: float4-aligned
constexpr int kKeyStride = kKeys + 1;  // K^T rows: conflict-free transpose
constexpr int kMaxHeadDim = 256;
constexpr size_t kMaxSmem = 232448;    // 227 KB opt-in per block on H100

// max / sum over the 16 lanes (one half-warp) that share a row
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// shared memory (floats): Q^T [DB][kRowStride] | K^T [DB][kKeyStride] |
// V [kKeys][DB] | P^T [kKeys][kRowStride]
__host__ __device__ constexpr size_t smem_floats(int DB) {
  return (size_t)DB * kRowStride + (size_t)DB * kKeyStride +
         (size_t)kKeys * DB + (size_t)kKeys * kRowStride;
}

// fp32: the scalar kernel.  DB: the head-dim bucket (64, 128 or 256) that
// sizes the register tile; D <= DB is the real head dim.
template <int DB>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse,
                     const int* __restrict__ kv_len, int BH, int nq, int M,
                     int D, int DV, int Skv, int block_q, int group,
                     float scale, int causal, int q_offset) {
  constexpr int kCols = DB / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + DB * kRowStride;
  float* v_s = k_s + DB * kKeyStride;
  float* p_s = v_s + kKeys * DB;

  // the heaviest q-blocks (largest qi, most live tiles) are issued first
  const int qi = nq - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys / head-dim columns tx + 16 j
  const long long row_base = ((long long)bh * nq + qi) * M;

  // Q^T, zero-filled past M rows and D columns
  for (int e = tid; e < kRows * DB; e += kThreads) {
    const int r = e / DB, d = e - r * DB;
    q_s[d * kRowStride + r] =
        (r < M && d < D) ? q[(row_base + r) * D + d] : 0.f;
  }

  int q_pos[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    q_pos[i] = r < M ? q_offset + qi * block_q + r / group : -1;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kvl = kv_len != nullptr ? min(Skv, kv_len[bh]) : Skv;
  int kv_end = kvl;
  if (causal) kv_end = min(kvl, q_offset + (qi + 1) * block_q);
  const int n_tiles = kv_end > 0 ? (kv_end + kKeys - 1) / kKeys : 0;
  const float* kb = k + (long long)bh * Skv * D;
  const float* vb = v + (long long)bh * Skv * DV;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kKeys;
    __syncthreads();  // the previous tile's readers of k_s / v_s / p_s
    for (int e = tid; e < kKeys * DB; e += kThreads) {
      const int j = e / DB, d = e - j * DB;
      const bool in = kv0 + j < kvl;
      k_s[d * kKeyStride + j] =
          in && d < D ? kb[(long long)(kv0 + j) * D + d] : 0.f;
      v_s[j * DB + d] = in && d < DV ? vb[(long long)(kv0 + j) * DV + d]
                                     : 0.f;
    }
    __syncthreads();

    // s = q . k (fp32), then * scale
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(q_s + d * kRowStride + ty * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[d * kKeyStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

    // online softmax per row; p^T to shared memory
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool live[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + tx + 16 * j;
        live[j] = q_pos[i] >= 0 && kp < kvl && (!causal || kp <= q_pos[i]);
        s[i][j] = live[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_prev = m[i];
      const float m_new = fmaxf(m_prev, row_max(mx));
      const float m_safe = m_new <= kNeg ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = live[j] ? expf(s[i][j] - m_safe) : 0.f;
        sum += pj;
        p[i][j] = pj;
      }
      const float alpha = m_prev <= kNeg ? 0.f : expf(m_prev - m_safe);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * kRowStride + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc += p . V
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 pv =
          *reinterpret_cast<const float4*>(p_s + j * kRowStride + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = v_s[j * DB + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

  // o = acc / l (l == 0 -> 1: rows with no live key are exact zeros);
  // lse = m + log(l), kNeg for those rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= M) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < DV) o[(row_base + r) * DV + d] = acc[i][c] / l_safe;
    }
    if (tx == 0) lse[row_base + r] = l[i] == 0.f ? kNeg : m[i] + logf(l_safe);
  }
}

template <int DB>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const int* kv_len, int BH, int nq, int M, int D, int DV, int Skv,
           int block_q, int group, float scale, int causal, int q_offset,
           cudaStream_t stream) {
  const size_t smem = smem_floats(DB) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DB><<<BH * nq, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, kv_len, BH, nq, M, D, DV, Skv, block_q, group, scale,
      causal, q_offset);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             const int* kv_len, int BH, int nq, int M, int D, int DV,
             int Skv, int block_q, int group, float scale, int causal,
             int q_offset, cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, o, lse, kv_len, BH, nq, M, D, DV, Skv,
                      block_q, group, scale, causal, q_offset, stream);
  if (D <= 128)
    return launch<128>(q, k, v, o, lse, kv_len, BH, nq, M, D, DV, Skv,
                       block_q, group, scale, causal, q_offset, stream);
  return launch<256>(q, k, v, o, lse, kv_len, BH, nq, M, D, DV, Skv,
                     block_q, group, scale, causal, q_offset, stream);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel.  One block per (64 flattened rows, b * Hkv)
// with rows = nq * M per slice; row R is token q_offset + R / group.
// ---------------------------------------------------------------------------
template <int D, int DV, bool kLen>
__global__ void __launch_bounds__(AT::kThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ kv_len, int BH, int rows,
                     int Skv, int group, float scale, int causal,
                     int q_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AT::bf16* smem = reinterpret_cast<AT::bf16*>(smem_raw);
  const int n_rb = (rows + AT::kBlockRows - 1) / AT::kBlockRows;
  const int rb = n_rb - 1 - (int)(blockIdx.x / BH);  // heaviest first
  const int bh = blockIdx.x % BH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = rb * AT::kBlockRows + warp * AT::kSlab;  // warp's first row
  const int valid = max(0, min(AT::kSlab, rows - r0));
  const long long slice = (long long)bh * rows;

  // exclusive key limit of flattened row R
  const int kvl = kLen ? min(Skv, kv_len[bh]) : Skv;
  auto limit_of = [&](int R) {
    return causal ? min(kvl, q_offset + R / group + 1) : kvl;
  };
  const int g = lane >> 2;
  const int lim[2] = {limit_of(r0 + g), limit_of(r0 + g + 8)};
  const int all_live = limit_of(r0);
  const int tiles =
      valid > 0 ? (limit_of(r0 + valid - 1) + AT::kKeys - 1) / AT::kKeys : 0;
  const int last = min(rb * AT::kBlockRows + AT::kBlockRows, rows) - 1;
  const int n_tiles = (limit_of(last) + AT::kKeys - 1) / AT::kKeys;

  using Lay = AT::Layout<D, DV>;
  AT::load_q_slab<D>(Lay::q(smem, warp), q + (slice + r0) * D, valid);
  AT::cp_async_commit();
  AT::cp_async_wait<0>();
  __syncwarp();
  AT::Warp<D, DV> w;
  w.init(Lay::q(smem, warp));

  const AT::bf16* kb = k + (long long)bh * Skv * D;
  const AT::bf16* vb = v + (long long)bh * Skv * DV;
  auto key_rows = [&](int key, const AT::bf16*& kr, const AT::bf16*& vr) {
    kr = kb + (long long)key * D;
    vr = vb + (long long)key * DV;
  };
  AT::walk<D, DV>(w, smem, n_tiles, kvl, kb, key_rows, valid > 0, tiles,
                  all_live, lim, scale);
  if (valid > 0) w.store(o + (slice + r0) * DV, lse + slice + r0, valid);
}

template <int D, int DV, bool kLen>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, const int* kv_len, int BH, int rows, int Skv,
               int group, float scale, int causal, int q_offset,
               cudaStream_t stream) {
  cudaError_t err = AT::prepare<D, DV>(flash_mma_kernel<D, DV, kLen>);
  if (err != cudaSuccess) return err;
  const int n_rb = (rows + AT::kBlockRows - 1) / AT::kBlockRows;
  flash_mma_kernel<D, DV, kLen>
      <<<BH * n_rb, AT::kThreads, AT::Layout<D, DV>::kBytes, stream>>>(
          (const AT::bf16*)q, (const AT::bf16*)k, (const AT::bf16*)v,
          (AT::bf16*)o, (float*)lse, kv_len, BH, rows, Skv, group, scale,
          causal, q_offset);
  return cudaGetLastError();
}

// The length mask is a template flag: the training path (no kv_len) runs
// the instantiation without it, whose registers it would otherwise cost.
template <int D, int DV>
int launch_mma_len(const void* q, const void* k, const void* v, void* o,
                   void* lse, const int* kv_len, int BH, int rows, int Skv,
                   int group, float scale, int causal, int q_offset,
                   cudaStream_t stream) {
  return kv_len != nullptr
             ? launch_mma<D, DV, true>(q, k, v, o, lse, kv_len, BH, rows,
                                       Skv, group, scale, causal, q_offset,
                                       stream)
             : launch_mma<D, DV, false>(q, k, v, o, lse, kv_len, BH, rows,
                                        Skv, group, scale, causal, q_offset,
                                        stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes).  `bf16` selects the tensor-core kernel
// (__nv_bfloat16 q / k / v / o; D / DV 64 / 64, 128 / 128 or 192 / 128)
// over the scalar fp32 one (DV <= D); lse is always fp32; kv_len may be
// null (no length mask).  Returns a cudaError_t code.
// ---------------------------------------------------------------------------
extern "C" {

int fa_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, const void* kv_len, int BH,
                           int nq, int M, int D, int DV, int Skv,
                           int block_q, int group, float scale, int causal,
                           int q_offset, int bf16, void* stream) {
  if (M <= 0 || M > kRows || group <= 0 || block_q * group != M || D <= 0 ||
      D > kMaxHeadDim || D % 8 != 0 || DV <= 0 || DV > D || DV % 8 != 0 ||
      Skv < 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  const bool same = D == DV && (D == 64 || D == 128);
  if (bf16 && !same && !(D == 192 && DV == 128))
    return cudaErrorInvalidValue;
  if (BH * nq == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int* kvl = static_cast<const int*>(kv_len);
  if (bf16) {
    if (D == 64)
      return launch_mma_len<64, 64>(q, k, v, o, lse, kvl, BH, nq * M, Skv,
                                    group, scale, causal, q_offset, st);
    if (D == 128)
      return launch_mma_len<128, 128>(q, k, v, o, lse, kvl, BH, nq * M, Skv,
                                      group, scale, causal, q_offset, st);
    return launch_mma_len<192, 128>(q, k, v, o, lse, kvl, BH, nq * M, Skv,
                                    group, scale, causal, q_offset, st);
  }
  return dispatch(q, k, v, o, lse, kvl, BH, nq, M, D, DV, Skv, block_q,
                  group, scale, causal, q_offset, st);
}

}  // extern "C"
