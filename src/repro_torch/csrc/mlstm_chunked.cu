// Stabilised chunkwise mLSTM forward for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mlstm/kernel.py:mlstm_chunked_fwd (`_mlstm_kernel`),
// the matrix-memory scan of an xLSTM mLSTM block's prefill, and computes
// the function the model calls, `repro/kernels/mlstm/ref.py:mlstm_chunked`
// WITH an initial state (C0, n0, m0) (the Pallas kernel always starts from
// zeros).  Per (batch, head) it walks the chunks of Q tokens in order and
// carries the fp32 memory C [P, P], the normaliser n [P] and the scalar
// stabiliser m across them.  Within a chunk, with b the inclusive cumsum
// of the log forget gates inside the chunk, g = cummax(ig - b) (both from
// the wrapper), ftot = b[Q-1], gq = g[Q-1]:
//
//   m_i    = b_i + max(m_in, g_i)
//   D_ij   = exp(b_i - b_j + ig_j - m_i)  for i >= j, exactly 0 above
//   S      = (q k^T) * D
//   w_in_i = exp(b_i + m_in - m_i)
//   num    = S v + w_in * (q C_in)
//   den_i  = max(|sum_j S_ij + w_in_i (q_i . n_in)|, exp(-m_i))
//   h      = num / den
//   m_out  = ftot + max(m_in, gq);  decay = exp(ftot + m_in - m_out)
//   w_j    = exp(ftot - b_j + ig_j - m_out)
//   C_out  = decay C_in + (k * w)^T v;   n_out = decay n_in + (k * w)^T 1
//
// The reference forms den_vec = D k + w_in n_in [Q, P] and then q . den_vec;
// since q_i . (D k)_i = sum_j (q_i . k_j) D_ij = sum_j S_ij, both kernels
// sum the same terms in another order and never form den_vec.  m0 = -inf
// gives exactly the zero-state result: w_in = decay = exp(-inf) = 0, and
// max(-inf, g) = g, so no -inf - -inf is ever formed.
//
// Layout (not the TPU kernel's [B, H, nc, Q, P]): q, k, v and h [B, L, H, P]
// in the model's dtype (fp32 or bf16), read as the block's projections
// leave them; `scale` (P^-0.5) multiplies k in fp32 in the scalar kernel
// (the host's k.float() * scale), the fp32 q k^T and w v in the tensor-core
// one; ig, bcum, g [B, L, H] fp32; C [B, H, P, P]
// (row: the k dimension, column: the v dimension), n [B, H, P], m [B, H]
// fp32.
//
// What bounds it on this card: bytes.  At the serve shape (B 8, L 1024,
// H 4, P 512, Q 64, bf16) the function needs B*H*nc*(6Q^2P + 4QP^2) =
// 40.8 GFLOP against ~0.2 GB moved (~0.07 ms at 3.35 TB/s).  Head dim 512
// poses two problems: C is 1 MiB per (batch, head) while a block has
// 227 KB of shared memory, and there are only B*H = 32 (batch, head)
// pairs for 132 SMs.  Both kernels answer them the same way: one 256-thread
// block per (64 columns of C, head, batch), since the columns of C, of
// num and of h are independent (8 x 4 x 8 = 256 blocks at the serve
// shape), each block recomputing the chunk's q k^T, the stabiliser and n,
// which every column block shares, and a loop inside the block walking
// the chunks (the Pallas grid's sequential axis).  The entry point picks
// the kernel by dtype (never as a fallback on failure):
//
// bf16, `mlstm_mma_kernel`: every product on the tensor cores (mma.sync
// m16n8k16, bf16 x bf16 -> fp32, mma_bf16.cuh), each with one operand
// exactly bf16 and the fp32 one split into bf16 hi + lo halves (two MMAs
// into one fp32 accumulator: ~2^-17 of each term lost, where one rounding
// of scale * w * v would put C 90x over its 2e-5 check):
//
//   S = q k^T        both exact; scale and the decay matrix D applied to
//                    the fp32 product;
//   S v              S split, v exact;
//   q C_in           C_in split (from the accumulators), q exact;
//   C update         k^T (scale * w * v): the v side split, k exact.
//
//   * C^T [64, PP] is held as fp32 MMA accumulators in registers, carried
//     across chunks (warp w = 4 hf + s: C's columns 16 s .. 16 s + 15 over
//     P's half hf, 128 floats a thread; 248 registers, 1 block an SM,
//     1.94 waves); its tiles are already the A fragments of (q C_in)^T,
//     split in registers, so C never goes through shared memory;
//   * q and k [64, PP] (PP = P rounded up to 32, zero-padded), v's 64
//     columns and S's hi / lo halves sit in shared memory as bf16 (rows
//     padded by 16 bytes for ldmatrix): 177 KB at P 512; 16-byte
//     cp.async copies (element-wise where a row is no multiple of 16
//     bytes);
//   * recomputing q k^T in each of the 8 column blocks costs 1/5 of the
//     block's MMAs (128 of ~640 a warp a chunk), all on the tensor cores:
//     cheap against a second pass that would write S and read it back;
//   * the two warps of a column slab sum their halves of (q C_in)^T
//     through shared memory; n, q . n_in, S's row sums for the
//     denominator and m stay fp32 on the CUDA cores.
//
// fp32, `mlstm_fwd_kernel` (the card-versus-CPU checks): scalar fp32 FMAs
// on the CUDA cores, since split fp32 q / k / v cannot meet the 2e-5 fp32
// checks at a sane MMA count:
//
//   * the block's C tile [P, 64] stays in shared memory (128 KB at P 512);
//   * q and k stream through shared memory in tiles of 64 rows of P; one
//     pass over the tiles accumulates S and q C_in in registers and, since
//     m_out, decay and w depend on the gates alone, updates the tile's
//     rows of C and n right after q C_in has read them;
//   * register tiles: each thread owns 4 x 4 entries of S, of q C_in, of
//     S v and of the C tile being updated, so every shared load feeds
//     several FMAs; S v stops at the thread's last row (S is 0 above the
//     diagonal).
//
// Limits (both kernels): Q <= 64, P <= 512, any L % Q == 0; the bf16
// kernel needs q, k and v 16-byte aligned (the wrapper raises before the
// launch otherwise).  The entry point is a plain C function (device
// pointers, shapes, the stream) returning cudaGetLastError(), loaded from
// Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kCols = 64;      // columns of C (and of h) per block
constexpr int kRows = 64;      // rows of P per streamed q / k tile
constexpr int kChunk = 64;     // chunk rows, padded
constexpr int kQS = kChunk + 4;  // row stride of the transposed tiles
constexpr int kMaxP = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on H100

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// shared memory (floats) for P padded to PP rows: the C tile [PP][kCols],
// q^T and k^T tiles [kRows][kQS] (q^T's buffer also holds (k * w) [Q][kQS]
// during the state update), v [kChunk][kCols], S^T [kChunk][kQS], n [PP],
// and eight per-row vectors [kChunk]
__host__ __device__ constexpr size_t smem_floats(int PP) {
  return (size_t)PP * kCols + (size_t)2 * kRows * kQS +
         (size_t)kChunk * kCols + (size_t)kChunk * kQS + (size_t)PP +
         (size_t)8 * kChunk;
}

__global__ void __launch_bounds__(kThreads, 1)
    mlstm_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ ig,
                     const float* __restrict__ bcum,
                     const float* __restrict__ g,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, float* __restrict__ h_out,
                     float* __restrict__ c_fin, float* __restrict__ n_fin,
                     float* __restrict__ m_fin, int L, int H, int P, int Q,
                     float scale) {
  const int PP = (P + kRows - 1) / kRows * kRows;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                   // C tile [PP][kCols]
  float* qt = cs + PP * kCols;        // q^T [kRows][kQS]; (k * w) [Q][kQS]
  float* kt = qt + kRows * kQS;       // k^T [kRows][kQS]
  float* vs = kt + kRows * kQS;       // v [kChunk][kCols]
  float* st = vs + kChunk * kCols;    // S^T [kChunk][kQS]: st[j*kQS+i]=S_ij
  float* ns = st + kChunk * kQS;      // n [PP]
  float* bv = ns + PP;                // b [kChunk]
  float* iv = bv + kChunk;            // ig
  float* mv = iv + kChunk;            // m_i
  float* wiv = mv + kChunk;           // w_in
  float* fv = wiv + kChunk;           // exp(-m_i), den's floor
  float* wv = fv + kChunk;            // w (state weights; 0 past Q)
  float* rsv = wv + kChunk;           // sum_j S_ij
  float* qnv = rsv + kChunk;          // q_i . n_in

  const int p0 = blockIdx.x * kCols;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // chunk rows ty*4 .. ty*4+3; C tile rows too
  const int tx = tid & 15;  // S columns tx*4..; C / h columns tx*4 .. +3
  const int nr = tid >> 2;  // the row of q . n / of n this thread sums
  const int part = tid & 3;  // ... over a quarter of the 64 terms
  const long long bh = (long long)b * H + hh;

  for (int e = tid; e < PP * kCols; e += kThreads) {
    const int p = e / kCols, c = e - p * kCols;
    cs[e] = (p < P && p0 + c < P) ? c0[(bh * P + p) * P + p0 + c] : 0.f;
  }
  for (int p = tid; p < PP; p += kThreads)
    ns[p] = p < P ? n0[bh * P + p] : 0.f;
  float m_in = m0[bh];

  for (int t0 = 0; t0 < L; t0 += Q) {
    const long long row0 = (long long)b * L + t0;  // first token row
    __syncthreads();  // the previous chunk's readers are done
    const long long last = (row0 + Q - 1) * H + hh;
    const float ftot = bcum[last];
    const float m_out = ftot + fmaxf(m_in, g[last]);
    const float decay = expf(ftot + m_in - m_out);
    if (tid < kChunk) {
      const int i = tid;
      float bi = 0.f, ii = 0.f, mi = 0.f, w = 0.f, win = 0.f, fl = 0.f;
      if (i < Q) {
        const long long r = (row0 + i) * H + hh;
        bi = bcum[r];
        ii = ig[r];
        mi = bi + fmaxf(m_in, g[r]);
        win = expf(bi + m_in - mi);
        fl = expf(-mi);
        w = expf(ftot - bi + ii - m_out);
      }
      bv[i] = bi;
      iv[i] = ii;
      mv[i] = mi;
      wiv[i] = win;
      fv[i] = fl;
      wv[i] = w;
    }
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int i = e / kCols, c = e - i * kCols;
      vs[e] = (i < Q && p0 + c < P)
                  ? v[((row0 + i) * H + hh) * P + p0 + c]
                  : 0.f;
    }

    float sa[4][4], na[4][4];  // S and q C_in, this thread's 4 x 4
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sa[r][c] = na[r][c] = 0.f;
    float qn = 0.f;

    for (int pt = 0; pt < PP; pt += kRows) {
      __syncthreads();  // gates / v written; the last tile's readers done
      for (int e = tid; e < kChunk * kRows; e += kThreads) {
        const int i = e / kRows, p = e - i * kRows;
        float qv = 0.f, kv = 0.f;
        if (i < Q && pt + p < P) {
          const long long o = ((row0 + i) * H + hh) * P + pt + p;
          qv = q[o];
          kv = k[o] * scale;
        }
        qt[p * kQS + i] = qv;
        kt[p * kQS + i] = kv;
      }
      __syncthreads();

      // S += q k^T and q C_in over this tile's rows of P
#pragma unroll 4
      for (int p = 0; p < kRows; ++p) {
        const float4 a = ld4(qt + p * kQS + ty * 4);
        const float4 kb = ld4(kt + p * kQS + tx * 4);
        const float4 cv = ld4(cs + (pt + p) * kCols + tx * 4);
        const float ar[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sa[r][0] = fmaf(ar[r], kb.x, sa[r][0]);
          sa[r][1] = fmaf(ar[r], kb.y, sa[r][1]);
          sa[r][2] = fmaf(ar[r], kb.z, sa[r][2]);
          sa[r][3] = fmaf(ar[r], kb.w, sa[r][3]);
          na[r][0] = fmaf(ar[r], cv.x, na[r][0]);
          na[r][1] = fmaf(ar[r], cv.y, na[r][1]);
          na[r][2] = fmaf(ar[r], cv.z, na[r][2]);
          na[r][3] = fmaf(ar[r], cv.w, na[r][3]);
        }
      }
      // q . n_in over this tile's rows
#pragma unroll
      for (int p = part * 16; p < part * 16 + 16; ++p)
        qn = fmaf(qt[p * kQS + nr], ns[pt + p], qn);
      __syncthreads();  // every reader of q^T, C_in and n_in rows is done

      // (k * w) into q^T's buffer, [j][p]; n_out for this tile's rows
      for (int e = tid; e < kChunk * kRows; e += kThreads) {
        const int j = e / kRows, p = e - j * kRows;
        qt[j * kQS + p] = kt[p * kQS + j] * wv[j];
      }
      {
        float s = 0.f;
#pragma unroll
        for (int j = part * 16; j < part * 16 + 16; ++j)
          s = fmaf(kt[nr * kQS + j], wv[j], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (part == 0) ns[pt + nr] = decay * ns[pt + nr] + s;
      }
      __syncthreads();

      // C_out rows pt + ty*4 .. +3 = decay C_in + (k * w)^T v
      {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 cv = ld4(cs + (pt + ty * 4 + r) * kCols + tx * 4);
          acc[r][0] = decay * cv.x;
          acc[r][1] = decay * cv.y;
          acc[r][2] = decay * cv.z;
          acc[r][3] = decay * cv.w;
        }
        for (int j = 0; j < Q; ++j) {
          const float4 kw = ld4(qt + j * kQS + ty * 4);
          const float4 vv = ld4(vs + j * kCols + tx * 4);
          const float kr[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] = fmaf(kr[r], vv.x, acc[r][0]);
            acc[r][1] = fmaf(kr[r], vv.y, acc[r][1]);
            acc[r][2] = fmaf(kr[r], vv.z, acc[r][2]);
            acc[r][3] = fmaf(kr[r], vv.w, acc[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(cs + (pt + ty * 4 + r) * kCols + tx * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }

    // q . n_in, summed over the four quarters
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
    if (part == 0) qnv[nr] = qn;
    // S = (q k^T) * D, lower triangle, into S^T; its row sums
    {
      float rowp[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        rowp[r] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx * 4 + c;
          const float s = (i >= j && i < Q)
                              ? sa[r][c] * expf(bv[i] - bv[j] + iv[j] - mv[i])
                              : 0.f;
          st[j * kQS + i] = s;
          rowp[r] += s;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int o = 8; o >= 1; o >>= 1)
          rowp[r] += __shfl_xor_sync(0xffffffffu, rowp[r], o);
        if (tx == 0) rsv[ty * 4 + r] = rowp[r];
      }
    }
    __syncthreads();

    // h = (S v + w_in * q C_in) / den
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      const int j_end = min(Q, ty * 4 + 4);  // S_ij = 0 for j > i
      for (int j = 0; j < j_end; ++j) {
        const float4 s = ld4(st + j * kQS + ty * 4);
        const float4 vv = ld4(vs + j * kCols + tx * 4);
        const float sr[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(sr[r], vv.x, acc[r][0]);
          acc[r][1] = fmaf(sr[r], vv.y, acc[r][1]);
          acc[r][2] = fmaf(sr[r], vv.z, acc[r][2]);
          acc[r][3] = fmaf(sr[r], vv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        if (i >= Q) continue;
        const float win = wiv[i];
        const float den = fmaxf(fabsf(rsv[i] + win * qnv[i]), fv[i]);
        float* hr = h_out + ((row0 + i) * H + hh) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + tx * 4 + c;
          if (p < P) hr[p] = (acc[r][c] + win * na[r][c]) / den;
        }
      }
    }
    m_in = m_out;
  }
  __syncthreads();
  for (int e = tid; e < PP * kCols; e += kThreads) {
    const int p = e / kCols, c = e - p * kCols;
    if (p < P && p0 + c < P) c_fin[(bh * P + p) * P + p0 + c] = cs[e];
  }
  if (blockIdx.x == 0) {
    for (int p = tid; p < P; p += kThreads) n_fin[bh * P + p] = ns[p];
    if (tid == 0) m_fin[bh] = m_in;
  }
}

int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* bcum, const void* g, const void* c0, const void* n0,
           const void* m0, void* h, void* c_fin, void* n_fin, void* m_fin,
           int B, int L, int H, int P, int Q, float scale,
           cudaStream_t stream) {
  const int PP = (P + kRows - 1) / kRows * kRows;
  const size_t smem = smem_floats(PP) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kCols - 1) / kCols, H, B);
  mlstm_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)ig,
      (const float*)bcum, (const float*)g, (const float*)c0,
      (const float*)n0, (const float*)m0, (float*)h, (float*)c_fin,
      (float*)n_fin, (float*)m_fin, L, H, P, Q, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace TC = mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;       // 8 warps
constexpr int kTcNT = kMaxP / 16;     // C^T n-tiles (8 p) a warp holds: 32
constexpr int kTS = kCols + 8;        // bf16 row stride of the 64-wide tiles

// Shared memory for P padded to PP (a multiple of 32): q and k [64][PP + 8],
// v, S's hi and lo halves [64][kTS] in bf16; then fp32: n [PP], the
// exchange of q C_in partial sums [8 warps][16][32], the per-row vectors
// b, ig, m, w_in, exp(-m), w, q . n_in [64] each and S's row sums [2][64].
__host__ __device__ constexpr size_t tc_smem_bytes(int PP) {
  return (size_t)(2 * kChunk * (PP + 8) + 3 * kChunk * kTS) * 2 +
         ((size_t)PP + 8 * 16 * 32 + 9 * kChunk) * sizeof(float);
}

// One block per (64 columns of C, head, batch), a loop over the chunks.
// Warp w = 4 hf + s holds C^T rows (columns of C) 16 s .. 16 s + 15 over
// P's half hf, p in [hf PP / 2, (hf + 1) PP / 2), as fp32 MMA accumulators
// carried across chunks: cacc[nt][e] is C[p][c] for c = 16 s + g + 8 (e >> 1),
// p = hf PP / 2 + 8 nt + 2 t + (e & 1).  The same warp computes S's tile of
// rows 16 s .., columns 32 hf .. and h's columns 16 s .. at rows 32 hf ..
__global__ void __launch_bounds__(kTcThreads, 1)
    mlstm_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ ig,
                     const float* __restrict__ bcum,
                     const float* __restrict__ g_,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, bf16* __restrict__ h_out,
                     float* __restrict__ c_fin, float* __restrict__ n_fin,
                     float* __restrict__ m_fin, int L, int H, int P, int Q,
                     float scale) {
  const int PP = (P + 31) & ~31;
  const int QS = PP + 8;  // row stride of q and k
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // q [i][p]
  bf16* ks = qs + kChunk * QS;                   // k [j][p]
  bf16* vs = ks + kChunk * QS;                   // v [j][c]
  bf16* sh = vs + kChunk * kTS;                  // S, hi half [i][j]
  bf16* sl = sh + kChunk * kTS;                  // S, lo half [i][j]
  float* ns = reinterpret_cast<float*>(sl + kChunk * kTS);  // n [PP]
  float* xch = ns + PP;            // q C_in partials [8][16][32]
  float* bv = xch + 8 * 16 * 32;   // b
  float* iv = bv + kChunk;         // ig
  float* mv = iv + kChunk;         // m_i
  float* wiv = mv + kChunk;        // w_in
  float* fv = wiv + kChunk;        // exp(-m_i), den's floor
  float* wv = fv + kChunk;         // w (state weights; 0 past Q)
  float* qnv = wv + kChunk;        // q_i . n_in
  float* rsv = qnv + kChunk;       // S's row sums over keys [2][64]

  const int p0 = blockIdx.x * kCols;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = w & 3;    // C^T rows 16 s ..; S rows 16 s ..
  const int hf = w >> 2;  // P's half; S columns 32 hf ..; h rows 32 hf ..
  const int ph = hf * (PP / 2);  // the warp's first row of C
  const int ntw = PP / 16;       // C^T n-tiles the warp holds
  const bool vec = P % 8 == 0;
  const long long bh = (long long)b * H + hh;

  float cacc[kTcNT][4];
#pragma unroll
  for (int nt = 0; nt < kTcNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = p0 + 16 * s + g + 8 * (e >> 1);
      const int p = ph + 8 * nt + 2 * t + (e & 1);
      cacc[nt][e] = (nt < ntw && p < P && c < P) ? c0[(bh * P + p) * P + c]
                                                 : 0.f;
    }
  for (int p = tid; p < PP; p += kTcThreads)
    ns[p] = p < P ? n0[bh * P + p] : 0.f;
  float m_in = m0[bh];

  const long long ld = (long long)H * P;
  for (int t0 = 0; t0 < L; t0 += Q) {
    const long long row0 = (long long)b * L + t0;  // first token row
    __syncthreads();  // the previous chunk's readers are done
    const long long last = (row0 + Q - 1) * H + hh;
    const float ftot = bcum[last];
    const float m_out = ftot + fmaxf(m_in, g_[last]);
    const float decay = expf(ftot + m_in - m_out);
    if (tid < kChunk) {
      const int i = tid;
      float bi = 0.f, ii = 0.f, mi = 0.f, wj = 0.f, win = 0.f, fl = 0.f;
      if (i < Q) {
        const long long r = (row0 + i) * H + hh;
        bi = bcum[r];
        ii = ig[r];
        mi = bi + fmaxf(m_in, g_[r]);
        win = expf(bi + m_in - mi);
        fl = expf(-mi);
        wj = expf(ftot - bi + ii - m_out);
      }
      bv[i] = bi;
      iv[i] = ii;
      mv[i] = mi;
      wiv[i] = win;
      fv[i] = fl;
      wv[i] = wj;
    }
    TC::load_tile(qs, QS, q + (row0 * H + hh) * P, ld, kChunk, PP / 8, Q, P,
                  vec);
    TC::load_tile(ks, QS, k + (row0 * H + hh) * P, ld, kChunk, PP / 8, Q, P,
                  vec);
    TC::load_tile(vs, kTS, v + (row0 * H + hh) * P + p0, ld, kChunk,
                  kCols / 8, Q, P - p0, vec);
    TC::cp_async_commit();
    TC::cp_async_wait<0>();
    __syncthreads();

    // q . n_in, fp32 on the CUDA cores: thread (row tid / 4, quarter tid % 4)
    {
      const int i = tid >> 2, part = tid & 3;
      float qn = 0.f;
      for (int p = 2 * part; p < PP; p += 8) {
        const float2 qq = TC::unpack_bf16(
            *reinterpret_cast<const uint32_t*>(qs + i * QS + p));
        qn = fmaf(qq.x, ns[p], fmaf(qq.y, ns[p + 1], qn));
      }
      qn = TC::quad_sum(qn);
      if (part == 0) qnv[i] = qn;
    }
    // n_out = decay n_in + sum_j (k_j * scale) w_j for columns 2 tid and
    // 2 tid + 1 (P <= 512), written after the barrier
    float2 n_new = make_float2(0.f, 0.f);
    if (2 * tid < PP) {
      for (int j = 0; j < Q; ++j) {
        const float2 kk = TC::unpack_bf16(
            *reinterpret_cast<const uint32_t*>(ks + j * QS + 2 * tid));
        n_new.x = fmaf(kk.x * scale, wv[j], n_new.x);
        n_new.y = fmaf(kk.y * scale, wv[j], n_new.y);
      }
      n_new.x = fmaf(decay, ns[2 * tid], n_new.x);
      n_new.y = fmaf(decay, ns[2 * tid + 1], n_new.y);
    }

    // S = (q k^T) * scale * D, the warp's 16 x 32 tile, both operands exact
    {
      float sacc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
      if (32 * hf <= 16 * s + 15) {  // not wholly above the diagonal
        for (int kk = 0; kk < PP / 16; ++kk) {
          uint32_t a[4], b0[4], b1[4];
          TC::ldsm_a(a, qs + 16 * s * QS + 16 * kk, QS);
          TC::ldsm_b(b0, ks + 32 * hf * QS + 16 * kk, QS);
          TC::ldsm_b(b1, ks + (32 * hf + 16) * QS + 16 * kk, QS);
          TC::mma16816(sacc[0], a, b0[0], b0[1]);
          TC::mma16816(sacc[1], a, b0[2], b0[3]);
          TC::mma16816(sacc[2], a, b1[0], b1[1]);
          TC::mma16816(sacc[3], a, b1[2], b1[3]);
        }
      }
      float rows[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * s + g + 8 * (e >> 1);
          const int j = 32 * hf + 8 * nt + 2 * t + (e & 1);
          const float x = (i >= j && i < Q)
                              ? sacc[nt][e] * scale *
                                    expf(bv[i] - bv[j] + iv[j] - mv[i])
                              : 0.f;
          sacc[nt][e] = x;
          rows[e >> 1] += x;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = (16 * s + g + 8 * r) * kTS + 32 * hf + 8 * nt + 2 * t;
          uint32_t hi, lo;
          TC::split_bf16(sacc[nt][2 * r], sacc[nt][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sh + o) = hi;
          *reinterpret_cast<uint32_t*>(sl + o) = lo;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = TC::quad_sum(rows[r]);
        if (t == 0) rsv[hf * kChunk + 16 * s + g + 8 * r] = sum;
      }
    }

    // (q C_in)^T over the warp's half of P: C_in (the accumulators) split
    float qacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) qacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTcNT / 2; ++kk) {
      if (2 * kk < ntw) {
        uint32_t ah[4], al[4];
        TC::split_bf16(cacc[2 * kk][0], cacc[2 * kk][1], ah[0], al[0]);
        TC::split_bf16(cacc[2 * kk][2], cacc[2 * kk][3], ah[1], al[1]);
        TC::split_bf16(cacc[2 * kk + 1][0], cacc[2 * kk + 1][1], ah[2],
                       al[2]);
        TC::split_bf16(cacc[2 * kk + 1][2], cacc[2 * kk + 1][3], ah[3],
                       al[3]);
#pragma unroll
        for (int ip = 0; ip < 4; ++ip) {
          uint32_t bq[4];
          TC::ldsm_b(bq, qs + 16 * ip * QS + ph + 16 * kk, QS);
          TC::mma16816(qacc[2 * ip], ah, bq[0], bq[1]);
          TC::mma16816(qacc[2 * ip], al, bq[0], bq[1]);
          TC::mma16816(qacc[2 * ip + 1], ah, bq[2], bq[3]);
          TC::mma16816(qacc[2 * ip + 1], al, bq[2], bq[3]);
        }
      }
    }


    // C_out^T = decay C_in^T + (v * scale * w)^T k: v's side split, k exact
#pragma unroll
    for (int nt = 0; nt < kTcNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[nt][e] *= decay;
    for (int kj = 0; kj < (Q + 15) / 16; ++kj) {
      uint32_t vr[4], ah[4], al[4];
      TC::ldsm_a_t(vr, vs + 16 * kj * kTS + 16 * s, kTS);
      const float* wj = wv + 16 * kj + 2 * t;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 vv = TC::unpack_bf16(vr[r]);
        const int o = (r >> 1) * 8;
        TC::split_bf16(vv.x * scale * wj[o], vv.y * scale * wj[o + 1], ah[r],
                       al[r]);
      }
#pragma unroll
      for (int np = 0; np < kTcNT / 2; ++np) {
        if (2 * np < ntw) {
          uint32_t bk[4];
          TC::ldsm_b_t(bk, ks + 16 * kj * QS + ph + 16 * np, QS);
          TC::mma16816(cacc[2 * np], ah, bk[0], bk[1]);
          TC::mma16816(cacc[2 * np], al, bk[0], bk[1]);
          TC::mma16816(cacc[2 * np + 1], ah, bk[2], bk[3]);
          TC::mma16816(cacc[2 * np + 1], al, bk[2], bk[3]);
        }
      }
    }

    // the partner warp (other half of P) sums the rows of h it owns
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xch[(w * 16 + 4 * u + e) * 32 + lane] =
            hf ? qacc[u][e] : qacc[4 + u][e];
    __syncthreads();  // every reader of n_in is done
    if (2 * tid < PP) {
      ns[2 * tid] = n_new.x;
      ns[2 * tid + 1] = n_new.y;
    }

    // h^T = (v^T S^T + w_in * (q C_in)^T) / den: columns 16 s .., rows
    // 32 hf .. 32 hf + 31; v exact, S split
    {
      float nacc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) nacc[nt][e] = 0.f;
      const int kj_end = min(2 * hf + 2, (Q + 15) / 16);  // S_ij = 0, j > i
      for (int kj = 0; kj < kj_end; ++kj) {
        uint32_t a[4];
        TC::ldsm_a_t(a, vs + 16 * kj * kTS + 16 * s, kTS);
#pragma unroll
        for (int ip = 0; ip < 2; ++ip) {
          uint32_t bh_[4], bl_[4];
          const int o = (32 * hf + 16 * ip) * kTS + 16 * kj;
          TC::ldsm_b(bh_, sh + o, kTS);
          TC::ldsm_b(bl_, sl + o, kTS);
          TC::mma16816(nacc[2 * ip], a, bh_[0], bh_[1]);
          TC::mma16816(nacc[2 * ip], a, bl_[0], bl_[1]);
          TC::mma16816(nacc[2 * ip + 1], a, bh_[2], bh_[3]);
          TC::mma16816(nacc[2 * ip + 1], a, bl_[2], bl_[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = p0 + 16 * s + g + 8 * (e >> 1);
          const int i = 32 * hf + 8 * u + 2 * t + (e & 1);
          if (i >= Q || c >= P) continue;
          const float qc = (hf ? qacc[4 + u][e] : qacc[u][e]) +
                           xch[((w ^ 4) * 16 + 4 * u + e) * 32 + lane];
          const float win = wiv[i];
          const float den =
              fmaxf(fabsf(rsv[i] + rsv[kChunk + i] + win * qnv[i]), fv[i]);
          h_out[((row0 + i) * H + hh) * P + c] =
              __float2bfloat16((nacc[u][e] + win * qc) / den);
        }
    }
    m_in = m_out;
  }

#pragma unroll
  for (int nt = 0; nt < kTcNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = p0 + 16 * s + g + 8 * (e >> 1);
      const int p = ph + 8 * nt + 2 * t + (e & 1);
      if (nt < ntw && p < P && c < P)
        c_fin[(bh * P + p) * P + c] = cacc[nt][e];
    }
  if (blockIdx.x == 0) {
    __syncthreads();
    for (int p = tid; p < P; p += kTcThreads) n_fin[bh * P + p] = ns[p];
    if (tid == 0) m_fin[bh] = m_in;
  }
}

int launch_mma(const void* q, const void* k, const void* v, const void* ig,
               const void* bcum, const void* g, const void* c0,
               const void* n0, const void* m0, void* h, void* c_fin,
               void* n_fin, void* m_fin, int B, int L, int H, int P, int Q,
               float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes((P + 31) & ~31);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kCols - 1) / kCols, H, B);
  mlstm_mma_kernel<<<grid, kTcThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)ig,
      (const float*)bcum, (const float*)g, (const float*)c0,
      (const float*)n0, (const float*)m0, (bf16*)h, (float*)c_fin,
      (float*)n_fin, (float*)m_fin, L, H, P, Q, scale);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (ctypes).  `bf16` selects bf16 q, k, v and h and the
// tensor-core kernel, else fp32 and the scalar one; the gates and the
// state are always fp32.  Returns a cudaError_t code.
// ---------------------------------------------------------------------------
extern "C" {

// The kernel a call of this dtype launches: 1 the tensor-core kernel
// (bf16), 0 the scalar one (fp32).  A choice by type, never a fallback.
int mlstm_chunked_fwd_uses_mma(int bf16) { return bf16 != 0; }

int mlstm_chunked_fwd(const void* q, const void* k, const void* v,
                      const void* ig, const void* bcum, const void* g,
                      const void* c0, const void* n0, const void* m0,
                      void* h, void* c_fin, void* n_fin, void* m_fin, int B,
                      int L, int H, int P, int Q, float scale, int bf16,
                      void* stream) {
  if (B < 0 || L < 0 || H < 0 || P <= 0 || P > kMaxP || Q <= 0 ||
      Q > kChunk || L % Q != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return mlstm_chunked_fwd_uses_mma(bf16)
             ? launch_mma(q, k, v, ig, bcum, g, c0, n0, m0, h, c_fin, n_fin,
                          m_fin, B, L, H, P, Q, scale, st)
             : launch(q, k, v, ig, bcum, g, c0, n0, m0, h, c_fin, n_fin,
                      m_fin, B, L, H, P, Q, scale, st);
}

}  // extern "C"
