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
// since q_i . (D k)_i = sum_j (q_i . k_j) D_ij = sum_j S_ij, this kernel
// sums the same terms in another order and never forms den_vec.  m0 = -inf
// gives exactly the zero-state result: w_in = decay = exp(-inf) = 0, and
// max(-inf, g) = g, so no -inf - -inf is ever formed.
//
// Layout (not the TPU kernel's [B, H, nc, Q, P]): q, k, v and h [B, L, H, P]
// in the model's dtype (fp32 or bf16), read as the block's projections
// leave them and widened here; k is scaled by `scale` (P^-0.5) in fp32, as
// the host's k.float() * scale; ig, bcum, g [B, L, H] fp32; C [B, H, P, P]
// (row: the k dimension, column: the v dimension), n [B, H, P], m [B, H]
// fp32.
//
// What bounds it on this card: bytes.  At the serve shape (B 8, L 1024,
// H 4, P 512, Q 64, bf16) the function needs B*H*nc*(6Q^2P + 4QP^2) =
// 40.8 GFLOP against ~0.2 GB moved (~0.07 ms at 3.35 TB/s).  Design, for
// the two problems of head dim 512 (C is 1 MiB per (batch, head), a block
// has 227 KB of shared memory; there are only B*H = 32 (batch, head)
// pairs for 132 SMs):
//
//   * one 256-thread block per (64 columns of C, head, batch): the columns
//     of C, of num and of h are independent, so P splits across blocks (8
//     x 4 x 8 = 256 blocks at the serve shape) and each block recomputes
//     the chunk's q k^T, the stabiliser and n, which every column tile
//     shares; a loop inside the block walks the chunks (the Pallas grid's
//     sequential axis), its C tile [P, 64] staying in shared memory
//     (128 KB at P 512);
//   * q and k stream through shared memory in tiles of 64 rows of P; one
//     pass over the tiles accumulates S and q C_in in registers and, since
//     m_out, decay and w depend on the gates alone, updates the tile's
//     rows of C and n right after q C_in has read them;
//   * register tiles: each thread owns 4 x 4 entries of S, of q C_in, of
//     S v and of the C tile being updated, so every shared load feeds
//     several FMAs; S v stops at the thread's last row (S is 0 above the
//     diagonal).
//
// This first version runs the ~54 GFLOP it executes (q k^T recomputed per
// column tile) as scalar fp32 FMAs on the CUDA cores, so the FMA rate
// bounds it in practice; wgmma and TMA are later work.
//
// Limits: Q <= 64, P <= 512, any L % Q == 0.  The entry point is a plain C
// function (device pointers, shapes, the stream) returning
// cudaGetLastError(), loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kCols = 64;      // columns of C (and of h) per block
constexpr int kRows = 64;      // rows of P per streamed q / k tile
constexpr int kChunk = 64;     // chunk rows, padded
constexpr int kQS = kChunk + 4;  // row stride of the transposed tiles
constexpr int kMaxP = 512;
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
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ ig,
                     const float* __restrict__ bcum,
                     const float* __restrict__ g,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, T* __restrict__ h_out,
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
                  ? to_f<T>(v[((row0 + i) * H + hh) * P + p0 + c])
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
          qv = to_f<T>(q[o]);
          kv = to_f<T>(k[o]) * scale;
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
        T* hr = h_out + ((row0 + i) * H + hh) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + tx * 4 + c;
          if (p < P) hr[p] = from_f<T>((acc[r][c] + win * na[r][c]) / den);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* bcum, const void* g, const void* c0, const void* n0,
           const void* m0, void* h, void* c_fin, void* n_fin, void* m_fin,
           int B, int L, int H, int P, int Q, float scale,
           cudaStream_t stream) {
  const int PP = (P + kRows - 1) / kRows * kRows;
  const size_t smem = smem_floats(PP) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kCols - 1) / kCols, H, B);
  mlstm_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ig,
      (const float*)bcum, (const float*)g, (const float*)c0,
      (const float*)n0, (const float*)m0, (T*)h, (float*)c_fin,
      (float*)n_fin, (float*)m_fin, L, H, P, Q, scale);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (ctypes).  `bf16` selects __nv_bfloat16 over float for q,
// k, v and h; the gates and the state are always fp32.  Returns a
// cudaError_t code.
// ---------------------------------------------------------------------------
extern "C" {

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
  return bf16 ? launch<__nv_bfloat16>(q, k, v, ig, bcum, g, c0, n0, m0, h,
                                      c_fin, n_fin, m_fin, B, L, H, P, Q,
                                      scale, st)
              : launch<float>(q, k, v, ig, bcum, g, c0, n0, m0, h, c_fin,
                              n_fin, m_fin, B, L, H, P, Q, scale, st);
}

}  // extern "C"
