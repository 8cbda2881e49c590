// Mamba2 chunked SSD forward for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mamba2/kernel.py:ssd_chunked_fwd (`_ssd_kernel`), the
// state-space scan of a Mamba2 block's prefill.  Per (batch, head) it walks
// the chunks of Q tokens in order and carries the fp32 state S [N, P]
// across them; within a chunk, with a = the inclusive cumsum of dt * A
// inside the chunk (computed by the wrapper) and xdt = x * dt:
//
//   G[i, j]  = (C B^T)[i, j] * exp(a[i] - a[j])   for i >= j, exactly 0 above
//   y        = G xdt + exp(a)[:, None] * (C S_in)
//   S_out    = exp(a_tot) * S_in + (B * exp(a_tot - a)[:, None])^T xdt
//
// and the last chunk's S_out is the final state.  Decays are always exp of
// DIFFERENCES of a, never products of per-step decays, so padded and dead
// rows (dt = 0) leave the state exactly unchanged and underflow matches the
// reference.
//
// Layout (not the TPU kernel's): x [B, L, H, P] and B / C [B, L, G, N] in
// the model's dtype, read as they come out of the block's projection; dt
// and a_cum [B, L, H] fp32; s0 / s_fin [B, H, N, P] fp32; y [B, L, H, P]
// fp32.  B and C are read through the group index h / (H / G), not
// repeated per head (the TPU wrapper's repeat moves 32x the bytes at
// G = 1), and xdt is formed here in fp32 as the wrapper formed it.
//
// What bounds it on this card: bytes.  At the serving shape (B 8, L 1024,
// H 32, P 128, N 64, Q 128) the work is ~21 GFLOP against ~220 MB moved:
// ~100 FLOP/byte, under the ~295 where the tensor cores stop waiting for
// memory.  This first version runs the FLOPs as scalar fp32 FMAs on the
// CUDA cores (no wgmma), so the FMA rate bounds it in practice.  Design:
//
//   * one 256-thread block per (64 columns of P, head, batch): the columns
//     of S and y are independent, so P splits across blocks (2 x 32 x 8 =
//     512 blocks at the serving shape) and each block recomputes C B^T;
//     a loop inside the block walks the chunks (the Pallas grid's
//     sequential "arbitrary" axis), the state staying in shared memory;
//   * shared memory holds C^T, B^T [N][Q], xdt [Q][64], S [N][64] and the
//     masked, decayed G^T [Q][Q]: 182 KB at Q 128, N 64 (limit 227 KB);
//   * register tiles: each thread owns an R x R tile of G (R = Q / 16,
//     tiles above the diagonal skipped), R rows x 4 columns of y, and
//     4 x 4 entries of the next state, so every shared load feeds several
//     FMAs; y's loop over keys stops at the thread's last row (G is zero
//     above the diagonal).
//
// Limits: Q <= 128, N <= 64, any P and G (H % G == 0), any L % Q == 0.
//
// The entry point is a plain C function (device pointers, shapes, the
// stream) returning cudaGetLastError(), loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kCols = 64;      // columns of P per block
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 64;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on H100

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// shared memory (floats) for a chunk padded to QP = 16 * R rows:
// C^T, B^T [N][QP+4] | xdt [QP][kCols] | S [N][kCols] | G^T [QP][QP+4] |
// a, exp(a_tot - a), exp(a) [QP] each
__host__ __device__ constexpr size_t smem_floats(int QP, int N) {
  return (size_t)2 * N * (QP + 4) + (size_t)QP * kCols + (size_t)N * kCols +
         (size_t)QP * (QP + 4) + (size_t)3 * QP;
}

// R consecutive floats from shared memory (16-byte loads when R % 4 == 0;
// the callers' offsets are then multiples of 4 floats)
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x;
      v[k + 1] = t.y;
      v[k + 2] = t.z;
      v[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = p[k];
  }
}

// R: rows of the chunk per thread row (Q <= 16 * R).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ a_cum,
                   const float* __restrict__ s0, float* __restrict__ y,
                   float* __restrict__ s_fin, int L, int H, int P, int N,
                   int G, int Q) {
  constexpr int QP = 16 * R;
  constexpr int QS = QP + 4;  // row stride of C^T / B^T / G^T
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;              // C^T [N][QS]
  float* bt = ct + N * QS;       // B^T [N][QS]
  float* xs = bt + N * QS;       // xdt [QP][kCols]
  float* st = xs + QP * kCols;   // S [N][kCols]
  float* gt = st + N * kCols;    // G^T [QP][QS]: gt[j * QS + i] = G[i, j]
  float* av = gt + QP * QS;      // a [QP]
  float* wv = av + QP;           // exp(a_tot - a) [QP]
  float* ev = wv + QP;           // exp(a) [QP]

  const int p0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // chunk rows ty*R .. ty*R+R-1; state rows ty+16k
  const int tx = tid & 15;  // G columns tx*R..; y / S columns tx*4 .. tx*4+3
  const int nk = (N + 15) / 16;
  const long long state0 = ((long long)b * H + h) * N;

  for (int e = tid; e < N * kCols; e += kThreads) {
    const int n = e / kCols, p = e - n * kCols;
    st[e] = p0 + p < P ? s0[(state0 + n) * P + p0 + p] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += Q) {
    const long long row0 = (long long)b * L + t0;  // first token row
    __syncthreads();  // the previous chunk's readers and its state write
    const float a_tot = a_cum[(row0 + Q - 1) * H + h];
    for (int i = tid; i < QP; i += kThreads) {
      const float a = i < Q ? a_cum[(row0 + i) * H + h] : a_tot;
      av[i] = a;
      wv[i] = expf(a_tot - a);
      ev[i] = expf(a);
    }
    for (int e = tid; e < QP * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      float cv = 0.f, bv = 0.f;
      if (i < Q) {
        const long long o = ((row0 + i) * G + g) * N + n;
        cv = to_f<T>(cm[o]);
        bv = to_f<T>(bm[o]);
      }
      ct[n * QS + i] = cv;
      bt[n * QS + i] = bv;
    }
    for (int e = tid; e < QP * kCols; e += kThreads) {
      const int i = e / kCols, p = e - i * kCols;
      float v = 0.f;
      if (i < Q && p0 + p < P) {
        const long long r = (row0 + i) * H + h;
        v = to_f<T>(x[r * P + p0 + p]) * dt[r];
      }
      xs[e] = v;
    }
    __syncthreads();

    // G = (C B^T) * exp(a_i - a_j), lower triangle; tiles above the
    // diagonal are written as zeros without computing them
    {
      float acc[R][R];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
      if (tx <= ty) {
        for (int n = 0; n < N; ++n) {
          float cr[R], br[R];
          load_rows<R>(ct + n * QS + ty * R, cr);
          load_rows<R>(bt + n * QS + tx * R, br);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < R; ++c) acc[r][c] = fmaf(cr[r], br[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ty * R + r;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int j = tx * R + c;
          gt[j * QS + i] =
              (i >= j && i < Q) ? acc[r][c] * expf(av[i] - av[j]) : 0.f;
        }
      }
    }

    // next state, into registers: exp(a_tot) S + sum_j (B_j w_j) xdt_j
    float snew[4][4];
    {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) snew[k][c] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * kCols + tx * 4);
        const float w = wv[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = ty + 16 * k;
          if (k < nk && n < N) {
            const float bw = bt[n * QS + j] * w;
            snew[k][0] = fmaf(bw, xv.x, snew[k][0]);
            snew[k][1] = fmaf(bw, xv.y, snew[k][1]);
            snew[k][2] = fmaf(bw, xv.z, snew[k][2]);
            snew[k][3] = fmaf(bw, xv.w, snew[k][3]);
          }
        }
      }
      const float decay = expf(a_tot);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = ty + 16 * k;
        if (k < nk && n < N) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            snew[k][c] = decay * st[n * kCols + tx * 4 + c] + snew[k][c];
        }
      }
    }
    __syncthreads();  // G^T is complete

    // y = G xdt + exp(a) * (C S_in)
    {
      float acc[R][4], inter[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = inter[r][c] = 0.f;
      const int j_end = min(Q, (ty + 1) * R);  // G[i, j] = 0 for j > i
      for (int j = 0; j < j_end; ++j) {
        float gr[R];
        load_rows<R>(gt + j * QS + ty * R, gr);
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * kCols + tx * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][0] = fmaf(gr[r], xv.x, acc[r][0]);
          acc[r][1] = fmaf(gr[r], xv.y, acc[r][1]);
          acc[r][2] = fmaf(gr[r], xv.z, acc[r][2]);
          acc[r][3] = fmaf(gr[r], xv.w, acc[r][3]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float cr[R];
        load_rows<R>(ct + n * QS + ty * R, cr);
        const float4 sv = *reinterpret_cast<const float4*>(st + n * kCols + tx * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          inter[r][0] = fmaf(cr[r], sv.x, inter[r][0]);
          inter[r][1] = fmaf(cr[r], sv.y, inter[r][1]);
          inter[r][2] = fmaf(cr[r], sv.z, inter[r][2]);
          inter[r][3] = fmaf(cr[r], sv.w, inter[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ty * R + r;
        if (i >= Q) continue;
        float* yr = y + ((row0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + tx * 4 + c;
          if (p < P) yr[p] = acc[r][c] + ev[i] * inter[r][c];
        }
      }
    }
    __syncthreads();  // every reader of S_in is done
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = ty + 16 * k;
      if (k < nk && n < N) {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n * kCols + tx * 4 + c] = snew[k][c];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * kCols; e += kThreads) {
    const int n = e / kCols, p = e - n * kCols;
    if (p0 + p < P) s_fin[(state0 + n) * P + p0 + p] = st[e];
  }
}

template <typename T, int R>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a_cum, const void* s0, void* y, void* s_fin, int B,
           int L, int H, int P, int N, int G, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(16 * R, N) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kCols - 1) / kCols, H, B);
  ssd_fwd_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const T*)bm, (const T*)cm,
      (const float*)a_cum, (const float*)s0, (float*)y, (float*)s_fin, L, H,
      P, N, G, Q);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* bm, const void* cm,
             const void* a_cum, const void* s0, void* y, void* s_fin, int B,
             int L, int H, int P, int N, int G, int Q, cudaStream_t stream) {
  if (Q <= 16)
    return launch<T, 1>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                        Q, stream);
  if (Q <= 32)
    return launch<T, 2>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                        Q, stream);
  if (Q <= 64)
    return launch<T, 4>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                        Q, stream);
  return launch<T, 8>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                      Q, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (ctypes).  `bf16` selects __nv_bfloat16 over float for x,
// B and C; dt, a_cum, the states and y are always fp32.  Returns a
// cudaError_t code.
// ---------------------------------------------------------------------------
extern "C" {

int ssd_chunked_fwd(const void* x, const void* dt, const void* bm,
                    const void* cm, const void* a_cum, const void* s0,
                    void* y, void* s_fin, int B, int L, int H, int P, int N,
                    int G, int Q, int bf16, void* stream) {
  if (B < 0 || L < 0 || H < 0 || P < 0 || N <= 0 || N > kMaxState ||
      G <= 0 || Q <= 0 || Q > kMaxChunk || L % Q != 0 || (H > 0 && H % G))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || P == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(x, dt, bm, cm, a_cum, s0, y, s_fin,
                                        B, L, H, P, N, G, Q, st)
              : dispatch<float>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H,
                                P, N, G, Q, st);
}

}  // extern "C"
