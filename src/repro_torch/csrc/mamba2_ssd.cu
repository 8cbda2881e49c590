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
// G = 1).  The scalar kernel forms xdt in fp32 as the wrapper formed it;
// the tensor-core kernel folds dt into G's columns and the state weights.
//
// What bounds it on this card: bytes.  At the serving shape (B 8, L 1024,
// H 32, P 128, N 64, Q 128) the work is ~21 GFLOP against ~220 MB moved:
// ~100 FLOP/byte, under the ~295 where the tensor cores stop waiting for
// memory.  The entry point picks the kernel by dtype (never as a fallback
// on failure):
//
// bf16, `ssd_mma_kernel`: the four products on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> fp32, mma_bf16.cuh), each with one
// operand exactly bf16 (x, B, C as they come) and the fp32 one split into
// bf16 hi + lo halves (two MMAs into one fp32 accumulator: ~2^-17 of each
// term lost where one rounding would lose 2^-9 and miss the bf16 check's
// 2e-2 by 10x):
//
//   C B^T                              both exact;
//   G xdt = G' x, G' = G * dt_j         G' split, x exact;
//   C S_in                             S_in split;
//   (B * exp(a_tot - a) * dt)^T x      the weighted B^T split, x exact.
//
//   * one 256-thread block per (64 columns of P, head, batch): 2 x 32 x 8
//     = 512 blocks at the serving shape, 2 an SM (92 KB of shared memory,
//     <= 128 registers), 1.94 waves; a loop inside the block walks the
//     chunks;
//   * warp w owns chunk rows 16 w .. 16 w + 15: its slab of G (computed
//     64 keys at a time up to its diagonal, decayed and masked in
//     registers, then split into the A fragments of G' x directly) and of
//     y = exp(a) (C S_in) + G' x; the state S [N, 64] lives in the warps'
//     MMA accumulators (warp w: rows 16 (w % 4) .., columns 32 (w / 4) ..),
//     carried across chunks in fp32, and goes to shared memory as hi / lo
//     bf16 once a chunk for C S_in;
//   * x, B and C reach shared memory by 16-byte cp.async (rows padded by 16
//     bytes: ldmatrix without bank conflicts; element-wise where a row is
//     no multiple of 16 bytes); x is double-buffered and the gates wait in
//     registers, so the next chunk's copies run under this chunk's
//     products; N, P and Q are padded with zeros to the MMA tiles.
//
// fp32, `ssd_fwd_kernel` (the card-versus-CPU checks): scalar fp32 FMAs on
// the CUDA cores, since split fp32 inputs cannot meet the 1e-5 x max|y|
// fp32 check at a sane MMA count:
//
//   * one 256-thread block per (64 columns of P, head, batch): the columns
//     of S and y are independent, so P splits across blocks and each block
//     recomputes C B^T; a loop inside the block walks the chunks (the
//     Pallas grid's sequential "arbitrary" axis), the state staying in
//     shared memory;
//   * shared memory holds C^T, B^T [N][Q], xdt [Q][64], S [N][64] and the
//     masked, decayed G^T [Q][Q]: 182 KB at Q 128, N 64 (limit 227 KB);
//   * register tiles: each thread owns an R x R tile of G (R = Q / 16,
//     tiles above the diagonal skipped), R rows x 4 columns of y, and
//     4 x 4 entries of the next state, so every shared load feeds several
//     FMAs; y's loop over keys stops at the thread's last row (G is zero
//     above the diagonal).
//
// Limits (both kernels): Q <= 128, N <= 64, any P and G (H % G == 0), any
// L % Q == 0; the bf16 kernel needs x, B and C 16-byte aligned (the
// wrapper raises before the launch otherwise).
//
// The entry point is a plain C function (device pointers, shapes, the
// stream) returning cudaGetLastError(), loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kCols = 64;      // columns of P per block
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 64;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on H100

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
template <int R>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ bm, const float* __restrict__ cm,
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
        cv = cm[o];
        bv = bm[o];
      }
      ct[n * QS + i] = cv;
      bt[n * QS + i] = bv;
    }
    for (int e = tid; e < QP * kCols; e += kThreads) {
      const int i = e / kCols, p = e - i * kCols;
      float v = 0.f;
      if (i < Q && p0 + p < P) {
        const long long r = (row0 + i) * H + h;
        v = x[r * P + p0 + p] * dt[r];
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

template <int R>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a_cum, const void* s0, void* y, void* s_fin, int B,
           int L, int H, int P, int N, int G, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(16 * R, N) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kCols - 1) / kCols, H, B);
  ssd_fwd_kernel<R><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)bm, (const float*)cm,
      (const float*)a_cum, (const float*)s0, (float*)y, (float*)s_fin, L, H,
      P, N, G, Q);
  return cudaGetLastError();
}

int dispatch(const void* x, const void* dt, const void* bm, const void* cm,
             const void* a_cum, const void* s0, void* y, void* s_fin, int B,
             int L, int H, int P, int N, int G, int Q, cudaStream_t stream) {
  if (Q <= 16)
    return launch<1>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                        Q, stream);
  if (Q <= 32)
    return launch<2>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                        Q, stream);
  if (Q <= 64)
    return launch<4>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                        Q, stream);
  return launch<8>(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N, G,
                      Q, stream);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace TC = mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcRows = 128;     // chunk rows, padded: 8 warp slabs of 16
constexpr int kTS = kCols + 8;   // bf16 row stride of every 64-wide tile
// two x buffers [128][kTS] (this chunk's and the next one's), C [128][kTS],
// B [128][kTS] and the state's hi / lo halves [64][kTS] in bf16; a, exp(a),
// exp(a_tot - a) * dt and dt [128] fp32
constexpr size_t kTcSmem =
    (size_t)(4 * kTcRows + 2 * kMaxState) * kTS * sizeof(bf16) +
    (size_t)4 * kTcRows * sizeof(float);

// One block per (64 columns of P, head, batch), a loop over the chunks.
// Warp w owns rows 16 w .. 16 w + 15 of the chunk (its slab of G and y) and
// the state tile rows 16 (w % 4) .., columns 32 (w / 4) .. + 31 (fp32 MMA
// accumulators, carried across chunks in registers).
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                   const float* __restrict__ a_cum,
                   const float* __restrict__ s0, float* __restrict__ y,
                   float* __restrict__ s_fin, int L, int H, int P, int N,
                   int G, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xbuf = reinterpret_cast<bf16*>(smem_raw);  // 2 x [j][p]
  bf16* cs = xbuf + 2 * kTcRows * kTS;           // C [i][n]
  bf16* bs = cs + kTcRows * kTS;                 // B [j][n]
  bf16* sh = bs + kTcRows * kTS;                 // S_in, hi half [n][p]
  bf16* sl = sh + kMaxState * kTS;               // S_in, lo half [n][p]
  float* av = reinterpret_cast<float*>(sl + kMaxState * kTS);  // a
  float* ev = av + kTcRows;                      // exp(a)
  float* wdv = ev + kTcRows;                     // exp(a_tot - a) * dt
  float* dtv = wdv + kTcRows;                    // dt (0 on padded rows)

  const int p0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sn = w & 3;   // state rows 16 sn ..
  const int sp = w >> 2;  // state columns 32 sp ..
  const int i0 = 16 * w;  // the warp's chunk rows
  const int QP = (Q + 15) & ~15;
  const int NP = (N + 15) & ~15;
  const bool vec_x = P % 8 == 0, vec_bc = N % 8 == 0;
  const long long state0 = ((long long)b * H + h) * N;

  float st[4][4];  // the state tile: [n-tile of 8 columns][mma C element]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * sn + g + 8 * (e >> 1);
      const int p = 32 * sp + 8 * nt + 2 * t + (e & 1);
      st[nt][e] = (n < N && p0 + p < P) ? s0[(state0 + n) * P + p0 + p] : 0.f;
    }

  // x runs one chunk ahead (its copy lands while the chunk before computes),
  // and so do the gates, in registers (row tid < Q and the last row)
  const long long ldx = (long long)H * P;
  auto load_x = [&](long long r0, bf16* dst) {
    TC::load_tile(dst, kTS, x + (r0 * H + h) * P + p0, ldx, QP, kCols / 8, Q,
                  P - p0, vec_x);
  };
  float ga = 0.f, gd = 0.f, ga_last = 0.f;
  auto load_gates = [&](long long r0) {
    ga_last = a_cum[(r0 + Q - 1) * H + h];
    if (tid < Q) {
      ga = a_cum[(r0 + tid) * H + h];
      gd = dt[(r0 + tid) * H + h];
    }
  };
  load_x((long long)b * L, xbuf);
  load_gates((long long)b * L);

  for (int t0 = 0, ci = 0; t0 < L; t0 += Q, ++ci) {
    const long long row0 = (long long)b * L + t0;  // first token row
    bf16* xs = xbuf + (ci & 1) * kTcRows * kTS;    // this chunk's x
    __syncthreads();  // the previous chunk's readers of every tile are done

    // S_in as hi + lo bf16 halves, the B operand of C S_in
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = (16 * sn + g + 8 * r) * kTS + 32 * sp + 8 * nt + 2 * t;
        uint32_t hi, lo;
        TC::split_bf16(st[nt][2 * r], st[nt][2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sh + o) = hi;
        *reinterpret_cast<uint32_t*>(sl + o) = lo;
      }
    TC::load_tile(cs, kTS, cm + (row0 * G + grp) * N, (long long)G * N, QP,
                  NP / 8, Q, N, vec_bc);
    TC::load_tile(bs, kTS, bm + (row0 * G + grp) * N, (long long)G * N, QP,
                  NP / 8, Q, N, vec_bc);
    const float a_tot = ga_last;
    if (tid < QP) {  // QP <= 128 < kTcThreads
      const bool ok = tid < Q;
      const float a = ok ? ga : a_tot;
      const float d = ok ? gd : 0.f;
      av[tid] = a;
      ev[tid] = expf(a);
      wdv[tid] = expf(a_tot - a) * d;
      dtv[tid] = d;
    }
    TC::cp_async_commit();
    TC::cp_async_wait<0>();
    __syncthreads();
    if (t0 + Q < L) {  // the next chunk's x into the other buffer, its gates
      load_x(row0 + Q, xbuf + ((ci + 1) & 1) * kTcRows * kTS);
      TC::cp_async_commit();
      load_gates(row0 + Q);
    }

    // S_out = exp(a_tot) S_in + (B * exp(a_tot - a) dt)^T x: the A operand
    // (B^T, weighted) is split, x is exact
    {
      const float decay = expf(a_tot);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= decay;
      if (16 * sn < N) {
        for (int kk = 0; kk < QP / 16; ++kk) {
          uint32_t braw[4], ah[4], al[4];
          TC::ldsm_a_t(braw, bs + kk * 16 * kTS + 16 * sn, kTS);
          const float* wd = wdv + kk * 16 + 2 * t;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 bv = TC::unpack_bf16(braw[r]);
            const int o = (r >> 1) * 8;
            TC::split_bf16(bv.x * wd[o], bv.y * wd[o + 1], ah[r], al[r]);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bx[4];
            TC::ldsm_b_t(bx, xs + kk * 16 * kTS + 32 * sp + 16 * np, kTS);
            TC::mma16816(st[2 * np], ah, bx[0], bx[1]);
            TC::mma16816(st[2 * np], al, bx[0], bx[1]);
            TC::mma16816(st[2 * np + 1], ah, bx[2], bx[3]);
            TC::mma16816(st[2 * np + 1], al, bx[2], bx[3]);
          }
        }
      }
    }

    // y = exp(a) * (C S_in) + G' x for the warp's 16 rows, G' = (C B^T) *
    // exp(a_i - a_j) * dt_j on and below the diagonal
    if (i0 < QP) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      for (int kn = 0; kn < NP / 16; ++kn) {
        uint32_t ca[4];
        TC::ldsm_a(ca, cs + i0 * kTS + 16 * kn, kTS);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bh[4], bl[4];
          TC::ldsm_b_t(bh, sh + kn * 16 * kTS + 16 * np, kTS);
          TC::ldsm_b_t(bl, sl + kn * 16 * kTS + 16 * np, kTS);
          TC::mma16816(acc[2 * np], ca, bh[0], bh[1]);
          TC::mma16816(acc[2 * np], ca, bl[0], bl[1]);
          TC::mma16816(acc[2 * np + 1], ca, bh[2], bh[3]);
          TC::mma16816(acc[2 * np + 1], ca, bl[2], bl[3]);
        }
      }
      const float e0 = ev[i0 + g], e1 = ev[i0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
      const float ai[2] = {av[i0 + g], av[i0 + g + 8]};
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {  // keys 64 jh .. 64 jh + 63
        if (64 * jh > i0 + 15) break;   // above the slab's diagonal
        float gs[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) gs[nt][e] = 0.f;
        for (int kn = 0; kn < NP / 16; ++kn) {
          uint32_t ca[4];
          TC::ldsm_a(ca, cs + i0 * kTS + 16 * kn, kTS);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            const int j0 = 64 * jh + 16 * jp;
            if (j0 > i0 + 15) continue;
            uint32_t bb[4];
            TC::ldsm_b(bb, bs + j0 * kTS + 16 * kn, kTS);
            TC::mma16816(gs[2 * jp], ca, bb[0], bb[1]);
            TC::mma16816(gs[2 * jp + 1], ca, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e >> 1);
            const int j = 64 * jh + 8 * nt + 2 * t + (e & 1);
            gs[nt][e] = j <= i ? gs[nt][e] * expf(ai[e >> 1] - av[j]) * dtv[j]
                               : 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j0 = 64 * jh + 16 * kk;
          if (j0 > i0 + 15) continue;
          uint32_t ah[4], al[4];
          TC::split_bf16(gs[2 * kk][0], gs[2 * kk][1], ah[0], al[0]);
          TC::split_bf16(gs[2 * kk][2], gs[2 * kk][3], ah[1], al[1]);
          TC::split_bf16(gs[2 * kk + 1][0], gs[2 * kk + 1][1], ah[2], al[2]);
          TC::split_bf16(gs[2 * kk + 1][2], gs[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bx[4];
            TC::ldsm_b_t(bx, xs + j0 * kTS + 16 * np, kTS);
            TC::mma16816(acc[2 * np], ah, bx[0], bx[1]);
            TC::mma16816(acc[2 * np], al, bx[0], bx[1]);
            TC::mma16816(acc[2 * np + 1], ah, bx[2], bx[3]);
            TC::mma16816(acc[2 * np + 1], al, bx[2], bx[3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i >= Q) continue;
        float* yr = y + ((row0 + i) * H + h) * P + p0;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int p = 8 * nt + 2 * t;
          if (P % 2 == 0 && p0 + p + 1 < P) {
            *reinterpret_cast<float2*>(yr + p) =
                make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
          } else {
            if (p0 + p < P) yr[p] = acc[nt][2 * r];
            if (p0 + p + 1 < P) yr[p + 1] = acc[nt][2 * r + 1];
          }
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * sn + g + 8 * (e >> 1);
      const int p = 32 * sp + 8 * nt + 2 * t + (e & 1);
      if (n < N && p0 + p < P) s_fin[(state0 + n) * P + p0 + p] = st[nt][e];
    }
}

int launch_mma(const void* x, const void* dt, const void* bm, const void* cm,
               const void* a_cum, const void* s0, void* y, void* s_fin,
               int B, int L, int H, int P, int N, int G, int Q,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTcSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kCols - 1) / kCols, H, B);
  ssd_mma_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(
      (const bf16*)x, (const float*)dt, (const bf16*)bm, (const bf16*)cm,
      (const float*)a_cum, (const float*)s0, (float*)y, (float*)s_fin, L, H,
      P, N, G, Q);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (ctypes).  `bf16` selects bf16 x, B and C and the
// tensor-core kernel, else fp32 and the scalar one; dt, a_cum, the states
// and y are always fp32.  Returns a cudaError_t code.
// ---------------------------------------------------------------------------
extern "C" {

// The kernel a call of this dtype launches: 1 the tensor-core kernel
// (bf16), 0 the scalar one (fp32).  A choice by type, never a fallback.
int ssd_chunked_fwd_uses_mma(int bf16) { return bf16 != 0; }

int ssd_chunked_fwd(const void* x, const void* dt, const void* bm,
                    const void* cm, const void* a_cum, const void* s0,
                    void* y, void* s_fin, int B, int L, int H, int P, int N,
                    int G, int Q, int bf16, void* stream) {
  if (B < 0 || L < 0 || H < 0 || P < 0 || N <= 0 || N > kMaxState ||
      G <= 0 || Q <= 0 || Q > kMaxChunk || L % Q != 0 || (H > 0 && H % G))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || P == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return ssd_chunked_fwd_uses_mma(bf16)
             ? launch_mma(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H, P, N,
                          G, Q, st)
             : dispatch(x, dt, bm, cm, a_cum, s0, y, s_fin, B, L, H,
                               P, N, G, Q, st);
}

}  // extern "C"
