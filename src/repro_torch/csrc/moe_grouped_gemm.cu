// Grouped expert GEMM of the dropless MoE for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces no Pallas kernel: the reference computes this product with
// jax.lax.ragged_dot (src/repro/models/moe.py:moe_ffn_dropless), outside
// any kernel of its own.  It is written by hand because the group sizes
// live on the device: a loop of per-expert matmuls would need them on the
// host, a device-to-host copy inside the serving step that breaks its CUDA
// graph capture.
//
// Rows xs [R, K] are sorted by expert; offsets [E + 1] int32 (read on the
// device) bound expert e's rows [offsets[e], offsets[e + 1]).  Two
// functions, one launch each:
//
//   gate / up (kGLU):  out = silu(xs . Wg[e]) * (xs . Wu[e])   [R, N]
//   down:              out = xs . Wd[e]                         [R, N]
//
// with W [E, K, N] row-major.  In bf16 the two products are rounded to
// bf16 before silu and the product, as the bf16 ragged_dot of the
// reference and the plain version round them.
//
// What bounds it on this card: weight bytes.  A decode step of 8 rows
// touches at most 8 experts, 8 x 3 x 5120 x 8192 x 2 B = 2.01 GB a layer
// at llama4-maverick's width, for 2 x 8 x 3 x 5120 x 8192 = 2 GFLOP: one
// FLOP a byte, against the ~295 at which the tensor cores would be the
// limit.  A 512-row chunk touches every expert (32.2 GB a layer) for 129
// GFLOP: still bytes.  So the design reads each weight tile once for up to
// 64 rows of its expert and keeps many 16-byte loads in flight:
//
//   * the grid is (N / 64, E): fixed by the shapes, never by the group
//     sizes, so the launch captures into a graph; a block whose expert has
//     no rows exits at once, and a group longer than 64 rows is walked
//     64 rows at a time by a loop inside the block (each tile reading the
//     weights again);
//   * bf16 (`moe_mma_kernel`): 128 threads, 4 warps; warp w owns 16 of
//     the block's 64 columns (two m16n8k16 n-tiles) for all of the row
//     tile's 16-row slabs, and skips the slabs past the group's rows (a
//     decode step's group of 1-8 rows costs one slab); the 64 x 64 weight
//     tiles (two for gate / up) and the 64-row activation tile reach
//     shared memory by 16-byte cp.async in a 3-stage ring (rows padded by
//     16 bytes: ldmatrix without bank conflicts), so two stages of
//     weights are in flight under every product (mma.sync on
//     mma_bf16.cuh, fp32 accumulators);
//   * fp32 (`moe_fp32_kernel`, the card-versus-CPU checks): scalar fp32
//     FMAs, 256 threads over a 32 x 64 output tile, each thread 2 rows x
//     4 columns, 32-deep k tiles in shared memory.
//
// wgmma and TMA weight streaming are left to a later change.
//
// Every block checks the offsets it reads (0 <= offsets[e] <=
// offsets[e + 1] <= offsets[E] == R) and traps otherwise: the wrapper
// cannot read the device's offsets without a host sync, and a bad group
// must not read or write outside the rows.  With `tail` set the groups may
// end before the last row (offsets[E] <= R): the rows past offsets[E]
// belong to no expert and no block touches them.  The expert-parallel MoE
// launches so, its rows routed to other ranks' experts sorted to the tail
// (the wrapper zeroes the output's tail, as jax.lax.ragged_dot leaves
// rows outside every group).
//
// The entry point is a plain C function (device pointers, shapes, the
// stream) returning cudaGetLastError(), loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::bf16;

constexpr int kBM = 64;   // rows a tile
constexpr int kBN = 64;   // columns a block
constexpr int kBK = 64;   // k a stage
constexpr int kStages = 3;
constexpr int kLd = kBK + 8;   // padded row of the activation tile
constexpr int kLdW = kBN + 8;  // padded row of a weight tile
constexpr int kMmaThreads = 128;

__host__ __device__ constexpr size_t mma_smem_bytes(bool glu) {
  return (size_t)kStages *
         ((size_t)kBM * kLd + (size_t)(glu ? 2 : 1) * kBK * kLdW) *
         sizeof(bf16);
}

// [lo, hi) of expert e's rows; traps on offsets that break the contract
// (the groups end at R, or with `tail` at most at R)
__device__ __forceinline__ void group_bounds(const int* offsets, int e,
                                             int E, int R, int tail,
                                             int& lo, int& hi) {
  lo = __ldg(offsets + e);
  hi = __ldg(offsets + e + 1);
  const int end = __ldg(offsets + E);
  if ((tail ? end > R : end != R) || lo < 0 || lo > hi || hi > R) __trap();
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + expf(-x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// silu(g) * u with the reference's bf16 roundings: each product rounded,
// silu rounded, the product rounded
__device__ __forceinline__ float glu_bf16(float g, float u) {
  return round_bf16(silu(round_bf16(g))) * round_bf16(u);
}

template <bool kGLU>
__global__ void __launch_bounds__(kMmaThreads)
    moe_mma_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ w0,
                   const bf16* __restrict__ w1,
                   const int* __restrict__ offsets, bf16* __restrict__ out,
                   int R, int tail, int E, int K, int N) {
  using namespace mma_bf16;
  const int e = blockIdx.y;
  int lo, hi;
  group_bounds(offsets, e, E, R, tail, lo, hi);
  if (lo == hi) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kA = kBM * kLd;
  constexpr int kW = kBK * kLdW;
  constexpr int kStage = kA + (kGLU ? 2 : 1) * kW;

  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wofs = (long long)e * K * N;
  const bf16* wg = w0 + wofs + n0;
  const bf16* wu = kGLU ? w1 + wofs + n0 : nullptr;
  const bool vec = (K % 8 == 0) && (N % 8 == 0);
  const int nk = (K + kBK - 1) / kBK;

  for (int r0 = lo; r0 < hi; r0 += kBM) {
    const int rows = min(kBM, hi - r0);
    const int slabs = (rows + 15) >> 4;  // warp-uniform
    const bf16* a = xs + (long long)r0 * K;

    auto load_stage = [&](int kt) {
      bf16* st = smem + (kt % kStages) * kStage;
      const int k0 = kt * kBK;
      load_tile(st, kLd, a + k0, K, slabs * 16, kBK / 8, rows, K - k0, vec);
      load_tile(st + kA, kLdW, wg + (long long)k0 * N, N, kBK, kBN / 8,
                K - k0, N - n0, vec);
      if constexpr (kGLU)
        load_tile(st + kA + kW, kLdW, wu + (long long)k0 * N, N, kBK,
                  kBN / 8, K - k0, N - n0, vec);
    };

    float acc_g[4][2][4] = {};
    float acc_u[kGLU ? 4 : 1][2][4] = {};
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_stage(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
      cp_async_commit();
      const bf16* st = smem + (kt % kStages) * kStage;
      const bf16* sw = st + kA + warp * 16;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t bg[4];
        ldsm_b_t(bg, sw + kk * 16 * kLdW, kLdW);
        uint32_t bu[4];
        if constexpr (kGLU) ldsm_b_t(bu, sw + kW + kk * 16 * kLdW, kLdW);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < slabs) {
            uint32_t af[4];
            ldsm_a(af, st + m * 16 * kLd + kk * 16, kLd);
            mma16816(acc_g[m][0], af, bg[0], bg[1]);
            mma16816(acc_g[m][1], af, bg[2], bg[3]);
            if constexpr (kGLU) {
              mma16816(acc_u[m][0], af, bu[0], bu[1]);
              mma16816(acc_u[m][1], af, bu[2], bu[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();

    // epilogue: c0 / c1 row g at columns 2t, 2t + 1; c2 / c3 row g + 8
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= slabs) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + warp * 16 + j * 8 + 2 * t;
        if (col >= N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m * 16 + g + half * 8;
          if (row >= rows) continue;
          float v0 = acc_g[m][j][2 * half], v1 = acc_g[m][j][2 * half + 1];
          if constexpr (kGLU) {
            v0 = glu_bf16(v0, acc_u[m][j][2 * half]);
            v1 = glu_bf16(v1, acc_u[m][j][2 * half + 1]);
          }
          bf16* o = out + (long long)(r0 + row) * N + col;
          if (col + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *o = __float2bfloat16(v0);
          }
        }
      }
    }
    __syncthreads();  // the next row tile's prologue reuses the ring
  }
}

constexpr int kFBM = 32, kFBN = 64, kFBK = 32, kFThreads = 256;

template <bool kGLU>
__global__ void __launch_bounds__(kFThreads)
    moe_fp32_kernel(const float* __restrict__ xs,
                    const float* __restrict__ w0,
                    const float* __restrict__ w1,
                    const int* __restrict__ offsets,
                    float* __restrict__ out, int R, int tail, int E, int K,
                    int N) {
  const int e = blockIdx.y;
  int lo, hi;
  group_bounds(offsets, e, E, R, tail, lo, hi);
  if (lo == hi) return;
  __shared__ float sa[kFBM][kFBK + 1];
  __shared__ float sg[kFBK][kFBN];
  __shared__ float su[kGLU ? kFBK : 1][kFBN];
  const int n0 = blockIdx.x * kFBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long wofs = (long long)e * K * N;

  for (int r0 = lo; r0 < hi; r0 += kFBM) {
    const int rows = min(kFBM, hi - r0);
    float acc_g[2][4] = {}, acc_u[2][4] = {};
    for (int k0 = 0; k0 < K; k0 += kFBK) {
      for (int i = threadIdx.x; i < kFBM * kFBK; i += kFThreads) {
        const int r = i / kFBK, k = i % kFBK;
        sa[r][k] = (r < rows && k0 + k < K)
                       ? xs[(long long)(r0 + r) * K + k0 + k]
                       : 0.f;
      }
      for (int i = threadIdx.x; i < kFBK * kFBN; i += kFThreads) {
        const int k = i / kFBN, c = i % kFBN;
        const bool ok = k0 + k < K && n0 + c < N;
        const long long at = wofs + (long long)(k0 + k) * N + n0 + c;
        sg[k][c] = ok ? w0[at] : 0.f;
        if constexpr (kGLU) su[k][c] = ok ? w1[at] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kFBK; ++k) {
        const float a0 = sa[2 * ty][k], a1 = sa[2 * ty + 1][k];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float b = sg[k][4 * tx + c];
          acc_g[0][c] = fmaf(a0, b, acc_g[0][c]);
          acc_g[1][c] = fmaf(a1, b, acc_g[1][c]);
          if constexpr (kGLU) {
            const float bu = su[k][4 * tx + c];
            acc_u[0][c] = fmaf(a0, bu, acc_u[0][c]);
            acc_u[1][c] = fmaf(a1, bu, acc_u[1][c]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * ty + i;
      if (row >= rows) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + 4 * tx + c;
        if (col >= N) continue;
        float v = acc_g[i][c];
        if constexpr (kGLU) v = silu(v) * acc_u[i][c];
        out[(long long)(r0 + row) * N + col] = v;
      }
    }
  }
}

template <bool kGLU>
cudaError_t launch_mma(const void* xs, const void* w0, const void* w1,
                       const int* offsets, void* out, int R, int tail, int E,
                       int K, int N, cudaStream_t stream) {
  static bool attr_set = false;  // once per process, before any capture
  const size_t smem = mma_smem_bytes(kGLU);
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_mma_kernel<kGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, E);
  moe_mma_kernel<kGLU><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w1), offsets, static_cast<bf16*>(out), R,
      tail, E, K, N);
  return cudaGetLastError();
}

template <bool kGLU>
cudaError_t launch_fp32(const void* xs, const void* w0, const void* w1,
                        const int* offsets, void* out, int R, int tail, int E,
                        int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kFBN - 1) / kFBN, E);
  moe_fp32_kernel<kGLU><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(xs), static_cast<const float*>(w0),
      static_cast<const float*>(w1), offsets, static_cast<float*>(out), R,
      tail, E, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel a call of this dtype launches: 1 the tensor-core kernel
// (bf16), 0 the scalar one (fp32).  A choice by type, never a fallback.
int moe_grouped_gemm_uses_mma(int bf16) { return bf16 != 0; }

// out [R, N] = glu ? silu(xs . w0[e]) * (xs . w1[e]) : xs . w0[e] over each
// expert's rows; xs [R, K], w0 / w1 [E, K, N], offsets [E + 1] int32 ending
// at R, or with `tail` at most at R (the rows past offsets[E] untouched).
int moe_grouped_gemm(const void* xs, const void* w0, const void* w1,
                     const void* offsets, void* out, int R, int E, int K,
                     int N, int glu, int bf16, int tail, void* stream) {
  if (R < 0 || E <= 0 || E > 65535 || K <= 0 || N <= 0)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return glu ? launch_mma<true>(xs, w0, w1, off, out, R, tail, E, K, N, s)
               : launch_mma<false>(xs, w0, w1, off, out, R, tail, E, K, N,
                                   s);
  return glu ? launch_fp32<true>(xs, w0, w1, off, out, R, tail, E, K, N, s)
             : launch_fp32<false>(xs, w0, w1, off, out, R, tail, E, K, N, s);
}

}  // extern "C"
