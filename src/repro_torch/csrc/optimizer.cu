// The optimizer step for NVIDIA Hopper (sm_90a), hand-written CUDA C++: two
// multi-tensor kernels that take the places of the eager per-tensor
// operations of the clip's global norm and of the AdamW update.
//
// They replace no Pallas kernel.  In the reference the step is pure jnp
// under jit, which XLA fuses:
//
//   sum_squares_kernel  each gradient's fp32 sum of squares, the leaves of
//                       `global_norm` (src/repro/utils/misc.py:56)
//   adamw_kernel        the update of `adamw_update`
//                       (src/repro/training/optimizer.py:29), every
//                       parameter and both moments of one (parameter
//                       dtype, gradient dtype) group in place
//
// where the port ran about a dozen eager elementwise operations a
// parameter slice, each writing an fp32 temporary.
//
// What bounds them on this card: bytes.  AdamW reads a bf16 parameter, its
// bf16 gradient and two fp32 moments and writes the parameter and the
// moments back: 22 bytes an element (24 with an fp32 gradient, 28 at fp32
// parameters); the sum of squares reads each gradient once.  Both do a few
// operations a byte, far below the card's ~295 bf16 operations a byte, so
// the design streams each byte once with 16-byte loads and keeps every
// temporary in registers.
//
// Design:
//
//   * One launch over a device table of tensors (the wrapper builds it on
//     the host for each call: gradients are new tensors every step).  Each
//     tensor is cut into chunks of a fixed number of elements; block b takes
//     the b-th chunk of the launch and finds its tensor by a binary search
//     over the rows' first chunks.  Element indices are 64-bit (a MoE layer
//     of a full-width model holds tensors of more than 2^31 elements).
//   * 16-byte loads where the tensor's pointer allows: a scalar head up to
//     the first aligned element, the vector body, a scalar tail.  AdamW
//     takes 4 elements a step (fp32 operands 16 bytes, bf16 ones 8) from the
//     first element at which all four of a row's pointers are aligned; a row
//     whose pointers cannot align together runs scalar.
//   * sum_squares_kernel is deterministic: every thread squares and sums a
//     fixed set of elements in a fixed order (one fp32 sum per vector lane),
//     the block adds its threads' sums in a fixed tree and writes its
//     chunk's partial sum to a workspace; the last block to arrive (an
//     integer counter in the launch's own table, which the wrapper copies
//     with a 0 there each call) sums each tensor's partials, one warp a
//     tensor: lane l adds the partials of chunks l, l + 32, l + 64, ... in
//     that order, then the 32 lanes' sums meet in a fixed xor shuffle tree.
//     No floating-point atomics: two launches on the same inputs give the
//     same bits.
//   * adamw_kernel computes the plain version's expressions in its order,
//     each product, sum, quotient and square root rounded on its own as the
//     eager operations round them (__fmul_rn, __fadd_rn, __fdiv_rn,
//     __fsqrt_rn: nothing contracted into an FMA), and casts the parameter
//     back with round-to-nearest-even.  The clip scale, both bias
//     corrections and the learning rate are read from 0-d device tensors,
//     so nothing of the step is read on the host; b1, b2, 1 - b1, 1 - b2,
//     eps and the weight decay arrive as fp32 values that the host rounded
//     from Python's doubles, as PyTorch rounds a Python scalar.
//
// Interface: plain C functions (pointers, sizes, the stream) returning
// cudaGetLastError(), loaded from Python with ctypes.  Nothing is allocated
// here and nothing waits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the tables' rows, int64 each
constexpr int kSumCols = 4;   // data pointer, numel, is_bf16, first chunk
constexpr int kAdamCols = 6;  // p, g, mu, nu, numel, first chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The row of `table` (n rows of `cols`, the first chunk last) whose chunks
// hold chunk c: the last row whose first chunk is <= c.  A row of no chunks
// shares its first chunk with the next row, so it is never the last such
// row unless it ends the table, where its first chunk is past every c.
__device__ __forceinline__ int find_row(const long long* table, int cols,
                                        int n, long long c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[(long long)mid * cols + cols - 1] <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Elements from index i to the first 16-byte aligned one.
template <typename T>
__device__ __forceinline__ long long to_aligned(const T* x, long long i) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x + i);
  return (long long)(((16 - (addr & 15)) & 15) / sizeof(T));
}

// The sum of every thread's v, returned to every thread: each warp by a
// shuffle tree, then each warp over the warps' sums.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < kWarps ? warp_sums[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This thread's share of the sum of squares of x[s, e).
template <typename T>
__device__ float chunk_sumsq(const T* __restrict__ x, long long s,
                             long long e) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  long long a = s + to_aligned(x, s);
  if (a > e) a = e;
  const long long nv = (e - a) / V;
  const long long b = a + nv * V;
  const P* xv = reinterpret_cast<const P*>(x + a);
  float lane[V];
#pragma unroll
  for (int j = 0; j < V; ++j) lane[j] = 0.f;
  long long i = threadIdx.x;
  // four loads in flight a thread, then the rest one at a time
  for (; i + 3 * kThreads < nv; i += 4 * kThreads) {
    P u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = xv[i + k * kThreads];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_float(u[k].v[j]);
        lane[j] = fmaf(f, f, lane[j]);
      }
  }
  for (; i < nv; i += kThreads) {
    const P u = xv[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_float(u.v[j]);
      lane[j] = fmaf(f, f, lane[j]);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) acc += lane[j];
  // the head [s, a) and the tail [b, e): fewer than V elements each
  if (threadIdx.x < a - s) {
    const float f = to_float(x[s + threadIdx.x]);
    acc = fmaf(f, f, acc);
  }
  if (threadIdx.x < e - b) {
    const float f = to_float(x[b + threadIdx.x]);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

// table: n rows (data pointer, numel, is_bf16, first chunk), then the
// arrival counter (0).  Block c < total writes chunk c's sum to
// partials[c]; the last block to arrive writes out[r], row r's sum of its
// partials.  The grid is max(total, 1) blocks.
__global__ void __launch_bounds__(kThreads)
    sum_squares_kernel(long long* table, int n, long long chunk,
                       long long total, float* partials, float* out) {
  const long long c = blockIdx.x;
  if (c < total) {
    const long long* row = table + (long long)find_row(table, kSumCols, n,
                                                       c) * kSumCols;
    const long long s = (c - row[3]) * chunk;
    const long long e = s + chunk < row[1] ? s + chunk : row[1];
    const float part =
        row[2] ? chunk_sumsq(reinterpret_cast<const bf16*>(row[0]), s, e)
               : chunk_sumsq(reinterpret_cast<const float*>(row[0]), s, e);
    const float sum = block_sum(part);
    if (threadIdx.x == 0) partials[c] = sum;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partial, before its arrival
    auto* counter =
        reinterpret_cast<unsigned long long*>(table + (long long)n * kSumCols);
    last = atomicAdd(counter, 1ULL) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += kWarps) {
    const long long* row = table + (long long)r * kSumCols;
    const long long first = row[3];
    const long long count = (row[1] + chunk - 1) / chunk;
    float v = 0.f;
    for (long long k = lane; k < count; k += 32)
      v += __ldcg(partials + first + k);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) out[r] = v;
  }
}

struct AdamScalars {
  float b1, b2, omb1, omb2, eps, wd;
};

// One element of the update, in the plain version's order and roundings:
//   gs = g * scale
//   mu = b1 * mu + (1 - b1) * gs
//   nu = b2 * nu + (1 - b2) * gs^2
//   st = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
//   p  = p - lr * st
__device__ __forceinline__ void adam_element(float& p, float g, float& m,
                                             float& v, float scale,
                                             float bc1, float bc2, float lr,
                                             const AdamScalars& k) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(gs, k.omb1));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(gs, gs), k.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps);
  float st = __fdiv_rn(__fdiv_rn(m, bc1), den);
  st = __fadd_rn(st, __fmul_rn(p, k.wd));
  p = __fsub_rn(p, __fmul_rn(lr, st));
}

template <typename P, typename G>
__device__ __forceinline__ void adam_scalar(P* p, const G* g, float* mu,
                                            float* nu, long long i,
                                            float scale, float bc1, float bc2,
                                            float lr, const AdamScalars& k) {
  float pf = to_float(p[i]), m = mu[i], v = nu[i];
  adam_element(pf, to_float(g[i]), m, v, scale, bc1, bc2, lr, k);
  mu[i] = m;
  nu[i] = v;
  p[i] = from_float<P>(pf);
}

// Elements a row's pointer x lies past a 4-element boundary (x + 4 - that is
// aligned for 4-element loads), or -1 where x is not even element-aligned.
template <typename T>
__device__ __forceinline__ int phase4(const T* x) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr % sizeof(T)) return -1;
  return (int)((addr / sizeof(T)) & 3);
}

// table: n rows (p, g, mu, nu, numel, first chunk); block c updates chunk c
// of its row in place.  The grid is `total` blocks.
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const long long* table, int n, long long chunk,
                 const float* scale_p, const float* bc1_p, const float* bc2_p,
                 const float* lr_p, AdamScalars k) {
  const long long c = blockIdx.x;
  const long long* row =
      table + (long long)find_row(table, kAdamCols, n, c) * kAdamCols;
  P* __restrict__ p = reinterpret_cast<P*>(row[0]);
  const G* __restrict__ g = reinterpret_cast<const G*>(row[1]);
  float* __restrict__ mu = reinterpret_cast<float*>(row[2]);
  float* __restrict__ nu = reinterpret_cast<float*>(row[3]);
  const long long s = (c - row[5]) * chunk;
  const long long e = s + chunk < row[4] ? s + chunk : row[4];
  const float scale = *scale_p, bc1 = *bc1_p, bc2 = *bc2_p, lr = *lr_p;
  // the vector body [a, b): every pointer aligned for 4-element loads at a
  // (s is a multiple of 4, so a = s + the elements to that boundary)
  const int ph = phase4(p);
  long long a = e;
  if (ph >= 0 && ph == phase4(g) && ph == phase4(mu) && ph == phase4(nu)) {
    a = s + ((4 - ph) & 3);
    if (a > e) a = e;
  }
  const long long nv = (e - a) / 4;
  const long long b = a + 4 * nv;
  for (long long i = s + threadIdx.x; i < a; i += kThreads)
    adam_scalar(p, g, mu, nu, i, scale, bc1, bc2, lr, k);
  for (long long i = b + threadIdx.x; i < e; i += kThreads)
    adam_scalar(p, g, mu, nu, i, scale, bc1, bc2, lr, k);
  using PV = Pack<P, 4>;
  using GV = Pack<G, 4>;
  using FV = Pack<float, 4>;
  for (long long i = threadIdx.x; i < nv; i += kThreads) {
    const long long at = a + 4 * i;
    PV pv = *reinterpret_cast<const PV*>(p + at);
    const GV gv = *reinterpret_cast<const GV*>(g + at);
    FV mv = *reinterpret_cast<const FV*>(mu + at);
    FV vv = *reinterpret_cast<const FV*>(nu + at);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pf = to_float(pv.v[j]);
      adam_element(pf, to_float(gv.v[j]), mv.v[j], vv.v[j], scale, bc1, bc2,
                   lr, k);
      pv.v[j] = from_float<P>(pf);
    }
    *reinterpret_cast<FV*>(mu + at) = mv;
    *reinterpret_cast<FV*>(nu + at) = vv;
    *reinterpret_cast<PV*>(p + at) = pv;
  }
}

}  // namespace

extern "C" {

// table: int64 [n * 4 + 1], the rows (data pointer, numel, is_bf16, first
// chunk) then the arrival counter, 0; `total` chunks of `chunk` elements
// over all rows; partials fp32 [max(total, 1)]; out fp32 [n].
int sum_squares(void* table, int n, long long chunk, long long total,
                void* partials, void* out, void* stream) {
  if (n <= 0 || chunk <= 0 || chunk % 8 || total < 0 || total >= INT_MAX)
    return cudaErrorInvalidValue;
  const unsigned grid = total > 0 ? (unsigned)total : 1u;
  sum_squares_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<long long*>(table), n, chunk, total,
      static_cast<float*>(partials), static_cast<float*>(out));
  return cudaGetLastError();
}

// table: int64 [n * 6], the rows (p, g, mu, nu, numel, first chunk) of one
// (parameter dtype, gradient dtype) group: p_bf16 / g_bf16 != 0 bfloat16,
// else float32 (bf16 / bf16, fp32 / fp32, bf16 / fp32); mu, nu fp32.
// scale, bc1, bc2, lr: fp32 0-d device tensors.
int adamw(const void* table, int n, long long chunk, long long total,
          int p_bf16, int g_bf16, const void* scale, const void* bc1,
          const void* bc2, const void* lr, float b1, float b2, float omb1,
          float omb2, float eps, float wd, void* stream) {
  if (n <= 0 || chunk <= 0 || chunk % 4 || total < 0 || total >= INT_MAX ||
      (!p_bf16 && g_bf16))
    return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  const AdamScalars k{b1, b2, omb1, omb2, eps, wd};
  const auto* t = static_cast<const long long*>(table);
  const auto* sc = static_cast<const float*>(scale);
  const auto* c1 = static_cast<const float*>(bc1);
  const auto* c2 = static_cast<const float*>(bc2);
  const auto* l = static_cast<const float*>(lr);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)total;
  if (p_bf16 && g_bf16)
    adamw_kernel<bf16, bf16><<<grid, kThreads, 0, st>>>(t, n, chunk, sc, c1,
                                                        c2, l, k);
  else if (p_bf16)
    adamw_kernel<bf16, float><<<grid, kThreads, 0, st>>>(t, n, chunk, sc, c1,
                                                         c2, l, k);
  else
    adamw_kernel<float, float><<<grid, kThreads, 0, st>>>(t, n, chunk, sc,
                                                          c1, c2, l, k);
  return cudaGetLastError();
}

}  // extern "C"
