// The packed serving step's per-layer glue for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++: three kernels that take the places of the chains
// of small eager operations between a decoder layer's matrix products.
//
// They replace no Pallas kernel.  In the reference these functions run
// inside XLA's fusions of the jitted step:
//
//   add_rms_norm_kernel   the residual add of `_decoder_block`
//                         (src/repro/models/model.py:226) and the next
//                         `rms_norm` (src/repro/models/layers.py:37)
//   rope_write_kv_kernel  `apply_rope` / `apply_mrope` on q and k
//                         (src/repro/models/layers.py:68 / :86, called by
//                         `_qkv`, src/repro/models/attention.py:75) and the
//                         K / V page write `write_pages`
//                         (src/repro/core/paged/kv_cache.py:115)
//   silu_mul_kernel       the SwiGLU gate of `mlp`
//                         (src/repro/models/layers.py:131)
//
// Each computes what the port's plain PyTorch ops computed, at the same
// rounding points, so that a CUDA graph of the step and its eager run give
// the same bits, and the fp32 step agrees with the CPU:
//
//   * add_rms_norm: x_new = x + delta rounded to the activation type (as
//     the eager add rounds it), then h = rms_norm(x_new): the mean of the
//     squares in fp32 (sum times 1 / d, as PyTorch's CUDA mean), rsqrtf of
//     it plus eps, the product by that, the product by the scale, the cast.
//     Only the order of the sum of squares differs from the eager
//     reduction's.  delta NULL is the norm alone (x_new is x).
//   * rope_write_kv: angle = (float)position * freq, rounded once (the
//     frequencies come from the caller, computed once a step by the same
//     expression as `rope_frequencies`: never recomputed here with powf);
//     accurate cosf / sinf (no fast math); x1 c - x2 s and x2 c + x1 s with
//     every product and sum rounded on its own (__fmul_rn / __fadd_rn /
//     __fsub_rn: the eager ops round each product, and an FMA would not);
//     the cast.  M-RoPE takes for frequency pair f the position row of the
//     section f falls in.
//   * silu_mul: silu(g) = g / (1 + expf(-g)) in fp32 rounded to the
//     activation type, as `F.silu` rounds it, then its product with up
//     rounded again: `F.silu(g) * u` in bf16, and in fp32.
//
// What bounds them on this card: bytes, and at the decode shapes the
// launch itself.  At smollm-135m's decode (8 rows, d 576, Hq 9 / Hkv 3,
// D 64, ff 1536, bf16) add_rms_norm moves 38,016 bytes (x and delta read,
// the scale, h and x_new written): 0.011 us at 3.35 TB/s;
// rope_write_kv 31,048 (q, k, v read, positions, frequencies and the write
// index, q written, 8 rows of K and V into the pages): 0.009 us; silu_mul
// 73,728 (gate and up read, h written): 0.022 us.  Each launch costs some
// microseconds, so the design's point is the count: one launch where the
// eager step ran ~10 (the norm), ~21 (rope, q and k, and the write) and 2
// (the gate).
//
// Design:
//
//   * add_rms_norm_kernel<T, VEC>: one block a row, up to 1024 threads,
//     VEC elements a thread a step (16-byte loads where the row and every
//     pointer allow, else one element).  A row wider than the block holds
//     in registers (d 16384, llama3-405b's: 16 elements a thread) is not
//     kept in registers: the first pass adds, stores x_new and sums the
//     squares; the second pass re-reads the row this block just wrote
//     (from L1 / L2) for the normalisation.  The block sum is a fixed tree
//     (warp shuffles, then one warp over the warps' sums): the same bits
//     every run.
//   * rope_write_kv_kernel<T>: a grid of (token, share of its pairs):
//     the (Hq + 2 Hkv) x D / 2 element pairs of a token in shares of 256,
//     so that a decode step of 8 tokens still fills the card (musicgen's
//     32 + 64 heads: 12 blocks a token; one block a token ran its 48
//     launches at 8.1 us each, against 2.7 us at smollm's 15 heads).  Each
//     block's first threads compute its token's D / 2 cos / sin pairs into
//     shared memory; then it walks its pairs: q's rotated into a new
//     [T, Hq, D] tensor, k's rotated and v's as they are written straight
//     into this layer's pages.  q, k and v are read as
//     the views of the QKV output they are (any token stride, heads of D
//     contiguous elements), so the split needs no copy.  A token writes the
//     pages where `write_index` (src/repro_torch/core/paged/kv_cache.py)
//     keeps its slot (live and its own source row): negative slots arrive
//     wrapped from the pool's end, out-of-range and trash slots and dead
//     rows write nothing, so the pages end as `scatter_kv` leaves them.
//   * silu_mul_kernel<T, VEC>: a grid over (row chunks of ff, rows), VEC
//     elements a thread; gate and up are read at their own row strides (the
//     two halves of a fused gate_up product are views), h written
//     contiguous.
//
// Interface: plain C functions (pointers, sizes, the stream) returning
// cudaGetLastError(), loaded from Python with ctypes.  Nothing is
// allocated here and nothing waits: each launch captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 1024;
constexpr int kRopeThreads = 256;
constexpr int kGateThreads = 256;
// rope_write_kv's styles
constexpr int kRope = 0;
constexpr int kMrope = 1;
constexpr int kNone = 2;

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

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& x) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = x;
}

// The sum of every thread's v, returned to every thread: each warp by a
// shuffle tree, then each warp over the warps' sums.  blockDim.x is a
// multiple of 32.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    add_rms_norm_kernel(const T* x, const T* delta, const T* scale, T* h,
                        T* x_new, int d, float eps, float inv_d) {
  using P = Pack<T, VEC>;
  const size_t base = (size_t)blockIdx.x * d;
  const int step = blockDim.x * VEC;
  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < d; i += step) {
    P a = load<T, VEC>(x + base + i);
    if (delta != nullptr) {
      const P b = load<T, VEC>(delta + base + i);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        a.v[j] = from_float<T>(__fadd_rn(to_float(a.v[j]), to_float(b.v[j])));
      store<T, VEC>(x_new + base + i, a);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float(a.v[j]);
      ss = fmaf(f, f, ss);
    }
  }
  const float total = block_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
  // second pass: this thread's own elements of x_new (or x), re-read
  const T* src = delta != nullptr ? x_new : x;
  for (int i = threadIdx.x * VEC; i < d; i += step) {
    const P a = load<T, VEC>(src + base + i);
    const P s = load<T, VEC>(scale + i);
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_float<T>(
          __fmul_rn(__fmul_rn(to_float(a.v[j]), r), to_float(s.v[j])));
    store<T, VEC>(h + base + i, o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
    rope_write_kv_kernel(const T* q, const T* k, const T* v, long long qs,
                         long long ks, long long vs, const long long* pos,
                         long long pos_ts, long long pos_rs,
                         const float* freqs, T* k_pages, T* v_pages,
                         long long rows_per_head, const long long* src,
                         const long long* dest, const bool* live, T* q_out,
                         int hq, int hkv, int d, int style, int sec0,
                         int sec1) {
  extern __shared__ float cs[];  // [cos | sin] of the token's D / 2 pairs
  // blockIdx.x: the token; blockIdx.y: the block's share of its pairs
  const long long t = blockIdx.x;
  const int half = d / 2;
  if (style != kNone) {
    for (int f = threadIdx.x; f < half; f += blockDim.x) {
      const int row = style == kMrope ? (f >= sec0) + (f >= sec0 + sec1) : 0;
      const float a =
          __fmul_rn(__ll2float_rn(pos[row * pos_rs + t * pos_ts]), freqs[f]);
      cs[f] = cosf(a);
      cs[half + f] = sinf(a);
    }
    __syncthreads();
  }
  const bool write = live[t] && src[t] == t;
  const long long slot = dest[t];
  const int items = (hq + 2 * hkv) * half;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < items;
       i += gridDim.y * blockDim.x) {
    const int hb = i / half, f = i % half;
    const T* in;
    T* out;
    bool rotate = style != kNone;
    if (hb < hq) {
      in = q + t * qs + (long long)hb * d;
      out = q_out + (t * hq + hb) * (long long)d;
    } else if (hb < hq + hkv) {
      if (!write) continue;
      const int hh = hb - hq;
      in = k + t * ks + (long long)hh * d;
      out = k_pages + (hh * rows_per_head + slot) * d;
    } else {
      if (!write) continue;
      const int hh = hb - hq - hkv;
      in = v + t * vs + (long long)hh * d;
      out = v_pages + (hh * rows_per_head + slot) * d;
      rotate = false;
    }
    if (rotate) {
      const float x1 = to_float(in[f]), x2 = to_float(in[f + half]);
      const float c = cs[f], s = cs[half + f];
      out[f] = from_float<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
      out[f + half] =
          from_float<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
    } else {
      out[f] = in[f];
      out[f + half] = in[f + half];
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kGateThreads)
    silu_mul_kernel(const T* gate, const T* up, T* out, int rows, int ff,
                    long long gs, long long us) {
  using P = Pack<T, VEC>;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (i >= ff) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const P g = load<T, VEC>(gate + r * gs + i);
    const P u = load<T, VEC>(up + r * us + i);
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float gf = to_float(g.v[j]);
      const T s = from_float<T>(__fdiv_rn(gf, __fadd_rn(1.f, expf(-gf))));
      o.v[j] = from_float<T>(__fmul_rn(to_float(s), to_float(u.v[j])));
    }
    store<T, VEC>(out + r * ff + i, o);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int round_warps(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename T, int VEC>
int launch_norm(const void* x, const void* delta, const void* scale,
                void* h, void* x_new, int rows, int d, float eps,
                cudaStream_t stream) {
  const int threads = round_warps((d + VEC - 1) / VEC);
  add_rms_norm_kernel<T, VEC><<<rows, threads, 0, stream>>>(
      (const T*)x, (const T*)delta, (const T*)scale, (T*)h, (T*)x_new, d,
      eps, 1.0f / (float)d);
  return cudaGetLastError();
}

template <typename T>
int norm_typed(const void* x, const void* delta, const void* scale, void* h,
               void* x_new, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(delta) &&
                   aligned16(scale) && aligned16(h) && aligned16(x_new);
  return vec ? launch_norm<T, kVec>(x, delta, scale, h, x_new, rows, d, eps,
                                    stream)
             : launch_norm<T, 1>(x, delta, scale, h, x_new, rows, d, eps,
                                 stream);
}

template <typename T, int VEC>
int launch_gate(const void* gate, const void* up, void* out, int rows,
                int ff, long long gs, long long us, cudaStream_t stream) {
  const int per_block = kGateThreads * VEC;
  const dim3 grid((ff + per_block - 1) / per_block,
                  rows < 65535 ? rows : 65535);
  silu_mul_kernel<T, VEC><<<grid, kGateThreads, 0, stream>>>(
      (const T*)gate, (const T*)up, (T*)out, rows, ff, gs, us);
  return cudaGetLastError();
}

template <typename T>
int gate_typed(const void* gate, const void* up, void* out, int rows, int ff,
               long long gs, long long us, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = ff % kVec == 0 && gs % kVec == 0 && us % kVec == 0 &&
                   aligned16(gate) && aligned16(up) && aligned16(out);
  return vec ? launch_gate<T, kVec>(gate, up, out, rows, ff, gs, us, stream)
             : launch_gate<T, 1>(gate, up, out, rows, ff, gs, us, stream);
}

}  // namespace

extern "C" {

// x, delta (NULL: the norm alone), h, x_new [rows, d] contiguous; scale
// [d]; all of one type (is_bf16 != 0: bfloat16, else float32).
int add_rms_norm(const void* x, const void* delta, const void* scale,
                 void* h, void* x_new, int rows, int d, float eps, int is_bf16,
                 void* stream) {
  if (rows < 0 || d <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? norm_typed<__nv_bfloat16>(x, delta, scale, h, x_new, rows, d,
                                          eps, st)
              : norm_typed<float>(x, delta, scale, h, x_new, rows, d, eps,
                                  st);
}

// q [T, Hq, D], k / v [T, Hkv, D] at token strides qs / ks / vs (heads of D
// contiguous elements); positions int64 at token stride pos_ts and, for
// M-RoPE, row stride pos_rs (t / h / w rows); freqs fp32 [D / 2] (unread
// for style "none"); k_pages / v_pages [Hkv, rows_per_head, D] contiguous;
// src / dest int64 and live bool [T], the step's write index; q_out [T, Hq,
// D].  style 0 "rope", 1 "mrope" (sections sec0, sec1, the rest), 2
// "none".
int rope_write_kv(const void* q, const void* k, const void* v, long long qs,
                  long long ks, long long vs, const void* positions,
                  long long pos_ts, long long pos_rs, const void* freqs,
                  void* k_pages, void* v_pages, long long rows_per_head,
                  const void* src, const void* dest, const void* live,
                  void* q_out, int T, int hq, int hkv, int d, int style,
                  int sec0, int sec1, int is_bf16, void* stream) {
  if (T < 0 || hq <= 0 || hkv < 0 || d <= 0 || d % 2 || style < kRope ||
      style > kNone)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int items = (hq + 2 * hkv) * (d / 2);
  const int threads = items < kRopeThreads ? round_warps(items)
                                           : kRopeThreads;
  const int shares = (items + threads - 1) / threads;
  const dim3 grid(T, shares < 65535 ? shares : 65535);
  const size_t smem = style == kNone ? 0 : sizeof(float) * d;
  if (is_bf16) {
    rope_write_kv_kernel<bf16><<<grid, threads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, qs, ks, vs,
        (const long long*)positions, pos_ts, pos_rs, (const float*)freqs,
        (bf16*)k_pages, (bf16*)v_pages, rows_per_head, (const long long*)src,
        (const long long*)dest, (const bool*)live, (bf16*)q_out, hq, hkv, d,
        style, sec0, sec1);
  } else {
    rope_write_kv_kernel<float><<<grid, threads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, qs, ks, vs,
        (const long long*)positions, pos_ts, pos_rs, (const float*)freqs,
        (float*)k_pages, (float*)v_pages, rows_per_head,
        (const long long*)src, (const long long*)dest, (const bool*)live,
        (float*)q_out, hq, hkv, d, style, sec0, sec1);
  }
  return cudaGetLastError();
}

// gate / up [rows, ff] at row strides gs / us (unit element stride); out
// [rows, ff] contiguous.
int silu_mul(const void* gate, const void* up, void* out, int rows, int ff,
             long long gs, long long us, int is_bf16, void* stream) {
  if (rows < 0 || ff <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? gate_typed<__nv_bfloat16>(gate, up, out, rows, ff, gs, us, st)
              : gate_typed<float>(gate, up, out, rows, ff, gs, us, st);
}

}  // extern "C"
