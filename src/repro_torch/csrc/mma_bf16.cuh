// The PTX that every tensor-core kernel of this package is built from, for
// NVIDIA Hopper (sm_90a): cp.async copies, ldmatrix loads, the
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 product, and the bf16 packing and
// splitting of fp32 values.  attention_tile.cuh (flash forward, Q-Block
// prefill), mamba2_ssd.cu and mlstm_chunked.cu include it.
//
// Fragment layouts of m16n8k16 (lane = 4 g + t): A 16 x 16 row-major, a0
// holds row g, columns 2t and 2t + 1 (the lower column in the low half),
// a1 row g + 8, a2 and a3 the same rows at columns + 8; B 16 x 8, b0 holds
// rows 2t and 2t + 1 of column g, b1 rows + 8; C 16 x 8 fp32, c0 / c1 row
// g at columns 2t / 2t + 1, c2 / c3 row g + 8.  So the C tiles 2kk and
// 2kk + 1 of an accumulator are, packed in pairs, the A fragment of k-block
// kk of a product that takes the accumulator as its left operand.
//
// Which ldmatrix reads which operand from a row-major bf16 tile in shared
// memory (rows padded by 16 bytes, so the 8 rows of one 8 x 8 matrix fall
// in 8 different bank groups):
//
//   A stored [m][k]: ldsm_x4 at row (lane & 7) + ((lane >> 3) & 1) * 8,
//                    column (lane >> 4) * 8              (ldsm_a)
//   A stored [k][m]: ldsm_x4_t at row (lane & 7) + (lane >> 4) * 8,
//                    column ((lane >> 3) & 1) * 8         (ldsm_a_t)
//   B stored [n][k]: ldsm_x4 at row (lane & 7) + (lane >> 4) * 8,
//                    column ((lane >> 3) & 1) * 8: b0, b1 of n-tile 0 in
//                    r[0], r[1], of n-tile 1 in r[2], r[3]   (ldsm_b)
//   B stored [k][n]: ldsm_x4_t at row (lane & 7) + ((lane >> 3) & 1) * 8,
//                    column (lane >> 4) * 8: the same registers (ldsm_b_t)
//
// each relative to the 16 x 16 block's first element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The four loads of the table above; `tile` is the 16 x 16 block's first
// element, `ld` the tile's row stride in elements.
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const bf16* tile,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                 (lane >> 4) * 8);
}

__device__ __forceinline__ void ldsm_a_t(uint32_t (&r)[4], const bf16* tile,
                                         int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, tile + ((lane & 7) + (lane >> 4) * 8) * ld +
                   ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const bf16* tile,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + ((lane & 7) + (lane >> 4) * 8) * ld +
                 ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void ldsm_b_t(uint32_t (&r)[4], const bf16* tile,
                                         int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                   (lane >> 4) * 8);
}

// c += a . b: A 16 x 16 row-major, B 16 x 8 column-major, C 16 x 8 fp32
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> bf16x2, round to nearest even (jnp's astype); lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a packed pair, widened exactly (low half first)
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return make_float2(__uint_as_float(r << 16),
                     __uint_as_float(r & 0xffff0000u));
}

// fp32 x = hi + lo to ~2^-17 |x|: hi = bf16(x), lo = bf16(x - hi), for a
// pair (x0 in the low halves).  A product whose other operand is exactly
// bf16 then costs two MMAs into one fp32 accumulator and loses ~2^-17 of
// each term, where one rounding of x would lose 2^-9.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [0, rows) of a bf16 tile of `chunks` (<= blockDim.x) 16-byte chunks
// a row (row stride ld_s elements in shared memory) from global rows
// src + r * ld_g, by the whole block: row r < valid_rows, column c <
// valid_cols are read, the rest zero-filled.  vec: every chunk is 16-byte
// aligned in global memory and either wholly valid or wholly past
// valid_cols (ld_g and valid_cols multiples of 8, src 16-byte aligned);
// the copies are then cp.async (the caller commits and waits), else
// element-wise loads.  Each thread keeps one chunk column, so no division
// runs in the loop.
__device__ __forceinline__ void load_tile(bf16* dst, int ld_s,
                                          const bf16* src, long long ld_g,
                                          int rows, int chunks,
                                          int valid_rows, int valid_cols,
                                          bool vec) {
  const int step = blockDim.x / chunks;  // rows a pass
  if ((int)threadIdx.x >= step * chunks) return;
  const int c = (threadIdx.x % chunks) * 8;
  for (int r = threadIdx.x / chunks; r < rows; r += step) {
    bf16* d = dst + r * ld_s + c;
    const bf16* s = src + r * ld_g + c;
    if (vec) {
      const bool ok = r < valid_rows && c < valid_cols;
      cp_async16(d, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = (r < valid_rows && c + k < valid_cols) ? s[k]
                                                      : __float2bfloat16(0.f);
    }
  }
}

}  // namespace mma_bf16
