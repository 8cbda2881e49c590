// TMA tensor maps encoded on the host, cached: the encoder
// cuTensorMapEncodeTiled (an entry point looked up at run time, so a
// library links no -lcuda) and a small cache keyed by everything that
// goes into a map.  mla_decode.cu and moe_grouped_gemm.cu include it;
// each library keeps its own cache.
//
// A map is passed to its kernel by value as a __grid_constant__
// parameter, so a CUDA graph captures it.  The cache saves the encode
// (a few microseconds of host time) on a launch whose tensors were seen
// before: a model's weights, a serving step's reused buffers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: at run time)
#include <cuda_runtime.h>

#include <cstring>
#include <mutex>

namespace tma_map {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

constexpr int kMaxRank = 3;
constexpr int kCache = 128;  // maps remembered (round robin)

struct Key {
  const void* base;
  int rank;
  cuuint64_t dims[kMaxRank];
  cuuint64_t strides[kMaxRank - 1];
  cuuint32_t box[kMaxRank];
};

struct Entry {
  Key key;
  CUtensorMap map;
};

namespace detail {
inline std::mutex mu;
inline Entry cache[kCache];
inline int n_cached = 0, next_slot = 0;
inline EncodeTiled encode = nullptr;
}  // namespace detail

// cuTensorMapEncodeTiled, looked up once (call under mu)
inline cudaError_t encoder(EncodeTiled* out) {
  if (detail::encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    detail::encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = detail::encode;
  return cudaSuccess;
}

// The map of a bf16 tensor of `rank` (2 or 3) dims at `base`: dims
// innermost first, byte strides of dims 1.., a box of `box` elements a
// dim, 128-byte swizzle (the box's inner extent is 64 elements), 256-byte
// L2 promotion, elements past the dims read as zeros.
inline cudaError_t bf16_sw128(const void* base, int rank,
                              const cuuint64_t* dims,
                              const cuuint64_t* strides,
                              const cuuint32_t* box, CUtensorMap* map) {
  if (rank < 1 || rank > kMaxRank) return cudaErrorInvalidValue;
  Key key;
  std::memset(&key, 0, sizeof(key));
  key.base = base;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  std::lock_guard<std::mutex> lock(detail::mu);
  for (int i = 0; i < detail::n_cached; ++i)
    if (std::memcmp(&detail::cache[i].key, &key, sizeof(key)) == 0) {
      *map = detail::cache[i].map;
      return cudaSuccess;
    }
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t elem[kMaxRank] = {1, 1, 1};
  Entry& e = detail::cache[detail::next_slot];
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.key.base = nullptr;
    return cudaErrorInvalidValue;
  }
  e.key = key;
  *map = e.map;
  detail::next_slot = (detail::next_slot + 1) % kCache;
  if (detail::n_cached < kCache) ++detail::n_cached;
  return cudaSuccess;
}

}  // namespace tma_map
