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
// What bounds it on this card, by regime:
//
//   * decode and chunk steps (1-8 rows an expert: llama4-maverick's 8-row
//     step touches 8 experts, 2.01 GB of weights a layer for 2 GFLOP; its
//     520-row chunk ~4 rows an expert): weight bytes, about one FLOP a
//     byte against the ~295 at which the tensor cores would be the limit.
//     What counts is that each weight tile leaves HBM once and that each
//     SM keeps enough bytes in flight;
//   * prefill (deepseek-v2's 8 x 1024 tokens x top-6 = 49,152 rows over
//     160 experts, ~307 an expert, d 5120, ff 1536): both at once.  7.55
//     GB of weights and 1.0 GB of rows (2.55 ms at 3.35 TB/s) against
//     2.32 TFLOP (2.35 ms at 989 TFLOP/s).  The weights must still leave
//     HBM once although 3 row tiles of an expert use each of them, and the
//     products must run on wgmma near the tensor cores' rate.
//
// The design (bf16, `moe_wgmma_kernel`):
//
//   * a persistent grid of min(SMs, an upper bound on the tiles) blocks,
//     fixed by (R, E, N) and the SM count, so the launch reads nothing on
//     the host and captures into a CUDA graph.  Each block loads the
//     offsets into shared memory, checks them, and one warp scans each
//     expert's row tiles ceil(rows_e / 128) into their prefix.  The
//     sum_e ceil(rows_e / 128) x ceil(N / BN) tiles are numbered expert
//     by expert, within an expert n-tile by n-tile, and within an
//     (expert, n-tile) row tile by row tile: an expert with no rows gives
//     no tile, and the row tiles of one weight slab are neighbours.  The
//     blocks take the tiles in id order (block b first tile b, then the
//     next id not yet taken, from a counter in device memory), so the
//     tiles in flight are always a window of consecutive ids: the row
//     tiles of a slab run at the same time and find its k-tiles in L2,
//     and the weights come from HBM about once.  A fixed stride (block b
//     taking b, b + grid, ...) lets the blocks of an expert's short last
//     row tile run ahead of the full ones and read the slab again: on an
//     H100 at deepseek-v2's prefill it took 6.15 ms against 4.53 for the
//     counter.  A decode step's tiles are one row tile each: every weight
//     tile is read once.  `kernel.tile_schedule` in the package mirrors
//     the numbering in PyTorch (tests/test_torch_grouped_gemm_schedule.py);
//   * TMA for both operands, 128-byte swizzled into the layout wgmma
//     reads: xs as a 2-D map [R, K], K-major, a box of 64 rows x 64 k (a
//     tile may start at any row; rows past R read as zeros; rows of the
//     next expert are loaded and masked in the epilogue); W as a 3-D map
//     [E, K, N], a box of 64 k x 64 columns of one expert (k past K reads
//     zeros, never the next expert's rows), read by wgmma MN-major with
//     the transpose bit, as mla_decode.cu reads V.  The maps are encoded
//     on the host and cached (tma_map.cuh) and passed as
//     __grid_constant__ parameters;
//   * warp specialisation, 384 threads: one producer thread (warpgroup 0,
//     setmaxnreg 40) keeps a 4-stage mbarrier ring full (48 KB a stage:
//     128 rows x 64 k of xs, 64 k x 256 columns of W), running ahead
//     across tiles; two consumer warpgroups (setmaxnreg 232) each own 64
//     of the tile's 128 rows and run wgmma m64n256k16 asynchronously, one
//     stage in flight behind the one issued, fp32 accumulators in
//     registers (128 a thread).  Gate / up carries 128 gate and 128 up
//     columns a stage (two B tiles, one accumulator each half): the
//     epilogue applies silu(g) * u with the reference's bf16 roundings
//     and stores the rows of the tile's expert; down carries 256 columns
//     of one matrix;
//   * small groups: a consumer whose 64 rows all lie past its group's end
//     skips its products and its half of the rows' load (the 8-row step's
//     tiles run one consumer).  A 64-row product where one row is live
//     costs ~0.28 us a 64-k stage of the tensor cores, against ~1.3 us
//     for that stage's 32 KB of weights at an SM's share of HBM: bytes
//     still bound it, so one kernel serves every regime and the rows
//     need not be swapped onto wgmma's N.
//
//   fp32 (`moe_fp32_kernel`, the card-versus-CPU checks): scalar fp32
//   FMAs, 256 threads over a 32 x 64 output tile, each thread 2 rows x 4
//   columns, 32-deep k tiles in shared memory; a grid of (N / 64, E), a
//   block whose expert has no rows exits at once.
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

#include "tma_map.cuh"
#include "wgmma_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma kernel
// ---------------------------------------------------------------------------
constexpr int kBM = 128;      // rows a tile: two consumers of 64
constexpr int kBK = 64;       // k a stage (one 128-byte swizzled line)
constexpr int kBCols = 256;   // B columns a stage
constexpr int kStages = 4;
constexpr int kMaxE = 1024;   // experts the shared-memory plan holds
constexpr int kWg = 128;      // threads of a warpgroup
constexpr int kThreads = 3 * kWg;
constexpr int kBox = 64 * 128;  // a TMA box: 64 lines of 64 bf16

// output columns a tile: gate / up 128 (x 2 products), down 256
__host__ __device__ constexpr int tile_cols(bool glu) {
  return glu ? kBCols / 2 : kBCols;
}

// The shared-memory plan: the ring (each stage xs [128 x 64] as two
// 64-row boxes, then W [64 x 256] as four 64-column boxes), the offsets,
// each expert's first row tile, the barriers, and 1 KB to align the
// swizzled operands.
struct Plan {
  static constexpr int kA = 2 * kBox;
  static constexpr int kStage = kA + 4 * kBox;
  static constexpr size_t kOff = (size_t)kStages * kStage;
  static constexpr size_t kMt = kOff + (kMaxE + 1) * sizeof(int);
  static constexpr size_t kQueue = kMt + (kMaxE + 1) * sizeof(int);
  static constexpr size_t kBars = (kQueue + 2 * sizeof(int) + 7) & ~7;
  static constexpr size_t kSmem = kBars + (2 * kStages + 4) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory");
};

// The next tile id to hand out, one counter a function (gate / up,
// down), and the blocks that have taken their last: the last block to
// finish resets both, so every launch starts from zero.  Launches of one
// function must not overlap in time (the port issues them on one stream).
__device__ int g_next_tile[2];
__device__ int g_blocks_done[2];

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

struct Tile {
  int e, r0, rows, n0;  // expert, first row, live rows (<= kBM), column
};

// Tile t of the schedule (blocks take the tiles in id order: block b
// first tile b, then, each time its producer needs one, the next id not
// yet taken, from g_next_tile): experts in order, within an expert n-tile by
// n-tile, within an (expert, n-tile) row tile by row tile.  mt_s[e] is the
// number of row tiles before expert e (mt_s[E] all of them).
__device__ __forceinline__ Tile tile_at(int t, const int* off_s,
                                        const int* mt_s, int E, int nt,
                                        int bn) {
  const int q = t / nt;  // mt_s[e] <= q < mt_s[e + 1]
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (mt_s[mid] <= q) lo = mid;
    else hi = mid;
  }
  const int mte = mt_s[lo + 1] - mt_s[lo];
  const int local = t - mt_s[lo] * nt;
  const int n = local / mte, m = local - n * mte;
  Tile tl;
  tl.e = lo;
  tl.r0 = off_s[lo] + m * kBM;
  tl.rows = min(kBM, off_s[lo + 1] - tl.r0);
  tl.n0 = n * bn;
  return tl;
}

template <bool kGLU>
__global__ void __launch_bounds__(kThreads, 1)
    moe_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w0_map,
                     const __grid_constant__ CUtensorMap w1_map,
                     const int* __restrict__ offsets,
                     bf16* __restrict__ out, int R, int tail, int E, int K,
                     int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  int* off_s = reinterpret_cast<int*>(sm + Plan::kOff);
  int* mt_s = reinterpret_cast<int*>(sm + Plan::kMt);
  int* queue = reinterpret_cast<int*>(sm + Plan::kQueue);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Plan::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;  // [2]: a tile id in the queue slot
  uint64_t* q_empty = q_full + 2;      // [2]: both consumers have read it

  for (int i = threadIdx.x; i <= E; i += kThreads) off_s[i] = offsets[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 2);  // one thread of each consumer
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 2 * kWg);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // the contract: rising from >= 0 and ending at R (with `tail` at most R)
  bool bad = false;
  for (int i = threadIdx.x; i < E; i += kThreads)
    bad |= off_s[i] < 0 || off_s[i] > off_s[i + 1];
  if (threadIdx.x == 0) bad |= tail ? off_s[E] > R : off_s[E] != R;
  if (__syncthreads_or(bad)) __trap();

  // each expert's first row tile: one warp scans 32 experts at a time
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < E; base += 32) {
      const int i = base + lane;
      const int c = i < E ? (off_s[i + 1] - off_s[i] + kBM - 1) / kBM : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (i < E) mt_s[i] = carry + incl - c;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) mt_s[E] = carry;
  }
  __syncthreads();

  constexpr int kBN = tile_cols(kGLU);
  const int nt = (N + kBN - 1) / kBN;
  const int n_tiles = mt_s[E] * nt;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;

  if (wg == 0) {
    // ---- producer: one thread streams every tile's stages ----------------
    hopper::setmaxnreg_dec<40>();
    if (tid != 0) return;
    hopper::tma_prefetch_map(&x_map);
    hopper::tma_prefetch_map(&w0_map);
    if (kGLU) hopper::tma_prefetch_map(&w1_map);
    int it = 0;  // stages issued by this block
    for (int n = 0;; ++n) {
      // the next tile (past the last: none), handed to the consumers
      // through a two-slot queue before its stages are issued
      const int t = n == 0 ? blockIdx.x
                           : gridDim.x + atomicAdd(&g_next_tile[kGLU], 1);
      hopper::mbar_wait(&q_empty[n & 1], ((n >> 1) & 1) ^ 1);
      queue[n & 1] = t;
      hopper::mbar_arrive(&q_full[n & 1]);
      if (t >= n_tiles) break;
      const Tile tl = tile_at(t, off_s, mt_s, E, nt, kBN);
      const bool two = tl.rows > 64;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % kStages;
        hopper::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        unsigned char* a = sm + st * Plan::kStage;
        unsigned char* b = a + Plan::kA;
        hopper::mbar_arrive_expect_tx(&full[st], (two ? 6 : 5) * kBox);
        const int k0 = kt * kBK;
        hopper::tma_load_2d(a, &x_map, &full[st], k0, tl.r0);
        if (two) hopper::tma_load_2d(a + kBox, &x_map, &full[st], k0,
                                     tl.r0 + 64);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const void* map = kGLU && j >= 2 ? &w1_map : &w0_map;
          const int col = tl.n0 + 64 * (kGLU ? (j & 1) : j);
          hopper::tma_load_3d(b + j * kBox, map, &full[st], col, k0, tl.e);
        }
      }
    }
    if (atomicAdd(&g_blocks_done[kGLU], 1) == (int)gridDim.x - 1) {
      g_next_tile[kGLU] = 0;  // every block has taken its last tile
      g_blocks_done[kGLU] = 0;
    }
    return;
  }

  // ---- consumers: warpgroup 1 rows 0-63 of a tile, warpgroup 2 rows 64-127
  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;  // stages consumed by this block
  for (int n = 0;; ++n) {
    hopper::mbar_wait(&q_full[n & 1], (n >> 1) & 1);
    const int t = queue[n & 1];
    hopper::mbar_arrive(&q_empty[n & 1]);
    if (t >= n_tiles) break;
    const Tile tl = tile_at(t, off_s, mt_s, E, nt, kBN);
    if (tl.rows <= 64 * c) {
      // none of this consumer's rows are live: release each stage once it
      // has landed (so that the ring's phases stay in step)
      for (int kt = 0; kt < nk; ++kt, ++it) {
        if (tid == 0) {
          const int st = it % kStages;
          hopper::mbar_wait(&full[st], (it / kStages) & 1);
          hopper::mbar_arrive(&empty[st]);
        }
      }
      continue;
    }
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(&full[st], (it / kStages) & 1);
      const unsigned char* a = sm + st * Plan::kStage + c * kBox;
      const unsigned char* b = sm + st * Plan::kStage + Plan::kA;
      const uint64_t da = hopper::desc_sw128(a, 16, 1024);
      const uint64_t db = hopper::desc_sw128(b, kBox, 1024);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::wgmma_m64n256k16_bt(acc, da + ((kk * 32) >> 4),
                                    db + ((kk * 16 * 128) >> 4),
                                    kt > 0 || kk > 0);
      hopper::wgmma_commit();
      // the previous stage's products are done: its buffers are free
      hopper::wgmma_wait<1>();
      if (kt > 0 && tid == 0)
        hopper::mbar_arrive(&empty[(it + kStages - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (tid == 0) hopper::mbar_arrive(&empty[(it + kStages - 1) % kStages]);

    // epilogue: d[4 j + 2 h + x] is row 16 warp + g + 8 h of the
    // consumer's 64, column 8 j + 2 tq + x; gate / up: the up product of
    // column c sits 128 columns on (64 registers)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = tl.n0 + 8 * j + 2 * tq;  // N % 8 == 0: col + 1 < N
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * c + 16 * warp + g + 8 * h;
        if (row >= tl.rows) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (kGLU) {
          v0 = glu_bf16(v0, acc[64 + 4 * j + 2 * h]);
          v1 = glu_bf16(v1, acc[64 + 4 * j + 2 * h + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + (long long)(tl.r0 + row) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the scalar kernel (card-versus-CPU checks)
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// host: the launch shape, the tensor maps, the launches
// ---------------------------------------------------------------------------
// SMs of the current device, read once a device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// The wgmma kernel's grid: min(sms, an upper bound on its tiles) from the
// shapes alone.  Each expert with rows adds at most one partial row tile:
// sum_e ceil(rows_e / 128) <= (R + min(E, R) x 127) / 128.
long long wgmma_grid(int R, int E, int N, int glu, int sms) {
  const long long bn = tile_cols(glu != 0);
  const long long row_tiles =
      ((long long)R + (long long)(E < R ? E : R) * (kBM - 1)) / kBM;
  const long long tiles = row_tiles * ((N + bn - 1) / bn);
  return tiles < sms ? tiles : sms;
}

template <bool kGLU>
cudaError_t launch_wgmma(const void* xs, const void* w0, const void* w1,
                         const int* offsets, void* out, int R, int tail,
                         int E, int K, int N, cudaStream_t stream) {
  CUtensorMap x_map, w0_map, w1_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {64, 64};
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N * 2,
                                   (cuuint64_t)K * N * 2};
  const cuuint32_t w_box[3] = {64, 64, 1};
  cudaError_t err =
      tma_map::bf16_sw128(xs, 2, x_dims, x_strides, x_box, &x_map);
  if (err == cudaSuccess)
    err = tma_map::bf16_sw128(w0, 3, w_dims, w_strides, w_box, &w0_map);
  if (err == cudaSuccess)
    err = tma_map::bf16_sw128(w1, 3, w_dims, w_strides, w_box, &w1_map);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(moe_wgmma_kernel<kGLU>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Plan::kSmem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)wgmma_grid(R, E, N, kGLU, sms);
  moe_wgmma_kernel<kGLU><<<grid, kThreads, Plan::kSmem, stream>>>(
      x_map, w0_map, w1_map, offsets, static_cast<bf16*>(out), R, tail, E,
      K, N);
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

// The bf16 kernel's launch shape for (R, E, N) on the current device:
// rows and output columns a tile, and the grid (0 with no device).
void moe_grouped_gemm_shape(int R, int E, int N, int glu, int* bm, int* bn,
                            int* grid) {
  *bm = kBM;
  *bn = tile_cols(glu != 0);
  const int sms = sm_count();
  *grid = sms > 0 && R > 0 ? (int)wgmma_grid(R, E, N, glu, sms) : 0;
}

// out [R, N] = glu ? silu(xs . w0[e]) * (xs . w1[e]) : xs . w0[e] over each
// expert's rows; xs [R, K], w0 / w1 [E, K, N], offsets [E + 1] int32 ending
// at R, or with `tail` at most at R (the rows past offsets[E] untouched).
// bf16 takes E <= 1024 and K, N multiples of 8 (16-byte TMA strides).
int moe_grouped_gemm(const void* xs, const void* w0, const void* w1,
                     const void* offsets, void* out, int R, int E, int K,
                     int N, int glu, int bf16, int tail, void* stream) {
  if (R < 0 || E <= 0 || E > 65535 || K <= 0 || N <= 0)
    return cudaErrorInvalidValue;
  if (bf16 && (E > kMaxE || K % 8 || N % 8)) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return glu ? launch_wgmma<true>(xs, w0, w1, off, out, R, tail, E, K, N,
                                    s)
               : launch_wgmma<false>(xs, w0, w1, off, out, R, tail, E, K, N,
                                     s);
  return glu ? launch_fp32<true>(xs, w0, w1, off, out, R, tail, E, K, N, s)
             : launch_fp32<false>(xs, w0, w1, off, out, R, tail, E, K, N, s);
}

}  // extern "C"
