// The int8 serve path's dynamically quantized matmul on Hopper (sm_90a):
// a per-token quantization of the activations (int8_quantize_rows_kernel)
// and an int8 GEMM with the dequant and the bias in its epilogue
// (int8_gemm_sm90_kernel).
//
// Replaces mvropose_tpu/models/quantize.py:37 int8_matmul. That function is
// not Pallas: it is XLA ops written for the TPU's int8 matrix unit
// (`lax.dot_general(..., preferred_element_type=int32)` inside a per-token
// dynamic quantization). In the reference's rounding points
// (mvropose_torch/models/quantize.py has them in plain torch), per token row
// r of x (M, K) and output column c:
//   m_r   = max(max_k |x_rk|, 1e-6)             (finite x)
//   s_x,r = m_r / 127                             one rounding (a division)
//   xq_rk = rint(x_rk / s_x,r)                    int8, half to even
//   acc   = sum_k xq_rk wq_kc                     int32, exact in any order
//   y_rc  = ((f32(acc) * s_x,r) * s_w,c) + b_c    each step rounded, in order
// then y in the output dtype (round to nearest). The explicit `_rn`
// intrinsics keep nvcc from contracting a product and a sum into an fma,
// which rounds once where the reference rounds twice; `cvt.rn.f32.s32`
// is torch's `.float()` above 2^24 too (K = 3072 reaches it).
//
// What bounds them on an H100 at the int8 serve step's shapes (M = 4 views
// x 1025 tokens = 4100): the quantization moves bytes, 2 K + K + 4 bytes a
// row (bf16 in, int8 and a scale out): 11.3 us at (4100, 3072), 2.8 us at
// (4100, 768). The GEMM reads x_q and W_q and writes bf16 y: 3.0 us (bytes)
// for each of the four 768 -> 768 products of a block, 9.8 us (int8
// operations) for fc1 (768 -> 3072) and for fc2 (3072 -> 768).
//
// The design:
//   * the quantization (since the LayerNorm kernels quantize the rows of
//     q/k/v and fc1 themselves, it serves the out projection's and fc2's
//     inputs, 24 of its 48 launches a serve tick before): the row held in
//     registers between its max and its quantization, each lane on whole
//     16-value groups (a 16-byte int8 store each; at most 8 16-byte loads
//     a lane), as few lanes a row as hold it (16 at K = 768 bf16, two rows
//     a warp; 64 at K = 3072) so that many rows are in flight, a shuffle
//     max (and one through shared memory across a row's warps), then the
//     division by the row's scale as Markstein's correction steps with its
//     reciprocal (csrc/int8_quantize.cuh: five operations a value, the
//     division's bits). x_q comes out row-major, K-major as wgmma's A
//     operand wants it;
//   * the GEMM: a block computes 128 x 192 output tiles, two consumer
//     warpgroups of 64 rows each issuing wgmma m64n192k32 s8 x s8 -> s32
//     with both operands in shared memory. 8-bit operands are K-major only:
//     x_q is; W_q is held (N, K) contiguous by `Int8Linear`, which is the B
//     operand's K-major layout as it stands. One producer lane streams
//     K-tiles of 128 bytes (one 128-byte swizzle row) of A (128 rows) and
//     B (192 rows) by TMA through a 4-stage ring of full/empty mbarriers;
//     each consumer keeps one group of products in flight while it releases
//     the stage of the one before. Rows past M and K past the end are
//     zero-filled by TMA;
//   * the tile: M = 4100 = 32 x 128 + 4 gives 33 row tiles, and N = 768 =
//     4 x 192 gives 132 tiles, one wave on the 132 SMs (128 x 128 tiles
//     would give 198, 1.5 waves); fc1's N = 3072 gives 528, four a block:
//     the grid is persistent (one block an SM), and the producer streams
//     the next tile's K-tiles while the consumers finish the last one;
//   * the epilogue: each thread holds columns 8 i + 2 t and + 1 of rows g
//     and g + 8 of its warp's 16. The column scales and the bias come from
//     shared memory (a warpgroup's copy, loaded under the products; read
//     from device memory between the stores they cost ~9 us a tile); each
//     warp dequantizes into a padded staging tile of its own rows, then
//     writes whole rows in 16-byte stores, masked by row and column.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_quantize.cuh"  // Divisor, quantized_byte, pack4
#include "sm90_common.cuh"  // mbarriers, the swizzled descriptor, wgmma fences, the map encoder

namespace {

// ------------------------------------------------------------ quantization

constexpr int kQThreads = 256;
constexpr int kQLoads = 8;  // 16-byte loads a thread holds at most: 4 groups of bf16, 2 of f32

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }

// Value i (< 16 / sizeof(T)) of a 16-byte chunk as f32.
template <typename T>
__device__ __forceinline__ float chunk_value(const uint4& raw, int i) {
  return to_f32<T>(reinterpret_cast<const T*>(&raw)[i]);
}

// x (M, K) through its row stride `ld` (elements), K a multiple of 16 ->
// xq (M, K) int8 row-major, sx (M,). A row takes kLanes lanes (a power of
// two; above 32, whole warps); its lane l holds the row's 16-value groups
// l, l + kLanes, ... (at most kQLoads 16-byte loads), so that its int8
// values go out in 16-byte stores and few registers a lane keep many rows
// in flight.
template <typename T, int kLanes>
__global__ void __launch_bounds__(kQThreads)
    int8_quantize_rows_kernel(const T* __restrict__ x, int64_t ld, int M, int K,
                              int8_t* __restrict__ xq, float* __restrict__ sx) {
  constexpr int kPer = 16 / sizeof(T);           // values of a 16-byte load
  constexpr int kLoadsPer = 16 / kPer;           // loads of a 16-value group
  constexpr int kGroups = kQLoads / kLoadsPer;   // groups a lane holds at most
  constexpr int kRows = kQThreads / kLanes;      // rows of a block
  constexpr int kRowWarps = kLanes > 32 ? kLanes / 32 : 1;
  __shared__ float s_max[kQThreads / 32];
  const int r = threadIdx.x / kLanes, l = threadIdx.x % kLanes;
  const int row = blockIdx.x * kRows + r;
  const bool live = row < M;  // no early return: the shuffles and the block's barrier below
  const int groups = live ? K / 16 : 0;
  const T* src = x + static_cast<int64_t>(row) * ld;
  uint4 raw[kGroups][kLoadsPer];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int idx = g * kLanes + l;
#pragma unroll
    for (int u = 0; u < kLoadsPer; ++u) {
      raw[g][u] = idx < groups ? __ldg(reinterpret_cast<const uint4*>(src + 16 * idx + u * kPer))
                               : make_uint4(0, 0, 0, 0);
    }
  }
  float m = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int u = 0; u < kLoadsPer; ++u) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) m = fmaxf(m, fabsf(chunk_value<T>(raw[g][u], i)));
    }
  }
#pragma unroll
  for (int o = (kLanes < 32 ? kLanes : 32) / 2; o > 0; o /= 2) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if constexpr (kRowWarps > 1) {
    if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) m = fmaxf(m, s_max[r * kRowWarps + w]);
  }
  if (!live) return;
  const Divisor d = divisor_of_max(m);
  if (l == 0) sx[row] = d.s;
  int8_t* dst = xq + static_cast<int64_t>(row) * K;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int idx = g * kLanes + l;
    if (idx >= groups) break;
    uint32_t b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      b[i] = quantized_byte(chunk_value<T>(raw[g][i / kPer], i % kPer), d);
    }
    *reinterpret_cast<uint4*>(dst + 16 * idx) =
        make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                   pack4(b[8], b[9], b[10], b[11]), pack4(b[12], b[13], b[14], b[15]));
  }
}

template <typename T, int kLanes>
cudaError_t launch_quantize(const void* x, int64_t ld, int M, int K, void* xq, float* sx,
                            cudaStream_t stream) {
  constexpr int kRows = kQThreads / kLanes;
  int8_quantize_rows_kernel<T, kLanes><<<(M + kRows - 1) / kRows, kQThreads, 0, stream>>>(
      static_cast<const T*>(x), ld, M, K, static_cast<int8_t*>(xq), sx);
  return cudaGetLastError();
}

// The fewest lanes a row whose loads hold a row of K values: 16 at the
// ViT-B/16 width 768 in bf16 (3 groups a lane, 16 rows a block), 64 at 3072.
template <typename T>
cudaError_t quantize_rows(const void* x, int64_t ld, int M, int K, void* xq, float* sx,
                          cudaStream_t stream) {
  constexpr int kGroups = kQLoads / static_cast<int>(sizeof(T));  // 16-value groups a lane
  const int lanes = (K / 16 + kGroups - 1) / kGroups;
  if (lanes <= 1) return launch_quantize<T, 1>(x, ld, M, K, xq, sx, stream);
  if (lanes <= 2) return launch_quantize<T, 2>(x, ld, M, K, xq, sx, stream);
  if (lanes <= 4) return launch_quantize<T, 4>(x, ld, M, K, xq, sx, stream);
  if (lanes <= 8) return launch_quantize<T, 8>(x, ld, M, K, xq, sx, stream);
  if (lanes <= 16) return launch_quantize<T, 16>(x, ld, M, K, xq, sx, stream);
  if (lanes <= 32) return launch_quantize<T, 32>(x, ld, M, K, xq, sx, stream);
  if (lanes <= 64) return launch_quantize<T, 64>(x, ld, M, K, xq, sx, stream);
  if (lanes <= 128) return launch_quantize<T, 128>(x, ld, M, K, xq, sx, stream);
  return cudaErrorInvalidValue;
}

// -------------------------------------------------------------------- GEMM

constexpr int kGConsumers = 2;                     // consumer warpgroups of 64 rows
constexpr int kGM = 64 * kGConsumers;              // rows of a block tile: 128
constexpr int kGN = 192;                           // columns of a block tile
constexpr int kGK = 128;                           // int8 K of a stage: a 128-byte swizzle row
constexpr int kGStages = 4;                        // ring depth
constexpr int kGThreads = 128 * (kGConsumers + 1);  // + the producer warpgroup
constexpr int kATile = kGM * kGK;                  // 16 KB
constexpr int kBTile = kGN * kGK;                  // 24 KB
constexpr int kGStage = kATile + kBTile;           // both 1024-byte multiples
// A consumer warp's staging of its output rows: 16 bf16 rows or 8 f32 rows
// of 192 values, each row padded by 16 bytes (conflict-free bf16 writes).
constexpr int kPitch16 = kGN * 2 + 16, kPitch32 = kGN * 4 + 16;
constexpr int kWarpStage = 16 * kPitch16;
static_assert(8 * kPitch32 <= kWarpStage, "8 f32 rows fit a warp's staging");
struct GSmem {
  static constexpr int kRing = 0;
  static constexpr int kStaging = kRing + kGStages * kGStage;  // one per consumer warp
  static constexpr int kScales = kStaging + 4 * kGConsumers * kWarpStage;  // [wg][s_w, b]
  static constexpr int kBars = kScales + kGConsumers * 2 * kGN * 4;
  static constexpr int kAlloc = kBars + 2 * kGStages * 8 + 1024;  // + room to align to 1024
};

struct GemmParams {
  CUtensorMap a;      // x_q (M, K) int8, boxes of 128 rows x 128 bytes
  CUtensorMap b;      // W_q as (N, K) int8, boxes of 192 rows x 128 bytes
  const float* sx;    // (M,)
  const float* sw;    // (N,)
  const float* bias;  // (N,) or null
  void* out;          // (M, N) contiguous, bf16 or f32
  int M, N, K, out_f32;
};

#define WGMMA_N192_S32                                                                          \
  "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]),     \
      "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), \
      "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), \
      "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), \
      "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), \
      "+r"(d[7][2]), "+r"(d[7][3]), "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]), \
      "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]), "+r"(d[10][0]),               \
      "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]), "+r"(d[11][0]), "+r"(d[11][1]),           \
      "+r"(d[11][2]), "+r"(d[11][3]), "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]),           \
      "+r"(d[12][3]), "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),           \
      "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]), "+r"(d[15][0]),           \
      "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]), "+r"(d[16][0]), "+r"(d[16][1]),           \
      "+r"(d[16][2]), "+r"(d[16][3]), "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]),           \
      "+r"(d[17][3]), "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),           \
      "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]), "+r"(d[20][0]),           \
      "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]), "+r"(d[21][0]), "+r"(d[21][1]),           \
      "+r"(d[21][2]), "+r"(d[21][3]), "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]),           \
      "+r"(d[22][3]), "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3])
#define WGMMA_N192_REGS                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "  \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95}"

// D += A B, m64n192k32, s8 x s8 -> s32, A (64 rows) and B (192 rows) both
// K-major 128-byte swizzled tiles in shared memory.
__device__ __forceinline__ void wgmma_ss192_s8(int (&d)[24][4], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " WGMMA_N192_REGS ", %96, %97, 1;\n"
      : WGMMA_N192_S32
      : "l"(a), "l"(b));
}

// y = ((f32(acc) * sx) * sw) + b, each step rounded to nearest, no fma.
__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b, bool has_bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  return has_bias ? __fadd_rn(y, b) : y;
}

__device__ __forceinline__ void consumers_sync(int wg) {  // the 128 threads of warpgroup wg
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Rows [row, row + rows) of a warp's staged output (pitch bytes apart, 16
// / esize values a 16-byte chunk) to out at columns n0 .., in 16-byte
// stores, neighbouring lanes on neighbouring chunks; rows past M and
// columns past N are not stored.
template <int kEsize>
__device__ __forceinline__ void store_rows(const unsigned char* st, int pitch, int rows, int row,
                                           int n0, const GemmParams& p, int lane) {
  constexpr int kChunks = kGN * kEsize / 16;  // of a staged row
  for (int i = lane; i < rows * kChunks; i += 32) {
    const int r = i / kChunks, ch = i % kChunks;
    const int col = n0 + ch * (16 / kEsize);
    if (row + r < p.M && col < p.N) {
      *reinterpret_cast<uint4*>(static_cast<unsigned char*>(p.out) +
                                (static_cast<int64_t>(row + r) * p.N + col) * kEsize) =
          *reinterpret_cast<const uint4*>(st + r * pitch + ch * 16);
    }
  }
}

// A persistent grid: block b takes the output tiles b, b + gridDim.x, ...
// (tile t at row tile t / n_tiles, column tile t % n_tiles), one producer
// lane streaming every tile's K-tiles through the ring without a break, so
// that the next tile's loads run under the consumers' epilogue.
__global__ void __launch_bounds__(kGThreads, 1)
    int8_gemm_sm90_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* ring = smem + GSmem::kRing;  // [stage][A 128 x 128, B 192 x 128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GSmem::kBars);
  uint64_t* empty = full + kGStages;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int k_tiles = (p.K + kGK - 1) / kGK, n_tiles = (p.N + kGN - 1) / kGN;
  const int tiles = (p.M + kGM - 1) / kGM * n_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);                 // the producer's lane 0, with the bytes
      mbar_init(&empty[s], 4 * kGConsumers);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kGConsumers) {  // producer: one lane issues every copy
    if (warp != 0 || lane != 0) return;
    int it = 0;  // K-tiles issued, over all of this block's tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kGM, n0 = tile % n_tiles * kGN;
      for (int i = 0; i < k_tiles; ++i, ++it) {
        const int stage = it % kGStages;
        mbar_wait(&empty[stage], ((it / kGStages) & 1) ^ 1);  // round 0 passes
        unsigned char* st = ring + stage * kGStage;
        mbar_arrive_expect_tx(&full[stage], kGStage);
        tma_2d(st, &p.a, &full[stage], i * kGK, m0);
        tma_2d(st + kATile, &p.b, &full[stage], i * kGK, n0);
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows m0 + 64 wg .. + 64 of each tile.
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x % 128;
  float* scales = reinterpret_cast<float*>(smem + GSmem::kScales) + wg * 2 * kGN;  // s_w, b
  unsigned char* staged = smem + GSmem::kStaging + (wg * 4 + warp) * kWarpStage;
  const bool has_bias = p.bias != nullptr;
  int it = 0;  // K-tiles consumed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kGM, n0 = tile % n_tiles * kGN;
    const int row0 = m0 + wg * 64 + warp * 16;  // the warp's 16 rows; the thread's g and g + 8
    // The tile's column scales and bias into this warpgroup's copy (its last
    // tile's epilogue has read them), and the thread's two row scales, all
    // landing under the products.
    consumers_sync(wg);
    for (int c = tid; c < 2 * kGN; c += 128) {
      const int col = n0 + c % kGN;
      const float* src = c < kGN ? p.sw : p.bias;
      scales[c] = col < p.N && src != nullptr ? src[col] : 0.f;
    }
    float sx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) sx[r] = row0 + g + 8 * r < p.M ? p.sx[row0 + g + 8 * r] : 0.f;

    int acc[24][4];
#pragma unroll
    for (int n = 0; n < 24; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
    for (int i = 0; i < k_tiles; ++i, ++it) {
      const int stage = it % kGStages;
      mbar_wait(&full[stage], (it / kGStages) & 1);
      const unsigned char* st = ring + stage * kGStage;
      const uint64_t a = sw_desc<false>(st + wg * 64 * kGK), b = sw_desc<false>(st + kATile);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGK / 32; ++kk) wgmma_ss192_s8(acc, a + 2 * kk, b + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the products of the K-tile before are done: release its stage
      fence_acc(acc);
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kGStages]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kGStages]);
    consumers_sync(wg);  // the scales are in

    // Dequantize into the warp's staging, then store whole rows.
    const float* s_w = scales;
    const float* s_b = scales + kGN;
    if (!p.out_f32) {
#pragma unroll
      for (int n = 0; n < 24; ++n) {
        const int c = 8 * n + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<__nv_bfloat162*>(staged + (g + 8 * r) * kPitch16 + c * 2) =
              __floats2bfloat162_rn(dequant(acc[n][2 * r], sx[r], s_w[c], s_b[c], has_bias),
                                    dequant(acc[n][2 * r + 1], sx[r], s_w[c + 1], s_b[c + 1],
                                            has_bias));
        }
      }
      __syncwarp();
      store_rows<2>(staged, kPitch16, 16, row0, n0, p, lane);
      __syncwarp();
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows g, then g + 8
#pragma unroll
        for (int n = 0; n < 24; ++n) {
          const int c = 8 * n + 2 * t;
          *reinterpret_cast<float2*>(staged + g * kPitch32 + c * 4) = make_float2(
              dequant(acc[n][2 * r], sx[r], s_w[c], s_b[c], has_bias),
              dequant(acc[n][2 * r + 1], sx[r], s_w[c + 1], s_b[c + 1], has_bias));
        }
        __syncwarp();
        store_rows<4>(staged, kPitch32, 8, row0 + 8 * r, n0, p, lane);
        __syncwarp();
      }
    }
  }
}

// A tensor map over a (rows, K) row-major int8 matrix: dims (K, rows), boxes
// of 128 bytes x `box_rows`, 128-byte swizzle, out of bounds zero-filled.
// -> 0 or the CUresult of the encoding.
int make_int8_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kGK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                                 dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace

// x: (M, K) bf16 (x_f32 = 0) or f32 (1) rows `ld` elements apart (unit
// stride along K; 16-byte aligned base and rows; K a multiple of 16, at most
// 8192 bf16 or 4096 f32 values) -> xq (M, K) int8 contiguous, sx (M,) f32. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue (1) for a
// row it does not take.
extern "C" int int8_quantize_rows(const void* x, int64_t ld, int M, int K, int x_f32, void* xq,
                                  float* sx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_f32 ? quantize_rows<float>(x, ld, M, K, xq, sx, s)
                                : quantize_rows<bf16>(x, ld, M, K, xq, sx, s);
  return static_cast<int>(err);
}

// xq: (M, K) int8 contiguous; wq: (N, K) int8 contiguous (the (K, N)
// weight's K-major layout); K a multiple of 16, N of 8; 16-byte aligned
// bases; sx (M,), sw (N,) and bias (N,) f32 (bias may be null; sw and bias
// 8-byte aligned); out (M, N) contiguous, bf16 (out_f32 = 0) or f32. Every
// pointer on the device of `stream`. Returns cudaGetLastError() after the
// launch, or minus the CUresult of a tensor map that cannot be encoded.
extern "C" int int8_gemm_sm90(const void* xq, const void* wq, const float* sx, const float* sw,
                              const float* bias, void* out, int M, int N, int K, int out_f32,
                              void* stream) {
  GemmParams p{};
  int err = make_int8_map(&p.a, xq, M, K, kGM);
  if (!err) err = make_int8_map(&p.b, wq, N, K, kGN);
  if (err) return -err;
  p.sx = sx;
  p.sw = sw;
  p.bias = bias;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.out_f32 = out_f32;
  static const cudaError_t configured = cudaFuncSetAttribute(
      int8_gemm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSmem::kAlloc);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = static_cast<int64_t>((M + kGM - 1) / kGM) * ((N + kGN - 1) / kGN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // one block an SM at most
  int8_gemm_sm90_kernel<<<grid, kGThreads, GSmem::kAlloc, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
