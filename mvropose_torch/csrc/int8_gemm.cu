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
// operations) for fc1 (768 -> 3072) and for fc2 (3072 -> 768). Beside the
// products, the GEMM streams its operand tiles into shared memory: a 128 x
// 192 tile takes its A row panel and B column panel, (128 + 192) K bytes
// (32.4 MB from L2 at 768 -> 768, 129.8 MB at fc1 and at fc2,
// `ops/int8_matmul.py::gemm_l2_bytes`), and the ring's round trip (a stage
// released, refilled by TMA, landed), not L2's bandwidth, bounds how fast
// they come: with the products and the epilogue cut out, the loads alone
// take about as long as the products at their peak at fc2, and a ring of 2
// stages in place of 4 makes them 1.4x slower (PERF.md, the int8 GEMM's findings).
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
//   * the GEMM's products: 128 x 192 output tiles, wgmma m64n192k32 s8 x s8
//     -> s32 with both operands in shared memory. 8-bit operands are K-major
//     only: x_q is; W_q is held (N, K) contiguous by `Int8Linear`, which is
//     the B operand's K-major layout as it stands. One producer lane streams
//     K-tiles of 128 bytes (one 128-byte swizzle row) of A (128 rows) and B
//     (192 rows) by TMA through a 4-stage ring of full/empty mbarriers;
//     rows past M and K past the end are zero-filled by TMA;
//   * the tile and the grid: M = 4100 = 32 x 128 + 4 gives 33 row tiles, and
//     N = 768 = 4 x 192 gives 132 tiles, one wave on the 132 SMs (128 x 128
//     tiles would give 198, 1.5 waves); fc1's N = 3072 gives 528, four a
//     block. The grid is persistent, one block an SM (the SM count queried
//     once a device), and the producer streams the next tile's K-tiles
//     while the consumers finish the last one;
//   * the epilogue under the products (ping-pong), where a block has more
//     than one tile (fc1, the eval's M = 16400): each of the two consumer
//     warpgroups owns whole tiles, the block's tiles 0, 2, .. and 1, 3, ..,
//     all 128 rows as two m64 products (192 s32 sums a thread; setmaxnreg
//     gives the consumers 232 registers and the producer warpgroup 40). They
//     take turns at the products (named barriers): one issues its tile's
//     K-tiles while the other dequantizes and stores its last tile, so the
//     ring keeps flowing through an epilogue, which with both warpgroups on
//     one tile stopped it (fc1's four tiles a block). The turns also keep a
//     warpgroup, which skips the other's K-tiles in the ring, from waiting
//     on a stage more than one phase ahead;
//   * where no block has a second tile (tiles <= SMs: 768 -> 768 and fc2 at
//     M = 4100, 132 tiles), there is no next tile to hide an epilogue under,
//     and one warpgroup alone would dequantize and store all 128 rows: so
//     both warpgroups work on the tile, 64 rows each (kSplit), and share its
//     epilogue;
//   * the epilogue: each thread holds columns 8 n + 2 t and + 1 of rows g
//     and g + 8 of its warp's 16 in each m64 half. The column scales and the
//     bias are loaded into registers under the products and put in shared
//     memory (a warpgroup's copy) after them; each warp dequantizes 16 rows
//     (bf16; f32 8) into a staging of 128-byte-swizzled boxes (no bank
//     conflicts) and one lane stores them by TMA, which leaves out rows past
//     M and columns past N and lets the warp go on before the bytes land;
//   * the launch: programmatic dependent launch (the kernel waits in
//     griddepcontrol.wait for the kernels before it, which a CUDA graph
//     captured from the stream keeps as programmatic edges), with the
//     barrier set-up, the three tensor maps' prefetch and the weights' first
//     stages ahead of the wait and the next launch let in at once
//     (griddepcontrol.launch_dependents);
//   * not kept: thread-block clusters of two blocks sharing an operand
//     panel by TMA multicast (B for two row tiles of a column: 30 % fewer L2
//     reads, 91.2 MB at fc1 and fc2). A shared stage can be refilled only
//     when both blocks' consumers have released it, which lengthens the
//     ring's round trip, and the round trip, not L2, paces the loads: they
//     were slower with multicast than without, and the ping-pong schedule
//     with that multicast on top was slower than without it at every serve
//     and eval product (PERF.md, the int8 GEMM's findings).

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_quantize.cuh"  // Divisor, quantized_byte, pack4
#include "sm90_common.cuh"  // mbarriers, the swizzled descriptor, wgmma fences, the map encoder,
                             // programmatic dependent launch

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

constexpr int kGConsumers = 2;                     // consumer warpgroups, a tile each in turn
constexpr int kGM = 128;                           // rows of a tile: two m64 products
constexpr int kGN = 192;                           // columns of a tile
constexpr int kGK = 128;                           // int8 K of a stage: a 128-byte swizzle row
constexpr int kGStages = 4;                        // ring depth
constexpr int kGThreads = 128 * (kGConsumers + 1);  // + the producer warpgroup
constexpr int kGConsumerRegs = 232, kGProducerRegs = 40;  // setmaxnreg: 256 x 232 + 128 x 40
constexpr int kATile = kGM * kGK;                  // 16 KB
constexpr int kBTile = kGN * kGK;                  // 24 KB
constexpr int kGStage = kATile + kBTile;           // both 1024-byte multiples
// A consumer warp's staging of its output rows for the TMA store: 3 boxes
// of 16 rows of 128 bytes (bf16: 64 columns), or 6 of 8 rows (f32: 32
// columns), each 1024-byte aligned and laid out with the 128-byte swizzle
// (16-byte chunk j of box row r at chunk j ^ (r % 8)), so that the warp's
// writes are free of bank conflicts. A warp's 32 rows of a tile (16 in each
// m64 half) go out in 2 passes (bf16) or 4 (f32).
constexpr int kOutBox = 16 * 128;
constexpr int kWarpStage = 3 * kOutBox;
struct GSmem {
  static constexpr int kRing = 0;
  static constexpr int kStaging = kRing + kGStages * kGStage;              // one per consumer warp
  static constexpr int kScales = kStaging + 4 * kGConsumers * kWarpStage;  // [wg][s_w, b]
  static constexpr int kBars = kScales + kGConsumers * 2 * kGN * 4;
  static constexpr int kAlloc = kBars + 2 * kGStages * 8 + 1024;  // + room to align to 1024
};
static_assert(GSmem::kAlloc <= kMaxSmem, "the block's shared memory fits an SM");

struct GemmParams {
  CUtensorMap a;      // x_q (M, K) int8, boxes of 128 rows x 128 bytes
  CUtensorMap b;      // W_q as (N, K) int8, boxes of 192 rows x 128 bytes
  CUtensorMap c;      // out (M, N), boxes of 128 bytes (bf16: 16 rows x 64; f32: 8 x 32)
  const float* sx;    // (M,)
  const float* sw;    // (N,)
  const float* bias;  // (N,) or null
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
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// One box of the output from shared memory (laid out as the map's box,
// swizzled), at columns x, rows y of out; TMA leaves out what lies past M or
// N. Issued by one lane after the warp's writes and a proxy fence; its
// reads of shared memory are awaited by store_wait before the staging is
// written again.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait() {  // the committed stores have read shared memory
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The warp's generic-proxy writes to its staging, made visible to TMA.
__device__ __forceinline__ void fence_to_tma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One pass of a warp's epilogue: its kBoxes staged boxes (kBoxBytes apart)
// to out at columns x0, x0 + box_cols, .. (those before N) and rows y .. (if
// y < M), by lane 0 after every lane's writes.
template <int kBoxes, int kBoxBytes>
__device__ __forceinline__ void store_pass(const GemmParams& p, const unsigned char* staged, int x0,
                                           int box_cols, int y, int lane) {
  fence_to_tma();
  __syncwarp();
  if (lane == 0 && y < p.M) {
#pragma unroll
    for (int box = 0; box < kBoxes; ++box) {
      const int x = x0 + box * box_cols;
      if (x < p.N) tma_store_2d(&p.c, staged + box * kBoxBytes, x, y);
    }
    store_commit();
  }
}
__device__ __forceinline__ void staging_free(int lane) {  // the last pass's stores have read it
  if (lane == 0) store_wait();
  __syncwarp();
}

// A persistent grid, one block an SM: block b takes the output tiles b, b +
// gridDim.x, ... (tile t at row tile t / n_tiles, column tile t % n_tiles),
// one producer lane streaming every tile's K-tiles through the ring without
// a break. With kSplit (no block has a second tile), both consumer
// warpgroups work on each tile, warpgroup w on its rows 64 w .. + 64, so
// that the one epilogue is shared. Else the block's j-th tile is consumer
// warpgroup j % 2's, all 128 rows, and the warpgroups take turns at the
// products (turn_wait / turn_pass, sm90_common.cuh): one starts its tile's
// K-tiles when the other has issued its last, so that one warpgroup's
// epilogue runs under the other's products, and a warpgroup never waits on
// a stage more than one phase ahead of it.
template <bool kSplit>
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
    prefetch_map(&p.a);
    prefetch_map(&p.b);
    prefetch_map(&p.c);
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's lane 0, with the bytes
      mbar_init(&empty[s], kSplit ? 8 : 4);  // the warps of the warpgroups that read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    griddep_launch_dependents();
  }
  __syncthreads();

  if (wg == kGConsumers) {  // producer: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGProducerRegs));
    if (warp != 0 || lane != 0) return;
    // The weights' first stages go out before the wait for the kernel
    // before (none writes W_q); x_q's after it. The grid has at most
    // `tiles` blocks, so tile blockIdx.x exists.
    const int pre = k_tiles < kGStages ? k_tiles : kGStages;
    const int n0 = blockIdx.x % n_tiles * kGN;
    for (int i = 0; i < pre; ++i) {
      mbar_arrive_expect_tx(&full[i], kGStage);
      tma_2d(ring + i * kGStage + kATile, &p.b, &full[i], i * kGK, n0);
    }
    griddep_wait();
    const int m0 = blockIdx.x / n_tiles * kGM;
    for (int i = 0; i < pre; ++i) tma_2d(ring + i * kGStage, &p.a, &full[i], i * kGK, m0);
    int it = pre;  // K-tiles issued, over all of this block's tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kGM, n0 = tile % n_tiles * kGN;
      for (int i = tile == blockIdx.x ? pre : 0; i < k_tiles; ++i, ++it) {
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

  // Consumer warpgroup wg: with kSplit rows 64 wg .. + 64 of every tile of
  // the block, one m64 product (kHalves = 1, h0 = wg); else the block's
  // tiles j = wg, wg + 2, ..., all 128 rows, as two m64 products (h = 0, 1:
  // rows 64 h ..). s_x comes from the kernel before, and `out` may be memory
  // that kernel still reads.
  constexpr int kHalves = kSplit ? 1 : 2;
  const int h0 = kSplit ? wg : 0;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kGConsumerRegs));
  griddep_wait();
  if (!kSplit && wg == 1) turn_pass(1);  // warpgroup 0 has the first turn
  const int g = lane >> 2, q = lane & 3, tid = threadIdx.x % 128;
  float* scales = reinterpret_cast<float*>(smem + GSmem::kScales) + wg * 2 * kGN;  // s_w, b
  unsigned char* staged = smem + GSmem::kStaging + (wg * 4 + warp) * kWarpStage;
  const bool has_bias = p.bias != nullptr;
  for (int j = kSplit ? 0 : wg;; j += kSplit ? 1 : kGConsumers) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= tiles) break;
    const int m0 = tile / n_tiles * kGM, n0 = tile % n_tiles * kGN;
    const int row0 = m0 + 64 * h0 + warp * 16;  // the warp's rows: row0 + 64 h + g + 8 r
    // The tile's column scales and bias (three a thread) and the thread's
    // row scales, loaded into registers under the products: nothing waits
    // for them before the epilogue.
    float col_vals[2 * kGN / 128], sx[kHalves][2];
#pragma unroll
    for (int v = 0; v < 2 * kGN / 128; ++v) {
      const int c = tid + 128 * v, col = n0 + c % kGN;
      const float* src = c < kGN ? p.sw : p.bias;
      col_vals[v] = col < p.N && src != nullptr ? src[col] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 64 * h + g + 8 * r;
        sx[h][r] = row < p.M ? p.sx[row] : 0.f;
      }
    }

    int acc[kHalves][24][4];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int n = 0; n < 24; ++n) acc[h][n][0] = acc[h][n][1] = acc[h][n][2] = acc[h][n][3] = 0;
    }
    int it = j * k_tiles;  // the ring position of the tile's first K-tile
    if (!kSplit) turn_wait(wg);
    for (int i = 0; i < k_tiles; ++i, ++it) {
      const int stage = it % kGStages;
      mbar_wait(&full[stage], (it / kGStages) & 1);
      const unsigned char* st = ring + stage * kGStage;
      uint64_t a[kHalves];  // the A rows of product h: 64 (h0 + h) ..
#pragma unroll
      for (int h = 0; h < kHalves; ++h) a[h] = sw_desc<false>(st + 64 * (h0 + h) * kGK);
      const uint64_t b = sw_desc<false>(st + kATile);
#pragma unroll
      for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGK / 32; ++kk) {
#pragma unroll
        for (int h = 0; h < kHalves; ++h) wgmma_ss192_s8(acc[h], a[h] + 2 * kk, b + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products of the K-tile before are done: release its stage
#pragma unroll
      for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kGStages]);
      }
    }
    if (!kSplit) turn_pass(wg);  // every product of the tile issued: the other warpgroup's turn
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kGStages]);

    // The scales into this warpgroup's copy, once its last epilogue has read
    // them; then each warp dequantizes its rows into its staging, 16 rows a
    // pass (bf16; f32 8), the scales two columns at a time and four column
    // groups a batch, and lane 0 stores the pass by TMA.
    consumers_sync(wg);
#pragma unroll
    for (int v = 0; v < 2 * kGN / 128; ++v) scales[tid + 128 * v] = col_vals[v];
    consumers_sync(wg);
    const float2* s_w = reinterpret_cast<const float2*>(scales) + q;  // columns 8 n + 2 q, + 1
    const float2* s_b = reinterpret_cast<const float2*>(scales + kGN) + q;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      if (!p.out_f32) {
        staging_free(lane);
#pragma unroll
        for (int n4 = 0; n4 < 24; n4 += 4) {
          float2 w[4], b[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            w[u] = s_w[4 * (n4 + u)];
            b[u] = s_b[4 * (n4 + u)];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int n = n4 + u;  // box n / 8, chunk n % 8 of rows g and g + 8
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              *reinterpret_cast<__nv_bfloat162*>(staged + n / 8 * kOutBox + (g + 8 * r) * 128 +
                                                 ((n % 8) ^ g) * 16 + 4 * q) =
                  __floats2bfloat162_rn(
                      dequant(acc[h][n][2 * r], sx[h][r], w[u].x, b[u].x, has_bias),
                      dequant(acc[h][n][2 * r + 1], sx[h][r], w[u].y, b[u].y, has_bias));
            }
          }
        }
        store_pass<3, kOutBox>(p, staged, n0, 64, row0 + 64 * h, lane);
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows g, then g + 8
          staging_free(lane);
#pragma unroll
          for (int n4 = 0; n4 < 24; n4 += 4) {
            float2 w[4], b[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              w[u] = s_w[4 * (n4 + u)];
              b[u] = s_b[4 * (n4 + u)];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int n = n4 + u;  // box n / 4 (8 rows x 32), chunk 2 (n % 4) + q / 2 of row g
              *reinterpret_cast<float2*>(staged + n / 4 * (kOutBox / 2) + g * 128 +
                                         ((2 * (n % 4) + q / 2) ^ g) * 16 + 8 * (q % 2)) =
                  make_float2(dequant(acc[h][n][2 * r], sx[h][r], w[u].x, b[u].x, has_bias),
                              dequant(acc[h][n][2 * r + 1], sx[h][r], w[u].y, b[u].y, has_bias));
            }
          }
          store_pass<6, kOutBox / 2>(p, staged, n0, 32, row0 + 64 * h + 8 * r, lane);
        }
      }
    }
  }
  staging_free(lane);
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

// A tensor map over out (M, N) row-major, bf16 or f32: boxes of 128 bytes
// by 16 rows (bf16) or 8 (f32), 128-byte swizzle; TMA stores nothing past
// the ends. -> 0 or the CUresult of the encoding.
int make_out_map(CUtensorMap* map, void* base, int M, int N, int out_f32) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t esize = out_f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize), out_f32 ? 8u : 16u};
  const cuuint32_t unit[2] = {1, 1};
  return static_cast<int>(encode(
      map, out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The current device's SM count, queried once a device, with the kernels'
// shared-memory size set for it.
cudaError_t device_sms(int* sms) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < kDevices && known[device] > 0) {
    *sms = known[device];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(int8_gemm_sm90_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, GSmem::kAlloc);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(int8_gemm_sm90_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, GSmem::kAlloc);
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (device < kDevices) known[device] = *sms;
  return cudaSuccess;
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
// pointer on the device of `stream`. Launched with programmatic dependent
// launch: the kernel waits for the kernels before it (griddepcontrol.wait)
// before it reads x_q or s_x or writes out. Returns the launch's error, or
// minus the CUresult of a tensor map that cannot be encoded.
extern "C" int int8_gemm_sm90(const void* xq, const void* wq, const float* sx, const float* sw,
                              const float* bias, void* out, int M, int N, int K, int out_f32,
                              void* stream) {
  GemmParams p{};
  int err = make_int8_map(&p.a, xq, M, K, kGM);
  if (!err) err = make_int8_map(&p.b, wq, N, K, kGN);
  if (!err) err = make_out_map(&p.c, out, M, N, out_f32);
  if (err) return -err;
  p.sx = sx;
  p.sw = sw;
  p.bias = bias;
  p.M = M;
  p.N = N;
  p.K = K;
  p.out_f32 = out_f32;
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = static_cast<int64_t>((M + kGM - 1) / kGM) * ((N + kGN - 1) / kGN);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles < sms ? tiles : sms));  // one block an SM at most
  config.blockDim = dim3(kGThreads);
  config.dynamicSmemBytes = GSmem::kAlloc;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  // No block has a second tile: both warpgroups on each tile (kSplit).
  const cudaError_t launched = tiles <= sms
                                   ? cudaLaunchKernelEx(&config, int8_gemm_sm90_kernel<true>, p)
                                   : cudaLaunchKernelEx(&config, int8_gemm_sm90_kernel<false>, p);
  return static_cast<int>(launched != cudaSuccess ? launched : cudaGetLastError());
}
