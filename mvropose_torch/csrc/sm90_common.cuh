// Hopper (sm_90a) building blocks shared by the kernels that run on wgmma
// and TMA: csrc/flash_attention.cu (the flash forward, dK/dV and dQ at every
// head width, bf16 and f16), csrc/flash_attention_tf32.cu (the f32 flash
// forward, dK/dV and dQ on split-TF32 products), csrc/int8_attention.cu
// (int8-probability attention at every head width) and csrc/int8_gemm.cu (the
// int8 GEMM).
//
//   * mbarriers (init, arrive, arrive with an expected byte count, wait on a
//     phase parity) for the rings that one producer warp fills with TMA, and
//     the flash kernels' ring of full/empty barriers (`Ring`), their block
//     (two consumer warpgroups of 64 rows and a producer warpgroup) and its
//     registers' split (setmaxnreg);
//   * `Elem<E>`, what differs between the two 2-byte element types that
//     wgmma multiplies into f32, bf16 (the default) and f16: the tensor
//     map's data type and the packing of two f32 into an A-fragment register;
//   * TMA tiles of a (B, T, H, d) bf16 or f16 operand read through its strides
//     (`make_map`, `tma_box`, `tma_rows`): 64-row boxes of one swizzle atom's
//     columns (64, 32 or 16: 128-, 64- or 32-byte swizzle), a tile stored as
//     its column chunks one after another, the layout wgmma's descriptors
//     (`sw_desc`) name; at d = 64 one chunk, 64 x 64 boxes, 128-byte swizzle;
//     and one box of any 2-D map (`tma_2d`); the f32 int8 attention's map
//     over f32 q the same way (`Elem<float>`);
//   * programmatic dependent launch (`griddep_wait`,
//     `griddep_launch_dependents`: the int8 GEMM, the int8 attention and
//     its values' quantization);
//   * the wgmma wrappers, bf16 or f16 operands into f32: S = A B^T of two
//     K-major shared tiles (m64nNk16, N = 64 or 128), D += A B with A in
//     registers and B MN-major in shared memory (N = 32 .. 128), fences and
//     waits; and TF32 operands into f32 (m64nNk8), whose shared operands
//     are K-major only (32-bit types have no transpose bit), with the split
//     of an f32 into two exact TF32 parts (`tf32_big`, `tf32_small`) and the
//     2-D f32 tensor maps (`make_map_2d`) of the split-TF32 kernels
//     (flash_attention_tf32.cu, the f32 int8 attention);
//   * the two consumer warpgroups' turns (`turn_wait`, `turn_pass`);
//   * the flash forwards' online softmax on a tile of logits (`softmax_tile`,
//     ex2.approx on the SFU).
// Everything sits in an anonymous namespace: each source that includes this
// header gets its own copy, and the C entry points stay the only exports.

#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder via the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// The two 2-byte element types of the wgmma products: the tensor map's data
// type, and two f32 rounded to the type and packed into one 32-bit register
// (lo in the low half), the layout of an A fragment's pair and of a store.
template <typename E>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
// f32 operands are read by TMA only (the f32 int8 attention splits q in
// shared memory).
template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <typename E>
constexpr bool kIsHalf = std::is_same_v<E, __half>;

// The plain branch's masked logit: bf16's lowest finite value, exact in f32.
constexpr float kMasked = -3.3895313892515355e38f;

struct Strides {  // element strides of a (B, T, H, d) operand whose d is unit-stride
  int64_t b, t, h;
};

constexpr int kHD = 64;     // the default head width: one 128-byte row, one swizzle atom
constexpr int kHRows = 64;  // rows of a TMA box and of a consumer warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Brings a tensor map (a kernel parameter) into the TMA unit's cache.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a (B, T, H, d) operand: columns [col, col + the map's box
// width) of rows [row, row + 64) of head h of batch element b, into shared
// memory (swizzled as the map says); rows past T are zero-filled and still
// counted in the barrier's bytes.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                        int h, int b, int heads_inner, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(heads_inner ? h : row),
      "r"(heads_inner ? row : h), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 2-D map (dims (x, y), x contiguous): elements [x, x + the
// map's box width) of rows [y, y + its box height), swizzled as the map says;
// what lies past the map's ends is zero-filled and still counted in the
// barrier's bytes. The int8 GEMM's operands and the split-TF32 forward's.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                       int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// `rows` rows (whole boxes) of a D-wide operand from row `row` on, as a
// tile of D / C column chunks of `rows` x C each (chunk c at dst + c rows C).
template <int D = kHD, int C = kHD, typename E>
__device__ __forceinline__ void tma_rows(E* dst, const CUtensorMap* map, uint64_t* bar, int rows,
                                         int row, int h, int b, int heads_inner) {
#pragma unroll
  for (int c = 0; c < D / C; ++c) {
    for (int r = 0; r < rows; r += kHRows) {
      tma_box(dst + (c * rows + r) * C, map, bar, row + r, h, b, heads_inner, c * C);
    }
  }
}

// wgmma matrix descriptor of a tile stored as column chunks of C bf16, each
// one swizzle atom wide (2C bytes: C = 64, 32, 16 for the 128-, 64-, 32-byte
// swizzle; the default, a 128-byte row, also names an int8 tile of 128
// columns), rows 2C bytes apart, 8-row groups 16C bytes apart (the stride
// offset). At C = 64 an MN-major read at N = 64 never reaches a second atom. K-major: the leading offset is unused (1), and a k-step of 16
// columns never leaves its chunk. MN-major: the leading offset is the
// stride from one atom along MN to the next, `chunk` bytes, the distance
// between two column chunks.
template <bool MnMajor, int C = kHD>
__device__ __forceinline__ uint64_t sw_desc(const void* tile, int chunk = 1024) {
  static_assert(C == 64 || C == 32 || C == 16, "a chunk is one swizzle atom: 128, 64 or 32 bytes");
  constexpr uint64_t mode = C == 64 ? 1 : C == 32 ? 2 : 3;
  const uint64_t lbo = MnMajor ? static_cast<uint64_t>(chunk) >> 4 : 1, sbo = 16 * C >> 4;
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | lbo << 16 | sbo << 32 |
         mode << 62;
}

// Programmatic dependent launch (PTX ISA 7.8): wait until the kernels this
// one was launched behind have finished and their writes are visible (a
// no-op without it), and let the next kernel, if launched so, be scheduled
// now: it takes the SMs this grid leaves and waits in griddep_wait.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N][4]) {  // s32 accumulators
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

// Keeps the A registers of a product in registers, unmoved, until here.
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The accumulator of m64nN: per warp 16 rows; d[i][e] is row g + 8 (e >> 1)
// of the warp's 16, column 8 i + 2 t + (e & 1), as N / 8 m16n8 tiles.
#define WGMMA_T(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WGMMA_D32 WGMMA_T(0), WGMMA_T(1), WGMMA_T(2), WGMMA_T(3)
#define WGMMA_D48 WGMMA_D32, WGMMA_T(4), WGMMA_T(5)
#define WGMMA_D64 WGMMA_D48, WGMMA_T(6), WGMMA_T(7)
#define WGMMA_D96 WGMMA_D64, WGMMA_T(8), WGMMA_T(9), WGMMA_T(10), WGMMA_T(11)
#define WGMMA_D128 WGMMA_D96, WGMMA_T(12), WGMMA_T(13), WGMMA_T(14), WGMMA_T(15)
#define WGMMA_D32_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA_D48_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23}"
#define WGMMA_D64_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_D96_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
#define WGMMA_D128_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (+)= A B, m64nNk16 (N = 64 or 128), E x E -> f32 (E bf16 or f16), A
// and B K-major in shared memory; D = A B where `accumulate` is 0. TY is
// the PTX type of E.
#define WGMMA_SS(TY)                                                                  \
  if constexpr (N == 64) {                                                            \
    asm volatile(                                                                     \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                  \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WGMMA_D64_REGS    \
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                              \
        : WGMMA_D64                                                                   \
        : "l"(a), "l"(b), "r"(accumulate));                                           \
  } else {                                                                            \
    asm volatile(                                                                     \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                  \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WGMMA_D128_REGS  \
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                              \
        : WGMMA_D128                                                                  \
        : "l"(a), "l"(b), "r"(accumulate));                                           \
  }
template <int N, typename E = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "S tiles of 64 or 128 columns");
  if constexpr (kIsHalf<E>) {
    WGMMA_SS("f16")
  } else {
    WGMMA_SS("bf16")
  }
}
#undef WGMMA_SS

// D += A B, m64nNk16 (N = 32, 48, 64, 96, 128), E x E -> f32, A (16 x 16
// per warp, the m16n8k16 A fragment) in registers, B MN-major in shared
// memory (the transpose bit). WGMMA_RS(TY, N, A0..A3, B): the product at
// N, whose A registers are operands %A0..%A3 after the N / 2 accumulators
// and whose B descriptor is %B.
#define WGMMA_RS(TY, N_, A0, A1, A2, A3, B_)                                          \
  asm volatile("wgmma.mma_async.sync.aligned.m64n" #N_ "k16.f32." TY "." TY " "       \
               WGMMA_D##N_##_REGS ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B_  \
               ", 1, 1, 1, 1;\n"                                                      \
               : WGMMA_D##N_                                                          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
#define WGMMA_RS_ALL(TY)                                     \
  if constexpr (N == 32) {                                   \
    WGMMA_RS(TY, 32, 16, 17, 18, 19, 20);                    \
  } else if constexpr (N == 48) {                            \
    WGMMA_RS(TY, 48, 24, 25, 26, 27, 28);                    \
  } else if constexpr (N == 64) {                            \
    WGMMA_RS(TY, 64, 32, 33, 34, 35, 36);                    \
  } else if constexpr (N == 96) {                            \
    WGMMA_RS(TY, 96, 48, 49, 50, 51, 52);                    \
  } else if constexpr (N == 128) {                           \
    WGMMA_RS(TY, 128, 64, 65, 66, 67, 68);                   \
  }
template <int N, typename E = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 32 || N == 48 || N == 64 || N == 96 || N == 128, "a head width");
  if constexpr (kIsHalf<E>) {
    WGMMA_RS_ALL("f16")
  } else {
    WGMMA_RS_ALL("bf16")
  }
}
#undef WGMMA_RS_ALL
#undef WGMMA_RS

// S = A B^T over a head width D: A 64 rows, B N rows, both K-major tiles of
// D / C column chunks (chunk c AChunk bytes after chunk 0 in A, BChunk in
// B): D / 16 k-steps of 16 columns (32 bytes), step kk in chunk 16 kk / C.
template <int N = 128, int D = kHD, int C = kHD, int AChunk = 0, int BChunk = 0, typename E = bf16>
__device__ __forceinline__ void product_kmajor(float (&d)[N / 8][4], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / C, in_chunk = kk * 16 % C * 2;
    wgmma_ss<N, E>(d, a + ((c * AChunk + in_chunk) >> 4), b + ((c * BChunk + in_chunk) >> 4), kk > 0);
  }
}

// TF32 x TF32 -> f32, m64nNk8: each operand a 32-bit register holding an
// f32 whose low 13 mantissa bits are clear (the callers clear them). SS: D
// (+)= A B^T, A (64 x 8) and B (N x 8, N = 16, 32, 48 or 64) K-major in shared
// memory. RS: D (+)= A B^T (N = 16 .. 128) with A in registers, per warp 16
// x 8: a[0] row g column t, a[1] row g + 8 column t, a[2] row g column t +
// 4, a[3] row g + 8 column t + 4 (g = lane / 4, t = lane % 4; the PTX ISA's
// .tf32 A fragment). Both: D = A B^T where `accumulate` is 0.
#define WGMMA_D16 WGMMA_T(0), WGMMA_T(1)
#define WGMMA_D16_REGS "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WGMMA_TF32_SS(N_, A_, B_, P_)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P_ ", 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n" #N_ "k8.f32.tf32.tf32 "             \
               WGMMA_D##N_##_REGS ", %" #A_ ", %" #B_ ", p, 1, 1;\n}\n"               \
               : WGMMA_D##N_                                                          \
               : "l"(a), "l"(b), "r"(accumulate))
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                                              int accumulate) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 128,
                "S tiles of 16 to 64 or of 128 columns");
  if constexpr (N == 16) {
    WGMMA_TF32_SS(16, 8, 9, 10);
  } else if constexpr (N == 32) {
    WGMMA_TF32_SS(32, 16, 17, 18);
  } else if constexpr (N == 48) {
    WGMMA_TF32_SS(48, 24, 25, 26);
  } else if constexpr (N == 64) {
    WGMMA_TF32_SS(64, 32, 33, 34);
  } else {
    WGMMA_TF32_SS(128, 64, 65, 66);
  }
}
#undef WGMMA_TF32_SS

#define WGMMA_TF32_RS(N_, A0, A1, A2, A3, B_, P_)                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P_ ", 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n" #N_ "k8.f32.tf32.tf32 "             \
               WGMMA_D##N_##_REGS ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B_  \
               ", p, 1, 1;\n}\n"                                                      \
               : WGMMA_D##N_                                                          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate = 1) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128,
                "a head width or S tile");
  if constexpr (N == 16) {
    WGMMA_TF32_RS(16, 8, 9, 10, 11, 12, 13);
  } else if constexpr (N == 32) {
    WGMMA_TF32_RS(32, 16, 17, 18, 19, 20, 21);
  } else if constexpr (N == 48) {
    WGMMA_TF32_RS(48, 24, 25, 26, 27, 28, 29);
  } else if constexpr (N == 64) {
    WGMMA_TF32_RS(64, 32, 33, 34, 35, 36, 37);
  } else if constexpr (N == 96) {
    WGMMA_TF32_RS(96, 48, 49, 50, 51, 52, 53);
  } else {
    WGMMA_TF32_RS(128, 64, 65, 66, 67, 68, 69);
  }
}
#undef WGMMA_TF32_RS

// x with its low 13 mantissa bits cleared: an exact TF32 value.
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// The rest of x, itself cleared to TF32: x - tf32_big(x) is exact in f32.
__device__ __forceinline__ float tf32_small(float x) { return tf32_big(x - tf32_big(x)); }

// The consumer warpgroups take turns to issue their products (ping-pong):
// named barrier 1 + w is warpgroup w's turn, passed by the other one after
// it has issued its own, so one warpgroup's softmax runs beside the other's
// products instead of both waiting on the tensor cores at once.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// The flash kernels' block: two consumer warpgroups of 64 rows each (128
// rows of the block's own operand, queries in the forwards) and a producer
// warpgroup, of which one warp issues the loads and the other three only
// hand their registers over (setmaxnreg).
constexpr int kHConsumers = 2;                 // consumer warpgroups
constexpr int kHBlock = kHConsumers * kHRows;  // rows of the block's own operands
constexpr int kHThreads = 128 * (kHConsumers + 1);
constexpr int kHConsumerRegs = 232, kHProducerRegs = 40;
constexpr int kMaxSmem = 232448;  // shared memory a block can have

// 2^x on the SFU (flushes results below 2^-126 to 0; P is scaled by 1/l later).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The mbarriers: full[s] completes when stage s holds its tiles and row
// data (the producer warp's 32 lanes arrive, lane 0 with the bytes); empty[s]
// when the `Warps` consumer warps (8: two warpgroups) are done with it; own
// when the block's own operands have landed.
template <typename L, int Warps = 4 * kHConsumers>  // L: a tile plan with kBars and kStages
struct Ring {
  uint64_t *full, *empty, *own;
  __device__ explicit Ring(unsigned char* base) {
    full = reinterpret_cast<uint64_t*>(base + L::kBars);
    empty = full + L::kStages;
    own = empty + L::kStages;
  }
  __device__ void init() const {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], Warps);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// One online-softmax step on a 64 x S tile of raw S = Q K^T, in place: the
// row max m (base 2) moves to the tile's, `corr` = exp2(m_old - m_new) is
// the factor for l and O, and s becomes P = exp2(S scale_log2 - m_new), 0
// past T and exp2(kMasked - m_new) at masked keys (1 while a row has no
// attended key, else 0); l (the thread's part) becomes l corr + rowsum(P).
// Coded: the tile holds a masked or past-T key, whose code (0 attended, 1
// masked, 2 past T) is read; else every key is attended and the max is taken
// on raw S (scaling by scale_log2 > 0 keeps the order, so the max is the
// same value).
template <bool Coded, int S>
__device__ __forceinline__ void softmax_tile(float (&s)[S / 8][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const uint8_t* code, int t,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    // Codes of keys 8 n + 2 t (low byte) and 8 n + 2 t + 1.
    const uint32_t kc = Coded ? *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (Coded) {  // S scaled, masked and skipped in place
        const uint32_t c = (kc >> (8 * (e & 1))) & 0xff;
        s[n][e] = c == 0 ? s[n][e] * scale_log2 : (c == 1 ? kMasked : -INFINITY);
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = Coded ? mx[r] : mx[r] * scale_log2;
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fmaxf(m[r], x);  // finite: tile 0 holds key 0
    corr[r] = exp2_approx(m[r] - x);  // 0 on tile 0 (m = -inf)
    m[r] = x;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mr = m[e >> 1];
      s[n][e] = exp2_approx(Coded ? s[n][e] - mr : fmaf(s[n][e], scale_log2, -mr));
      sum[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], sum[r]);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// CUDA's cuTensorMapEncodeTiled, reached through the runtime (no link against
// libcuda); null if the installed CUDA has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A tensor map over a (B, T, H, d) operand of E (bf16, f16 or f32) through
// its element strides: dims (d, T, H, B), or (d, H, T, B) when
// `heads_inner`; boxes of 64 rows x `cols` (one 128-, 64- or 32-byte
// swizzle atom: 64, 32 or 16 2-byte columns, 32 or 16 f32), rows past T
// zero-filled. -> 0 or the CUresult of the encoding.
template <typename E = bf16>
int make_map(CUtensorMap* map, const void* base, Strides s, int B, int H, int T, bool heads_inner,
             int d = kHD, int cols = kHD) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  constexpr cuuint64_t kBytes = sizeof(E);
  const CUtensorMapSwizzle swizzle = cols * kBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols * kBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t t = static_cast<cuuint64_t>(T), hh = static_cast<cuuint64_t>(H);
  const cuuint64_t st = static_cast<cuuint64_t>(s.t) * kBytes;
  const cuuint64_t sh = static_cast<cuuint64_t>(s.h) * kBytes;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), heads_inner ? hh : t,
                              heads_inner ? t : hh, static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {heads_inner ? sh : st, heads_inner ? st : sh,
                                 static_cast<cuuint64_t>(s.b) * kBytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), heads_inner ? 1u : kHRows,
                             heads_inner ? kHRows : 1u, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(map, Elem<E>::kMap, 4, const_cast<void*>(base),
                                 dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// A 2-D tensor map over f32 rows of `inner` elements (dims (inner, rows)),
// boxes of box_inner x box_rows with the 128-byte swizzle (box_inner = 32,
// one atom) or the 64-byte one (16). -> 0 or the CUresult of the encoding.
int make_map_2d(CUtensorMap* map, const float* base, int64_t inner, int64_t rows, int box_inner,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_inner * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                                 dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace
