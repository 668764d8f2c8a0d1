// int8-probability attention on Hopper (sm_90a): one fused kernel for the
// logits, the row max, the exponent, the int8 probabilities and their int8
// product with the values (int8_attention_sm90_kernel), and a small kernel
// that quantizes the values first (int8_quantize_v_kernel).
//
// Replaces mvropose_tpu/ops/attention.py:29 int8_prob_attention. That
// function is not Pallas: it is XLA einsums and elementwise ops written for
// the TPU's int8 matrix unit. Per batch element b, head h and query row q,
// at head width d = 64 (scale 1/8, a power of two), in the reference's
// rounding points (mvropose_torch/ops/int8_attention.py has them in plain
// torch):
//   s_k  = bf16(q . k_k / 8), bf16's lowest finite value at a masked key;
//          keys past T do not exist (no part in m, z or the product)
//   m    = max_k s_k, the true row max: a first pass over all the keys
//   e_k  = bf16(expf(bf16(s_k - m)))  in [0, 1], expf the accurate one that
//          torch's bf16 exp uses on CUDA, so equal logits give equal e
//   z    = sum_k e_k (f32);  pq_k = rint(127 e_k) (int8, half to even)
//   acc  = sum_k pq_k vq_k (int32, exact)
//   out  = bf16((f32(acc) * (1 / (127 z))) * sv), written in (B, T, H, 64)
// with the values quantized per (b, h, channel c) by int8_quantize_v_kernel:
//   sv_c = max(max_k |v_kc|, 1e-6) / 127,  vq_kc = rint(v_kc / sv_c).
// A row whose keys are all masked has m = s_k for every real key: e = 1,
// z = T, and it averages the values over the T real keys.
//
// What bounds it on an H100 at the serve shape (B H = 48, T = 1025): one
// QK^T (6.46 GFLOP, 6.5 us at the bf16 tensor-core rate) and the int8 P@V
// (6.46 G operations, 3.3 us at the int8 rate); ~22 MB of q, k, vq and out
// (6.6 us at 3.35 TB/s); but 50.4 M exponentials, ~13.6 us at 16 a clock
// per SM, and ~16 ALU instructions per logit around them (two bf16
// roundings, the accurate expf, the row sum, the int8 rounding and the byte
// packing). The elementwise work per logit, not the products or the bytes,
// sets the pace. The plain chain it replaces writes and rereads the (B H, T,
// T) logits, exponents and probabilities in device memory: ~2.2 GB a layer.
//
// The design (the flash forward's, csrc/flash_attention.cu, on the helpers
// of csrc/sm90_common.cuh):
//   * a block owns 128 queries, in two consumer warpgroups of 64, Q loaded
//     once by TMA; one producer warp streams tiles of 128 keys through a
//     4-stage ring of full/empty mbarriers: K alone in pass 1, K and a tile
//     of values (64 channels x 128 keys of int8, one 8 KB box) in pass 2.
//     Both passes run through the ring as one sequence of 2 n tiles, so a
//     stage's phase parity carries over from the first pass to the second;
//   * pass 1: S = Q K^T (wgmma m64n128k16 bf16, both operands in shared
//     memory, f32 sums) and the row max. bf16 rounding is monotonic and the
//     scale a power of two, so m = bf16(max S / 8) equals the max of the
//     rounded logits, taken on raw S. A one-pass online softmax would
//     quantize against a running max: other int8 probabilities, another
//     function. Pass 2 recomputes S and does the rest;
//   * bf16(s - m) is one bf16x2 fma of the bf16-rounded S pair, 1/8 and -m
//     (S / 8 is exact in bf16, and one rounding of s - m equals torch's f32
//     difference rounded to bf16); rint(127 e) is one fma with 1.5 * 2^23,
//     whose low byte is the rounded value (half to even);
//   * P@V is wgmma m64n64k32 s8 x s8 -> s32 with the probabilities as the A
//     operand in registers. 8-bit A fragments hold 4 consecutive k of a row
//     per register, which are not the columns a thread holds of the f32 S
//     accumulator. The contraction does not care in which order it meets
//     the keys, so the values carry the accumulator's order instead:
//     int8_quantize_v_kernel writes them transposed and K-major, (B H, 64,
//     Tp) zero past T, with each group of 16 keys permuted (`key_position`)
//     so that a thread's own probabilities, packed in place, are its A
//     fragment. No byte moves between threads or through shared memory:
//     `tile_probs` leaves each probability in the low byte of an f32 in
//     place, and `pack_probs` gathers four into a register (three byte
//     permutes) once the previous tile's P V has finished with the registers;
//   * the two consumer warpgroups take turns to issue their products, and
//     each issues S of tile j with P V of tile j - 1, so the elementwise
//     work of one tile runs under the products of the other warpgroup and
//     of its own previous tile;
//   * masks without per-element branches: the producer writes a code per key
//     (attended, masked, past T) and a flag per tile; a tile of attended keys
//     only (all but the last at T = 1025 without a mask, whose last tile
//     holds 1 key of 128) takes the path that reads no code;
//   * the tail of T = 1025 = 8 x 128 + 1: the last key tile's probabilities
//     skip its column tiles past T; a warp with no query below T skips its
//     elementwise work; and blocks run in order
//     of their query tile, so the nearly empty blocks of the last one (a
//     single query) fill the last wave. Without these, T = 1025 costs far
//     more than its 1/1024 more keys: 9 key tiles, not 8, and 432 blocks in
//     4 waves of 132, not 384 in 3.
// q and k are read through their (B, T, H, 64) strides by TMA tensor maps
// built on the host per call (a CUDA graph captures them as parameters).
//
// f32 q, k and v (int8_attention_sm90_kernel<float>, int8_quantize_v_kernel<
// float>): the reference's f32 route, the logits, exponents and
// probabilities in f32. What the f32 instantiation changes, on the same plan
// (two passes, the ring, the turns, the codes, P V and the dequant):
//   * S on split-TF32 wgmma (csrc/flash_attention_tf32.cu's three-product
//     form): a pre-pass (int8_split_qk_kernel, launched by the same entry
//     point) writes q / 8 (the reference's q * sm_scale in q's dtype, exact
//     at d = 64) and k as their big and small TF32 parts in row order, (B H,
//     Tp, 64) each, into a scratch buffer the wrapper allocates; S = Q_big
//     K_small + Q_small K_big, then Q_big K_big (the small terms first: the
//     tensor cores round each partial sum toward zero, so only the big
//     term's k-steps round at the sum's full magnitude), m64n128k8, both
//     operands K-major in shared memory (TF32 reads K-major only; Q and K
//     are both K-major in Q K^T). Q big and small (64 KB) and a stage's K big
//     and small (64 KB) and values (8 KB) leave room for 2 stages;
//   * the masked logit is f32's lowest finite value, and pass 2 follows the
//     reference's f32 rounding points: e = expf(s - m) (the accurate expf
//     that torch's f32 exp uses on CUDA), z += e, pq = rint(fl(127 e)):
//     __fmul_rn(e, 127) and then the rounding to an integer by adding 1.5 *
//     2^23 (__fadd_rn). The bf16 kernel's single fma(e, 127, 1.5 * 2^23) is
//     exact there only because a bf16 e times 127 is exact in f32; an f32 e
//     rounds twice in the reference (e = 0.7440945: fl(127 e) = 94.5 -> 94,
//     where one rounding gives 95);
//   * the output in f32. The values' kernel reads 8 f32 channels a key as
//     two 16-byte words.
// Bound at the serve shape (4, 1025, 12, 64): three TF32 S products in each
// of two passes, 78.2 us at 495 TFLOP/s, and P V in int8, 3.3 us; the pre-
// pass's 75.6 MB of reads and writes, 22.6 us at 3.35 TB/s; the 50.4 M
// exponentials 12.1 us beside the products.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_quantize.cuh"  // Divisor, quantized_byte, pack4
#include "sm90_common.cuh"  // mbarriers, TMA maps and boxes, the wgmma wrappers, turns

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups of kHRows queries
constexpr int kBlockQ = kConsumers * kHRows;      // queries of a block: 128
constexpr int kKeys = 128;                        // keys of a streamed tile
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kVTile = kHD * kKeys;               // bytes of an int8 value tile: 8 KB
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kInnerQ = 1, kInnerK = 2;  // bits of heads_inner
constexpr float kRound = 12582912.0f;    // 1.5 * 2^23: x + kRound rounds x to an integer
constexpr int kF32Cols = 32;             // f32 of a column chunk: one 128-byte swizzle atom
constexpr int kF32Chunk = kKeys * kF32Cols * 4;  // bytes of a chunk of 128 rows: 16 KB
static_assert(kBlockQ == kKeys, "Q and a K tile share the f32 chunk size");
constexpr int kSplitRows = 16;  // rows of a pre-pass block: 16 float4 a row

// What differs between the two element types: the masked logit (the plain
// branch's finfo(dtype).min), a logit from raw S (the bf16 kernel scales S
// by 1/8; the f32 one reads q / 8 from its pre-pass), and the shared memory
// of Q and of a K tile (f32: big and small parts, in column chunks of 32).
template <typename E>
struct Int8Plan;
template <>
struct Int8Plan<bf16> {
  static constexpr float kMaskedLogit = kMasked;
  static __device__ __forceinline__ float logit(float s) { return s * 0.125f; }
  static constexpr int kQBytes = kBlockQ * kHD * 2;  // 16 KB
  static constexpr int kKTile = kKeys * kHD * 2;     // 16 KB
  static constexpr int kStages = 4;
};
template <>
struct Int8Plan<float> {
  static constexpr float kMaskedLogit = -FLT_MAX;
  static __device__ __forceinline__ float logit(float s) { return s; }
  static constexpr int kQBytes = 2 * kBlockQ * kHD * 4;  // Q_big, Q_small: 64 KB
  static constexpr int kKTile = 2 * kKeys * kHD * 4;     // K_big, K_small: 64 KB
  static constexpr int kStages = 2;
};

template <typename E>
struct Smem {
  using P = Int8Plan<E>;
  static constexpr int kStages = P::kStages;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + P::kQBytes;
  static constexpr int kStage = P::kKTile + kVTile;        // a stage: K (both parts), values
  static constexpr int kCodes = kRing + kStages * kStage;  // a code per key and stage
  static constexpr int kFlags = kCodes + kStages * kKeys;  // a flag per stage
  static constexpr int kBars = (kFlags + kStages + 7) / 8 * 8;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024 bytes
  static_assert(kAlloc <= kMaxSmem, "more shared memory than a block can have");
};

struct Int8Params {
  // bf16: q, k (B, T, H, 64) through their strides (make_map). f32: q, k
  // the big parts and qs, ks the small parts of the pre-pass, (B H Tp) rows
  // of 64 f32 (make_map_2d), boxes of 32 f32 x 128 rows.
  CUtensorMap q, k, qs, ks;
  CUtensorMap vt;    // (B H, 64, Tp) int8 values, boxes of 128 keys x 64 channels
  int heads_inner;   // bits kInnerQ, kInnerK: the map's dims are (d, H, T, B)
  const uint8_t* mask;  // (B, T), 0 = key not attended; null: every key attended
  const float* sv;      // (B H, 64) the values' scales
  void* out;            // (B, T, H, 64) contiguous, in the operands' type
  int B, H, T, Tp;
};

// `key_position`, where key j (of a tile) sits among the K-major bytes of
// its 16-key group: keys 8 i + 2 t + c (i = 0, 1; c = 0, 1) go to bytes
// 4 t + 2 i + c, the A-fragment bytes of the thread that holds the S
// accumulator columns 8 i + 2 t + c (see the source note), that is byte
// (j & ~15) | (4 ((j & 7) >> 1) + 2 ((j >> 3) & 1) + (j & 1));
// ops/int8_attention.py::key_positions gives its inverse, the key at each byte.

// One 128-key x 64-channel box of the values, keys [key, key + 128) of row bh.
__device__ __forceinline__ void tma_values(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int key, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(key), "r"(0), "r"(bh), "r"(smem_u32(bar))
      : "memory");
}

#define WGMMA_D64_S32 \
  "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), \
  "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), \
  "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), \
  "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), \
  "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), \
  "+r"(d[7][2]), "+r"(d[7][3])

// D += A B, m64n64k32, s8 x s8 -> s32: A (16 rows x 32 per warp; register r
// holds 4 consecutive k of row g + 8 (r & 1), from k = 4 t + 16 (r >> 1)) in
// registers, B K-major in shared memory (8-bit operands are K-major only).
__device__ __forceinline__ void wgmma_rs64_s8(int (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WGMMA_D64_REGS
      ", {%32, %33, %34, %35}, %36, 1;\n"
      : WGMMA_D64_S32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// O += P V over a 128-key tile: 4 k-steps of 32 keys (32 bytes) along the
// K-major value rows.
__device__ __forceinline__ void product_pv(int (&o)[8][4], const uint32_t (&pa)[kKeys / 32][4],
                                           uint64_t v) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 32; ++kk) wgmma_rs64_s8(o, pa[kk], v + 2 * kk);
}

// A logit of a coded tile in f32: the logit of raw S at an attended key,
// the masked logit at a masked one, -inf past T (code 0, 1, 2).
template <typename E>
__device__ __forceinline__ float coded_logit(float s, uint32_t code) {
  return code == 0 ? Int8Plan<E>::logit(s) : (code == 1 ? Int8Plan<E>::kMaskedLogit : -INFINITY);
}

// Pass 1 on a tile: mx (rows g, g + 8) takes the max of the tile's logits.
template <bool Coded, typename E>
__device__ __forceinline__ void tile_max(const float (&s)[16][4], float (&mx)[2],
                                         const uint8_t* code, int t) {
  float x[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const uint32_t kc = Coded ? *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = Coded ? coded_logit<E>(s[n][e], (kc >> (8 * (e & 1))) & 0xff) : s[n][e];
      x[e >> 1] = fmaxf(x[e >> 1], v);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], Coded ? x[r] : Int8Plan<E>::logit(x[r]));
}

// Pass 2 on a tile, in place: each logit becomes fma(e, 127, kRound) with
// e = bf16(expf(bf16(s - m))), whose low byte is rint(127 e); z += e.
// negm: -m of rows g and g + 8 as bf16 pairs. A coded tile skips its column
// tiles of keys past T (the last tile: `keys` of them exist), which the
// values' zeros cancel in P V and which add nothing to z.
template <bool Coded>
__device__ __forceinline__ void tile_probs(float (&s)[16][4], const __nv_bfloat162 (&negm)[2],
                                           float (&z)[2], const uint8_t* code, int t, int keys) {
  const __nv_bfloat162 scale = __floats2bfloat162_rn(Coded ? 1.f : 0.125f, Coded ? 1.f : 0.125f);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    if (Coded && 8 * n >= keys) break;
    const uint32_t kc = Coded ? *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t) : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a = s[n][2 * r], b = s[n][2 * r + 1];
      if constexpr (Coded) {
        a = coded_logit<bf16>(a, kc & 0xff);
        b = coded_logit<bf16>(b, kc >> 8);
      }
      // bf16(s - m): S rounded to bf16 (exact / 8), then one rounding.
      const __nv_bfloat162 x = __hfma2(__floats2bfloat162_rn(a, b), scale, negm[r]);
      const __nv_bfloat162 e = __floats2bfloat162_rn(expf(__low2float(x)), expf(__high2float(x)));
      const float e0 = __low2float(e), e1 = __high2float(e);
      z[r] += e0;
      z[r] += e1;
      s[n][2 * r] = fmaf(e0, 127.f, kRound);
      s[n][2 * r + 1] = fmaf(e1, 127.f, kRound);
    }
  }
}

// The same in f32, at the reference's f32 rounding points: e = expf(s - m),
// z += e, and fl(127 e) rounded to an integer by adding kRound, each an
// explicit `_rn` operation so that nvcc contracts none of them into an fma.
template <bool Coded>
__device__ __forceinline__ void tile_probs_f32(float (&s)[16][4], const float (&m)[2],
                                               float (&z)[2], const uint8_t* code, int t,
                                               int keys) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    if (Coded && 8 * n >= keys) break;
    const uint32_t kc = Coded ? *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = Coded ? coded_logit<float>(s[n][e], (kc >> (8 * (e & 1))) & 0xff) : s[n][e];
      const float p = expf(__fsub_rn(x, m[e >> 1]));
      z[e >> 1] += p;
      s[n][e] = __fadd_rn(__fmul_rn(p, 127.f), kRound);
    }
  }
}

// The int8 probabilities (low bytes of `tile_probs`' values) as the A
// fragments of P V: register r of 32-key group kk holds row g + 8 (r & 1),
// column tiles 4 kk + 2 (r >> 1) and the next, two bytes each.
__device__ __forceinline__ void pack_probs(const float (&s)[16][4],
                                           uint32_t (&pa)[kKeys / 32][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 32; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = 4 * kk + 2 * (r >> 1), e = 2 * (r & 1);
      const uint32_t lo =
          __byte_perm(__float_as_uint(s[n][e]), __float_as_uint(s[n][e + 1]), 0x0040);
      const uint32_t hi =
          __byte_perm(__float_as_uint(s[n + 1][e]), __float_as_uint(s[n + 1][e + 1]), 0x0040);
      pa[kk][r] = __byte_perm(lo, hi, 0x5410);
    }
  }
}

// S = Q_big K_small + Q_small K_big, then Q_big K_big, over d = 64 (8 k-steps
// of 8 f32, 32 bytes, in chunk kk / 4 of each tile), m64n128k8 TF32: q_big,
// q_small the warpgroup's 64 rows of Q's parts, k_big, k_small a stage's.
__device__ __forceinline__ void product_split(float (&s)[16][4], uint64_t q_big, uint64_t q_small,
                                              uint64_t k_big, uint64_t k_small) {
  auto at = [](int kk) { return static_cast<uint64_t>((kk / 4 * kF32Chunk + kk % 4 * 32) >> 4); };
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    wgmma_tf32_ss<kKeys>(s, q_big + at(kk), k_small + at(kk), kk > 0);
    wgmma_tf32_ss<kKeys>(s, q_small + at(kk), k_big + at(kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) wgmma_tf32_ss<kKeys>(s, q_big + at(kk), k_big + at(kk), 1);
}

// 128 rows from `row` on of one part (big or small) of a pre-pass operand,
// as its two column chunks of 32 f32.
__device__ __forceinline__ void tma_f32_rows(unsigned char* dst, const CUtensorMap* map,
                                             uint64_t* bar, int row) {
#pragma unroll
  for (int c = 0; c < kHD / kF32Cols; ++c) tma_2d(dst + c * kF32Chunk, map, bar, c * kF32Cols, row);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
    int8_attention_sm90_kernel(const __grid_constant__ Int8Params p) {
  using L = Smem<E>;
  constexpr bool kF32 = std::is_same_v<E, float>;
  constexpr int kStages = L::kStages, kKTile = Int8Plan<E>::kKTile, kHalf = kKTile / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem + L::kQ;      // 128 query rows (f32: big, then small)
  unsigned char* ring = smem + L::kRing;  // [stage][K tile (f32: big, small), V 64 x 128 s8]
  uint8_t* codes = smem + L::kCodes;  // per stage and key: 0 attended, 1 masked, 2 past T
  uint8_t* coded = smem + L::kFlags;  // per stage: whether any key is not attended
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own = empty + kStages;

  // Blocks in order of their query tile, so the last tiles (at T = 1025 a
  // single query each, and so little work) run after all the full ones.
  const int heads = p.B * p.H, qt = blockIdx.x / heads, h = blockIdx.x % p.H;
  const int b = blockIdx.x % heads / p.H, q0 = qt * kBlockQ, T = p.T;
  const int bh = b * p.H + h;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int n_tiles = (T + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                // the producer warp's lanes, lane 0 with the bytes
      mbar_init(&empty[s], 4 * kConsumers);  // the consumer warps
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(own, Int8Plan<E>::kQBytes);
      if constexpr (kF32) {
        tma_f32_rows(sQ, &p.q, own, bh * p.Tp + q0);
        tma_f32_rows(sQ + Int8Plan<E>::kQBytes / 2, &p.qs, own, bh * p.Tp + q0);
      } else {
        tma_rows(reinterpret_cast<bf16*>(sQ), &p.q, own, kBlockQ, q0, h, b,
                 p.heads_inner & kInnerQ);
      }
    }
    const uint8_t* mask = p.mask ? p.mask + static_cast<int64_t>(b) * T : nullptr;
    // Tiles 0 .. n - 1 are pass 1's (K), n .. 2 n - 1 pass 2's (K and V).
    for (int i = 0; i < 2 * n_tiles; ++i) {
      const int stage = i % kStages, second = i >= n_tiles;
      const int k0 = (second ? i - n_tiles : i) * kKeys;
      mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);  // round 0 passes
      bool any = false;
      for (int r = lane; r < kKeys; r += 32) {
        const int key = k0 + r;
        const uint8_t c = key >= T ? 2 : (mask != nullptr && mask[key] == 0 ? 1 : 0);
        codes[stage * kKeys + r] = c;
        any |= c != 0;
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) {
        coded[stage] = any;
        unsigned char* st = ring + stage * L::kStage;
        mbar_arrive_expect_tx(&full[stage], kKTile + (second ? kVTile : 0));
        if constexpr (kF32) {
          tma_f32_rows(st, &p.k, &full[stage], bh * p.Tp + k0);
          tma_f32_rows(st + kHalf, &p.ks, &full[stage], bh * p.Tp + k0);
        } else {
          tma_rows(reinterpret_cast<bf16*>(st), &p.k, &full[stage], kKeys, k0, h, b,
                   p.heads_inner & kInnerK);
        }
        if (second) tma_values(st + kKTile, &p.vt, &full[stage], k0, bh);
      } else {
        mbar_arrive(&full[stage]);
      }
    }
  } else {  // consumer warpgroup wg: queries q0 + 64 wg ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * kHRows + warp * 16;  // the warp's 16 queries
    // A warp with no query below T does no elementwise work. (Its warpgroup
    // issues every product all the same: skipping them made ptxas serialize
    // the products of every block.)
    const bool idle = row0 >= T;
    // The warpgroup's 64 rows of Q: 128-byte rows in every type (64 bf16, or
    // a chunk of 32 f32), so 8 KB into the tile (into each chunk).
    const uint64_t q_desc = sw_desc<false>(sQ + wg * kHRows * 128);
    const uint64_t qs_desc = sw_desc<false>(sQ + Int8Plan<E>::kQBytes / 2 + wg * kHRows * 128);
    auto v_tile = [&](int stage) { return sw_desc<false>(ring + stage * L::kStage + kKTile); };
    mbar_wait(own, 0);
    float s[16][4];
    auto product_s = [&](int stage) {  // S of a stage's K tile into s
      const unsigned char* st = ring + stage * L::kStage;
      if constexpr (kF32) {
        product_split(s, q_desc, qs_desc, sw_desc<false>(st), sw_desc<false>(st + kHalf));
      } else {
        product_kmajor(s, q_desc, sw_desc<false>(st));
      }
    };

    // Pass 1: the row max (the codes are read before the stage is released).
    float mx[2] = {-INFINITY, -INFINITY};
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages;
      mbar_wait(&full[stage], (j / kStages) & 1);
      wgmma_fence();
      product_s(stage);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      if (idle) {
      } else if (coded[stage]) {
        tile_max<true, E>(s, mx, codes + stage * kKeys, t);
      } else {
        tile_max<false, E>(s, mx, nullptr, t);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    float m[2];  // the row max, finite: key 0 exists
    __nv_bfloat162 negm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      m[r] = kF32 ? x : __bfloat162float(__float2bfloat16_rn(x));
      negm[r] = __floats2bfloat162_rn(-m[r], -m[r]);
    }

    // Pass 2: S again, the probabilities, and P V (ring tiles n .. 2 n - 1).
    int o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
    float z[2] = {0.f, 0.f};  // this thread's part of the row sums
    uint32_t pa[kKeys / 32][4];
    auto probs = [&](int stage, int j) {  // tile j's probabilities, packed
      if (idle) return;
      const bool c = coded[stage];
      const uint8_t* code = codes + stage * kKeys;
      if constexpr (kF32) {
        if (c) {
          tile_probs_f32<true>(s, m, z, code, t, T - j * kKeys);
        } else {
          tile_probs_f32<false>(s, m, z, nullptr, t, kKeys);
        }
      } else {
        if (c) {
          tile_probs<true>(s, negm, z, code, t, T - j * kKeys);
        } else {
          tile_probs<false>(s, negm, z, nullptr, t, kKeys);
        }
      }
    };
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    {  // tile 0: S alone
      const int i = n_tiles, stage = i % kStages;
      mbar_wait(&full[stage], (i / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      product_s(stage);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_acc(s);
      probs(stage, 0);
      if (!idle) pack_probs(s, pa);
    }
    // Tile j: S of tile j and P V of tile j - 1 in one turn; the
    // probabilities of tile j while P V runs.
    for (int j = 1; j < n_tiles; ++j) {
      const int i = n_tiles + j, stage = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(&full[stage], (i / kStages) & 1);
      fence_acc(o);
      turn_wait(wg);
      wgmma_fence();
      product_s(stage);
      wgmma_commit();
      product_pv(o, pa, v_tile(prev));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      fence_acc(s);
      probs(stage, j);
      wgmma_wait<0>();
      fence_acc(o);
      fence_a(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      if (!idle) pack_probs(s, pa);
    }
    // P V of the last tile.
    const int last = (2 * n_tiles - 1) % kStages;
    fence_acc(o);
    turn_wait(wg);
    wgmma_fence();
    product_pv(o, pa, v_tile(last));
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[last]);
    if (wg == 0) turn_wait(wg);  // the other warpgroup's last pass

    // out = (f32(acc) * (1 / (127 z))) * sv, rows past T (zero-filled Q) not stored.
    const float* sv = p.sv + static_cast<int64_t>(bh) * kHD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
      const int row = row0 + g + 8 * r;
      if (row >= T) continue;
      const float rz = 1.f / (127.f * z[r]);
      E* dst = static_cast<E*>(p.out) + (static_cast<int64_t>(b) * T + row) * p.H * kHD +
               static_cast<int64_t>(h) * kHD;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n * 8 + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(sv + c);
        const float lo = static_cast<float>(o[n][2 * r]) * rz * sc.x;
        const float hi = static_cast<float>(o[n][2 * r + 1]) * rz * sc.y;
        if constexpr (kF32) {
          *reinterpret_cast<float2*>(dst + c) = make_float2(lo, hi);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(lo, hi);
        }
      }
    }
  }
}

// The f32 kernel's pre-pass: for rows [16 x, 16 x + 16) of head h of batch
// element b, q / 8 (the reference's q * sm_scale in f32, exact at d = 64)
// and k as their TF32 big and small parts, (B H, Tp, 64) each, zero past T.
// A thread one float4 of a row.
__global__ void __launch_bounds__(kSplitRows * kHD / 4)
    int8_split_qk_kernel(const float* __restrict__ q, const float* __restrict__ k, Strides sq,
                         Strides sk, int H, int T, int Tp, float* __restrict__ qb,
                         float* __restrict__ qs, float* __restrict__ kb, float* __restrict__ ks) {
  const int b = blockIdx.z, h = blockIdx.y, row = blockIdx.x * kSplitRows + threadIdx.x / 16;
  const int c = 4 * (threadIdx.x % 16);
  const int64_t at = ((static_cast<int64_t>(b) * H + h) * Tp + row) * kHD + c;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
  if (row < T) {
    x = *reinterpret_cast<const float4*>(q + b * sq.b + row * sq.t + h * sq.h + c);
    y = *reinterpret_cast<const float4*>(k + b * sk.b + row * sk.t + h * sk.h + c);
  }
  x = make_float4(__fmul_rn(x.x, 0.125f), __fmul_rn(x.y, 0.125f), __fmul_rn(x.z, 0.125f),
                  __fmul_rn(x.w, 0.125f));
  auto big = [](float4 v) {
    return make_float4(tf32_big(v.x), tf32_big(v.y), tf32_big(v.z), tf32_big(v.w));
  };
  auto small = [](float4 v) {
    return make_float4(tf32_small(v.x), tf32_small(v.y), tf32_small(v.z), tf32_small(v.w));
  };
  *reinterpret_cast<float4*>(qb + at) = big(x);
  *reinterpret_cast<float4*>(qs + at) = small(x);
  *reinterpret_cast<float4*>(kb + at) = big(y);
  *reinterpret_cast<float4*>(ks + at) = small(y);
}

// ------------------------------------------------------ values, quantized
//
// Its bound is bytes: 6.3 MB read and 3.5 MB written at the serve shape
// (4, 1025, 12, 64), 2.9 us. A block owns 16 channels (32 bytes a key, one
// whole memory sector) of one (b, h) and every key: 192 blocks at the
// serve shape. Its thread owns 8 channels of half of one 16-key group (the
// unit of `key_position`): the 8 keys whose bytes are the group's first 8
// (keys 0-3 and 8-11) or its last 8 (4-7 and 12-15), so 8 16-byte loads in
// flight a thread and, for each channel, one 8-byte store of bytes put in
// `key_position` order in registers (byte permutes): no shared tile, no
// single-byte store. A pair of lanes reads a key's 32 bytes, a warp 16
// half-groups (kVChannels / 8 lanes a key, any of 8, 16 or 32 channels a
// block gives the same bits). The channel's max is a shuffle max, then one through shared
// memory across the block's warps; the division by its scale is
// Markstein's correction steps with the scale's reciprocal
// (csrc/int8_quantize.cuh: the division's bits in five operations a
// value, in place of 96 serial IEEE divisions a thread). A block has 2 Tp /
// 8 threads (288 at T = 1025: one round of all keys, held in registers
// from the max to the quantization), at most 512: a longer T (Tp > 2048)
// takes several rounds and reads them again (from L2) to quantize them.
// (Splitting T across the blocks of a thread-block cluster, whose maxima
// meet in distributed shared memory, gives more blocks but was slower: the
// cluster's barrier cost more than the whole kernel takes without it; 8
// channels a block, 384 blocks at the serve shape, was no faster either:
// PERF.md.) f32 values: the same plan, 8 channels of a key two 16-byte loads
// (12.6 MB read at the serve shape, 4.8 us).

constexpr int kVChannels = 16;                 // channels of a block (8, 16 or 32)
constexpr int kVLanes = kVChannels / 8;        // lanes on one key
constexpr int kVMaxThreads = 512;
constexpr int kVMaxUnits = kVMaxThreads / kVLanes;  // half-groups of a round
constexpr int kVMaxWarps = kVMaxThreads / 32;

template <typename E>
constexpr int kVWords = sizeof(E) / 2;  // 16-byte words of 8 channels of a key: 1 bf16, 2 f32

template <typename E>
__device__ __forceinline__ float channel(const uint4 (&raw)[kVWords<E>], int c) {
  const E x = reinterpret_cast<const E*>(raw)[c];
  if constexpr (std::is_same_v<E, float>) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

template <typename E>
__global__ void __launch_bounds__(kVMaxThreads)
    int8_quantize_v_kernel(const E* __restrict__ v, Strides s, int H, int T, int Tp, int rounds,
                           int8_t* __restrict__ vt, float* __restrict__ sv) {
  constexpr int W = kVWords<E>;
  __shared__ float s_warp[kVMaxWarps][kVChannels];
  __shared__ Divisor s_div[kVChannels];

  const int c16 = blockIdx.y * kVChannels, bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const int o = lane % kVLanes;  // channels c16 + 8 o .. + 7
  const int unit = tid / kVLanes;  // half-group of the round
  const int units = blockDim.x / kVLanes;
  const E* base = v + b * s.b + h * s.h + c16 + 8 * o;
  // The thread's first output byte in round i (bytes 0-7 or 8-15 of group
  // (i units + unit) / 2), and its keys j and 8 + j of the group, j = 4 (unit % 2) .. + 3.
  auto first_byte = [&](int i) { return 8 * (i * units + unit); };
  auto load = [&](int i, uint4 (&raw)[8][W]) {  // keys of round i, zero past T
    const int k0 = first_byte(i) - 4 * (unit % 2);  // the group's first key + 4 (unit % 2)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int key = k0 + (k < 4 ? k : 4 + k);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        raw[k][w] = key < T ? reinterpret_cast<const uint4*>(base + key * s.t)[w]
                            : make_uint4(0, 0, 0, 0);
      }
    }
  };

  float mx[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) mx[c] = 0.f;
  uint4 raw[8][W];
  for (int i = 0; i < rounds; ++i) {
    load(i, raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int c = 0; c < 8; ++c) mx[c] = fmaxf(mx[c], fabsf(channel<E>(raw[k], c)));
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // the 32 / kVLanes lanes of a warp on the same channels
#pragma unroll
    for (int x = kVLanes; x < 32; x *= 2) {
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], x));
    }
    if (lane < kVLanes) s_warp[warp][8 * o + c] = mx[c];
  }
  __syncthreads();
  if (tid < kVChannels) {
    float m = s_warp[0][tid];
    for (int w = 1; w < warps; ++w) m = fmaxf(m, s_warp[w][tid]);
    const Divisor d = divisor_of_max(m);
    s_div[tid] = d;
    sv[static_cast<int64_t>(bh) * kHD + c16 + tid] = d.s;
  }
  __syncthreads();
  Divisor d[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) d[c] = s_div[8 * o + c];
  int8_t* out = vt + (static_cast<int64_t>(bh) * kHD + c16 + 8 * o) * Tp;
  for (int i = 0; i < rounds; ++i) {
    const int byte0 = first_byte(i);
    if (byte0 >= Tp) break;
    if (rounds > 1) load(i, raw);  // else round 0 is still in registers
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = quantized_byte(channel<E>(raw[k], c), d[c]);
      // Byte 4 t + 2 i + c' of a group holds its key 8 i + 2 t + c' (key_position):
      // the thread's keys 2 w, 2 w + 1 (of j) and 8 + 2 w, 9 + 2 w make its word w.
      *reinterpret_cast<uint2*>(out + static_cast<int64_t>(c) * Tp + byte0) =
          make_uint2(pack4(q[0], q[1], q[4], q[5]), pack4(q[2], q[3], q[6], q[7]));
    }
  }
}

// A tensor map over the (B H, 64, Tp) int8 values: dims (Tp, 64, B H),
// boxes of 128 keys x 64 channels, 128-byte swizzle. -> 0 or the CUresult.
int make_values_map(CUtensorMap* map, const void* base, int BH, int Tp) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t tp = static_cast<cuuint64_t>(Tp);
  const cuuint64_t dims[3] = {tp, kHD, static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {tp, kHD * tp};
  const cuuint32_t box[3] = {kKeys, kHD, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
                                 dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <typename E>
int quantize_v(const void* v, int B, int H, int T, const int64_t* strides, void* vt, float* sv,
               int Tp, cudaStream_t stream) {
  const Strides s{strides[0], strides[1], strides[2]};
  constexpr int kWarpUnits = 32 / kVLanes;  // half-groups of a warp: a block holds whole warps
  const int units = Tp / 8;  // half-groups
  const int round = std::min((units + kWarpUnits - 1) / kWarpUnits * kWarpUnits, kVMaxUnits);
  const dim3 grid(B * H, kHD / kVChannels);
  int8_quantize_v_kernel<E><<<grid, kVLanes * round, 0, stream>>>(
      static_cast<const E*>(v), s, H, T, Tp, (units + round - 1) / round,
      static_cast<int8_t*>(vt), sv);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's tensor maps, its shared memory, its launch: grid a block a
// (query tile, b, h), query tile outermost.
template <typename E>
int launch_attention(Int8Params& p, const void* vt, int B, int H, int T, int Tp,
                     cudaStream_t stream) {
  const int err = make_values_map(&p.vt, vt, B * H, Tp);
  if (err) return -err;
  p.B = B;
  p.H = H;
  p.T = T;
  p.Tp = Tp;
  static const cudaError_t configured = cudaFuncSetAttribute(
      int8_attention_sm90_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<E>::kAlloc);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((T + kBlockQ - 1) / kBlockQ * H * B);
  int8_attention_sm90_kernel<E><<<grid, kThreads, Smem<E>::kAlloc, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v: (B, T, H, 64) bf16 (f32 = 0) or f32 (f32 = 1) through `strides` (b, t,
// h elements, each a 16-byte multiple, unit stride along d, 16-byte aligned
// base). -> vt (B H, 64, Tp) int8, Tp = T rounded up to a multiple of 128,
// each 16-key group in key_position order, zero past T; sv (B H, 64) f32.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue (1)
// for a Tp it does not take.
extern "C" int int8_quantize_v(const void* v, int B, int H, int T, const int64_t* strides,
                               void* vt, float* sv, int Tp, int f32, void* stream) {
  if (Tp % kKeys != 0 || Tp < T) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? quantize_v<float>(v, B, H, T, strides, vt, sv, Tp, s)
             : quantize_v<bf16>(v, B, H, T, strides, vt, sv, Tp, s);
}

// q, k: (B, T, H, 64) bf16 through `strides` (6 element strides: b, t, h of
// q, then of k; multiples of 8 below 2^36, unit stride along d, 16-byte
// aligned bases); mask: (B, T) bytes, 0 = key not attended, or null; vt, sv
// from int8_quantize_v; out: (B, T, H, 64) bf16 contiguous. Every pointer
// on the device of `stream`. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue (1) for a Tp it does not take, or minus the
// CUresult of a tensor map that cannot be encoded.
extern "C" int int8_attention_sm90(const void* q, const void* k, const uint8_t* mask,
                                   const void* vt, const float* sv, void* out, int B, int H, int T,
                                   int Tp, const int64_t* strides, void* stream) {
  if (Tp % kKeys != 0 || Tp < T) return static_cast<int>(cudaErrorInvalidValue);
  Int8Params p{};
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]};
  const bool q_inner = sq.h < sq.t, k_inner = sk.h < sk.t;  // e.g. a contiguous projection
  int err = make_map(&p.q, q, sq, B, H, T, q_inner);
  if (!err) err = make_map(&p.k, k, sk, B, H, T, k_inner);
  if (err) return -err;
  p.heads_inner = (q_inner ? kInnerQ : 0) | (k_inner ? kInnerK : 0);
  p.mask = mask;
  p.sv = sv;
  p.out = out;
  return launch_attention<bf16>(p, vt, B, H, T, Tp, static_cast<cudaStream_t>(stream));
}

// f32 elements of the f32 kernel's scratch at (B, H, Tp): q / 8 and k, each
// as big and small TF32 parts, (B H, Tp, 64) each.
extern "C" int64_t int8_attention_f32_scratch(int B, int H, int Tp) {
  return 4 * static_cast<int64_t>(B) * H * Tp * kHD;
}

// The same for f32 q, k (strides as int8_attention_sm90's, each a multiple
// of 4 elements), values from int8_quantize_v(.., f32 = 1), out (B, T, H,
// 64) f32 contiguous, and scratch: int8_attention_f32_scratch(B, H, Tp) f32,
// 16-byte aligned. Launches the pre-pass (int8_split_qk_kernel) and the
// kernel; returns as int8_attention_sm90 does.
extern "C" int int8_attention_f32_sm90(const void* q, const void* k, const uint8_t* mask,
                                       const void* vt, const float* sv, void* out, int B, int H,
                                       int T, int Tp, const int64_t* strides, float* scratch,
                                       void* stream) {
  if (Tp % kKeys != 0 || Tp < T) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(B) * H * Tp * kHD, rows = static_cast<int64_t>(B) * H * Tp;
  float *qb = scratch, *qs = scratch + n, *kb = scratch + 2 * n, *ks = scratch + 3 * n;
  Int8Params p{};
  int err = make_map_2d(&p.q, qb, kHD, rows, kF32Cols, kBlockQ);
  if (!err) err = make_map_2d(&p.qs, qs, kHD, rows, kF32Cols, kBlockQ);
  if (!err) err = make_map_2d(&p.k, kb, kHD, rows, kF32Cols, kKeys);
  if (!err) err = make_map_2d(&p.ks, ks, kHD, rows, kF32Cols, kKeys);
  if (err) return -err;
  p.mask = mask;
  p.sv = sv;
  p.out = out;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]};
  int8_split_qk_kernel<<<dim3(Tp / kSplitRows, H, B), kSplitRows * kHD / 4, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), sq, sk, H, T, Tp, qb, qs, kb,
      ks);
  const cudaError_t split = cudaGetLastError();
  if (split != cudaSuccess) return static_cast<int>(split);
  return launch_attention<float>(p, vt, B, H, T, Tp, s);
}
