// int8-probability attention on Hopper (sm_90a): one fused kernel for the
// logits, the row max, the exponent, the int8 probabilities and their int8
// product with the values (int8_attention_sm90_kernel<d, E>), and a small
// kernel that quantizes the values first (int8_quantize_v_kernel<d, E>), at
// every head width d of HEAD_DIMS (32, 48, 64, 96, 128), bf16 and f32.
//
// Replaces mvropose_tpu/ops/attention.py:29 int8_prob_attention. That
// function is not Pallas: it is XLA einsums and elementwise ops written for
// the TPU's int8 matrix unit. Per batch element b, head h and query row q,
// in the reference's rounding points (mvropose_torch/ops/int8_attention.py
// has them in plain torch), with s = 1/sqrt(d) rounded to the operands' type:
//   q'   = bf16(q * s), the reference's q * sm_scale in q's dtype (1/8 at
//          d = 64 is exact; 1/sqrt(48) is not, so the rounding is real)
//   s_k  = bf16(q' . k_k), bf16's lowest finite value at a masked key;
//          keys past T do not exist (no part in m, z or the product)
//   m    = max_k s_k, the true row max: a first pass over all the keys
//   e_k  = bf16(expf(bf16(s_k - m)))  in [0, 1], expf the accurate one that
//          torch's bf16 exp uses on CUDA, so equal logits give equal e
//   z    = sum_k e_k (f32);  pq_k = rint(127 e_k) (int8, half to even)
//   acc  = sum_k pq_k vq_k (int32, exact)
//   out  = bf16((f32(acc) * (1 / (127 z))) * sv), written in (B, T, H, d)
// with the values quantized per (b, h, channel c) by int8_quantize_v_kernel:
//   sv_c = max(max_k |v_kc|, 1e-6) / 127,  vq_kc = rint(v_kc / sv_c).
// A row whose keys are all masked has m = s_k for every real key: e = 1,
// z = T, and it averages the values over the T real keys.
//
// What bounds it on an H100 at the serve shape (B H = 48, T = 1025, d = 64):
// one QK^T (6.46 GFLOP, 6.5 us at the bf16 tensor-core rate) and the int8
// P@V (6.46 G operations, 3.3 us at the int8 rate); ~22 MB of q, k, vq and
// out (6.6 us at 3.35 TB/s); but 50.4 M exponentials, ~13.6 us at 16 a
// clock per SM, and ~16 ALU instructions per logit around them (two bf16
// roundings, the accurate expf, the row sum, the int8 rounding and the byte
// packing). The elementwise work per logit, not the products or the bytes,
// sets the pace, at every width: the logits' count does not depend on d.
// The plain chain it replaces writes and rereads the (B H, T, T) logits,
// exponents and probabilities in device memory: ~2.2 GB a layer.
//
// The design (the flash forward's, csrc/flash_attention.cu, on the helpers
// of csrc/sm90_common.cuh):
//   * a block owns 128 queries, in two consumer warpgroups of 64, Q loaded
//     once by TMA; one producer warp streams tiles of N keys (`Int8Plan`:
//     128, fewer for f32 at d >= 96) through a ring of up to 4 stages of
//     full/empty mbarriers: K alone in pass 1, K and a tile of values (d
//     channels x N keys of int8) in pass 2. Both passes run through the
//     ring as one sequence of 2 n tiles, so a stage's phase parity carries
//     over from the first pass to the second;
//   * a row of d bf16 is 2d bytes, one 128-byte swizzle atom only at d = 64:
//     Q and K tiles are stored as column chunks of one atom each, the widest
//     of 64, 32 or 16 columns dividing d (the flash kernels' `Sm90Tiles`),
//     each chunk one TMA box over a map whose inner extent is the true d; a
//     k-step of 16 columns stays in one chunk. No column is padded;
//   * Q is scaled in shared memory before the first product: each consumer
//     warpgroup rounds bf16(q * s) over its 64 rows in place (the swizzle
//     moves whole elements, so the layout does not matter), then a
//     fence.proxy.async makes the stores visible to the tensor cores;
//   * pass 1: S = Q' K^T (wgmma m64n128k16 bf16, both operands in shared
//     memory, f32 sums) and the row max. bf16 rounding is monotonic, so m =
//     bf16(max S) equals the max of the rounded logits, taken on raw S. A
//     one-pass online softmax would quantize against a running max: other
//     int8 probabilities, another function. Pass 2 recomputes S and does the
//     rest;
//   * bf16(s - m) is one bf16x2 add of the bf16-rounded S pair and -m (one
//     rounding of s - m equals torch's f32 difference rounded to bf16);
//     rint(127 e) is one fma with 1.5 * 2^23, whose low byte is the rounded
//     value (half to even);
//   * P@V is wgmma m64n{d}k32 s8 x s8 -> s32 with the probabilities as the A
//     operand in registers. 8-bit A fragments hold 4 consecutive k of a row
//     per register, which are not the columns a thread holds of the f32 S
//     accumulator. The contraction does not care in which order it meets
//     the keys, so the values carry the accumulator's order instead:
//     int8_quantize_v_kernel writes them transposed and K-major, (B H, d,
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
// q and k are read through their (B, T, H, d) strides by TMA tensor maps
// built on the host per call (a CUDA graph captures them as parameters).
//
// f32 q, k and v (int8_attention_sm90_kernel<d, float>, int8_quantize_v_kernel<
// d, float>): the reference's f32 route, the logits, exponents and
// probabilities in f32. What the f32 instantiation changes, on the same plan
// (two passes, the ring, the turns, the codes, P V and the dequant):
//   * S on split-TF32 wgmma (csrc/flash_attention_tf32.cu's three-product
//     form): a pre-pass (int8_split_qk_kernel<d>, launched by the same entry
//     point) writes fl(q * s) (the reference's q * sm_scale in f32, rounded
//     before the split) and k as their big and small TF32 parts in row
//     order, (B H, Tp, d) each, into a scratch buffer the wrapper allocates;
//     S = Q_big K_small + Q_small K_big, then Q_big K_big (the small terms
//     first: the tensor cores round each partial sum toward zero, so only
//     the big term's k-steps round at the sum's full magnitude), m64nNk8,
//     both operands K-major in shared memory (TF32 reads K-major only; Q and
//     K are both K-major in Q K^T), in column chunks of 32 f32 (16 at d =
//     48: 64 bytes, the 64-byte swizzle). Q's two parts take 1 KB a channel
//     and a stage's K parts 8 N bytes a channel, so the plan (`Int8Plan`)
//     streams 128 keys a tile at d <= 64 (4, 3 and 2 stages at d = 32, 48,
//     64), 64 at d = 96 and 32 at d = 128 (2 stages each): 128 keys leave
//     room for one stage only there, and the ring needs two (a tile's P V
//     runs after the next tile's S was issued);
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
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kInnerQ = 1, kInnerK = 2;  // bits of heads_inner
constexpr float kRound = 12582912.0f;    // 1.5 * 2^23: x + kRound rounds x to an integer
constexpr int kSplitRows = 16;  // rows of a pre-pass block
constexpr int kTpUnit = 128;    // Tp, the values' padded key count, is a multiple of this

// The tiles of the kernel at head width D for operands of E: the column
// chunks of Q and K (one swizzle atom each), the keys of a streamed tile, and
// the shared memory of Q, of a stage (K, both TF32 parts for f32, and the
// values) and the ring depth that fits. bf16: chunks of 64, 32 or 16 bf16
// (the widest dividing D), 128 keys a tile; f32: big and small parts, chunks
// of 32 f32 (16 at d = 48), the widest key tile of 128, 64 or 32 that leaves
// room for two stages.
// Stages of `keys` keys that fit beside Q's q_bytes: each holds K (`elem`
// bytes a channel and key: 2 for bf16, 8 for f32's two TF32 parts), the int8
// values and a code byte per key; 1024 + 256 bytes for the base's alignment,
// the flags and the barriers.
constexpr int int8_stages_fit(int q_bytes, int elem, int d, int keys) {
  return (kMaxSmem - 1024 - 256 - q_bytes) / (keys * d * elem + keys * d + keys);
}

template <int D, typename E>
struct Int8Plan {
  static constexpr bool kF32 = std::is_same_v<E, float>;
  static constexpr int kElem = sizeof(E);
  static constexpr int kParts = kF32 ? 2 : 1;  // f32: big and small TF32 parts
  // Columns of a chunk, in elements of E, and the chunk's row in bytes.
  static constexpr int kCols = kF32 ? (D % 32 == 0 ? 32 : 16)
                                    : (D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16);
  static constexpr int kRowBytes = kCols * kElem;
  static constexpr int kAtom = kRowBytes / 2;  // `sw_desc`'s C: the atom in 2-byte columns
  static constexpr int kQBytes = kParts * kBlockQ * D * kElem;
  static constexpr int kFit128 = int8_stages_fit(kQBytes, kParts * kElem, D, 128);
  static constexpr int kFit64 = int8_stages_fit(kQBytes, kParts * kElem, D, 64);
  static constexpr int kKeys = kFit128 >= 2 ? 128 : kFit64 >= 2 ? 64 : 32;
  static constexpr int kFit = int8_stages_fit(kQBytes, kParts * kElem, D, kKeys);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kKTile = kParts * kKeys * D * kElem;  // bytes of a K tile (both parts)
  static constexpr int kVTile = D * kKeys;                     // bytes of a values tile
  static constexpr int kQChunk = kBlockQ * kRowBytes;          // bytes of a chunk of Q (a part)
  static constexpr int kKChunk = kKeys * kRowBytes;            // ... and of a K tile
  static constexpr int kVAtom = kKeys / 2;  // `sw_desc`'s C of the values: a row of kKeys bytes
  static constexpr float kMaskedLogit = kF32 ? -FLT_MAX : kMasked;  // finfo(dtype).min
  static_assert(kStages >= 2, "the ring needs two stages");
};

template <int D, typename E>
struct Smem {
  using P = Int8Plan<D, E>;
  static constexpr int kStages = P::kStages;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + P::kQBytes;
  static constexpr int kStage = P::kKTile + P::kVTile;     // a stage: K (both parts), values
  static constexpr int kCodes = kRing + kStages * kStage;  // a code per key and stage
  static constexpr int kFlags = kCodes + kStages * P::kKeys;  // a flag per stage
  static constexpr int kBars = (kFlags + kStages + 7) / 8 * 8;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024 bytes
  static_assert(kAlloc <= kMaxSmem, "more shared memory than a block can have");
  static_assert(kRing % 1024 == 0 && kStage % 1024 == 0, "tiles on 1024-byte boundaries");
};

struct Int8Params {
  // bf16: q, k (B, T, H, d) through their strides (make_map), boxes of 64
  // rows x a chunk. f32: q, k the big parts and qs, ks the small parts of the
  // pre-pass, (B H Tp) rows of d f32 (make_map_2d), boxes of a chunk x 128
  // rows (Q) or x the key tile (K).
  CUtensorMap q, k, qs, ks;
  CUtensorMap vt;    // (B H, d, Tp) int8 values, boxes of a key tile x d channels
  int heads_inner;   // bits kInnerQ, kInnerK: the map's dims are (d, H, T, B)
  const uint8_t* mask;  // (B, T), 0 = key not attended; null: every key attended
  const float* sv;      // (B H, d) the values' scales
  void* out;            // (B, T, H, d) contiguous, in the operands' type
  float scale;          // 1/sqrt(d) rounded to bf16 (the bf16 kernel scales Q with it)
  int B, H, T, Tp;
};

// `key_position`, where key j (of a tile) sits among the K-major bytes of
// its 16-key group: keys 8 i + 2 t + c (i = 0, 1; c = 0, 1) go to bytes
// 4 t + 2 i + c, the A-fragment bytes of the thread that holds the S
// accumulator columns 8 i + 2 t + c (see the source note), that is byte
// (j & ~15) | (4 ((j & 7) >> 1) + 2 ((j >> 3) & 1) + (j & 1));
// ops/int8_attention.py::key_positions gives its inverse, the key at each byte.

// One box of the values (a key tile x d channels), keys [key, ..) of row bh.
__device__ __forceinline__ void tma_values(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int key, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(key), "r"(0), "r"(bh), "r"(smem_u32(bar))
      : "memory");
}

// The s32 accumulator of m64nN as "+r" operands (d[i][e]: the layout of
// sm90_common.cuh's f32 accumulators).
#define WGMMA_S(i) "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3])
#define WGMMA_S32 WGMMA_S(0), WGMMA_S(1), WGMMA_S(2), WGMMA_S(3)
#define WGMMA_S48 WGMMA_S32, WGMMA_S(4), WGMMA_S(5)
#define WGMMA_S64 WGMMA_S48, WGMMA_S(6), WGMMA_S(7)
#define WGMMA_S96 WGMMA_S64, WGMMA_S(8), WGMMA_S(9), WGMMA_S(10), WGMMA_S(11)
#define WGMMA_S128 WGMMA_S96, WGMMA_S(12), WGMMA_S(13), WGMMA_S(14), WGMMA_S(15)
#define WGMMA_RS_S8(N_, A0, A1, A2, A3, B_)                                            \
  asm volatile("wgmma.mma_async.sync.aligned.m64n" #N_ "k32.s32.s8.s8 "                 \
               WGMMA_D##N_##_REGS ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B_ \
               ", 1;\n"                                                               \
               : WGMMA_S##N_                                                          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))

// D += A B, m64nNk32 (N = d), s8 x s8 -> s32: A (16 rows x 32 per warp;
// register r holds 4 consecutive k of row g + 8 (r & 1), from k = 4 t + 16
// (r >> 1)) in registers, B K-major in shared memory (8-bit operands are
// K-major only).
template <int N>
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[N / 8][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  static_assert(N == 32 || N == 48 || N == 64 || N == 96 || N == 128, "a head width");
  if constexpr (N == 32) {
    WGMMA_RS_S8(32, 16, 17, 18, 19, 20);
  } else if constexpr (N == 48) {
    WGMMA_RS_S8(48, 24, 25, 26, 27, 28);
  } else if constexpr (N == 64) {
    WGMMA_RS_S8(64, 32, 33, 34, 35, 36);
  } else if constexpr (N == 96) {
    WGMMA_RS_S8(96, 48, 49, 50, 51, 52);
  } else {
    WGMMA_RS_S8(128, 64, 65, 66, 67, 68);
  }
}
#undef WGMMA_RS_S8

// O += P V over a tile of N keys: N / 32 k-steps of 32 keys (32 bytes)
// along the K-major value rows.
template <int D, int N>
__device__ __forceinline__ void product_pv(int (&o)[D / 8][4], const uint32_t (&pa)[N / 32][4],
                                           uint64_t v) {
#pragma unroll
  for (int kk = 0; kk < N / 32; ++kk) wgmma_rs_s8<D>(o, pa[kk], v + 2 * kk);
}

// A logit of a coded tile in f32: raw S at an attended key, the masked
// logit at a masked one, -inf past T (code 0, 1, 2).
__device__ __forceinline__ float coded_logit(float s, uint32_t code, float masked) {
  return code == 0 ? s : (code == 1 ? masked : -INFINITY);
}

// Pass 1 on a tile of N keys: mx (rows g, g + 8) takes the max of its logits.
template <bool Coded, int N>
__device__ __forceinline__ void tile_max(const float (&s)[N / 8][4], float (&mx)[2],
                                         const uint8_t* code, int t, float masked) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const uint32_t kc = Coded ? *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = Coded ? coded_logit(s[n][e], (kc >> (8 * (e & 1))) & 0xff, masked) : s[n][e];
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
}

// Pass 2 on a tile, in place: each logit becomes fma(e, 127, kRound) with
// e = bf16(expf(bf16(s - m))), whose low byte is rint(127 e); z += e.
// negm: -m of rows g and g + 8 as bf16 pairs. A coded tile skips its column
// tiles of keys past T (the last tile: `keys` of them exist), which the
// values' zeros cancel in P V and which add nothing to z.
template <bool Coded>
__device__ __forceinline__ void tile_probs(float (&s)[16][4], const __nv_bfloat162 (&negm)[2],
                                           float (&z)[2], const uint8_t* code, int t, int keys) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    if (Coded && 8 * n >= keys) break;
    const uint32_t kc = Coded ? *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t) : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a = s[n][2 * r], b = s[n][2 * r + 1];
      if constexpr (Coded) {
        a = coded_logit(a, kc & 0xff, kMasked);
        b = coded_logit(b, kc >> 8, kMasked);
      }
      // bf16(s - m): S rounded to bf16, then one rounding of the difference.
      const __nv_bfloat162 x = __hadd2(__floats2bfloat162_rn(a, b), negm[r]);
      const __nv_bfloat162 e = __floats2bfloat162_rn(expf(__low2float(x)), expf(__high2float(x)));
      const float e0 = __low2float(e), e1 = __high2float(e);
      z[r] += e0;
      z[r] += e1;
      s[n][2 * r] = fmaf(e0, 127.f, kRound);
      s[n][2 * r + 1] = fmaf(e1, 127.f, kRound);
    }
  }
}

// The same in f32 on a tile of N keys, at the reference's f32 rounding
// points: e = expf(s - m), z += e, and fl(127 e) rounded to an integer by
// adding kRound, each an explicit `_rn` operation so that nvcc contracts
// none of them into an fma.
template <bool Coded, int N>
__device__ __forceinline__ void tile_probs_f32(float (&s)[N / 8][4], const float (&m)[2],
                                               float (&z)[2], const uint8_t* code, int t,
                                               int keys) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (Coded && 8 * n >= keys) break;
    const uint32_t kc = Coded ? *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = Coded ? coded_logit(s[n][e], (kc >> (8 * (e & 1))) & 0xff, -FLT_MAX)
                            : s[n][e];
      const float p = expf(__fsub_rn(x, m[e >> 1]));
      z[e >> 1] += p;
      s[n][e] = __fadd_rn(__fmul_rn(p, 127.f), kRound);
    }
  }
}

// The int8 probabilities (low bytes of `tile_probs`' values) as the A
// fragments of P V: register r of 32-key group kk holds row g + 8 (r & 1),
// column tiles 4 kk + 2 (r >> 1) and the next, two bytes each.
template <int N>
__device__ __forceinline__ void pack_probs(const float (&s)[N / 8][4], uint32_t (&pa)[N / 32][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 32; ++kk) {
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

// S = Q_big K_small + Q_small K_big, then Q_big K_big, over d = D (D / 8
// k-steps of 8 f32, 32 bytes, in chunk 8 kk / C of each tile), m64nNk8
// TF32: q_big, q_small the warpgroup's 64 rows of Q's parts, k_big, k_small
// a stage's; P the plan (its chunks of C f32, their sizes in Q and in K).
template <int D, typename P>
__device__ __forceinline__ void product_split(float (&s)[P::kKeys / 8][4], uint64_t q_big,
                                              uint64_t q_small, uint64_t k_big, uint64_t k_small) {
  constexpr int C = P::kCols, N = P::kKeys;
  auto at = [](int kk, int chunk) {
    return static_cast<uint64_t>((kk * 8 / C * chunk + kk * 8 % C * 4) >> 4);
  };
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32_ss<N>(s, q_big + at(kk, P::kQChunk), k_small + at(kk, P::kKChunk), kk > 0);
    wgmma_tf32_ss<N>(s, q_small + at(kk, P::kQChunk), k_big + at(kk, P::kKChunk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32_ss<N>(s, q_big + at(kk, P::kQChunk), k_big + at(kk, P::kKChunk), 1);
  }
}

// `rows` rows from `row` on of one part (big or small) of a pre-pass
// operand, as its D / C column chunks of C f32.
template <int D, int C>
__device__ __forceinline__ void tma_f32_rows(unsigned char* dst, const CUtensorMap* map,
                                             uint64_t* bar, int rows, int row) {
#pragma unroll
  for (int c = 0; c < D / C; ++c) tma_2d(dst + c * rows * C * 4, map, bar, c * C, row);
}

// Q' = bf16(q * scale) in place: the warpgroup's 64 rows of each chunk of
// C bf16 (contiguous: 64 rows of 2C bytes), 8 bf16 a thread and step; then
// the stores are made visible to the tensor cores (the async proxy) and the
// warpgroup waits for all of them (named barrier 3 + wg).
template <int D, int C>
__device__ __forceinline__ void scale_q(unsigned char* sQ, int wg, float scale) {
  constexpr int kPart = kHRows * C * 2;  // bytes of the warpgroup's rows in a chunk
  constexpr int kWords = D / C * kPart / 16;
  for (int i = threadIdx.x % 128; i < kWords; i += 128) {
    const int c = i / (kPart / 16), w = i % (kPart / 16);
    uint4* at = reinterpret_cast<uint4*>(sQ + c * kBlockQ * C * 2 + wg * kPart + 16 * w);
    uint4 x = *at;
    uint32_t* words = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&words[j]);
      words[j] = Elem<bf16>::pack(__fmul_rn(__low2float(pair), scale),
                                  __fmul_rn(__high2float(pair), scale));
    }
    *at = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    int8_attention_sm90_kernel(const __grid_constant__ Int8Params p) {
  using P = Int8Plan<D, E>;
  using L = Smem<D, E>;
  constexpr bool kF32 = P::kF32;
  constexpr int N = P::kKeys, C = P::kCols, kStages = L::kStages, kKTile = P::kKTile;
  constexpr int kHalf = kKTile / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem + L::kQ;      // 128 query rows in chunks (f32: big, then small)
  unsigned char* ring = smem + L::kRing;  // [stage][K tile (f32: big, small), V d x N s8]
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
  const int n_tiles = (T + N - 1) / N;
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
      mbar_arrive_expect_tx(own, P::kQBytes);
      if constexpr (kF32) {
        tma_f32_rows<D, C>(sQ, &p.q, own, kBlockQ, bh * p.Tp + q0);
        tma_f32_rows<D, C>(sQ + P::kQBytes / 2, &p.qs, own, kBlockQ, bh * p.Tp + q0);
      } else {
        tma_rows<D, C>(reinterpret_cast<bf16*>(sQ), &p.q, own, kBlockQ, q0, h, b,
                       p.heads_inner & kInnerQ);
      }
    }
    const uint8_t* mask = p.mask ? p.mask + static_cast<int64_t>(b) * T : nullptr;
    // Tiles 0 .. n - 1 are pass 1's (K), n .. 2 n - 1 pass 2's (K and V).
    for (int i = 0; i < 2 * n_tiles; ++i) {
      const int stage = i % kStages, second = i >= n_tiles;
      const int k0 = (second ? i - n_tiles : i) * N;
      mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);  // round 0 passes
      bool any = false;
      for (int r = lane; r < N; r += 32) {
        const int key = k0 + r;
        const uint8_t c = key >= T ? 2 : (mask != nullptr && mask[key] == 0 ? 1 : 0);
        codes[stage * N + r] = c;
        any |= c != 0;
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) {
        coded[stage] = any;
        unsigned char* st = ring + stage * L::kStage;
        mbar_arrive_expect_tx(&full[stage], kKTile + (second ? P::kVTile : 0));
        if constexpr (kF32) {
          tma_f32_rows<D, C>(st, &p.k, &full[stage], N, bh * p.Tp + k0);
          tma_f32_rows<D, C>(st + kHalf, &p.ks, &full[stage], N, bh * p.Tp + k0);
        } else {
          tma_rows<D, C>(reinterpret_cast<bf16*>(st), &p.k, &full[stage], N, k0, h, b,
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
    // The warpgroup's 64 rows of Q in each chunk (of each part).
    const uint64_t q_desc = sw_desc<false, P::kAtom>(sQ + wg * kHRows * P::kRowBytes);
    const uint64_t qs_desc =
        sw_desc<false, P::kAtom>(sQ + P::kQBytes / 2 + wg * kHRows * P::kRowBytes);
    auto v_tile = [&](int stage) {
      return sw_desc<false, P::kVAtom>(ring + stage * L::kStage + kKTile);
    };
    mbar_wait(own, 0);
    if constexpr (!kF32) scale_q<D, C>(sQ, wg, p.scale);
    float s[N / 8][4];
    auto product_s = [&](int stage) {  // S of a stage's K tile into s
      const unsigned char* st = ring + stage * L::kStage;
      if constexpr (kF32) {
        product_split<D, P>(s, q_desc, qs_desc, sw_desc<false, P::kAtom>(st),
                            sw_desc<false, P::kAtom>(st + kHalf));
      } else {
        product_kmajor<N, D, C, P::kQChunk, P::kKChunk>(s, q_desc, sw_desc<false, C>(st));
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
        tile_max<true, N>(s, mx, codes + stage * N, t, P::kMaskedLogit);
      } else {
        tile_max<false, N>(s, mx, nullptr, t, P::kMaskedLogit);
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
    int o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
    float z[2] = {0.f, 0.f};  // this thread's part of the row sums
    uint32_t pa[N / 32][4];
    auto probs = [&](int stage, int j) {  // tile j's probabilities, packed
      if (idle) return;
      const bool c = coded[stage];
      const uint8_t* code = codes + stage * N;
      if constexpr (kF32) {
        if (c) {
          tile_probs_f32<true, N>(s, m, z, code, t, T - j * N);
        } else {
          tile_probs_f32<false, N>(s, m, z, nullptr, t, N);
        }
      } else {
        if (c) {
          tile_probs<true>(s, negm, z, code, t, T - j * N);
        } else {
          tile_probs<false>(s, negm, z, nullptr, t, N);
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
      if (!idle) pack_probs<N>(s, pa);
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
      product_pv<D, N>(o, pa, v_tile(prev));
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
      if (!idle) pack_probs<N>(s, pa);
    }
    // P V of the last tile.
    const int last = (2 * n_tiles - 1) % kStages;
    fence_acc(o);
    turn_wait(wg);
    wgmma_fence();
    product_pv<D, N>(o, pa, v_tile(last));
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[last]);
    if (wg == 0) turn_wait(wg);  // the other warpgroup's last pass

    // out = (f32(acc) * (1 / (127 z))) * sv, rows past T (zero-filled Q) not stored.
    const float* sv = p.sv + static_cast<int64_t>(bh) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
      const int row = row0 + g + 8 * r;
      if (row >= T) continue;
      const float rz = 1.f / (127.f * z[r]);
      E* dst = static_cast<E*>(p.out) + (static_cast<int64_t>(b) * T + row) * p.H * D +
               static_cast<int64_t>(h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
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
// element b, fl(q * scale) (the reference's q * sm_scale in f32) and k as
// their TF32 big and small parts, (B H, Tp, D) each, zero past T. A thread
// one float4 of a row.
template <int D>
__global__ void __launch_bounds__(kSplitRows * D / 4)
    int8_split_qk_kernel(const float* __restrict__ q, const float* __restrict__ k, Strides sq,
                         Strides sk, int H, int T, int Tp, float scale, float* __restrict__ qb,
                         float* __restrict__ qs, float* __restrict__ kb, float* __restrict__ ks) {
  constexpr int kRowThreads = D / 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * kSplitRows + threadIdx.x / kRowThreads;
  const int c = 4 * (threadIdx.x % kRowThreads);
  const int64_t at = ((static_cast<int64_t>(b) * H + h) * Tp + row) * D + c;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
  if (row < T) {
    x = *reinterpret_cast<const float4*>(q + b * sq.b + row * sq.t + h * sq.h + c);
    y = *reinterpret_cast<const float4*>(k + b * sk.b + row * sk.t + h * sk.h + c);
  }
  x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale),
                  __fmul_rn(x.w, scale));
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
// (12.6 MB read at the serve shape, 4.8 us). At head width d a (b, h) has
// d / 16 blocks, every width of HEAD_DIMS a multiple of 16.

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

template <int D, typename E>
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
    sv[static_cast<int64_t>(bh) * D + c16 + tid] = d.s;
  }
  __syncthreads();
  Divisor d[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) d[c] = s_div[8 * o + c];
  int8_t* out = vt + (static_cast<int64_t>(bh) * D + c16 + 8 * o) * Tp;
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

// A tensor map over the (B H, D, Tp) int8 values: dims (Tp, D, B H), boxes
// of `keys` keys x D channels, swizzled by the box's row of `keys` bytes
// (128, 64 or 32). -> 0 or the CUresult.
int make_values_map(CUtensorMap* map, const void* base, int BH, int D, int Tp, int keys) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t tp = static_cast<cuuint64_t>(Tp), d = static_cast<cuuint64_t>(D);
  const cuuint64_t dims[3] = {tp, d, static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {tp, d * tp};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(keys), static_cast<cuuint32_t>(D), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = keys == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : keys == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
                                 dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int D, typename E>
int quantize_v(const void* v, int B, int H, int T, const int64_t* strides, void* vt, float* sv,
               int Tp, cudaStream_t stream) {
  const Strides s{strides[0], strides[1], strides[2]};
  constexpr int kWarpUnits = 32 / kVLanes;  // half-groups of a warp: a block holds whole warps
  const int units = Tp / 8;  // half-groups
  const int round = std::min((units + kWarpUnits - 1) / kWarpUnits * kWarpUnits, kVMaxUnits);
  const dim3 grid(B * H, D / kVChannels);
  int8_quantize_v_kernel<D, E><<<grid, kVLanes * round, 0, stream>>>(
      static_cast<const E*>(v), s, H, T, Tp, (units + round - 1) / round,
      static_cast<int8_t*>(vt), sv);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's values map, its shared memory, its launch: grid a block a
// (query tile, b, h), query tile outermost.
template <int D, typename E>
int launch_attention(Int8Params& p, const void* vt, int B, int H, int T, int Tp,
                     cudaStream_t stream) {
  using L = Smem<D, E>;
  const int err = make_values_map(&p.vt, vt, B * H, D, Tp, Int8Plan<D, E>::kKeys);
  if (err) return -err;
  p.B = B;
  p.H = H;
  p.T = T;
  p.Tp = Tp;
  static const cudaError_t configured = cudaFuncSetAttribute(
      int8_attention_sm90_kernel<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((T + kBlockQ - 1) / kBlockQ * H * B);
  int8_attention_sm90_kernel<D, E><<<grid, kThreads, L::kAlloc, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel at width D: q, k through their strides, Q scaled in the kernel.
template <int D>
int attention_bf16(const void* q, const void* k, Int8Params& p, const void* vt, int B, int H,
                   int T, int Tp, const int64_t* strides, cudaStream_t stream) {
  constexpr int C = Int8Plan<D, bf16>::kCols;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]};
  const bool q_inner = sq.h < sq.t, k_inner = sk.h < sk.t;  // e.g. a contiguous projection
  int err = make_map(&p.q, q, sq, B, H, T, q_inner, D, C);
  if (!err) err = make_map(&p.k, k, sk, B, H, T, k_inner, D, C);
  if (err) return -err;
  p.heads_inner = (q_inner ? kInnerQ : 0) | (k_inner ? kInnerK : 0);
  return launch_attention<D, bf16>(p, vt, B, H, T, Tp, stream);
}

// The f32 pre-pass and kernel at width D on `scratch` (four (B H Tp, D) parts).
template <int D>
int attention_f32(const void* q, const void* k, Int8Params& p, const void* vt, int B, int H,
                  int T, int Tp, const int64_t* strides, float scale, float* scratch,
                  cudaStream_t stream) {
  using P = Int8Plan<D, float>;
  const int64_t n = static_cast<int64_t>(B) * H * Tp * D, rows = static_cast<int64_t>(B) * H * Tp;
  float *qb = scratch, *qs = scratch + n, *kb = scratch + 2 * n, *ks = scratch + 3 * n;
  int err = make_map_2d(&p.q, qb, D, rows, P::kCols, kBlockQ);
  if (!err) err = make_map_2d(&p.qs, qs, D, rows, P::kCols, kBlockQ);
  if (!err) err = make_map_2d(&p.k, kb, D, rows, P::kCols, P::kKeys);
  if (!err) err = make_map_2d(&p.ks, ks, D, rows, P::kCols, P::kKeys);
  if (err) return -err;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]};
  int8_split_qk_kernel<D><<<dim3(Tp / kSplitRows, H, B), kSplitRows * D / 4, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), sq, sk, H, T, Tp, scale, qb, qs,
      kb, ks);
  const cudaError_t split = cudaGetLastError();
  if (split != cudaSuccess) return static_cast<int>(split);
  return launch_attention<D, float>(p, vt, B, H, T, Tp, stream);
}

// f(integral_constant<int, D>) at the head width D of HEAD_DIMS, or
// cudaErrorInvalidValue (1) for another.
template <typename F>
int at_width(int D, F&& f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// v: (B, T, H, D) bf16 (f32 = 0) or f32 (f32 = 1) through `strides` (b, t,
// h elements, each a 16-byte multiple, unit stride along d, 16-byte aligned
// base), D in {32, 48, 64, 96, 128}. -> vt (B H, D, Tp) int8, Tp = T
// rounded up to a multiple of 128, each 16-key group in key_position order,
// zero past T; sv (B H, D) f32. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue (1) for a Tp or a D it does not take.
extern "C" int int8_quantize_v(const void* v, int B, int H, int T, int D, const int64_t* strides,
                               void* vt, float* sv, int Tp, int f32, void* stream) {
  if (Tp % kTpUnit != 0 || Tp < T) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return at_width(D, [&](auto d) {
    return f32 ? quantize_v<d.value, float>(v, B, H, T, strides, vt, sv, Tp, s)
               : quantize_v<d.value, bf16>(v, B, H, T, strides, vt, sv, Tp, s);
  });
}

// q, k: (B, T, H, D) bf16 through `strides` (6 element strides: b, t, h of
// q, then of k; multiples of 8 below 2^36, unit stride along d, 16-byte
// aligned bases), D in {32, 48, 64, 96, 128}; mask: (B, T) bytes, 0 = key
// not attended, or null; vt, sv from int8_quantize_v; out: (B, T, H, D) bf16
// contiguous; scale: 1/sqrt(D) rounded to bf16 (the reference's sm_scale
// in q's dtype). Every pointer on the device of `stream`. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue (1) for a Tp or
// a D it does not take, or minus the CUresult of a tensor map that cannot be
// encoded.
extern "C" int int8_attention_sm90(const void* q, const void* k, const uint8_t* mask,
                                   const void* vt, const float* sv, void* out, int B, int H, int T,
                                   int D, int Tp, const int64_t* strides, float scale,
                                   void* stream) {
  if (Tp % kTpUnit != 0 || Tp < T) return static_cast<int>(cudaErrorInvalidValue);
  Int8Params p{};
  p.mask = mask;
  p.sv = sv;
  p.out = out;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return at_width(D, [&](auto d) {
    return attention_bf16<d.value>(q, k, p, vt, B, H, T, Tp, strides, s);
  });
}

// f32 elements of the f32 kernel's scratch at (B, H, Tp, D): fl(q * scale)
// and k, each as big and small TF32 parts, (B H, Tp, D) each.
extern "C" int64_t int8_attention_f32_scratch(int B, int H, int Tp, int D) {
  return 4 * static_cast<int64_t>(B) * H * Tp * D;
}

// The same for f32 q, k (strides as int8_attention_sm90's, each a multiple
// of 4 elements), values from int8_quantize_v(.., f32 = 1), out (B, T, H,
// D) f32 contiguous, scale 1/sqrt(D) in f32, and scratch:
// int8_attention_f32_scratch(B, H, Tp, D) f32, 16-byte aligned. Launches
// the pre-pass (int8_split_qk_kernel<D>) and the kernel; returns as
// int8_attention_sm90 does.
extern "C" int int8_attention_f32_sm90(const void* q, const void* k, const uint8_t* mask,
                                       const void* vt, const float* sv, void* out, int B, int H,
                                       int T, int D, int Tp, const int64_t* strides, float scale,
                                       float* scratch, void* stream) {
  if (Tp % kTpUnit != 0 || Tp < T) return static_cast<int>(cudaErrorInvalidValue);
  Int8Params p{};
  p.mask = mask;
  p.sv = sv;
  p.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return at_width(D, [&](auto d) {
    return attention_f32<d.value>(q, k, p, vt, B, H, T, Tp, strides, scale, scratch, s);
  });
}
