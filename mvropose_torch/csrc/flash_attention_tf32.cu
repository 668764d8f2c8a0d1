// Flash attention for f32 operands on Hopper (sm_90a): the forward, the
// dK/dV and the dQ kernels, their products on the tensor cores in split
// TF32, so the results keep f32's accuracy, at every head width d in {32,
// 48, 64, 96, 128}.
//
// Replaces, for f32 operands, the stock Pallas TPU kernels that
// mvropose_tpu/ops/attention.py::fused_self_attention calls at T >= 2048 (a
// TPU runs them in the operands' own dtype, f32 included), in
// jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0):
//   * flash_fwd_tf32_sm90_kernel<d> <- _flash_attention_kernel (:331, pallas_call :758);
//   * flash_dkv_tf32_sm90_kernel<d> <- _flash_attention_dkv_kernel (:796, pallas_call :1121);
//   * flash_dq_tf32_sm90_kernel<d>  <- _flash_attention_dq_kernel (:1146, pallas_call :1456).
//
// What they compute is flash_attention.cu's three kernels, with every
// operand, the probabilities and the sums in f32: S = sm_scale Q K^T in
// base 2 (times log2(e)), masked keys at bf16's lowest finite value (so a
// row whose keys are all masked averages V over its T real keys, and its
// backward recomputes P = 1/T), keys past T skipped, O = (sum_j exp2(S_j -
// m) V_j) / l with m the row max (base 2) and l the row sum, both saved
// apart; the backward recomputes P = exp2(S - m) / l from them, dV = P^T
// dO, dS = P o (dO V^T - di) with di = rowsum(dO o O), 0 at masked keys,
// dK = sm_scale dS^T Q, dQ = sm_scale dS K (ops/attention.py's
// flash_forward_plain and flash_backward_plain in plain torch).
//
// The split. A TF32 operand keeps 10 of f32's 23 mantissa bits. Each operand
// x is written as big + small, big = x with its low 13 mantissa bits cleared
// and small = x - big (exact in f32) with its own low 13 bits cleared: both
// exact TF32 values, so nothing depends on what the tensor cores do with the
// bits they ignore. A product becomes three TF32 products,
// a b ~ a_big b_big + a_big b_small + a_small b_big, accumulated in f32:
// each drops at most ~2^-20 of |a b| (the cleared bits of the smalls and
// a_small b_small), where one TF32 product drops ~2^-10. (CUTLASS's
// OpMultiplyAddFastF32 rests on the same idea; these kernels call none of it.)
//
// What bounds them on an H100: three TF32 products per f32 product, each of
// 2 B H T^2 d FLOPs, at the card's 495 TFLOP/s of dense TF32 (half bf16's
// rate): the forward's 2 products, dK/dV's 4 (S^T, dP^T, dV, dK) and dQ's
// 3 (S, dP, dQ), and the B H T^2 exponentials on the SFU beside them: at
// (2, 2305, 12, 64) 0.198, 0.396 and 0.297 ms of products and 0.031 ms of
// exponentials each, against 0.487, 0.974 and 0.731 ms for the same work at
// the CUDA cores' f32 rate. Each also streams its operands' split parts
// through the L2, 8 bytes an element where bf16 streams 2.
//
// TF32 wgmma reads its shared operands K-major only (32-bit types have no
// transpose bit), and each operand comes twice, big and small. So every
// kernel starts with a pre-pass (`flash_split_tf32_kernel`, launched by the
// same entry point) that writes, from the (B, T, H, d) operands read through
// their strides, into one scratch buffer the wrapper allocates: the big and
// small parts in row order, (B H, Tp, d), of the operands a kernel uses as
// they lie, and in transposed order, (B H, d, Tp), of those a product needs
// with T contiguous, T padded to Tp (a multiple of kPad rows) with zeros.
// Each 8-row group of a transposed operand is written in the order [0, 2,
// 4, 6, 1, 3, 5, 7] (row j at slot (j & 1) * 4 + j / 2): an accumulator of
// m64nNk8 holds columns 2t and 2t + 1 of each 8-column group (t = lane % 4),
// a TF32 A fragment k-columns t and t + 4, so with that order every
// accumulator register goes to its A slot as it is (`split_a`), and the sum
// over the k-dimension does not care about the order.
//   * forward: Q and K as they lie, V^T (P V); at (2, 2305, 12, 64) 42 MB
//     read, 90 MB written;
//   * dK/dV: Q, K, V, dO as they lie (S^T = K Q^T, dP^T = V dO^T), Q^T and
//     dO^T (dV += P^T dO, dK += dS^T Q): 57 MB read, 180 MB written;
//   * dQ: the same four as they lie (S = Q K^T, dP = dO V^T), K^T (dQ +=
//     dS K): 57 MB read, 150 MB written.
//
// The tensor cores' f32 sums round toward zero: with all of a row's 2305
// keys summed in one accumulator, the forward's O drifted 3e-5 of |O| from
// f32 on an H100. So every sum over T (O, dV, dK, dQ) takes each streamed
// tile's product in an accumulator of its own (D = A B on its first
// k-step), which the FP32 units add to the running sum, rounding to
// nearest: within 3e-6 of |O|, the error of one tile.
//
// Forward design: flash_attention.cu's forward (a block of two consumer
// warpgroups of 64 queries in turns, a producer warp filling a ring by TMA,
// a code per key and a flag per tile, setmaxnreg), with what TF32 changes:
//   * S = Q_big K_big + Q_big K_small with both operands in shared memory
//     (Q_big, 128 rows, loaded once) + Q_small K_big with Q_small as A
//     fragments in registers (loaded once; in shared memory beside Q_big at
//     d = 128); P is split in registers into the A fragments of
//     P_big V_big + P_big V_small + P_small V_big (`rs_split`);
//   * a TF32 k-step is 8 elements, 32 bytes, the byte advance of bf16's
//     k16, and a 128-byte swizzle atom holds 32 f32: tiles are stored as
//     column chunks of 32 f32 (16 at d = 48, a 64-byte atom), and V^T's in
//     chunks of 32 keys (d rows of 128 bytes; of 16 keys, 64 bytes, where a
//     tile has 48 or 16 keys);
//   * the budget (`Tf32Tiles`): a consumer thread holds O and the tile's P V
//     (d/2 each), S (S/2), the previous tile's P big and small (S) and
//     Q_small (d/2): S = 64 keys a tile at d = 32 and 48 (at most 168
//     registers), 48 at d = 64 (168; with 64 keys, 192, ptxas spilled 44
//     bytes of the 232 a consumer thread gets), 16 at d = 96 (168); at d =
//     128 Q_small moves to shared memory and S = 16 (152). Shared memory: Q
//     (512 d bytes a part) and per stage four streamed tiles of 4 S d bytes
//     (K big and small, V^T big and small): 4 stages up to d = 96, 3 at 128
//     (with 32 keys a tile at d = 96, 2 stages fit beside Q_small in shared
//     memory, and the loads waited: 0.67 ms at (2, 2305, 8, 96)).
//
// Backward design (`flash_dkv_tf32_sm90_kernel`, `flash_dq_tf32_sm90_kernel`):
// flash_attention.cu's pair (own rows loaded once, a streamed operand
// through a TMA ring of full/empty mbarriers filled by one producer warp,
// the row statistics or key codes copied into each stage by its plain
// loads, every product on wgmma, P and dS from the accumulators straight
// into the next product's A registers, dQ in its own kernel, no atomics),
// with what the split forces:
//   * a stage holds twice what the bf16 pair's does per operand (big and
//     small) at twice the bytes an element, and dK/dV streams Q and dO in
//     both orders: 8 tiles of S rows x d f32, 32 S d bytes (dQ: K, V as they
//     lie and K^T, 24 S d), beside own operands of 4 x 256 d bytes a 64-row
//     warpgroup (K, V or Q, dO, big and small, all in shared memory: SS
//     products, as the forward's S at d = 128). Two warpgroups of 64 own
//     rows each would need 2 KB x d of own operands, which leaves no room
//     for two stages from d = 64 on; so a block owns 64 rows, one consumer
//     warpgroup and one producer warp (160 threads, no setmaxnreg: up to
//     255 registers a thread), and the warpgroup keeps its products in
//     flight beside its own elementwise work (P while dP runs, dS's split
//     while dV runs);
//   * rows of a streamed tile (`BwdTf32Tiles`): dK/dV S = 64 queries at d =
//     32, 32 at 48 and 64, 16 at 96 and 128; dQ 64 keys at 32 and 48, 32 at
//     64, 16 at 96 and 128; as many stages (2 to 4) as fit in 227 KB. At d =
//     128 dK/dV's own operands alone take 128 KB and a stage of its output
//     columns too many, so each block writes half of them (64 columns;
//     D / kDo blocks per 64 keys, each recomputing S^T and dP^T) and streams
//     only those rows of Q^T and dO^T;
//   * registers: dK/dV holds dK, dV and one tile accumulator, used for dV
//     and then for dK (3 d/2), S^T and dP^T (S) and the A fragments of P
//     and dS, big and small (2 S): at most ~190 live values (d = 96); dQ
//     holds dQ, its tile accumulator (d), S, dP and dS's fragments (2 S);
//   * ex2.approx.ftz (2 ulp) for the exponentials, as the bf16 kernels;
//     within f32's accuracy bound here (chip_smoke.py's F32_TOL).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder via the runtime
#include <cuda_runtime.h>

#include "sm90_common.cuh"  // mbarriers, Ring, wgmma wrappers, turns, softmax_tile, the split, 2-D maps

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// Tp: T rounded up to this, a query block. A key tile (48 keys at d = 64)
// may run past Tp: its K rows are the next slice's (or past the buffer,
// zero-filled by TMA), its V^T columns past Tp are zero-filled by TMA, and
// its keys past T are coded out (P = 0).
constexpr int kPad = 128;
constexpr int kSplitRows = 32;  // rows (keys) per block of the pre-pass
constexpr int kSplitThreads = 256;

__host__ __device__ constexpr int64_t padded(int T) { return (T + kPad - 1) / kPad * kPad; }

struct Tf32Params {
  // 2D maps over the scratch: Q_big, Q_small, K_big, K_small as (B H Tp)
  // rows of d f32, boxes of kCols x (128 or S) rows; V^T big and small as
  // (B H d) rows of Tp f32, boxes of kVKeys keys x d rows.
  CUtensorMap qb, qs, kb, ks, vtb, vts;
  const float* q_small;    // the scratch's Q_small, (B H, Tp, d)
  const uint8_t* mask;     // (B, T), 0 = key not attended; null: every key attended
  float* o;                // (B, T, H, d) contiguous
  float *m, *l;            // (B, H, T): row max (base 2) and row sum; null: not saved
  int H, T, Tp;
  float scale_log2;        // sm_scale * log2(e)
};

// The pre-pass's operands: up to four split in row order, up to two in
// transposed order (the same pointer may be in both lists).
struct SplitParams {
  const float* src[4];  // (B, T, H, d) through their strides: the first NR are split by rows
  Strides st[4];
  float *big[4], *small[4];  // (B H, Tp, d)
  const float* tsrc[2];      // (B, T, H, d) through their strides: the NT written transposed
  Strides tst[2];
  float *tbig[2], *tsmall[2];  // (B H, d, Tp), rows of each 8-group in the order [0,2,4,6,1,3,5,7]
  int H, T, Tp;
};

// ---------------------------------------------------------------- pre-pass

// Rows [r0, r0 + kSplitRows) of head h of batch element b: the big and
// small parts of NR operands in row order, and of NT operands transposed
// through a shared tile, each 8-row group in the A fragments' order; zeros
// past T.
template <int D, int NR, int NT>
__global__ void __launch_bounds__(kSplitThreads) flash_split_tf32_kernel(const SplitParams p) {
  __shared__ float tile[NT][kSplitRows][D + 1];
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kSplitRows;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  for (int i = threadIdx.x; i < kSplitRows * D; i += kSplitThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    const int64_t at = (bh * p.Tp + row) * D + c;
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const float x = row < p.T ? p.src[u][b * p.st[u].b + row * p.st[u].t + h * p.st[u].h + c]
                                : 0.f;
      p.big[u][at] = tf32_big(x);
      p.small[u][at] = tf32_small(x);
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      tile[u][r][c] =
          row < p.T ? p.tsrc[u][b * p.tst[u].b + row * p.tst[u].t + h * p.tst[u].h + c] : 0.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSplitRows * D; i += kSplitThreads) {
    const int n = i / kSplitRows, j = i % kSplitRows;
    const int64_t at = (bh * D + n) * p.Tp + r0 + (j & ~7) + ((j & 1) << 2) + ((j >> 1) & 3);
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const float x = tile[u][j][n];
      p.tbig[u][at] = tf32_big(x);
      p.tsmall[u][at] = tf32_small(x);
    }
  }
}

// ---------------------------------------------------------------- forward

// The tiles at head width D: S keys a streamed tile, chunks of kCols f32
// (Q and K) and of kVKeys keys (V^T).
template <int D>
struct Tf32Tiles {
  // Q_small in shared memory beside Q_big (SS products) where its A
  // fragments would not fit in registers beside O and the tile's P V (d =
  // 128); else in registers (an RS product). Keys a tile: as many as the
  // registers hold beside them and the shared memory holds 4 stages of (3
  // at d = 128; see the budget above).
  static constexpr bool kQsShared = D > 96;
  static constexpr int kS = D <= 48 ? 64 : D == 64 ? 48 : 16;
  static constexpr int kCols = D % 32 == 0 ? 32 : 16;  // f32 of a chunk: one 128- or 64-byte atom
  static constexpr int kC2 = 2 * kCols;                // the same in 2-byte units (`sw_desc`)
  static constexpr int kVKeys = kS % 32 == 0 ? 32 : 16;  // keys of a V^T chunk: 128 or 64 bytes
  static constexpr int kQChunk = kHBlock * kCols * 4;  // bytes of a chunk of Q (128 rows)
  static constexpr int kKChunk = kS * kCols * 4;       // ... of a K tile
  static constexpr int kVChunk = D * kVKeys * 4;       // ... of a V^T tile: d rows of kVKeys keys
  static constexpr int kTile = kS * D * 4;             // bytes of one streamed tile
  static constexpr int kOwnBytes = (kQsShared ? 2 : 1) * kHBlock * D * 4;
  static constexpr int kFit = (kMaxSmem - 2048 - kOwnBytes) / (4 * kTile + kS);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // Q_big (and Q_small), then per stage K_big, K_small, V^T_big, V^T_small,
  // then a code per key and stage, a flag per stage, the barriers.
  static constexpr int kRing = kOwnBytes;
  static constexpr int kRowData = kRing + kStages * 4 * kTile;
  static constexpr int kFlags = kRowData + kStages * kS;
  static constexpr int kBars = (kFlags + kStages + 7) / 8 * 8;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024 bytes
  static_assert(kStages >= 2 && kAlloc <= kMaxSmem, "more shared memory than a block can have");
};

// big and small of a 64 x S accumulator tile as TF32 A fragments, one per
// 8-key k-step: the accumulator's keys 2t, 2t + 1 of group n go to slots t,
// t + 4 (V^T's key order).
template <int S>
__device__ __forceinline__ void split_a(uint32_t (&big)[S / 8][4], uint32_t (&small)[S / 8][4],
                                        const float (&acc)[S / 8][4]) {
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8, 2t + 1)
      const float x = acc[n][e == 1 ? 2 : e == 2 ? 1 : e];
      big[n][e] = __float_as_uint(tf32_big(x));
      small[n][e] = __float_as_uint(tf32_small(x));
    }
  }
}

// The split products below sum their two small terms (each ~2^-11 of the
// big one) first and the big term last: the tensor cores round each partial
// sum toward zero, and so only the big term's k-steps round at the sum's
// full magnitude (a third of the k-steps where the three alternate; at d =
// 128 the backward's gradients came within 9.7e-6 of the 1e-5 bound that
// way on an H100, their P and dS moved by S's and dP's roundings).

// D = A B^T in split TF32 over a width of K (8 columns a k-step): A_big
// B_small + A_small B_big, then A_big B_big, A (64 rows) and B (N rows)
// K-major tiles in chunks of C f32 (AChunk, BChunk bytes apart). The
// backward's S (S^T) and dP (dP^T).
template <int N, int K, int C, int AChunk, int BChunk>
__device__ __forceinline__ void ss_split(float (&d)[N / 8][4], uint64_t ab, uint64_t as,
                                         uint64_t bb, uint64_t bs) {
  auto at = [](int kk, int chunk) {
    return static_cast<uint64_t>((8 * kk / C * chunk + 8 * kk % C * 4) >> 4);
  };
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    wgmma_tf32_ss<N>(d, ab + at(kk, AChunk), bs + at(kk, BChunk), kk > 0);
    wgmma_tf32_ss<N>(d, as + at(kk, AChunk), bb + at(kk, BChunk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    wgmma_tf32_ss<N>(d, ab + at(kk, AChunk), bb + at(kk, BChunk), 1);
  }
}

// D = A B in split TF32 over S rows: A (64 x S, an accumulator's P or dS)
// big and small as A fragments (`split_a`), B a transposed tile of N rows
// of S f32 in chunks of VK (BChunk bytes apart), 8 rows (32 bytes) a
// k-step; the small terms first, as `ss_split`. The forward's P V, the
// backward's dV, dK and dQ, each a tile's own sum (D = A B).
template <int N, int S, int VK, int BChunk>
__device__ __forceinline__ void rs_split(float (&d)[N / 8][4], const uint32_t (&ab)[S / 8][4],
                                         const uint32_t (&as)[S / 8][4], uint64_t bb,
                                         uint64_t bs) {
  auto at = [](int kk) {
    return static_cast<uint64_t>((8 * kk / VK * BChunk + 8 * kk % VK * 4) >> 4);
  };
#pragma unroll
  for (int kk = 0; kk < S / 8; ++kk) {
    wgmma_tf32_rs<N>(d, ab[kk], bs + at(kk), kk > 0);
    wgmma_tf32_rs<N>(d, as[kk], bb + at(kk));
  }
#pragma unroll
  for (int kk = 0; kk < S / 8; ++kk) wgmma_tf32_rs<N>(d, ab[kk], bb + at(kk));
}

template <int D>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_fwd_tf32_sm90_kernel(const __grid_constant__ Tf32Params p) {
  using L = Tf32Tiles<D>;
  constexpr int S = L::kS, C = L::kCols, VK = L::kVKeys, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem);  // Q_big (, Q_small): 128 rows in chunks of C columns
  float* ring = reinterpret_cast<float*>(smem + L::kRing);  // [stage][Kb, Ks, Vtb, Vts]
  uint8_t* codes = smem + L::kRowData;  // per stage and key: 0 attended, 1 masked, 2 past T
  uint8_t* coded = smem + L::kFlags;    // per stage: whether any key is not attended
  const Ring<L> bars(smem);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kHBlock, T = p.T;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int n_tiles = (T + S - 1) / S;
  const int bh = b * p.H + h;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (wg == kHConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kHProducerRegs));
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.own, L::kOwnBytes);
#pragma unroll
      for (int c = 0; c < D / C; ++c) {
        tma_2d(sQ + c * kHBlock * C, &p.qb, bars.own, c * C, bh * p.Tp + q0);
        if constexpr (L::kQsShared) {
          tma_2d(sQ + kHBlock * D + c * kHBlock * C, &p.qs, bars.own, c * C, bh * p.Tp + q0);
        }
      }
    }
    const uint8_t* mask = p.mask ? p.mask + static_cast<int64_t>(b) * T : nullptr;
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages, k0 = j * S;
      mbar_wait(&bars.empty[stage], ((j / kStages) & 1) ^ 1);  // round 0 passes
      bool any = false;
      for (int r = lane; r < S; r += 32) {
        const int key = k0 + r;
        const uint8_t c = key >= T ? 2 : (mask != nullptr && mask[key] == 0 ? 1 : 0);
        codes[stage * S + r] = c;
        any |= c != 0;
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) {
        coded[stage] = any;
        float* st = ring + stage * 4 * S * D;
        uint64_t* full = &bars.full[stage];
        mbar_arrive_expect_tx(full, 4 * L::kTile);
#pragma unroll
        for (int c = 0; c < D / C; ++c) {
          tma_2d(st + c * S * C, &p.kb, full, c * C, bh * p.Tp + k0);
          tma_2d(st + S * D + c * S * C, &p.ks, full, c * C, bh * p.Tp + k0);
        }
#pragma unroll
        for (int c = 0; c < S / VK; ++c) {
          tma_2d(st + 2 * S * D + c * D * VK, &p.vtb, full, k0 + VK * c, bh * D);
          tma_2d(st + 3 * S * D + c * D * VK, &p.vts, full, k0 + VK * c, bh * D);
        }
      } else {
        mbar_arrive(&bars.full[stage]);
      }
    }
  } else {  // consumer warpgroup wg: queries q0 + 64 wg ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kHConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * kHRows + warp * 16;  // the warp's 16 queries
    // Q_small as A fragments (none where it is in shared memory): rows g,
    // g + 8 x columns 8 kk + t, 8 kk + t + 4, zero past T as the scratch is.
    uint32_t qs[L::kQsShared ? 1 : D / 8][4];
    if constexpr (!L::kQsShared) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = static_cast<int64_t>(bh) * p.Tp + row0 + g + 8 * (e & 1);
        const float* qrow = p.q_small + row * D + t + 4 * (e >> 1);
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) qs[kk][e] = __float_as_uint(qrow[8 * kk]);
      }
    }
    const uint64_t q_desc = sw_desc<false, L::kC2>(sQ + wg * kHRows * C);
    const uint64_t qs_desc = sw_desc<false, L::kC2>(sQ + kHBlock * D + wg * kHRows * C);
    // O, the running sum in f32 registers; ot, a tile's P V on the tensor
    // cores, added to O with the FP32 units' rounding: the tensor cores'
    // f32 sums round toward zero, and over T = 2305 keys in one accumulator
    // that drift reached 3e-5 of |O| on an H100 (within 3e-6 per tile).
    float o[D / 8][4], ot[D / 8][4];
    zero_acc(o);
    float m_i[2] = {-INFINITY, -INFINITY};  // running row max (base 2), rows g and g + 8
    float l_i[2] = {0.f, 0.f};              // this thread's part of the row sum
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(bars.own, 0);

    float s[S / 8][4];
    uint32_t pb[S / 8][4], ps[S / 8][4];
    float corr[2];
    auto softmax = [&](int stage) {
      if (coded[stage]) {
        softmax_tile<true, S>(s, m_i, l_i, corr, codes + stage * S, t, p.scale_log2);
      } else {
        softmax_tile<false, S>(s, m_i, l_i, corr, nullptr, t, p.scale_log2);
      }
    };
    // S = Q_big K_big + Q_big K_small + Q_small K_big over the stage's keys:
    // k-step kk (8 columns, 32 bytes) in chunk 8 kk / C of both tiles.
    auto s_product = [&](int stage) {
      const float* st = ring + stage * 4 * S * D;
      const uint64_t kb = sw_desc<false, L::kC2>(st), ks = sw_desc<false, L::kC2>(st + S * D);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = 8 * kk / C, in_chunk = 8 * kk % C * 4;
        const uint64_t qa = q_desc + ((c * L::kQChunk + in_chunk) >> 4);
        const uint64_t kof = (c * L::kKChunk + in_chunk) >> 4;
        wgmma_tf32_ss<S>(s, qa, kb + kof, kk > 0);
        wgmma_tf32_ss<S>(s, qa, ks + kof, 1);
        if constexpr (L::kQsShared) {
          wgmma_tf32_ss<S>(s, qs_desc + ((c * L::kQChunk + in_chunk) >> 4), kb + kof, 1);
        } else {
          wgmma_tf32_rs<S>(s, qs[kk], kb + kof);
        }
      }
    };
    // ot = P_big V_big + P_big V_small + P_small V_big with the stage's
    // V^T: k-step kk (8 keys) in chunk 8 kk / VK, 32 bytes a step into its rows.
    auto pv_product = [&](int stage) {
      const float* st = ring + stage * 4 * S * D;
      rs_split<D, S, VK, L::kVChunk>(ot, pb, ps, sw_desc<false, 2 * VK>(st + 2 * S * D),
                                     sw_desc<false, 2 * VK>(st + 3 * S * D));
    };
    // Tile 0: S alone.
    mbar_wait(&bars.full[0], 0);
    turn_wait(wg);
    wgmma_fence();
    s_product(0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(s);
    if constexpr (!L::kQsShared) fence_a(qs);
    softmax(0);  // O is 0: no correction
    split_a<S>(pb, ps, s);
    // Tile j: S of tile j and P V of tile j - 1 in one turn; the softmax of
    // tile j while P V runs.
    for (int j = 1; j < n_tiles; ++j) {
      const int stage = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(&bars.full[stage], (j / kStages) & 1);
      fence_acc(ot);
      turn_wait(wg);
      wgmma_fence();
      s_product(stage);
      wgmma_commit();
      pv_product(prev);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      fence_acc(s);
      if constexpr (!L::kQsShared) fence_a(qs);
      softmax(stage);
      wgmma_wait<0>();
      fence_acc(ot);
      fence_a(pb);
      fence_a(ps);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.empty[prev]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = (o[n][e] + ot[n][e]) * corr[e >> 1];
      split_a<S>(pb, ps, s);
    }
    // P V of the last tile.
    const int last = (n_tiles - 1) % kStages;
    fence_acc(ot);
    turn_wait(wg);
    wgmma_fence();
    pv_product(last);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(ot);
    fence_a(pb);
    fence_a(ps);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[last]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += ot[n][e];
    if (wg == 0) turn_wait(wg);  // the other warpgroup's last pass
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    }
    // Rows past T (zero in Q_big and Q_small) are computed and never stored.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= T) continue;
      const float rl = 1.f / l_i[r];
      float* dst = p.o + ((static_cast<int64_t>(b) * T + row) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(dst + n * 8 + 2 * t) =
            make_float2(o[n][2 * r] * rl, o[n][2 * r + 1] * rl);
      }
      if (p.m != nullptr && t == 0) {
        const int64_t i = static_cast<int64_t>(bh) * T + row;
        p.m[i] = m_i[r];
        p.l[i] = l_i[r];
      }
    }
  }
}

// ---------------------------------------------------------------- backward

constexpr int kBwdRows = 64;              // own rows a block: its consumer warpgroup's
constexpr int kBwdThreads = 128 + 32;     // the consumer warpgroup, then the producer warp
constexpr int kBwdProducerWarp = 4;

// A backward kernel's tiles at head width D: S rows a streamed tile, Do
// output columns a block (D / Do blocks per 64 own rows), four own
// operands of 64 rows and four streamed ones in row order (chunks of kCols
// f32), NT transposed ones of Do rows of S f32 (chunks of kVK), RowBytes of
// row data per streamed row; as many stages (up to 4) as fit.
template <int D, int S, int Do, int NT, int RowBytes>
struct BwdTf32Tiles {
  static constexpr int kS = S;
  static constexpr int kDo = Do;
  static constexpr int kSplit = D / Do;
  static constexpr int kCols = D % 32 == 0 ? 32 : 16;
  static constexpr int kC2 = 2 * kCols;         // kCols in 2-byte units (`sw_desc`)
  static constexpr int kVK = S % 32 == 0 ? 32 : 16;
  static constexpr int kOwnChunk = kBwdRows * kCols * 4;  // bytes of a chunk of an own operand
  static constexpr int kRowChunk = S * kCols * 4;         // ... of a streamed row tile
  static constexpr int kTChunk = Do * kVK * 4;            // ... of a transposed tile
  static constexpr int kOwnTile = kBwdRows * D * 4;       // bytes of an own operand
  static constexpr int kStage = 4 * S * D * 4 + NT * Do * S * 4;  // bytes of a stage's tiles
  static constexpr int kFit = (kMaxSmem - 2048 - 4 * kOwnTile) / (kStage + RowBytes * S);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kRing = 4 * kOwnTile;
  static constexpr int kRowData = kRing + kStages * kStage;
  static constexpr int kBars = (kRowData + kStages * RowBytes * S + 7) / 8 * 8;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024 bytes
  static_assert(kStages >= 2 && kAlloc <= kMaxSmem, "more shared memory than a block can have");
};
// dK/dV: own K, V; streamed Q, dO as they lie and Q^T, dO^T; m, 1/l, di per query.
template <int D>
using DkvTf32Tiles = BwdTf32Tiles<D, D == 32 ? 64 : D <= 64 ? 32 : 16, D == 128 ? 64 : D, 4, 12>;
// dQ: own Q, dO; streamed K, V as they lie and K^T; a code byte per key.
template <int D>
using DqTf32Tiles = BwdTf32Tiles<D, D <= 48 ? 64 : D == 64 ? 32 : 16, D, 2, 1>;

struct BwdTf32Params {
  // 2D maps over the scratch: own (boxes of kCols x 64 rows), streamed in
  // row order (kCols x S) and transposed (kVK x Do); big, small in turn.
  // dK/dV: own K, V; row Q, dO; transposed Q^T, dO^T. dQ: own Q, dO; row K,
  // V; transposed K^T.
  CUtensorMap own[4], row[4], tr[4];
  const uint8_t* mask;        // (B, T), 0 = key not attended; null: every key attended
  const float *m, *l, *di;    // (B, H, T): row max (base 2), row sum, rowsum(dO o O)
  float *out0, *out1;         // (B, T, H, d) contiguous: dK and dV, or dQ
  int H, T, Tp;
  float scale, scale_log2;    // sm_scale, sm_scale * log2(e)
};

// Rows g and g + 8 of the warp's 16 (row0 + ...) of a 64 x N accumulator,
// times `mul`, into columns [col, col + N) of (B, T, H, D) f32; rows past T
// are skipped.
template <int N, int D>
__device__ __forceinline__ void store_rows_f32(float* out, const float (&acc)[N / 8][4], float mul,
                                               int T, int H, int b, int h, int row0, int col,
                                               int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    float* dst = out + ((static_cast<int64_t>(b) * T + row) * H + h) * D + col;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

template <int N>
__device__ __forceinline__ void add_acc(float (&sum)[N / 8][4], const float (&tile)[N / 8][4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] += tile[n][e];
}

// The own operands (4 x 64 rows from row `row` of the scratch's rows) onto
// the own barrier.
template <int D, typename L>
__device__ __forceinline__ void load_own(float* own, const BwdTf32Params& p, uint64_t* bar,
                                         int row) {
  constexpr int C = L::kCols;
  mbar_arrive_expect_tx(bar, 4 * L::kOwnTile);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / C; ++c) {
      tma_2d(own + (a * D + c * C) * kBwdRows, &p.own[a], bar, c * C, row);
    }
}

// A stage's tiles: the four row-order tiles (rows [row, row + S) of the
// scratch's rows), then NT transposed ones (columns [col, col + S) of rows
// [trow, trow + Do)), onto the stage's full barrier.
template <int D, int NT, typename L>
__device__ __forceinline__ void load_stage(float* tile, const BwdTf32Params& p, uint64_t* full,
                                           int row, int col, int trow) {
  constexpr int S = L::kS, C = L::kCols, VK = L::kVK, Do = L::kDo;
  mbar_arrive_expect_tx(full, L::kStage);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / C; ++c) tma_2d(tile + (a * D + c * C) * S, &p.row[a], full, c * C, row);
  float* tt = tile + 4 * S * D;
#pragma unroll
  for (int a = 0; a < NT; ++a)
#pragma unroll
    for (int c = 0; c < S / VK; ++c) {
      tma_2d(tt + (a * S + c * VK) * Do, &p.tr[a], full, col + c * VK, trow);
    }
}

// dK and dV of 64 keys (columns [col0, col0 + Do) of them), streaming the
// queries in tiles of S: per tile S^T = K Q^T and dP^T = V dO^T (SS, split),
// P^T = exp2(S^T s log2 e - m) / l (while dP^T runs), dS^T = P^T o (dP^T -
// di) (0 at masked keys), then dV += P^T dO (dO^T the B tile) and dK += dS^T
// Q (Q^T), each a tile sum added by the FP32 units; dK scaled by s at the end.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_tf32_sm90_kernel(const __grid_constant__ BwdTf32Params p) {
  using L = DkvTf32Tiles<D>;
  constexpr int S = L::kS, C = L::kCols, VK = L::kVK, Do = L::kDo, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* own = reinterpret_cast<float*>(smem);  // K_b, K_s, V_b, V_s: 64 rows in chunks of C
  // [stage][Q_b, Q_s, dO_b, dO_s (S rows, chunks of C);
  //        Q^T_b, Q^T_s, dO^T_b, dO^T_s (Do rows, chunks of VK)]
  float* ring = reinterpret_cast<float*>(smem + L::kRing);
  float* rows = reinterpret_cast<float*>(smem + L::kRowData);  // [stage][m, 1/l, di][S]
  const Ring<L, 4> bars(smem);

  const int b = blockIdx.z, h = blockIdx.y, T = p.T;
  const int n0 = blockIdx.x / L::kSplit * kBwdRows, col0 = blockIdx.x % L::kSplit * Do;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = b * p.H + h;
  const int m_tiles = (T + S - 1) / S;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (warp == kBwdProducerWarp) {
    if (lane == 0) load_own<D, L>(own, p, bars.own, bh * p.Tp + n0);
    const int64_t stat0 = static_cast<int64_t>(bh) * T;
    for (int i = 0; i < m_tiles; ++i) {
      const int stage = i % kStages, q0 = i * S;
      mbar_wait(&bars.empty[stage], ((i / kStages) & 1) ^ 1);  // round 0 passes
      // Queries past T get P = exp2(x - inf) * 0 = 0 and dS = 0.
      float* st = rows + stage * 3 * S;
      for (int r = lane; r < S; r += 32) {
        const int q = q0 + r;
        const bool valid = q < T;
        const float mv = valid ? p.m[stat0 + q] : INFINITY;
        const float lv = valid ? p.l[stat0 + q] : INFINITY;
        const float dv = valid ? p.di[stat0 + q] : 0.f;
        st[r] = mv;
        st[S + r] = __frcp_rn(lv);  // 1/inf = 0
        st[2 * S + r] = dv;
      }
      if (lane == 0) {
        load_stage<D, 4, L>(ring + stage * (L::kStage / 4), p, &bars.full[stage], bh * p.Tp + q0,
                            q0, bh * D + col0);
      } else {
        mbar_arrive(&bars.full[stage]);
      }
    }
    return;
  }
  // The consumer warpgroup: keys n0 ..
  const int g = lane >> 2, t = lane & 3;
  const int row0 = n0 + warp * 16;  // the warp's 16 keys
  bool key_masked[2];  // rows g and g + 8: masked keys take no dS
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = row0 + g + 8 * r;
    key_masked[r] = p.mask != nullptr && key < T && p.mask[static_cast<int64_t>(b) * T + key] == 0;
  }
  const uint64_t kb = sw_desc<false, L::kC2>(own), ks = sw_desc<false, L::kC2>(own + kBwdRows * D);
  const uint64_t vb = sw_desc<false, L::kC2>(own + 2 * kBwdRows * D);
  const uint64_t vs = sw_desc<false, L::kC2>(own + 3 * kBwdRows * D);
  // dK, dV: the running sums in f32 registers; acc: a tile's dV, then its dK.
  float dk[Do / 8][4], dv[Do / 8][4], acc[Do / 8][4];
  zero_acc(dk);
  zero_acc(dv);
  mbar_wait(bars.own, 0);

  for (int i = 0; i < m_tiles; ++i) {
    const int stage = i % kStages;
    mbar_wait(&bars.full[stage], (i / kStages) & 1);
    const float* tile = ring + stage * (L::kStage / 4);
    const float* tt = tile + 4 * S * D;
    const float* st = rows + stage * 3 * S;

    // S^T = K Q^T and dP^T = V dO^T over the 64 keys and the tile's S queries.
    float s[S / 8][4], dp[S / 8][4];
    wgmma_fence();
    ss_split<S, D, C, L::kOwnChunk, L::kRowChunk>(s, kb, ks, sw_desc<false, L::kC2>(tile),
                                                  sw_desc<false, L::kC2>(tile + S * D));
    wgmma_commit();
    ss_split<S, D, C, L::kOwnChunk, L::kRowChunk>(dp, vb, vs,
                                                  sw_desc<false, L::kC2>(tile + 2 * S * D),
                                                  sw_desc<false, L::kC2>(tile + 3 * S * D));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(s);
    // P^T = exp2(S^T s log2 e - m) / l while dP^T runs; a masked key's
    // logit is bf16's lowest finite value (P = 1/T on an all-masked row).
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      const int q2 = n * 8 + 2 * t;  // queries q2, q2 + 1
      const float2 m2 = *reinterpret_cast<const float2*>(st + q2);
      const float2 rl2 = *reinterpret_cast<const float2*>(st + S + q2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = e & 1 ? m2.y : m2.x, rl = e & 1 ? rl2.y : rl2.x;
        const float x = key_masked[e >> 1] ? kMasked - m : fmaf(s[n][e], p.scale_log2, -m);
        s[n][e] = exp2_approx(x) * rl;
      }
    }
    wgmma_wait<0>();
    fence_acc(dp);
    // dS^T = P^T o (dP^T - di), 0 at masked keys.
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      const float2 di2 = *reinterpret_cast<const float2*>(st + 2 * S + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float di = e & 1 ? di2.y : di2.x;
        dp[n][e] = key_masked[e >> 1] ? 0.f : s[n][e] * (dp[n][e] - di);
      }
    }
    // This tile's dV = P^T dO (B: dO^T), split into TF32 parts while it runs dS^T.
    uint32_t pb[S / 8][4], ps[S / 8][4], db[S / 8][4], ds[S / 8][4];
    split_a<S>(pb, ps, s);
    fence_acc(acc);
    wgmma_fence();
    rs_split<Do, S, VK, L::kTChunk>(acc, pb, ps, sw_desc<false, 2 * VK>(tt + 2 * S * Do),
                                    sw_desc<false, 2 * VK>(tt + 3 * S * Do));
    wgmma_commit();
    split_a<S>(db, ds, dp);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_a(pb);
    fence_a(ps);
    add_acc<Do>(dv, acc);
    // This tile's dK = dS^T Q (B: Q^T).
    fence_acc(acc);
    wgmma_fence();
    rs_split<Do, S, VK, L::kTChunk>(acc, db, ds, sw_desc<false, 2 * VK>(tt),
                                    sw_desc<false, 2 * VK>(tt + S * Do));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_a(db);
    fence_a(ds);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[stage]);
    add_acc<Do>(dk, acc);
  }
  // Keys past T (zero rows of K and V) are computed and never stored.
  store_rows_f32<Do, D>(p.out0, dk, p.scale, T, p.H, b, h, row0, col0, g, t);
  store_rows_f32<Do, D>(p.out1, dv, 1.f, T, p.H, b, h, row0, col0, g, t);
}

// dQ of 64 queries, streaming the keys in tiles of S: per tile S = Q K^T and
// dP = dO V^T (SS, split), P = exp2(S s log2 e - m) / l (0 at masked keys
// and past T; while dP runs), dS = P o (dP - di), then dQ += dS K (K^T the B
// tile), a tile sum added by the FP32 units; scaled by s at the end.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_tf32_sm90_kernel(const __grid_constant__ BwdTf32Params p) {
  using L = DqTf32Tiles<D>;
  constexpr int S = L::kS, C = L::kCols, VK = L::kVK, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* own = reinterpret_cast<float*>(smem);  // Q_b, Q_s, dO_b, dO_s: 64 rows in chunks of C
  // [stage][K_b, K_s, V_b, V_s (S rows, chunks of C); K^T_b, K^T_s (D rows, chunks of VK)]
  float* ring = reinterpret_cast<float*>(smem + L::kRing);
  uint8_t* codes = smem + L::kRowData;  // per stage and key: 0 attended, 1 masked, 2 past T
  const Ring<L, 4> bars(smem);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBwdRows, T = p.T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = b * p.H + h;
  const int n_tiles = (T + S - 1) / S;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (warp == kBwdProducerWarp) {
    if (lane == 0) load_own<D, L>(own, p, bars.own, bh * p.Tp + q0);
    const uint8_t* mask = p.mask ? p.mask + static_cast<int64_t>(b) * T : nullptr;
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages, k0 = j * S;
      mbar_wait(&bars.empty[stage], ((j / kStages) & 1) ^ 1);  // round 0 passes
      for (int r = lane; r < S; r += 32) {
        const int key = k0 + r;
        codes[stage * S + r] = key >= T ? 2 : (mask != nullptr && mask[key] == 0 ? 1 : 0);
      }
      if (lane == 0) {
        load_stage<D, 2, L>(ring + stage * (L::kStage / 4), p, &bars.full[stage], bh * p.Tp + k0,
                            k0, bh * D);
      } else {
        mbar_arrive(&bars.full[stage]);
      }
    }
    return;
  }
  // The consumer warpgroup: queries q0 ..
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // the warp's 16 queries
  float m_r[2], rl_r[2], di_r[2];   // rows g and g + 8; rows past T get P = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const int64_t i = static_cast<int64_t>(bh) * T + row;
    const bool valid = row < T;
    m_r[r] = valid ? p.m[i] : INFINITY;
    rl_r[r] = valid ? __frcp_rn(p.l[i]) : 0.f;
    di_r[r] = valid ? p.di[i] : 0.f;
  }
  const uint64_t qb = sw_desc<false, L::kC2>(own), qs = sw_desc<false, L::kC2>(own + kBwdRows * D);
  const uint64_t ob = sw_desc<false, L::kC2>(own + 2 * kBwdRows * D);
  const uint64_t os = sw_desc<false, L::kC2>(own + 3 * kBwdRows * D);
  float dq[D / 8][4], acc[D / 8][4];  // the running sum; a tile's dS K
  zero_acc(dq);
  mbar_wait(bars.own, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    mbar_wait(&bars.full[stage], (j / kStages) & 1);
    const float* tile = ring + stage * (L::kStage / 4);
    const uint8_t* code = codes + stage * S;

    // S = Q K^T and dP = dO V^T over the 64 queries and the tile's S keys.
    float s[S / 8][4], dp[S / 8][4];
    wgmma_fence();
    ss_split<S, D, C, L::kOwnChunk, L::kRowChunk>(s, qb, qs, sw_desc<false, L::kC2>(tile),
                                                  sw_desc<false, L::kC2>(tile + S * D));
    wgmma_commit();
    ss_split<S, D, C, L::kOwnChunk, L::kRowChunk>(dp, ob, os,
                                                  sw_desc<false, L::kC2>(tile + 2 * S * D),
                                                  sw_desc<false, L::kC2>(tile + 3 * S * D));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(s);
    // P while dP runs: 0 at masked keys (their dS is 0) and past T.
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      const uint32_t kc = *reinterpret_cast<const uint16_t*>(code + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[n][e], p.scale_log2, -m_r[e >> 1]);
        s[n][e] = (kc >> (8 * (e & 1))) & 0xff ? 0.f : exp2_approx(x) * rl_r[e >> 1];
      }
    }
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int n = 0; n < S / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - di_r[e >> 1];  // dS
    // This tile's dQ = dS K (B: K^T).
    uint32_t db[S / 8][4], ds[S / 8][4];
    split_a<S>(db, ds, s);
    fence_acc(acc);
    wgmma_fence();
    rs_split<D, S, VK, L::kTChunk>(acc, db, ds, sw_desc<false, 2 * VK>(tile + 4 * S * D),
                                   sw_desc<false, 2 * VK>(tile + 4 * S * D + D * S));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_a(db);
    fence_a(ds);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[stage]);
    add_acc<D>(dq, acc);
  }
  store_rows_f32<D, D>(p.out0, dq, p.scale, T, p.H, b, h, row0, 0, g, t);
}

// The forward's arguments.
struct Tf32Call {
  const float *q, *k, *v;
  const uint8_t* mask;
  float *o, *m, *l;
  int B, H, T;
  const int64_t* strides;
  float sm_scale;
  cudaStream_t stream;
  float* scratch;
};

// Operand i (q, k, v, dO) of the 12 strides.
Strides strides_of(const int64_t* strides, int i) {
  return {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <int D>
int launch_tf32(const Tf32Call& a) {
  using L = Tf32Tiles<D>;
  const int B = a.B, H = a.H, T = a.T;
  float* scratch = a.scratch;
  const int64_t Tp = padded(T), n = static_cast<int64_t>(B) * H * Tp * D;
  // Q_big, Q_small, K_big, K_small in row order, then V^T_big, V^T_small.
  SplitParams sp{};
  const float* rows_of[2] = {a.q, a.k};
  for (int u = 0; u < 2; ++u) {
    sp.src[u] = rows_of[u];
    sp.st[u] = strides_of(a.strides, u);
    sp.big[u] = scratch + 2 * u * n;
    sp.small[u] = scratch + (2 * u + 1) * n;
  }
  sp.tsrc[0] = a.v;
  sp.tst[0] = strides_of(a.strides, 2);
  sp.tbig[0] = scratch + 4 * n;
  sp.tsmall[0] = scratch + 5 * n;
  sp.H = H;
  sp.T = T;
  sp.Tp = static_cast<int>(Tp);

  Tf32Params p{};
  const int64_t rows = static_cast<int64_t>(B) * H * Tp, vrows = static_cast<int64_t>(B) * H * D;
  int err = make_map_2d(&p.qb, sp.big[0], D, rows, L::kCols, kHBlock);
  if (!err) err = make_map_2d(&p.qs, sp.small[0], D, rows, L::kCols, kHBlock);
  if (!err) err = make_map_2d(&p.kb, sp.big[1], D, rows, L::kCols, L::kS);
  if (!err) err = make_map_2d(&p.ks, sp.small[1], D, rows, L::kCols, L::kS);
  if (!err) err = make_map_2d(&p.vtb, sp.tbig[0], Tp, vrows, L::kVKeys, D);
  if (!err) err = make_map_2d(&p.vts, sp.tsmall[0], Tp, vrows, L::kVKeys, D);
  if (err) return -err;
  p.q_small = sp.small[0];
  p.mask = a.mask;
  p.o = a.o;
  p.m = a.m;
  p.l = a.l;
  p.H = H;
  p.T = T;
  p.Tp = sp.Tp;
  p.scale_log2 = a.sm_scale * kLog2e;

  static const cudaError_t configured = cudaFuncSetAttribute(
      &flash_fwd_tf32_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  flash_split_tf32_kernel<D, 2, 1><<<dim3(Tp / kSplitRows, H, B), kSplitThreads, 0, a.stream>>>(sp);
  const cudaError_t split = cudaGetLastError();
  if (split != cudaSuccess) return static_cast<int>(split);
  flash_fwd_tf32_sm90_kernel<D><<<dim3(Tp / kHBlock, H, B), kHThreads, L::kAlloc, a.stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The backward entry points' arguments: out0, out1 are dK, dV or dQ, null.
struct BwdTf32Call {
  const float *q, *k, *v, *dout;
  const uint8_t* mask;
  const float *m, *l, *di;
  float *out0, *out1;
  int B, H, T;
  const int64_t* strides;
  float sm_scale;
  cudaStream_t stream;
  float* scratch;
};

// The pre-pass and dK/dV (Dkv) or dQ at head width D. The scratch: the big
// and small parts of Q, K, V, dO in row order (8 arrays of (B H, Tp, D)),
// then transposed those of Q and dO (dK/dV) or of K (dQ).
template <int D, bool Dkv>
int launch_bwd_tf32(const BwdTf32Call& a) {
  using L = std::conditional_t<Dkv, DkvTf32Tiles<D>, DqTf32Tiles<D>>;
  constexpr int NT = Dkv ? 2 : 1;
  const int B = a.B, H = a.H, T = a.T;
  float* scratch = a.scratch;
  const int64_t Tp = padded(T), n = static_cast<int64_t>(B) * H * Tp * D;
  SplitParams sp{};
  const float* srcs[4] = {a.q, a.k, a.v, a.dout};
  for (int u = 0; u < 4; ++u) {
    sp.src[u] = srcs[u];
    sp.st[u] = strides_of(a.strides, u);
    sp.big[u] = scratch + 2 * u * n;
    sp.small[u] = scratch + (2 * u + 1) * n;
  }
  const int transposed[2] = {Dkv ? 0 : 1, 3};  // dK/dV: Q, dO; dQ: K
  for (int u = 0; u < NT; ++u) {
    sp.tsrc[u] = srcs[transposed[u]];
    sp.tst[u] = sp.st[transposed[u]];
    sp.tbig[u] = scratch + (8 + 2 * u) * n;
    sp.tsmall[u] = scratch + (9 + 2 * u) * n;
  }
  sp.H = H;
  sp.T = T;
  sp.Tp = static_cast<int>(Tp);

  BwdTf32Params p{};
  const int64_t rows = static_cast<int64_t>(B) * H * Tp, trows = static_cast<int64_t>(B) * H * D;
  // dK/dV owns K, V and streams Q, dO; dQ owns Q, dO and streams K, V.
  const int own[2] = {Dkv ? 1 : 0, Dkv ? 2 : 3}, streamed[2] = {Dkv ? 0 : 1, Dkv ? 3 : 2};
  int err = 0;
  for (int u = 0; u < 4 && !err; ++u) {
    const int part = u % 2;
    err = make_map_2d(&p.own[u], scratch + (2 * own[u / 2] + part) * n, D, rows, L::kCols,
                      kBwdRows);
    if (!err) {
      err = make_map_2d(&p.row[u], scratch + (2 * streamed[u / 2] + part) * n, D, rows, L::kCols,
                        L::kS);
    }
  }
  for (int u = 0; u < 2 * NT && !err; ++u) {
    err = make_map_2d(&p.tr[u], scratch + (8 + u) * n, Tp, trows, L::kVK, L::kDo);
  }
  if (err) return -err;
  p.mask = a.mask;
  p.m = a.m;
  p.l = a.l;
  p.di = a.di;
  p.out0 = a.out0;
  p.out1 = a.out1;
  p.H = H;
  p.T = T;
  p.Tp = sp.Tp;
  p.scale = a.sm_scale;
  p.scale_log2 = a.sm_scale * kLog2e;

  void (*kernel)(BwdTf32Params) = nullptr;
  if constexpr (Dkv) {
    kernel = &flash_dkv_tf32_sm90_kernel<D>;
  } else {
    kernel = &flash_dq_tf32_sm90_kernel<D>;
  }
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 split_grid(Tp / kSplitRows, H, B);
  flash_split_tf32_kernel<D, 4, NT><<<split_grid, kSplitThreads, 0, a.stream>>>(sp);
  const cudaError_t split = cudaGetLastError();
  if (split != cudaSuccess) return static_cast<int>(split);
  kernel<<<dim3(Tp / kBwdRows * L::kSplit, H, B), kBwdThreads, L::kAlloc, a.stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool Dkv>
int dispatch_bwd_tf32(const BwdTf32Call& a, int D) {
  switch (D) {
    case 32: return launch_bwd_tf32<32, Dkv>(a);
    case 48: return launch_bwd_tf32<48, Dkv>(a);
    case 64: return launch_bwd_tf32<64, Dkv>(a);
    case 96: return launch_bwd_tf32<96, Dkv>(a);
    case 128: return launch_bwd_tf32<128, Dkv>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// f32 (B, T, H, D) q, k, v with D in {32, 48, 64, 96, 128}, read through
// `strides` (flash_attention.cu's 12 element strides; dO's unused), unit
// stride along D; mask: (B, T) bytes, 0 = key not attended, or null; O:
// (B, T, H, D) f32 contiguous; m, l: (B, H, T) f32, written unless null;
// scratch: flash_attention_forward_tf32_scratch(B, H, T, D) f32, 16-byte
// aligned, for the split operands. Every pointer on the device of `stream`.
// Launches the pre-pass and the forward; returns cudaGetLastError() after
// them, cudaErrorInvalidValue (1) for a head width it does not take, or
// minus the CUresult of a tensor map that cannot be encoded.
extern "C" int flash_attention_forward_tf32(const void* q, const void* k, const void* v,
                                            const uint8_t* mask, void* o, float* m, float* l,
                                            int B, int H, int T, int D, const int64_t* strides,
                                            float sm_scale, void* stream, float* scratch) {
  const Tf32Call a{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), mask, static_cast<float*>(o), m, l, B, H, T,
                   strides, sm_scale, static_cast<cudaStream_t>(stream), scratch};
  switch (D) {
    case 32: return launch_tf32<32>(a);
    case 48: return launch_tf32<48>(a);
    case 64: return launch_tf32<64>(a);
    case 96: return launch_tf32<96>(a);
    case 128: return launch_tf32<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32 elements of the forward's scratch at (B, H, T, D): Q_big, Q_small,
// K_big, K_small, V^T_big and V^T_small, T padded to a multiple of 128.
extern "C" int64_t flash_attention_forward_tf32_scratch(int B, int H, int T, int D) {
  return 6 * static_cast<int64_t>(B) * H * padded(T) * D;
}

// The backward pair for f32 operands, on the split-TF32 forward's m (base
// 2) and l: the arguments of flash_attention.cu's backward entry points
// with f32 for bf16 (q, k, v, dO through `strides`; dK, dV, dQ (B, T, H, D)
// f32 contiguous; m, l, di (B, H, T) f32), and scratch:
// flash_attention_backward_tf32_scratch(B, H, T, D) f32, 16-byte aligned,
// for the split operands. Each launches its pre-pass and its kernel and
// returns as flash_attention_forward_tf32 does.
extern "C" int flash_attention_backward_dkv_tf32(const void* q, const void* k, const void* v,
                                                 const uint8_t* mask, const void* dout,
                                                 const float* m, const float* l, const float* di,
                                                 void* dk, void* dv, int B, int H, int T, int D,
                                                 const int64_t* strides, float sm_scale,
                                                 void* stream, float* scratch) {
  const BwdTf32Call a{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const float*>(dout), mask, m, l,
                      di, static_cast<float*>(dk), static_cast<float*>(dv), B, H, T, strides,
                      sm_scale, static_cast<cudaStream_t>(stream), scratch};
  return dispatch_bwd_tf32<true>(a, D);
}

extern "C" int flash_attention_backward_dq_tf32(const void* q, const void* k, const void* v,
                                                const uint8_t* mask, const void* dout,
                                                const float* m, const float* l, const float* di,
                                                void* dq, int B, int H, int T, int D,
                                                const int64_t* strides, float sm_scale,
                                                void* stream, float* scratch) {
  const BwdTf32Call a{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const float*>(dout), mask, m, l,
                      di, static_cast<float*>(dq), nullptr, B, H, T, strides, sm_scale,
                      static_cast<cudaStream_t>(stream), scratch};
  return dispatch_bwd_tf32<false>(a, D);
}

// f32 elements of either backward kernel's scratch at (B, H, T, D): the
// big and small parts of Q, K, V, dO in row order and of two operands
// transposed, T padded to a multiple of 128.
extern "C" int64_t flash_attention_backward_tf32_scratch(int B, int H, int T, int D) {
  return 12 * static_cast<int64_t>(B) * H * padded(T) * D;
}
