// The flash-attention forward for f32 operands on Hopper (sm_90a): its
// products on the tensor cores in split TF32, so the result keeps f32's
// accuracy, at every head width d in {32, 48, 64, 96, 128}.
//
// Replaces, for f32 operands, the stock Pallas TPU kernel that
// mvropose_tpu/ops/attention.py::fused_self_attention calls at T >= 2048 (a
// TPU runs it in the operands' own dtype, f32 included):
// _flash_attention_kernel, jax/experimental/pallas/ops/tpu/flash_attention.py
// :331 in jax 0.9.0 (pallas_call :758). Its backward stays the f32-arithmetic
// pair of flash_attention_simt.cu, which reads the m and l saved here.
//
// What it computes is flash_attention.cu's forward, with every operand, the
// probabilities and the sums in f32: S = sm_scale Q K^T in base 2 (times
// log2(e)), masked keys at bf16's lowest finite value (so a row whose keys
// are all masked averages V over its T real keys), keys past T skipped, O =
// (sum_j exp2(S_j - m) V_j) / l with m the row max (base 2) and l the row
// sum, both saved apart (ops/attention.py::flash_forward_plain in plain torch).
//
// The split. A TF32 operand keeps 10 of f32's 23 mantissa bits. Each operand
// x is written as big + small, big = x with its low 13 mantissa bits cleared
// and small = x - big (exact in f32) with its own low 13 bits cleared: both
// exact TF32 values, so nothing depends on what the tensor cores do with the
// bits they ignore. A product becomes three TF32 products,
// a b ~ a_big b_big + a_big b_small + a_small b_big, accumulated in f32:
// each drops at most ~2^-20 of |a b| (the cleared bits of the smalls and
// a_small b_small), where one TF32 product drops ~2^-10. (CUTLASS's
// OpMultiplyAddFastF32 rests on the same idea; this kernel calls none of it.)
//
// What bounds it on an H100: three TF32 products per f32 product, 2 x 3 x 2 B
// H T^2 d FLOPs at the card's 495 TFLOP/s of dense TF32 (half bf16's rate),
// and the B H T^2 exponentials on the SFU beside them: at (2, 2305, 12, 64)
// 0.198 ms of products and 0.031 ms of exponentials, against 0.487 ms for
// the same work at the CUDA cores' f32 rate.
//
// Design: flash_attention.cu's forward (a block of two consumer warpgroups
// of 64 queries in turns, a producer warp filling a ring by TMA, a code per
// key and a flag per tile, setmaxnreg), with what TF32 changes:
//   * TF32 wgmma reads its shared operands K-major only: 32-bit types have
//     no transpose bit. S = Q K^T is K-major as it lies (d contiguous in Q
//     and K), but P V needs V^T, keys contiguous. And each operand comes
//     twice, big and small. So a pre-pass kernel (`flash_split_tf32_kernel`,
//     part of the forward, launched by the same entry point) writes, from
//     q, k, v read through their strides, into one scratch buffer the
//     wrapper allocates: Q_big, Q_small, K_big, K_small (B H, Tp, d) and
//     V^T_big, V^T_small (B H, d, Tp), T padded to Tp (a multiple of kPad
//     rows) with zeros: at (2, 2305, 12, 64) 42 MB read, 90 MB written;
//   * P is the A operand of P V in registers. Its accumulator holds keys 2t
//     and 2t + 1 of each 8-key group (t = lane % 4), where a TF32 A fragment
//     holds k-columns t and t + 4; so each register goes to the A slot as it
//     is, and the pre-pass writes each 8-key group of V^T in the key order
//     [0, 2, 4, 6, 1, 3, 5, 7] (key j at slot (j & 1) * 4 + j / 2): slot t
//     holds key 2t, slot t + 4 key 2t + 1, and the sum over keys does not
//     care about their order;
//   * S = Q_big K_big + Q_big K_small with both operands in shared memory
//     (Q_big, 128 rows, loaded once) + Q_small K_big with Q_small as A
//     fragments in registers (loaded once; in shared memory beside Q_big at
//     d = 128); P is split in registers into the A fragments of
//     P_big V_big + P_big V_small + P_small V_big;
//   * the tensor cores' f32 sums round toward zero: with all of a row's
//     2305 keys summed in one accumulator, O drifted 3e-5 of |O| from f32 on
//     an H100. So each tile's P V goes to an accumulator of its own (D = A B
//     on its first product), which the FP32 units add to O, rounding to
//     nearest: within 3e-6 of |O|, the error of one tile;
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
//     memory, and the loads waited: 0.67 ms at (2, 2305, 8, 96));
//   * ex2.approx.ftz (2 ulp) for the exponentials, as the bf16 forward;
//     within f32's accuracy bound here (chip_smoke.py's SIMT_TOL).

#include <cmath>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder via the runtime
#include <cuda_runtime.h>

#include "sm90_common.cuh"  // mbarriers, Ring, wgmma wrappers, turns, softmax_tile

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

// x with its low 13 mantissa bits cleared: an exact TF32 value.
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// The rest of x, itself cleared to TF32: x - tf32_big(x) is exact in f32.
__device__ __forceinline__ float tf32_small(float x) { return tf32_big(x - tf32_big(x)); }

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

struct SplitParams {
  const float *q, *k, *v;  // (B, T, H, d) through their strides
  Strides sq, sk, sv;
  float *qb, *qs, *kb, *ks;  // (B H, Tp, d)
  float *vtb, *vts;        // (B H, d, Tp), keys of each 8-group in the order [0,2,4,6,1,3,5,7]
  int H, T, Tp;
};

// ---------------------------------------------------------------- pre-pass

// Rows [r0, r0 + kSplitRows) of head h of batch element b: Q_big, Q_small,
// K_big and K_small in row order, V^T big and small through a shared tile, each 8-key
// group in the A fragments' order; zeros past T.
template <int D>
__global__ void __launch_bounds__(kSplitThreads) flash_split_tf32_kernel(const SplitParams p) {
  __shared__ float tile[kSplitRows][D + 1];
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kSplitRows;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  for (int i = threadIdx.x; i < kSplitRows * D; i += kSplitThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (row < p.T) {
      qv = p.q[b * p.sq.b + row * p.sq.t + h * p.sq.h + c];
      kv = p.k[b * p.sk.b + row * p.sk.t + h * p.sk.h + c];
      vv = p.v[b * p.sv.b + row * p.sv.t + h * p.sv.h + c];
    }
    const int64_t at = (bh * p.Tp + row) * D + c;
    p.qb[at] = tf32_big(qv);
    p.qs[at] = tf32_small(qv);
    p.kb[at] = tf32_big(kv);
    p.ks[at] = tf32_small(kv);
    tile[r][c] = vv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSplitRows * D; i += kSplitThreads) {
    const int n = i / kSplitRows, j = i % kSplitRows;
    const float x = tile[j][n];
    const int64_t at = (bh * D + n) * p.Tp + r0 + (j & ~7) + ((j & 1) << 2) + ((j >> 1) & 3);
    p.vtb[at] = tf32_big(x);
    p.vts[at] = tf32_small(x);
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
      const uint64_t vb = sw_desc<false, 2 * VK>(st + 2 * S * D);
      const uint64_t vs = sw_desc<false, 2 * VK>(st + 3 * S * D);
#pragma unroll
      for (int kk = 0; kk < S / 8; ++kk) {
        const uint64_t vof = (8 * kk / VK * L::kVChunk + 8 * kk % VK * 4) >> 4;
        wgmma_tf32_rs<D>(ot, pb[kk], vb + vof, kk > 0);
        wgmma_tf32_rs<D>(ot, pb[kk], vs + vof);
        wgmma_tf32_rs<D>(ot, ps[kk], vb + vof);
      }
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

// A 2D tensor map over `rows` rows of `inner` f32 (row stride inner * 4
// bytes), boxes of box_inner x box_rows with the swizzle of a box row's
// bytes (128 or 64) -> 0 or the CUresult of the encoding.
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

// The entry point's arguments.
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

template <int D>
int launch_tf32(const Tf32Call& a) {
  using L = Tf32Tiles<D>;
  const int B = a.B, H = a.H, T = a.T;
  const int64_t* strides = a.strides;
  float* scratch = a.scratch;
  const int64_t Tp = padded(T), n = static_cast<int64_t>(B) * H * Tp * D;
  SplitParams sp{};
  sp.q = a.q;
  sp.k = a.k;
  sp.v = a.v;
  sp.sq = {strides[0], strides[1], strides[2]};
  sp.sk = {strides[3], strides[4], strides[5]};
  sp.sv = {strides[6], strides[7], strides[8]};
  sp.qb = scratch;
  sp.qs = scratch + n;
  sp.kb = scratch + 2 * n;
  sp.ks = scratch + 3 * n;
  sp.vtb = scratch + 4 * n;
  sp.vts = scratch + 5 * n;
  sp.H = H;
  sp.T = T;
  sp.Tp = static_cast<int>(Tp);

  Tf32Params p{};
  const int64_t rows = static_cast<int64_t>(B) * H * Tp, vrows = static_cast<int64_t>(B) * H * D;
  int err = make_map_2d(&p.qb, sp.qb, D, rows, L::kCols, kHBlock);
  if (!err) err = make_map_2d(&p.qs, sp.qs, D, rows, L::kCols, kHBlock);
  if (!err) err = make_map_2d(&p.kb, sp.kb, D, rows, L::kCols, L::kS);
  if (!err) err = make_map_2d(&p.ks, sp.ks, D, rows, L::kCols, L::kS);
  if (!err) err = make_map_2d(&p.vtb, sp.vtb, Tp, vrows, L::kVKeys, D);
  if (!err) err = make_map_2d(&p.vts, sp.vts, Tp, vrows, L::kVKeys, D);
  if (err) return -err;
  p.q_small = sp.qs;
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
  flash_split_tf32_kernel<D><<<dim3(Tp / kSplitRows, H, B), kSplitThreads, 0, a.stream>>>(sp);
  const cudaError_t split = cudaGetLastError();
  if (split != cudaSuccess) return static_cast<int>(split);
  flash_fwd_tf32_sm90_kernel<D><<<dim3(Tp / kHBlock, H, B), kHThreads, L::kAlloc, a.stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
