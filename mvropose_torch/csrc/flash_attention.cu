// Flash attention with a per-key mask on Hopper (sm_90a): the forward, the
// dK/dV and the dQ kernels for bf16 and for f16 operands, with f32
// accumulation, at every head width d in {32, 48, 64, 96, 128}.
//
// Replaces the stock Pallas TPU flash attention that
// mvropose_tpu/ops/attention.py::fused_self_attention calls at T >= 2048
// (jax/experimental/pallas/ops/tpu/flash_attention.py in jax 0.9.0):
//   * flash_fwd_sm90_kernel<d, E> <- _flash_attention_kernel (:331, pallas_call :758);
//   * flash_dkv_sm90_kernel<d, E> <- _flash_attention_dkv_kernel (:796, pallas_call :1121);
//   * flash_dq_sm90_kernel<d, E>  <- _flash_attention_dq_kernel (:1146, pallas_call :1456).
// (f32 operands take flash_attention_tf32.cu's three kernels, on split-TF32
// products.)
// The segment ids of the TPU call become what they encode: a (B, T) byte
// mask of the keys (0 = not attended), and keys past T, which are skipped.
//
// What it computes, per batch element b and head h, with s = sm_scale:
//   S = s Q K^T, masked keys set to bf16's lowest finite value (the plain
//   branch's masked logit, ops/attention.py:102-114), P = softmax(S),
//   O = P V, with P (exp2 of S against the running row max) rounded to the
//   operands' type E before P V, as the stock kernel rounds it (:470); the
//   backward recomputes P = exp2(S - m) / l from the saved row max m and
//   row sum l, then dV = P^T dO, dP = dO V^T, dS = P o (dP - di) with di =
//   rowsum(dO o O), dS = 0 at masked keys (the plain branch's masked_fill
//   stops the gradient there), dK = s dS^T Q, dQ = s dS K.
// A row whose keys are all masked takes the plain branch's value, the mean
// of V over the T real keys: the masked logit is finite, keys past T are
// skipped (not masked), and m and l are saved apart (m = -3.39e38 would
// absorb log l in one saved m + log l, and the backward would recompute
// P = 1 where it is 1/T).
//
// What bounds it on an H100: the products and the exponentials. Forward 2,
// dK/dV 4 and dQ 3 products of 2 B H T^2 d FLOPs each, against q, k, v, o
// of 4 B T H d elements: the forward does T / 2 FLOPs a byte at every width
// (1152 at T = 2305), far above the card's ~295 bf16 FLOPs a byte, so it is
// compute-bound; and its B H T^2 exponentials, whatever d, take the SM's 16
// SFU lanes as long as its products take the tensor cores at d = 64: a 64 x
// 128 tile's two products take 8 d tensor-core cycles of an SM, its 8192
// exponentials 512 cycles. So at d = 32 and 48 the exponentials bound the
// forward, at 96 and 128 the products.
//
// Design: on Hopper's own units, every part at every width, for bf16 and
// for f16 operands E (f16 x f16 products accumulate exactly in f32 on the
// tensor cores, as bf16's do):
//   * all products on wgmma.mma_async (E x E -> f32), which alone reaches
//     the card's tensor-core rate: S = Q K^T (forward, dQ), S^T = K Q^T and
//     dP^T = V dO^T (dK/dV), dP = dO V^T (dQ) as m64nSk16 (S the streamed
//     tile's rows, 128 or 64) with both operands in shared memory; O += P
//     V, dV += P^T dO, dK += dS^T Q and dQ += dS K as m64ndk16 with P, P^T,
//     dS^T, dS as the A operand in registers and B the streamed tile read
//     MN-major (the transpose bit), so no transposed copy is made;
//   * TMA loads (cp.async.bulk.tensor, boxes of 64 rows x one swizzle atom:
//     64 x 64 with the 128-byte swizzle at d = 64, see `Sm90Tiles` for the
//     other widths; rows past T zero-filled) through tensor maps over the
//     (B, T, H, d) operands' own strides, built on the host per call with CUDA's
//     cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, no
//     link against libcuda) and passed as __grid_constant__ parameters, so a
//     CUDA graph captures them;
//   * a block owns 128 rows (keys in dK/dV, queries in the forward and
//     dQ), loaded once, in two consumer warpgroups of 64; the streamed
//     operand comes in tiles of 128 rows (64 in dK/dV at d >= 96) through a
//     ring of up to 4 stages with full/empty mbarriers, filled by one
//     producer warp, so the loads never wait on the products (4 stages: the
//     forward holds two tiles at once, and with 3 its next tile's loads
//     started too late); setmaxnreg moves registers from the producer
//     warpgroup to the consumers; no __syncthreads in the main loop;
//   * the row statistics m, l and di have a row stride of T floats, not a
//     multiple of 16 bytes at T = 2305, so TMA cannot copy them: the producer
//     warp copies them by plain loads (all of a stage's issued before any is
//     used) into the stage, with 1/l taken there, and arrives on the stage's
//     full barrier beside the bytes of its TMA copies; in the forward and dQ
//     it writes a code per key (attended, masked, past T) the same way, and
//     in the forward a flag per tile, so a tile of attended keys only (all
//     but the last at T = 2305 without a mask) takes a softmax that reads
//     no code;
//   * the two consumer warpgroups take turns to issue their products (two
//     named barriers), so one's softmax (the exponentials on the SFU, the
//     other arithmetic on the FP32 units) runs beside the other's products
//     on the tensor cores;
//   * P and dS go from the accumulators straight into the A operand of the
//     next product, never through shared or device memory;
//   * exp2 of S s log2(e), the base-2 form of the same exponent; m is saved
//     in that base-2 unit;
//   * dQ has its own kernel over key tiles, as the stock kernel splits it:
//     no atomics, so every gradient is deterministic.
// q, k, v and dO are read through their strides in the projections'
// (B, T, H, d) layout, and O, dQ, dK and dV written in that layout, so no
// transposed copy is made.

#include <cmath>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder via the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"  // mbarriers, TMA maps and boxes, the wgmma wrappers, turns

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16 *q, *k, *v, *dout;
  const uint8_t* mask;  // (B, T), 0 = key not attended; null: every key attended
  bf16 *o, *dq, *dk, *dv;  // (B, T, H, d) contiguous
  float *m, *l;            // (B, H, T): row max (base 2) and row sum; null: not saved
  const float* di;         // (B, H, T): rowsum(dO o O)
  Strides sq, sk, sv, sdo;
  int B, H, T;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

// Accumulators of column tiles 2kk, 2kk + 1 (16 x 16) as an A fragment of E.
template <typename E = bf16>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = Elem<E>::pack(c0[0], c0[1]);
  a[1] = Elem<E>::pack(c0[2], c0[3]);
  a[2] = Elem<E>::pack(c1[0], c1[1]);
  a[3] = Elem<E>::pack(c1[2], c1[3]);
}

// Rows g and g + 8 of the warp's 16 into (B, T, H, D) of E (bf16 or f16) at
// row index row0 + ..., each value times its row's `mul`, rounded once.
template <int D, typename E>
__device__ __forceinline__ void store_rows(E* out, const float (&acc)[D / 8][4], float mul0,
                                           float mul1, int T, int H, int b, int h, int row0,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    const float mul = r ? mul1 : mul0;
    E* dst = out + (static_cast<int64_t>(b) * T + row) * H * D + static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t) =
          Elem<E>::pack(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

// ------------------------------------------- the tile plan (every head width)
//
// The three kernels at every width of HEAD_DIMS: wgmma, TMA and a
// warp-specialised mbarrier ring. Block: two consumer warpgroups of 64 rows
// each (128 rows of the block's own operands: keys in dK/dV, queries in the
// forward and dQ, loaded once) and a producer warpgroup, of which one warp
// issues the loads and the other three only hand their registers over
// (setmaxnreg). The streamed operands (K and V, or Q and dO) come in tiles
// of S rows through a ring of up to 4 stages: S (S^T) and dP (dP^T) are
// m64nS products of two shared tiles; P and dS, rounded to the operands'
// type in registers, are the A operand of the m64nd products into O, dV, dK
// (dQ), whose B is the streamed tile read MN-major. The element type E
// (bf16, or f16: `Elem<E>` of sm90_common.cuh) changes only the products'
// PTX type, the tensor maps' data type and the roundings of P, dS and the
// outputs; the tiles, stages and registers are those of 2-byte elements
// either way.
//
// Per head width (`Sm90Tiles<d, S, ...>`), what the card forces:
//   * a row of d 2-byte elements is 2d bytes, one 128-byte swizzle atom only at d = 64.
//     Every operand tile is stored as column chunks of one atom each, the
//     widest of 64, 32 or 16 columns that divides d (d = 32: one chunk of 64
//     bytes; 48: three of 32; 96: three of 64; 128: two of 128), each chunk
//     a TMA box of 64 rows over a tensor map whose inner extent is the true
//     d, with the swizzle of its width. A k-step of the S products (16
//     columns) stays in one chunk; the MN-major B of the second products
//     spans the chunks as its atoms along N (the descriptor's leading offset
//     is the chunk stride), so each k-step is one m64nd instruction. No
//     column is padded: the products do the true d's work at every width;
//   * registers: a consumer thread holds d/2 f32 of each 64 x d accumulator
//     and S/2 of each 64 x S logit tile. dK/dV holds dK, dV, S^T and dP^T,
//     d + S: at S = 128 that is 160 (d = 32), 176 (48), 192 (64), but 224 at
//     d = 96 and 256 at d = 128, beyond the 232 a consumer thread gets (with
//     the bf16 A fragments beside them); so its streamed tile has 64 rows at
//     d >= 96 (d + S = 160, 192). dQ holds dQ, S and dP, d/2 + S: 128 rows
//     fit at every width (192 at d = 128). The forward holds O, S and the
//     P fragments of the previous tile, d/2 + S/2 + S/4 = d/2 + 96 at S =
//     128 (112 at d = 32 to 160 at d = 128): no second accumulator, so 128
//     keys a tile at every width. At 64 rows the S products are m64n64,
//     whose two shared operands take as many shared-memory cycles as the
//     product takes tensor-core cycles; dQ at d = 96 and 128 took 13-16 %
//     longer with them on an H100;
//   * shared memory: the block's own operands (two in the backward, 512 d
//     bytes; Q alone in the forward, 256 d), up to 4 stages of two streamed
//     tiles of 2 S d bytes each, as many as fit in the 227 KB of a block,
//     and the stages' row data: dK/dV 87 KB at d = 32, 127 at 48, 167 at 64,
//     148 at 96, 196 at 128 (4 stages each); dQ 4 stages up to d = 64, 3 at
//     96 (197 KB), 2 at 128 (196 KB); the forward 4 stages up to d = 96
//     (217 KB there), 3 at 128 (224 KB).

constexpr int kInnerQ = 1, kInnerK = 2, kInnerV = 4, kInnerDo = 8;  // bits of heads_inner

// Rows of the streamed tiles at head width d: the dK/dV kernel's (registers
// allow 128 up to d = 64), the dQ kernel's and the forward's (128 at every width).
__host__ __device__ constexpr int dkv_stream(int d) { return d <= 64 ? 128 : 64; }
constexpr int kDqStream = 128, kFwdStream = 128;

// The tiles of a kernel at head width D whose streamed tiles have S rows,
// beside `Own` own operands of 128 rows and `RowBytes` bytes of row data per
// streamed row and stage.
template <int D, int S = dkv_stream(D), int Own = 2, int RowBytes = 12>
struct Sm90Tiles {
  // Columns of a chunk (a TMA box, one swizzle atom): the widest of 64, 32, 16 dividing D.
  static constexpr int kCols = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kStream = S;  // rows of a streamed tile
  // Ring depth: 4 stages where they fit beside the block's own operands.
  static constexpr int kFit =
      (kMaxSmem - 2048 - Own * kHBlock * D * 2) / (4 * S * D + RowBytes * S);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kOwnChunk = kHBlock * kCols * 2;     // bytes of a chunk of an own operand
  static constexpr int kStreamChunk = kStream * kCols * 2;  // ... and of a streamed one
  static constexpr int kTile = kStream * D * 2;             // bytes of one streamed tile
  // Shared memory: the block's own operands (128 rows each), kStages stages
  // of the two streamed ones, the stages' row data (dK/dV: m, 1/l, di per
  // query; dQ and the forward: a code per key), a flag byte per stage (the
  // forward's), then the barriers.
  static constexpr int kOwn = 0;
  static constexpr int kRing = kOwn + Own * kHBlock * D * 2;
  static constexpr int kRowData = kRing + kStages * 2 * kTile;
  static constexpr int kFlags = kRowData + kStages * RowBytes * kStream;
  static constexpr int kBars = (kFlags + kStages + 7) / 8 * 8;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024 bytes
  static_assert(kStages >= 2 && kAlloc <= kMaxSmem, "more shared memory than a block can have");
};

// The forward's: Q its one own operand, a code byte per key.
template <int D>
using FwdTiles = Sm90Tiles<D, kFwdStream, 1, 1>;

template <typename E>
struct HopperParams {
  // (B, T, H, d) E through their strides, boxes of 64 rows x one chunk;
  // dims (d, T, H, B), or (d, H, T, B) where heads lie inside rows (bit
  // kInnerQ.. of `heads_inner`): a tensor map's strides grow with its dims.
  CUtensorMap q, k, v, dout;  // dout: the backward's only
  int heads_inner;
  const uint8_t* mask;     // (B, T), 0 = key not attended; null: every key attended
  E *o, *dq, *dk, *dv;  // (B, T, H, d) contiguous
  float *m, *l;         // (B, H, T): written by the forward (unless null), read by the backward
  const float* di;         // (B, H, T)
  int H, T;
  float scale, scale_log2;
};

// The 64 x S accumulator as A fragments of E, 16 columns per k-step.
template <int S, typename E = bf16>
__device__ __forceinline__ void to_a(uint32_t (&a)[S / 16][4], const float (&acc)[S / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk) acc_to_a<E>(a[kk], acc[2 * kk], acc[2 * kk + 1]);
}

// D += A B with A in registers (`to_a`) and B the S rows of an MN-major
// tile of N columns in chunks of C: k-step kk reads rows 16 kk.. of it, 16
// rows of 2C bytes further.
template <int S, int N, int C, typename E = bf16>
__device__ __forceinline__ void product_rs(float (&d)[N / 8][4], const uint32_t (&a)[S / 16][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk) wgmma_rs<N, E>(d, a[kk], b + (32 * C >> 4) * kk);
}

template <int D, typename E>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ HopperParams<E> p) {
  using L = Sm90Tiles<D, dkv_stream(D)>;
  constexpr int S = L::kStream, C = L::kCols, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  E* sK = reinterpret_cast<E*>(smem + L::kOwn);  // 128 key rows, in chunks of C columns
  E* sV = sK + kHBlock * D;
  E* ring = reinterpret_cast<E*>(smem + L::kRing);  // [stage][Q, dO][chunk][S][C]
  float* rows = reinterpret_cast<float*>(smem + L::kRowData);  // [stage][m, 1/l, di][S]
  const Ring<L> bars(smem);

  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kHBlock, T = p.T;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int m_tiles = (T + S - 1) / S;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (wg == kHConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kHProducerRegs));
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.own, 2 * kHBlock * D * 2);
      tma_rows<D, C>(sK, &p.k, bars.own, kHBlock, n0, h, b, p.heads_inner & kInnerK);
      tma_rows<D, C>(sV, &p.v, bars.own, kHBlock, n0, h, b, p.heads_inner & kInnerV);
    }
    const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * T;
    for (int i = 0; i < m_tiles; ++i) {
      const int stage = i % kStages, m0 = i * S;
      mbar_wait(&bars.empty[stage], ((i / kStages) & 1) ^ 1);  // round 0 passes
      // Every load of the stage issued before any is used. Queries past T
      // get P = exp2(x - inf) * 0 = 0.
      float* st = rows + stage * 3 * S;
      float mv[S / 32], lv[S / 32], dv[S / 32];
#pragma unroll
      for (int u = 0; u < S / 32; ++u) {
        const int r = m0 + lane + 32 * u;
        const bool valid = r < T;
        mv[u] = valid ? p.m[stat0 + r] : INFINITY;
        lv[u] = valid ? p.l[stat0 + r] : INFINITY;
        dv[u] = valid ? p.di[stat0 + r] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < S / 32; ++u) {
        st[lane + 32 * u] = mv[u];
        st[S + lane + 32 * u] = __frcp_rn(lv[u]);  // 1/inf = 0
        st[2 * S + lane + 32 * u] = dv[u];
      }
      if (lane == 0) {
        E* q_s = ring + stage * 2 * S * D;
        mbar_arrive_expect_tx(&bars.full[stage], 2 * L::kTile);
        tma_rows<D, C>(q_s, &p.q, &bars.full[stage], S, m0, h, b, p.heads_inner & kInnerQ);
        tma_rows<D, C>(q_s + S * D, &p.dout, &bars.full[stage], S, m0, h, b,
                       p.heads_inner & kInnerDo);
      } else {
        mbar_arrive(&bars.full[stage]);
      }
    }
  } else {  // consumer warpgroup wg: keys n0 + 64 wg ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kHConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int row0 = n0 + wg * kHRows + warp * 16;  // the warp's 16 keys
    bool key_masked[2];  // rows g and g + 8: masked keys take no dS
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = row0 + g + 8 * r;
      key_masked[r] =
          p.mask != nullptr && key < T && p.mask[static_cast<int64_t>(b) * T + key] == 0;
    }
    const uint64_t k_desc = sw_desc<false, C>(sK + wg * kHRows * C);
    const uint64_t v_desc = sw_desc<false, C>(sV + wg * kHRows * C);
    float dk[D / 8][4], dv[D / 8][4];
    zero_acc(dk);
    zero_acc(dv);
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(bars.own, 0);

    for (int i = 0; i < m_tiles; ++i) {
      const int stage = i % kStages;
      mbar_wait(&bars.full[stage], (i / kStages) & 1);
      const E* q_s = ring + stage * 2 * S * D;
      const E* do_s = q_s + S * D;
      const float* st = rows + stage * 3 * S;

      // S^T = K Q^T and dP^T = V dO^T over the warpgroup's 64 keys and the tile's S queries.
      float s[S / 8][4], dp[S / 8][4];
      turn_wait(wg);
      wgmma_fence();
      product_kmajor<S, D, C, L::kOwnChunk, L::kStreamChunk, E>(s, k_desc, sw_desc<false, C>(q_s));
      product_kmajor<S, D, C, L::kOwnChunk, L::kStreamChunk, E>(dp, v_desc,
                                                                sw_desc<false, C>(do_s));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait();
      fence_acc(s);
      fence_acc(dp);
      // P^T = exp2(S^T s log2 e - m) / l; dS^T = P^T o (dP^T - di), 0 at
      // masked keys. (Waiting for S^T alone first, as dQ does for S, keeps
      // more registers live across the exponentials and spills at 232.)
#pragma unroll
      for (int n = 0; n < S / 8; ++n) {
        const int q2 = n * 8 + 2 * t;  // queries q2, q2 + 1: float2 loads
        const float2 m2 = *reinterpret_cast<const float2*>(st + q2);
        const float2 rl2 = *reinterpret_cast<const float2*>(st + S + q2);
        const float2 di2 = *reinterpret_cast<const float2*>(st + 2 * S + q2);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float m = c ? m2.y : m2.x, rl = c ? rl2.y : rl2.x, di = c ? di2.y : di2.x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float x = key_masked[r] ? kMasked - m : fmaf(s[n][e], p.scale_log2, -m);
            const float prob = exp2_approx(x) * rl;
            s[n][e] = prob;
            dp[n][e] = key_masked[r] ? 0.f : prob * (dp[n][e] - di);
          }
        }
      }
      // dV += P^T dO and dK += dS^T Q (P^T and dS^T rounded to E, sm_scale
      // applied at the end); dO and Q are read MN-major, as they lie.
      uint32_t pa[S / 16][4], da[S / 16][4];
      to_a<S, E>(pa, s);
      to_a<S, E>(da, dp);
      fence_acc(dv);
      fence_acc(dk);
      turn_wait(wg);
      wgmma_fence();  // A registers and D written by ordinary instructions
      product_rs<S, D, C, E>(dv, pa, sw_desc<true, C>(do_s, L::kStreamChunk));
      product_rs<S, D, C, E>(dk, da, sw_desc<true, C>(q_s, L::kStreamChunk));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait();
      fence_acc(dv);
      fence_acc(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.empty[stage]);
    }
    if (wg == 0) turn_wait(wg);  // the other warpgroup's last pass
    store_rows<D>(p.dk, dk, p.scale, p.scale, T, p.H, b, h, row0, g, t);
    store_rows<D>(p.dv, dv, 1.f, 1.f, T, p.H, b, h, row0, g, t);
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_dq_sm90_kernel(const __grid_constant__ HopperParams<E> p) {
  using L = Sm90Tiles<D, kDqStream>;
  constexpr int S = L::kStream, C = L::kCols, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  E* sQ = reinterpret_cast<E*>(smem + L::kOwn);  // 128 query rows, in chunks of C columns
  E* sO = sQ + kHBlock * D;                       // dO
  E* ring = reinterpret_cast<E*>(smem + L::kRing);  // [stage][K, V][chunk][S][C]
  // Per stage and key: 0 attended, 1 masked, 2 past T.
  uint8_t* codes = smem + L::kRowData;
  const Ring<L> bars(smem);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kHBlock, T = p.T;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int n_tiles = (T + S - 1) / S;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (wg == kHConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kHProducerRegs));
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.own, 2 * kHBlock * D * 2);
      tma_rows<D, C>(sQ, &p.q, bars.own, kHBlock, q0, h, b, p.heads_inner & kInnerQ);
      tma_rows<D, C>(sO, &p.dout, bars.own, kHBlock, q0, h, b, p.heads_inner & kInnerDo);
    }
    const uint8_t* mask = p.mask ? p.mask + static_cast<int64_t>(b) * T : nullptr;
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages, k0 = j * S;
      mbar_wait(&bars.empty[stage], ((j / kStages) & 1) ^ 1);
      for (int r = lane; r < S; r += 32) {
        const int key = k0 + r;
        codes[stage * S + r] = key >= T ? 2 : (mask != nullptr && mask[key] == 0 ? 1 : 0);
      }
      if (lane == 0) {
        E* k_s = ring + stage * 2 * S * D;
        mbar_arrive_expect_tx(&bars.full[stage], 2 * L::kTile);
        tma_rows<D, C>(k_s, &p.k, &bars.full[stage], S, k0, h, b, p.heads_inner & kInnerK);
        tma_rows<D, C>(k_s + S * D, &p.v, &bars.full[stage], S, k0, h, b,
                       p.heads_inner & kInnerV);
      } else {
        mbar_arrive(&bars.full[stage]);
      }
    }
  } else {  // consumer warpgroup wg: queries q0 + 64 wg ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kHConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * kHRows + warp * 16;  // the warp's 16 queries
    float m_r[2], rl_r[2], di_r[2];  // rows g and g + 8; rows past T get P = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      const int64_t i = (static_cast<int64_t>(b) * p.H + h) * T + row;
      const bool valid = row < T;
      m_r[r] = valid ? p.m[i] : INFINITY;
      rl_r[r] = valid ? 1.f / p.l[i] : 0.f;
      di_r[r] = valid ? p.di[i] : 0.f;
    }
    const uint64_t q_desc = sw_desc<false, C>(sQ + wg * kHRows * C);
    const uint64_t do_desc = sw_desc<false, C>(sO + wg * kHRows * C);
    float dq[D / 8][4];
    zero_acc(dq);
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(bars.own, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages;
      mbar_wait(&bars.full[stage], (j / kStages) & 1);
      const E* k_s = ring + stage * 2 * S * D;
      const E* v_s = k_s + S * D;
      const uint8_t* code = codes + stage * S;

      // S = Q K^T and dP = dO V^T over the warpgroup's 64 queries and the tile's S keys.
      float s[S / 8][4], dp[S / 8][4];
      turn_wait(wg);
      wgmma_fence();
      product_kmajor<S, D, C, L::kOwnChunk, L::kStreamChunk, E>(s, q_desc, sw_desc<false, C>(k_s));
      wgmma_commit();
      product_kmajor<S, D, C, L::kOwnChunk, L::kStreamChunk, E>(dp, do_desc,
                                                                sw_desc<false, C>(v_s));
      wgmma_commit();
      turn_pass(wg);
      // P while dP is still running (0 at masked keys and past T), then
      // dS = P o (dP - di).
      wgmma_wait<1>();
      fence_acc(s);
#pragma unroll
      for (int n = 0; n < S / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = code[n * 8 + 2 * t + (e & 1)];
          const float x = fmaf(s[n][e], p.scale_log2, -m_r[e >> 1]);
          s[n][e] = kc != 0 ? 0.f : exp2_approx(x) * rl_r[e >> 1];
        }
      }
      wgmma_wait<0>();
      fence_acc(dp);
#pragma unroll
      for (int n = 0; n < S / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - di_r[e >> 1];  // dS
      // dQ += dS K (dS rounded to E, sm_scale applied at the end); K is read MN-major.
      uint32_t da[S / 16][4];
      to_a<S, E>(da, s);
      fence_acc(dq);
      turn_wait(wg);
      wgmma_fence();
      product_rs<S, D, C, E>(dq, da, sw_desc<true, C>(k_s, L::kStreamChunk));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait();
      fence_acc(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.empty[stage]);
    }
    if (wg == 0) turn_wait(wg);  // the other warpgroup's last pass
    store_rows<D>(p.dq, dq, p.scale, p.scale, T, p.H, b, h, row0, g, t);
  }
}

// ------------------------------------------------------------------ forward
//
// The forward on the backward's pieces: two consumer warpgroups own 64
// queries each (128 per block, Q loaded once by TMA); K and V stream past
// them in 128-key tiles through the ring, with a code per key (attended,
// masked, past T) and a flag per stage that says whether the tile holds any
// key that is not attended. Per tile and warpgroup: S = Q K^T (m64n128, both
// operands in shared memory, the dQ kernel's S product); the online softmax
// in registers; P to A registers of E; O += P V (m64nd, V read MN-major, the
// dQ kernel's second product with V for K). The softmax's exponentials cost
// about as much SFU time as the products cost tensor-core time at d = 64
// (more below, less above), so the two overlap twice: each turn of a
// warpgroup issues S of tile j and P V of tile j - 1 together, and the
// softmax of tile j runs while that P V and the other warpgroup's products
// run. (With S and P V in turns of their own, both warpgroups' softmax
// phases fell together, and the tensor cores waited.)

template <int D, typename E>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ HopperParams<E> p) {
  using L = FwdTiles<D>;
  constexpr int S = L::kStream, C = L::kCols, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  E* sQ = reinterpret_cast<E*>(smem + L::kOwn);  // 128 query rows, in chunks of C columns
  E* ring = reinterpret_cast<E*>(smem + L::kRing);  // [stage][K, V][chunk][S][C]
  // Per stage and key: 0 attended, 1 masked, 2 past T; per stage a flag:
  // whether any key of the tile is not attended.
  uint8_t* codes = smem + L::kRowData;
  uint8_t* coded = smem + L::kFlags;
  const Ring<L> bars(smem);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kHBlock, T = p.T;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int n_tiles = (T + S - 1) / S;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (wg == kHConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kHProducerRegs));
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.own, kHBlock * D * 2);
      tma_rows<D, C>(sQ, &p.q, bars.own, kHBlock, q0, h, b, p.heads_inner & kInnerQ);
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
        E* k_s = ring + stage * 2 * S * D;
        mbar_arrive_expect_tx(&bars.full[stage], 2 * L::kTile);
        tma_rows<D, C>(k_s, &p.k, &bars.full[stage], S, k0, h, b, p.heads_inner & kInnerK);
        tma_rows<D, C>(k_s + S * D, &p.v, &bars.full[stage], S, k0, h, b,
                       p.heads_inner & kInnerV);
      } else {
        mbar_arrive(&bars.full[stage]);
      }
    }
  } else {  // consumer warpgroup wg: queries q0 + 64 wg ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kHConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * kHRows + warp * 16;  // the warp's 16 queries
    const uint64_t q_desc = sw_desc<false, C>(sQ + wg * kHRows * C);
    float o[D / 8][4];
    zero_acc(o);
    float m_i[2] = {-INFINITY, -INFINITY};  // running row max (base 2), rows g and g + 8
    float l_i[2] = {0.f, 0.f};              // this thread's part of the row sum
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(bars.own, 0);

    float s[S / 8][4];
    uint32_t pa[S / 16][4];
    float corr[2];
    auto softmax = [&](int stage) {
      if (coded[stage]) {
        softmax_tile<true, S>(s, m_i, l_i, corr, codes + stage * S, t, p.scale_log2);
      } else {
        softmax_tile<false, S>(s, m_i, l_i, corr, nullptr, t, p.scale_log2);
      }
    };
    // S = Q K^T of the stage's keys; O += P V with the stage's values.
    auto s_product = [&](int stage) {
      product_kmajor<S, D, C, L::kOwnChunk, L::kStreamChunk, E>(
          s, q_desc, sw_desc<false, C>(ring + stage * 2 * S * D));
    };
    auto pv_product = [&](int stage) {
      product_rs<S, D, C, E>(o, pa, sw_desc<true, C>(ring + stage * 2 * S * D + S * D,
                                                     L::kStreamChunk));
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
    softmax(0);  // O is 0: no correction
    to_a<S, E>(pa, s);  // P rounded to E
    // Tile j: S of tile j and P V of tile j - 1 in one turn; the softmax of
    // tile j while P V runs.
    for (int j = 1; j < n_tiles; ++j) {
      const int stage = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(&bars.full[stage], (j / kStages) & 1);
      fence_acc(o);
      turn_wait(wg);
      wgmma_fence();
      s_product(stage);
      wgmma_commit();
      pv_product(prev);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      fence_acc(s);
      softmax(stage);
      wgmma_wait<0>();
      fence_acc(o);
      fence_a(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.empty[prev]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      to_a<S, E>(pa, s);
    }
    // P V of the last tile.
    const int last = (n_tiles - 1) % kStages;
    fence_acc(o);
    turn_wait(wg);
    wgmma_fence();
    pv_product(last);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[last]);
    if (wg == 0) turn_wait(wg);  // the other warpgroup's last pass
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    }
    // Rows past T (zero-filled by TMA) are computed and never stored.
    store_rows<D>(p.o, o, 1.f / l_i[0], 1.f / l_i[1], T, p.H, b, h, row0, g, t);
    if (p.m != nullptr && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row < T) {
          const int64_t i = (static_cast<int64_t>(b) * p.H + h) * T + row;
          p.m[i] = m_i[r];
          p.l[i] = l_i[r];
        }
      }
    }
  }
}

// The kernels' parameters from the entry points' arguments (`Params`), at
// head width D for operands of E (tensor maps of D columns of E, boxes of
// Sm90Tiles<D>::kCols; `Params` carries the addresses, typed bf16, of
// operands of either type) -> 0, or a negative CUresult when a tensor map
// cannot be encoded. Maps are made for the operands the kernel reads: q, k,
// v, and dO unless it is null (the forward).
template <int D, typename E>
int make_hopper_params(HopperParams<E>* hp, const Params& p) {
  const int B = p.B, H = p.H, T = p.T;
  CUtensorMap* maps[4] = {&hp->q, &hp->k, &hp->v, &hp->dout};  // bits kInnerQ, K, V, Do
  const void* bases[4] = {p.q, p.k, p.v, p.dout};
  const Strides strides[4] = {p.sq, p.sk, p.sv, p.sdo};
  int err = 0, inner = 0;
  for (int i = 0; i < 4 && !err; ++i) {
    if (bases[i] == nullptr) continue;
    const bool heads_inner = strides[i].h < strides[i].t;  // e.g. a contiguous projection
    err = make_map<E>(maps[i], bases[i], strides[i], B, H, T, heads_inner, D,
                      Sm90Tiles<D>::kCols);
    inner |= heads_inner << i;
  }
  if (err) return -err;
  hp->heads_inner = inner;
  hp->mask = p.mask;
  hp->o = reinterpret_cast<E*>(p.o);
  hp->dq = reinterpret_cast<E*>(p.dq);
  hp->dk = reinterpret_cast<E*>(p.dk);
  hp->dv = reinterpret_cast<E*>(p.dv);
  hp->m = p.m;
  hp->l = p.l;
  hp->di = p.di;
  hp->H = H;
  hp->T = T;
  hp->scale = p.scale;
  hp->scale_log2 = p.scale_log2;
  return 0;
}

enum Kind { kForward, kDkv, kDq };

template <Kind K, int D, typename E>
int launch_sm90(const Params& p, cudaStream_t stream) {
  void (*kernel)(HopperParams<E>) = nullptr;
  if constexpr (K == kForward) {
    kernel = &flash_fwd_sm90_kernel<D, E>;
  } else if constexpr (K == kDkv) {
    kernel = &flash_dkv_sm90_kernel<D, E>;
  } else {
    kernel = &flash_dq_sm90_kernel<D, E>;
  }
  constexpr int smem = K == kForward ? FwdTiles<D>::kAlloc
                       : K == kDkv   ? Sm90Tiles<D, dkv_stream(D)>::kAlloc
                                     : Sm90Tiles<D, kDqStream>::kAlloc;
  HopperParams<E> hp{};
  const int err = make_hopper_params<D, E>(&hp, p);
  if (err) return err;
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((p.T + kHBlock - 1) / kHBlock, p.H, p.B);
  kernel<<<grid, kHThreads, smem, stream>>>(hp);
  return static_cast<int>(cudaGetLastError());
}

// The forward, dK/dV or dQ kernel at head width D for operands of E.
template <Kind K, typename E>
int dispatch_sm90(const Params& p, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_sm90<K, 32, E>(p, s);
    case 48: return launch_sm90<K, 48, E>(p, s);
    case 64: return launch_sm90<K, 64, E>(p, s);
    case 96: return launch_sm90<K, 96, E>(p, s);
    case 128: return launch_sm90<K, 128, E>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make_params(const void* q, const void* k, const void* v, const uint8_t* mask, int B, int H,
                   int T, const int64_t* strides, float sm_scale) {
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.mask = mask;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.sdo = {strides[9], strides[10], strides[11]};
  p.B = B;
  p.H = H;
  p.T = T;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return p;
}

// The forward kernel for operands of E.
template <typename E>
int forward_sm90(const void* q, const void* k, const void* v, const uint8_t* mask, void* o,
                 float* m, float* l, int B, int H, int T, int D, const int64_t* strides,
                 float sm_scale, void* stream) {
  Params p = make_params(q, k, v, mask, B, H, T, strides, sm_scale);
  p.o = static_cast<bf16*>(o);
  p.m = m;
  p.l = l;
  return dispatch_sm90<kForward, E>(p, D, stream);
}

// The dK/dV (K = kDkv: dk, dv) or dQ (kDq: dq) kernel for operands of E.
template <Kind K, typename E>
int backward_sm90(const void* q, const void* k, const void* v, const uint8_t* mask,
                  const void* dout, const float* m, const float* l, const float* di, void* dq,
                  void* dk, void* dv, int B, int H, int T, int D, const int64_t* strides,
                  float sm_scale, void* stream) {
  Params p = make_params(q, k, v, mask, B, H, T, strides, sm_scale);
  p.dout = static_cast<const bf16*>(dout);
  p.m = const_cast<float*>(m);
  p.l = const_cast<float*>(l);
  p.di = di;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  return dispatch_sm90<K, E>(p, D, stream);
}

}  // namespace

// Operands are bf16 (B, T, H, D) with D in {32, 48, 64, 96, 128}, read
// through `strides`: 12 element strides (b, t, h) of q, k, v and dO in that
// order (dO's unused by the forward), each a multiple of 8 with 16-byte
// aligned bases and unit stride along D. mask: (B, T) bytes, 0 = key not
// attended, or null. Outputs O, dQ, dK, dV: (B, T, H, D) bf16 contiguous;
// m, l (written by the forward unless null), di: (B, H, T) f32 contiguous.
// Every pointer on the device of `stream`. Each returns cudaGetLastError()
// after its launch, cudaErrorInvalidValue (1) for a head width it does not
// take, or minus the CUresult of a tensor map that cannot be encoded (q, k,
// v and dO strides: multiples of 16 bytes below 2^40, as the wrapper checks).
extern "C" int flash_attention_forward_sm90(const void* q, const void* k, const void* v,
                                            const uint8_t* mask, void* o, float* m, float* l,
                                            int B, int H, int T, int D, const int64_t* strides,
                                            float sm_scale, void* stream) {
  return forward_sm90<bf16>(q, k, v, mask, o, m, l, B, H, T, D, strides, sm_scale, stream);
}

// Keys per tile of the forward (kFwdStream), for checks that need its tiling.
extern "C" int flash_attention_forward_key_tile() { return kFwdStream; }

extern "C" int flash_attention_backward_dkv_sm90(const void* q, const void* k, const void* v,
                                                 const uint8_t* mask, const void* dout,
                                                 const float* m, const float* l, const float* di,
                                                 void* dk, void* dv, int B, int H, int T, int D,
                                                 const int64_t* strides, float sm_scale,
                                                 void* stream) {
  return backward_sm90<kDkv, bf16>(q, k, v, mask, dout, m, l, di, nullptr, dk, dv, B, H, T, D,
                                   strides, sm_scale, stream);
}

extern "C" int flash_attention_backward_dq_sm90(const void* q, const void* k, const void* v,
                                                const uint8_t* mask, const void* dout,
                                                const float* m, const float* l, const float* di,
                                                void* dq, int B, int H, int T, int D,
                                                const int64_t* strides, float sm_scale,
                                                void* stream) {
  return backward_sm90<kDq, bf16>(q, k, v, mask, dout, m, l, di, dq, nullptr, nullptr, B, H, T,
                                  D, strides, sm_scale, stream);
}

// The same three for f16 operands and outputs (the arguments above, with
// f16 for bf16): flash_fwd_sm90_kernel<D, __half>, and
// flash_dkv_sm90_kernel<D, __half> and flash_dq_sm90_kernel<D, __half> on
// its m (base 2) and l.
extern "C" int flash_attention_forward_sm90_f16(const void* q, const void* k, const void* v,
                                                const uint8_t* mask, void* o, float* m, float* l,
                                                int B, int H, int T, int D,
                                                const int64_t* strides, float sm_scale,
                                                void* stream) {
  return forward_sm90<__half>(q, k, v, mask, o, m, l, B, H, T, D, strides, sm_scale, stream);
}

extern "C" int flash_attention_backward_dkv_sm90_f16(const void* q, const void* k, const void* v,
                                                     const uint8_t* mask, const void* dout,
                                                     const float* m, const float* l,
                                                     const float* di, void* dk, void* dv, int B,
                                                     int H, int T, int D, const int64_t* strides,
                                                     float sm_scale, void* stream) {
  return backward_sm90<kDkv, __half>(q, k, v, mask, dout, m, l, di, nullptr, dk, dv, B, H, T, D,
                                     strides, sm_scale, stream);
}

extern "C" int flash_attention_backward_dq_sm90_f16(const void* q, const void* k, const void* v,
                                                    const uint8_t* mask, const void* dout,
                                                    const float* m, const float* l,
                                                    const float* di, void* dq, int B, int H,
                                                    int T, int D, const int64_t* strides,
                                                    float sm_scale, void* stream) {
  return backward_sm90<kDq, __half>(q, k, v, mask, dout, m, l, di, dq, nullptr, nullptr, B, H, T,
                                    D, strides, sm_scale, stream);
}
