// Flash attention with a per-key mask on Hopper (sm_90a): the forward, the
// dK/dV and the dQ kernels, in bf16 with f32 accumulation.
//
// Replaces the stock Pallas TPU flash attention that
// mvropose_tpu/ops/attention.py::fused_self_attention calls at T >= 2048
// (jax/experimental/pallas/ops/tpu/flash_attention.py in jax 0.9.0):
//   * flash_fwd_kernel  <- _flash_attention_kernel (:331, pallas_call :758);
//   * flash_dkv_kernel  <- _flash_attention_dkv_kernel (:796, pallas_call :1121);
//   * flash_dq_kernel   <- _flash_attention_dq_kernel (:1146, pallas_call :1456).
// The segment ids of the TPU call become what they encode: a (B, T) byte
// mask of the keys (0 = not attended), and keys past T, which are skipped.
//
// What it computes, per batch element b and head h, with s = sm_scale:
//   S = s Q K^T, masked keys set to bf16's lowest finite value (the plain
//   branch's masked logit, ops/attention.py:102-114), P = softmax(S),
//   O = P V; the backward recomputes P = exp(S - m) / l from the saved row
//   max m and row sum l, then dV = P^T dO, dP = dO V^T, dS = P o (dP - di)
//   with di = rowsum(dO o O), dS = 0 at masked keys (the plain branch's
//   masked_fill stops the gradient there), dK = s dS^T Q, dQ = s dS K.
// A row whose keys are all masked takes the plain branch's value, the mean
// of V over the T real keys: the masked logit is finite, keys past T are
// skipped (not masked), and m and l are saved apart (m = -3.39e38 would
// absorb log l in one saved m + log l, and the backward would recompute
// P = 1 where it is 1/T).
//
// What bounds it on an H100: the products. Forward 2, dK/dV 4 and dQ 3
// products of 2 B H T^2 d FLOPs each, against q, k, v, o of 4 B T H d bytes:
// at T = 2305, d = 64 the forward does ~720 FLOPs a byte, above the card's
// ~295 bf16 FLOPs a byte, so it is compute-bound, and the exponentials
// (B H T^2 of them) cost about as much again on the SFU. The design:
//   * mma.sync.m16n8k16 (bf16 x bf16 -> f32) on fragments in registers; one
//     block of 4 warps, each warp owning 16 rows of the block's tile, so the
//     softmax statistics of a row stay in the 4 threads of a quad;
//   * the operand that the block walks (K and V in the forward and dQ, Q,
//     dO and the row statistics in dK/dV) streams through a 2-stage ring in
//     shared memory, filled by 16-byte cp.async copies one tile ahead;
//   * P and dS go from the accumulators straight into the A fragments of the
//     next product, never through shared or device memory;
//   * shared rows are padded by 16 bytes, so the fragment loads (32-bit
//     loads, ldmatrix.trans for the transposed operands) are free of bank
//     conflicts at every head width;
//   * exp2 of S s log2(e), the base-2 form of the same exponent; m is saved
//     in that base-2 unit;
//   * dQ has its own kernel over key tiles, as the stock kernel splits it:
//     no atomics, so every gradient is deterministic.
// q, k, v and dO are read through their strides in the projections'
// (B, T, H, d) layout, and O, dQ, dK and dV written in that layout, so no
// transposed copy is made. wgmma, TMA and warp specialisation are left for
// later work.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
// The plain branch's masked logit: bf16's lowest finite value, exact in f32.
constexpr float kMasked = -3.3895313892515355e38f;

struct Strides {  // element strides of a (B, T, H, d) operand whose d is unit-stride
  int64_t b, t, h;
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + R) of one (b, h) slice of an operand into a shared tile of
// row stride D + 8; rows at or past T are zero-filled (no byte is read).
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* base, Strides s, int b, int h,
                                          int r0, int T, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(R * kChunks % kThreads == 0, "whole rounds of 16-byte copies");
  const bf16* bh = base + b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = r0 + r < T;
    cp_async16(tile + r * (D + 8) + col, bh + (valid ? r0 + r : 0) * s.t + col, valid);
  }
}

// R floats of a (B, H, T) row statistic from row r0 on; past T zero-filled.
template <int R>
__device__ __forceinline__ void load_stat(float* dst, const float* src, int r0, int T, int tid) {
  for (int i = tid; i < R; i += kThreads) {
    const bool valid = r0 + i < T;
    cp_async4(dst + i, src + (valid ? r0 + i : 0), valid);
  }
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of m16n8k16: rows m0..m0+15, columns k0..k0+15 of a shared
// tile stored [m][k] with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0,
                                       int g, int t) {
  const bf16* p = s + (m0 + g) * ld + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B fragment (k0..k0+15) x (n0..n0+7) of a shared tile stored [n][k].
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* s, int ld, int n0, int k0,
                                       int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// B fragments (k0..k0+15) x (n0..n0+7) and x (n0+8..n0+15) of a shared
// tile stored [k][n] (the transposed operand), by one ldmatrix.x4.trans:
// matrix j covers rows k0 + 8 (j & 1), columns n0 + 8 (j >> 1).
__device__ __forceinline__ void load_b_trans2(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* s,
                                              int ld, int k0, int n0, int lane) {
  const int j = lane >> 3;
  const bf16* p = s + (k0 + (j & 1) * 8 + (lane & 7)) * ld + n0 + (j >> 1) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Accumulators of column tiles 2kk, 2kk + 1 (16 x 16) as an A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Rows g and g + 8 of the warp's 16 into (B, T, H, D) at row index q0 + ...
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], float mul0,
                                           float mul1, const Params& p, int b, int h, int row0,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= p.T) continue;
    const float mul = r ? mul1 : mul0;
    bf16* dst = out + (static_cast<int64_t>(b) * p.T + row) * p.H * D + static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------- forward

template <int D>
struct FwdTiles {
  static constexpr int kBlockM = 64;  // query rows per block, 16 per warp
  static constexpr int kBlockN = 64;  // keys per tile
  static constexpr int kLd = D + 8;
  static constexpr int kSmem = (kBlockM + 4 * kBlockN) * kLd * 2;  // Q + 2 stages of K, V
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using C = FwdTiles<D>;
  constexpr int kLd = C::kLd, kBlockM = C::kBlockM, kBlockN = C::kBlockN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBlockM * kLd;      // [2][kBlockN][kLd]
  bf16* sV = sK + 2 * kBlockN * kLd;  // [2][kBlockN][kLd]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int T = p.T;
  const uint8_t* mask = p.mask ? p.mask + static_cast<int64_t>(b) * T : nullptr;
  const int n_tiles = (T + kBlockN - 1) / kBlockN;

  load_rows<D, kBlockM>(sQ, p.q, p.sq, b, h, q0, T, tid);
  load_rows<D, kBlockN>(sK, p.k, p.sk, b, h, 0, T, tid);
  load_rows<D, kBlockN>(sV, p.v, p.sv, b, h, 0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], sQ, kLd, warp * 16, kk * 16, g, t);

  float o[D / 8][4];
  zero(o);
  float m_i[2] = {-INFINITY, -INFINITY};  // running row max (base 2), rows g and g + 8
  float l_i[2] = {0.f, 0.f};              // this thread's part of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int stage = (j + 1) & 1;
      load_rows<D, kBlockN>(sK + stage * kBlockN * kLd, p.k, p.sk, b, h, (j + 1) * kBlockN, T, tid);
      load_rows<D, kBlockN>(sV + stage * kBlockN * kLd, p.v, p.sv, b, h, (j + 1) * kBlockN, T, tid);
    }
    cp_async_commit();  // one group per tile, empty past the end
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = sK + (j & 1) * kBlockN * kLd;
    const bf16* v_s = sV + (j & 1) * kBlockN * kLd;

    float s[kBlockN / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        uint32_t bfr[2];
        load_b(bfr, k_s, kLd, n * 8, kk * 16, g, t);
        mma(s[n], qf[kk], bfr);
      }
    }
    // Scale, mask and skip; element e of column tile n is row g + 8 (e >> 1),
    // key j * kBlockN + 8 n + 2 t + (e & 1).
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = j * kBlockN + n * 8 + 2 * t + c;
        const bool in_range = key < T;
        const bool masked = in_range && mask != nullptr && mask[key] == 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = s[n][2 * r + c] * p.scale_log2;
          x = !in_range ? -INFINITY : (masked ? kMasked : x);
          s[n][2 * r + c] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_i[r] - mx[r]);  // finite mx: tile 0 holds key 0
      m_i[r] = mx[r];
      l_i[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_i[e >> 1]);
        l_i[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);  // P rounded to bf16
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t b0[2], b1[2];
        load_b_trans2(b0, b1, v_s, kLd, kk * 16, n * 8, lane);
        mma(o[n], pa, b0);
        mma(o[n + 1], pa, b1);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  store_rows<D>(p.o, o, 1.f / l_i[0], 1.f / l_i[1], p, b, h, q0 + warp * 16, g, t);
  if (p.m != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < T) {
        const int64_t i = (static_cast<int64_t>(b) * p.H + h) * T + row;
        p.m[i] = m_i[r];
        p.l[i] = l_i[r];
      }
    }
  }
}

// ------------------------------------------------------------------ dK/dV

template <int D>
struct DkvTiles {
  static constexpr int kBlockN = 64;               // keys per block, 16 per warp
  static constexpr int kBlockM = D <= 64 ? 64 : 32;  // queries per tile
  static constexpr int kLd = D + 8;
  // K, V; 2 stages of Q, dO; 2 stages of m, 1/l, di.
  static constexpr int kSmem = (2 * kBlockN + 4 * kBlockM) * kLd * 2 + 2 * 3 * kBlockM * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  using C = DkvTiles<D>;
  constexpr int kLd = C::kLd, kBlockM = C::kBlockM, kBlockN = C::kBlockN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBlockN * kLd;
  bf16* sQ = sV + kBlockN * kLd;       // [2][kBlockM][kLd]
  bf16* sO = sQ + 2 * kBlockM * kLd;   // dO, [2][kBlockM][kLd]
  float* sStat = reinterpret_cast<float*>(sO + 2 * kBlockM * kLd);  // [2][m, 1/l, di][kBlockM]

  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kBlockN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int T = p.T;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * T;
  const int m_tiles = (T + kBlockM - 1) / kBlockM;

  auto load_tile = [&](int i) {
    const int stage = i & 1, m0 = i * kBlockM;
    load_rows<D, kBlockM>(sQ + stage * kBlockM * kLd, p.q, p.sq, b, h, m0, T, tid);
    load_rows<D, kBlockM>(sO + stage * kBlockM * kLd, p.dout, p.sdo, b, h, m0, T, tid);
    float* st = sStat + stage * 3 * kBlockM;
    load_stat<kBlockM>(st, p.m + stat0, m0, T, tid);
    load_stat<kBlockM>(st + kBlockM, p.l + stat0, m0, T, tid);
    load_stat<kBlockM>(st + 2 * kBlockM, p.di + stat0, m0, T, tid);
  };

  load_rows<D, kBlockN>(sK, p.k, p.sk, b, h, n0, T, tid);
  load_rows<D, kBlockN>(sV, p.v, p.sv, b, h, n0, T, tid);
  load_tile(0);
  cp_async_commit();

  // The warp's key rows g and g + 8: masked keys take no dS.
  bool key_masked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + warp * 16 + g + 8 * r;
    key_masked[r] = p.mask != nullptr && key < T && p.mask[static_cast<int64_t>(b) * T + key] == 0;
  }
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);

  for (int i = 0; i < m_tiles; ++i) {
    if (i + 1 < m_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* st = sStat + (i & 1) * 3 * kBlockM;
    // Queries past T: P = exp2(x - inf) * 0 = 0.
    for (int r = tid; r < kBlockM; r += kThreads) {
      const bool valid = i * kBlockM + r < T;
      st[r] = valid ? st[r] : INFINITY;
      st[kBlockM + r] = valid ? 1.f / st[kBlockM + r] : 0.f;
    }
    __syncthreads();
    const bf16* q_s = sQ + (i & 1) * kBlockM * kLd;
    const bf16* do_s = sO + (i & 1) * kBlockM * kLd;
    const float* s_m = st;
    const float* s_rl = st + kBlockM;
    const float* s_di = st + 2 * kBlockM;

    // S^T = K Q^T and dP^T = V dO^T over the warp's 16 keys and the tile's queries.
    float pt[kBlockM / 8][4], dpt[kBlockM / 8][4];
    zero(pt);
    zero(dpt);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, kLd, warp * 16, kk * 16, g, t);
      load_a(va, sV, kLd, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
        uint32_t bq[2], bo[2];
        load_b(bq, q_s, kLd, n * 8, kk * 16, g, t);
        load_b(bo, do_s, kLd, n * 8, kk * 16, g, t);
        mma(pt[n], ka, bq);
        mma(dpt[n], va, bo);
      }
    }
    // P^T = exp2(S^T s log2 e - m) / l; dS^T = P^T o (dP^T - di), 0 at masked keys.
#pragma unroll
    for (int n = 0; n < kBlockM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qi = n * 8 + 2 * t + (e & 1);
        const float x = key_masked[r] ? kMasked : pt[n][e] * p.scale_log2;
        const float prob = exp2f(x - s_m[qi]) * s_rl[qi];
        pt[n][e] = prob;
        dpt[n][e] = key_masked[r] ? 0.f : prob * (dpt[n][e] - s_di[qi]);
      }
    }
    // dV += P^T dO and dK += dS^T Q (sm_scale applied at the end).
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, pt[2 * kk], pt[2 * kk + 1]);
      acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t b0[2], b1[2];
        load_b_trans2(b0, b1, do_s, kLd, kk * 16, n * 8, lane);
        mma(dv[n], pa, b0);
        mma(dv[n + 1], pa, b1);
        load_b_trans2(b0, b1, q_s, kLd, kk * 16, n * 8, lane);
        mma(dk[n], da, b0);
        mma(dk[n + 1], da, b1);
      }
    }
    __syncthreads();
  }
  store_rows<D>(p.dk, dk, p.scale, p.scale, p, b, h, n0 + warp * 16, g, t);
  store_rows<D>(p.dv, dv, 1.f, 1.f, p, b, h, n0 + warp * 16, g, t);
}

// --------------------------------------------------------------------- dQ

template <int D>
struct DqTiles {
  static constexpr int kBlockM = 64;               // query rows per block, 16 per warp
  static constexpr int kBlockN = D <= 64 ? 64 : 32;  // keys per tile
  static constexpr int kLd = D + 8;
  static constexpr int kSmem = (2 * kBlockM + 4 * kBlockN) * kLd * 2;  // Q, dO; 2 stages of K, V
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  using C = DqTiles<D>;
  constexpr int kLd = C::kLd, kBlockM = C::kBlockM, kBlockN = C::kBlockN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kBlockM * kLd;  // dO
  bf16* sK = sO + kBlockM * kLd;  // [2][kBlockN][kLd]
  bf16* sV = sK + 2 * kBlockN * kLd;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int T = p.T;
  const uint8_t* mask = p.mask ? p.mask + static_cast<int64_t>(b) * T : nullptr;
  const int n_tiles = (T + kBlockN - 1) / kBlockN;

  load_rows<D, kBlockM>(sQ, p.q, p.sq, b, h, q0, T, tid);
  load_rows<D, kBlockM>(sO, p.dout, p.sdo, b, h, q0, T, tid);
  load_rows<D, kBlockN>(sK, p.k, p.sk, b, h, 0, T, tid);
  load_rows<D, kBlockN>(sV, p.v, p.sv, b, h, 0, T, tid);
  cp_async_commit();

  // Rows g and g + 8: m, 1/l and di; rows past T get P = 0.
  float m_r[2], rl_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const int64_t i = (static_cast<int64_t>(b) * p.H + h) * T + row;
    const bool valid = row < T;
    m_r[r] = valid ? p.m[i] : INFINITY;
    rl_r[r] = valid ? 1.f / p.l[i] : 0.f;
    di_r[r] = valid ? p.di[i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], sQ, kLd, warp * 16, kk * 16, g, t);
    load_a(of[kk], sO, kLd, warp * 16, kk * 16, g, t);
  }
  float dq[D / 8][4];
  zero(dq);

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int stage = (j + 1) & 1;
      load_rows<D, kBlockN>(sK + stage * kBlockN * kLd, p.k, p.sk, b, h, (j + 1) * kBlockN, T, tid);
      load_rows<D, kBlockN>(sV + stage * kBlockN * kLd, p.v, p.sv, b, h, (j + 1) * kBlockN, T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = sK + (j & 1) * kBlockN * kLd;
    const bf16* v_s = sV + (j & 1) * kBlockN * kLd;

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        uint32_t bk[2], bv[2];
        load_b(bk, k_s, kLd, n * 8, kk * 16, g, t);
        load_b(bv, v_s, kLd, n * 8, kk * 16, g, t);
        mma(s[n], qf[kk], bk);
        mma(dp[n], of[kk], bv);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = j * kBlockN + n * 8 + 2 * t + c;
        const bool in_range = key < T;
        const bool masked = in_range && mask != nullptr && mask[key] == 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float x = !in_range ? -INFINITY : (masked ? kMasked : s[n][e] * p.scale_log2);
          const float prob = exp2f(x - m_r[r]) * rl_r[r];
          s[n][e] = (masked || !in_range) ? 0.f : prob * (dp[n][e] - di_r[r]);  // dS
        }
      }
    }
    // dQ += dS K (sm_scale applied at the end).
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t b0[2], b1[2];
        load_b_trans2(b0, b1, k_s, kLd, kk * 16, n * 8, lane);
        mma(dq[n], da, b0);
        mma(dq[n + 1], da, b1);
      }
    }
    __syncthreads();
  }
  store_rows<D>(p.dq, dq, p.scale, p.scale, p, b, h, q0 + warp * 16, g, t);
}

// ----------------------------------------------------------------- launch

enum Kind { kForward, kDkv, kDq };

template <int D, Kind K>
int launch(const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = K == kForward ? &flash_fwd_kernel<D>
                           : K == kDkv   ? &flash_dkv_kernel<D>
                                         : &flash_dq_kernel<D>;
  const int smem = K == kForward ? FwdTiles<D>::kSmem
                   : K == kDkv   ? DkvTiles<D>::kSmem
                                 : DqTiles<D>::kSmem;
  const int rows = K == kDkv ? DkvTiles<D>::kBlockN : 64;  // rows of the output per block
  // Above 48 KB of dynamic shared memory a kernel has to opt in; once per
  // instantiation (thread-safe static initialization).
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((p.T + rows - 1) / rows, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <Kind K>
int dispatch(const Params& p, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32, K>(p, s);
    case 48: return launch<48, K>(p, s);
    case 64: return launch<64, K>(p, s);
    case 96: return launch<96, K>(p, s);
    case 128: return launch<128, K>(p, s);
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

}  // namespace

// Operands are bf16 (B, T, H, D) with D in {32, 48, 64, 96, 128}, read
// through `strides`: 12 element strides (b, t, h) of q, k, v and dO in that
// order (dO's unused by the forward), each a multiple of 8 with 16-byte
// aligned bases and unit stride along D. mask: (B, T) bytes, 0 = key not
// attended, or null. Outputs O, dQ, dK, dV: (B, T, H, D) bf16 contiguous;
// m, l, di: (B, H, T) f32 contiguous. Every pointer on the device of
// `stream`. Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue (1) for a head width it does not take.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v,
                                       const uint8_t* mask, void* o, float* m, float* l, int B,
                                       int H, int T, int D, const int64_t* strides, float sm_scale,
                                       void* stream) {
  Params p = make_params(q, k, v, mask, B, H, T, strides, sm_scale);
  p.o = static_cast<bf16*>(o);
  p.m = m;
  p.l = l;
  return dispatch<kForward>(p, D, stream);
}

extern "C" int flash_attention_backward_dkv(const void* q, const void* k, const void* v,
                                            const uint8_t* mask, const void* dout, const float* m,
                                            const float* l, const float* di, void* dk, void* dv,
                                            int B, int H, int T, int D, const int64_t* strides,
                                            float sm_scale, void* stream) {
  Params p = make_params(q, k, v, mask, B, H, T, strides, sm_scale);
  p.dout = static_cast<const bf16*>(dout);
  p.m = const_cast<float*>(m);
  p.l = const_cast<float*>(l);
  p.di = di;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  return dispatch<kDkv>(p, D, stream);
}

extern "C" int flash_attention_backward_dq(const void* q, const void* k, const void* v,
                                           const uint8_t* mask, const void* dout, const float* m,
                                           const float* l, const float* di, void* dq, int B, int H,
                                           int T, int D, const int64_t* strides, float sm_scale,
                                           void* stream) {
  Params p = make_params(q, k, v, mask, B, H, T, strides, sm_scale);
  p.dout = static_cast<const bf16*>(dout);
  p.m = const_cast<float*>(m);
  p.l = const_cast<float*>(l);
  p.di = di;
  p.dq = static_cast<bf16*>(dq);
  return dispatch<kDq>(p, D, stream);
}
