// int8 probabilities times int8 values, with the dequant in the epilogue, on
// Hopper (sm_90a): the P@V of int8-probability attention.
//
// Replaces the int8 P@V of mvropose_tpu/ops/attention.py::int8_prob_attention
// (the einsum "bhqk,bkhd->bqhd" on int8 with int32 accumulation, and the two
// dequant multiplies after it). That function is not Pallas: it was written
// for the TPU's int8 matrix unit, and torch has no batched int8 product on
// CUDA (bmm rejects int8, _int_mm is 2-D). Per (batch*head, query row q,
// channel c):
//   acc = sum_k pq[q, k] * vq[k, c]                     (int32, exact)
//   out = (f32(acc) * (1 / (127 * z[q]))) * sv[c]       (f32, in this order)
// written in the output type (round to nearest even for bf16).
//
// What bounds it on an H100: at the serve shape (48 heads, T = 1025, d = 64)
// it reads 50 MB of pq once, ~15 us at 3.35 TB/s, for 6.5 G int8 operations,
// ~3 us at the tensor cores' int8 rate. So it is bound by bytes, and by how
// many of them are in flight. The design:
//   * one block of 4 warps per 64 query rows of one head; each warp owns 16
//     rows and all 64 channels, and runs mma.sync.m16n8k32 (s8 x s8 -> s32)
//     over 8 column tiles, accumulating in 32 int32 registers a thread;
//   * the key axis is walked in tiles of 64 through a 3-stage ring in shared
//     memory, filled by 16-byte cp.async copies two tiles ahead of the one
//     being multiplied, so the loads stay in flight under the mma work.
//     That needs 16-byte aligned rows readable up to key Tp: the producer
//     writes pq into rows padded to 64 keys (`padded_probs` in the wrapper's
//     module), and the wrapper rejects any other layout. The values come in
//     transposed, (d, Tp), which also
//     makes the mma's column-major B operand whole words of 4 keys. Keys
//     from T to Tp are zero in the values, so whatever pq holds there adds
//     nothing;
//   * a shared-memory row stride of 80 bytes puts the 32 lanes' fragment words
//     in 32 different banks;
//   * the dequant runs on the accumulators before the only store of the
//     output, so no int32 or f32 product reaches device memory.
// Its first version staged pq byte by byte with no pipeline and took ~160 us
// at the serve shape, ~100 us of it waiting on loads (measured on an H100).
// TMA and wgmma, and fusing the softmax and the quantization before it, are
// left for later work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 64;  // d: all 64 channels in one block
constexpr int kBlockM = 64;   // query rows per block, 16 per warp
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kStages = 3;    // tiles in the shared-memory ring
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = kBlockK + 16;  // bytes per shared row: conflict-free fragments
constexpr int kTileBytes = kBlockM * kStride;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(uint8_t* smem, const int8_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
int8_pv_kernel(const int8_t* __restrict__ pq, const int8_t* __restrict__ vt,
               const float* __restrict__ z, const float* __restrict__ sv, Tout* __restrict__ out,
               int T, int Tp, int64_t ldp, int64_t batch_stride) {
  __shared__ __align__(16) uint8_t s_p[kStages][kTileBytes];  // [row][key]
  __shared__ __align__(16) uint8_t s_v[kStages][kTileBytes];  // [channel][key]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int8_t* p_bh = pq + bh * batch_stride;
  const int8_t* v_bh = vt + static_cast<int64_t>(bh) * kHeadDim * Tp;
  const int num_tiles = Tp / kBlockK;

  // Tile kt into ring slot kt % kStages: 64 rows (or channels) x 4 chunks
  // of 16 bytes, two chunks of each operand per thread. Rows past T are not
  // loaded: their slot keeps stale bytes, which only reach output rows that
  // are never stored.
  auto load_tile = [&](int kt) {
    const int k0 = kt * kBlockK;
    uint8_t* sp = s_p[kt % kStages];
    uint8_t* sv_tile = s_v[kt % kStages];
#pragma unroll
    for (int i = 0; i < kBlockM * kBlockK / 16 / kThreads; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk >> 2;
      const int c = (chunk & 3) * 16;
      if (q0 + r < T) cp_async16(sp + r * kStride + c, p_bh + (q0 + r) * ldp + k0 + c);
      cp_async16(sv_tile + r * kStride + c, v_bh + static_cast<int64_t>(r) * Tp + k0 + c);
    }
  };

  int acc[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
  }

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < num_tiles) load_tile(kt);
    cp_async_commit();  // one group per tile, empty past the end, so counts line up
  }
  for (int kt = 0; kt < num_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and slot (kt - 1) is free
    if (kt + kStages - 1 < num_tiles) load_tile(kt + kStages - 1);
    cp_async_commit();

    const uint8_t* sp = s_p[kt % kStages];
    const uint8_t* sv_tile = s_v[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBlockK; kk += 32) {
      const uint8_t* pa = sp + (warp * 16 + g) * kStride + kk + 4 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pa + 8 * kStride);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 16);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(pa + 8 * kStride + 16);
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        const uint8_t* pb = sv_tile + (n * 8 + g) * kStride + kk + 4 * t;
        mma_s8(acc[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(pb),
               *reinterpret_cast<const uint32_t*>(pb + 16));
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator i of column tile n is row g (+8 for i >= 2) of the
  // warp's 16, column 8n + 2t + (i & 1).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + warp * 16 + g + 8 * half;
    if (q >= T) continue;
    const float rz = 1.f / (127.f * z[static_cast<int64_t>(bh) * T + q]);
    Tout* o = out + (static_cast<int64_t>(bh) * T + q) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        const float v = static_cast<float>(acc[n][2 * half + j]) * rz;
        store(o + col, v * sv[bh * kHeadDim + col]);
      }
    }
  }
}

template <typename Tout>
int launch(const int8_t* pq, const int8_t* vt, const float* z, const float* sv, void* out, int BH,
           int T, int Tp, int64_t ldp, int64_t batch_stride, void* stream) {
  const dim3 grid((T + kBlockM - 1) / kBlockM, BH);
  int8_pv_kernel<Tout><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pq, vt, z, sv, static_cast<Tout*>(out), T, Tp, ldp, batch_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pq: (BH, T, T) int8 with rows of stride ldp and heads of stride
// batch_stride (elements), both multiples of 16 with a 16-byte aligned base,
// and readable up to key Tp of each row; vt: (BH, 64, Tp) int8, the values
// transposed, Tp = T rounded up to a multiple of 64, zero past T; z: (BH, T)
// f32; sv: (BH, 64) f32; out: (BH, T, 64), out_type 0 = f32, 1 = bf16. Every
// pointer on the device of `stream`. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue (1) for an unknown out_type or a layout
// the kernel does not take.
extern "C" int int8_pv(const int8_t* pq, const int8_t* vt, const float* z, const float* sv,
                       void* out, int BH, int T, int Tp, int64_t ldp, int64_t batch_stride,
                       int out_type, void* stream) {
  if (Tp % kBlockK != 0 || Tp < T || ldp < Tp || ldp % 16 != 0 || batch_stride % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(pq) & 15u) != 0 || (reinterpret_cast<uintptr_t>(vt) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (out_type) {
    case 0: return launch<float>(pq, vt, z, sv, out, BH, T, Tp, ldp, batch_stride, stream);
    case 1: return launch<__nv_bfloat16>(pq, vt, z, sv, out, BH, T, Tp, ldp, batch_stride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
