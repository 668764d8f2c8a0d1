// Flash attention's backward with a per-key mask in f32 arithmetic on the
// CUDA cores: the dK/dV and dQ kernels for f32 operands.
//
// Replace, for f32 operands, the same stock Pallas TPU kernels as
// flash_attention.cu's pair (jax/experimental/pallas/ops/tpu/flash_attention.py
// in jax 0.9.0: _flash_attention_dkv_kernel :796, _flash_attention_dq_kernel
// :1146), which the reference's fused_self_attention runs at T >= 2048 on a
// TPU in the operands' own dtype, f32 included. Their forward is
// flash_attention_tf32.cu's, on the tensor cores in split TF32; these two
// are still f32 arithmetic on the CUDA cores, the slowest part of the f32
// route (a wgmma pair in split TF32 is the next step).
//
// What they compute is flash_attention.cu's backward, term for term, with
// every operand and product in f32, from the forward's saved m (base 2) and
// l: P = exp2(S - m) / l with S = sm_scale Q K^T in base 2 (times log2(e)),
// masked keys at bf16's lowest finite value (so a row whose keys are all
// masked recomputes P = 1/T), keys past T skipped; dV = P^T dO, dS = P o (dO
// V^T - di), 0 at masked keys, dK = sm_scale dS^T Q, dQ = sm_scale dS K.
//
// Design, the simplest that is right (none of the main paths runs it:
// serve runs no backward, train runs bf16):
//   * a group of R threads owns one row: a query in dQ, a key in dK/dV (R =
//     1 at d <= 32, 2 at d <= 64, 4 above, so each thread holds d / R <= 32
//     elements of each of its row's vectors in registers); a dot product is
//     R partial sums joined by xor shuffles, which leave the same sum in
//     every thread of the group;
//   * the other operand streams through shared memory in tiles of 32 rows,
//     read whole by every group (broadcast); each thread's d / R elements
//     of a shared row sit 16 bytes apart from the next thread's, so the
//     groups of a quarter warp read distinct banks with 16-byte loads;
//   * dQ and dK/dV take one row of the tile at a time;
//   * no atomics: dQ has its own kernel, as in flash_attention.cu.
// What bounds them: the FP32 units and the shared-memory loads (one 16-byte
// load per 4 FMAs of a thread), far from the tensor cores' rate.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // rows of the streamed operand per tile
constexpr float kLog2e = 1.4426950408889634f;
// The plain branch's masked logit: bf16's lowest finite value, exact in f32.
constexpr float kMasked = -3.3895313892515355e38f;

struct Strides {  // element strides of a (B, T, H, d) operand whose d is unit-stride
  int64_t b, t, h;
};

struct SimtParams {
  const float *q, *k, *v, *dout;
  const uint8_t* mask;  // (B, T), 0 = key not attended; null: every key attended
  float *dq, *dk, *dv;  // (B, T, H, d) contiguous
  float *m, *l;         // (B, H, T): the forward's row max (base 2) and row sum
  const float* di;      // (B, H, T): rowsum(dO o O)
  Strides sq, sk, sv, sdo;
  int B, H, T;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

template <int D>
struct Shape {
  static constexpr int R = D <= 32 ? 1 : (D <= 64 ? 2 : 4);  // threads per row
  static constexpr int DH = D / R;                           // elements per thread
  static constexpr int ROWS = kThreads / R;                  // rows per block
  static constexpr int LD = R * (DH + 4);                    // shared row stride, floats
  static_assert(D % R == 0 && DH % 4 == 0, "whole 16-byte chunks per thread");
};

// The sum of x over the R threads of a row's group, in every one of them.
template <int R>
__device__ __forceinline__ float group_sum(float x) {
  if (R >= 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  if (R >= 4) x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Thread r's DH elements of a row, from shared memory (16-byte aligned).
template <int DH>
__device__ __forceinline__ float dot_shared(const float (&x)[DH], const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < DH; e += 4) {
    const float4 y = *reinterpret_cast<const float4*>(row + e);
    acc = fmaf(x[e], y.x, acc);
    acc = fmaf(x[e + 1], y.y, acc);
    acc = fmaf(x[e + 2], y.z, acc);
    acc = fmaf(x[e + 3], y.w, acc);
  }
  return acc;
}

template <int DH>
__device__ __forceinline__ void axpy_shared(float (&acc)[DH], float a, const float* row) {
#pragma unroll
  for (int e = 0; e < DH; e += 4) {
    const float4 y = *reinterpret_cast<const float4*>(row + e);
    acc[e] = fmaf(a, y.x, acc[e]);
    acc[e + 1] = fmaf(a, y.y, acc[e + 1]);
    acc[e + 2] = fmaf(a, y.z, acc[e + 2]);
    acc[e + 3] = fmaf(a, y.w, acc[e + 3]);
  }
}

// Rows [r0, r0 + kTile) of one (b, h) slice of an operand into a shared
// tile laid out [row][thread of the group][DH + 4]; rows at or past T are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* base, Strides s, int b, int h,
                                          int r0, int T) {
  using S = Shape<D>;
  const float* bh = base + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int row = i / D, col = i % D;
    const bool valid = r0 + row < T;
    tile[row * S::LD + (col / S::DH) * (S::DH + 4) + col % S::DH] =
        valid ? bh[(r0 + row) * s.t + col] : 0.f;
  }
}

// Thread r's DH elements of row `row` of an operand (0 past T).
template <int D>
__device__ __forceinline__ void load_own(float (&x)[Shape<D>::DH], const float* base, Strides s,
                                         int b, int h, int row, int T, int r) {
  const float* p = base + b * s.b + h * s.h + static_cast<int64_t>(row < T ? row : 0) * s.t +
               r * Shape<D>::DH;
#pragma unroll
  for (int e = 0; e < Shape<D>::DH; ++e) x[e] = row < T ? p[e] : 0.f;
}

template <int D>
__device__ __forceinline__ void store_own(float* out, const float (&x)[Shape<D>::DH], float mul,
                                          int b, int h, int row, int T, int H, int r) {
  if (row >= T) return;
  float* p = out + (static_cast<int64_t>(b) * T + row) * H * D + static_cast<int64_t>(h) * D +
         r * Shape<D>::DH;
#pragma unroll
  for (int e = 0; e < Shape<D>::DH; ++e) p[e] = x[e] * mul;
}

// Codes of keys [r0, r0 + kTile): 0 attended, 1 masked, 2 past T.
__device__ __forceinline__ void load_codes(uint8_t* code, const uint8_t* mask, int b, int r0,
                                           int T) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int key = r0 + i;
    code[i] = key >= T ? 2 : (mask != nullptr && mask[static_cast<int64_t>(b) * T + key] == 0);
  }
}

// ---------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_simt_kernel(const SimtParams p) {
  using S = Shape<D>;
  __shared__ __align__(16) float ks[kTile * S::LD];
  __shared__ __align__(16) float vs[kTile * S::LD];
  __shared__ uint8_t code[kTile];
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x % S::R;
  const int row = blockIdx.x * S::ROWS + threadIdx.x / S::R;
  float q[S::DH], dout[S::DH], dq[S::DH];
  load_own<D>(q, p.q, p.sq, b, h, row, p.T, r);
  load_own<D>(dout, p.dout, p.sdo, b, h, row, p.T, r);
#pragma unroll
  for (int e = 0; e < S::DH; ++e) dq[e] = 0.f;
  float m = 0.f, rl = 0.f, di = 0.f;
  if (row < p.T) {
    const int64_t i = (static_cast<int64_t>(b) * p.H + h) * p.T + row;
    m = p.m[i];
    rl = 1.f / p.l[i];
    di = p.di[i];
  }
  const int off = r * (S::DH + 4);
  for (int j0 = 0; j0 < p.T; j0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, p.k, p.sk, b, h, j0, p.T);
    load_tile<D>(vs, p.v, p.sv, b, h, j0, p.T);
    load_codes(code, p.mask, b, j0, p.T);
    __syncthreads();
    const int n = min(kTile, p.T - j0);
    for (int j = 0; j < n; ++j) {
      const float* kj = ks + j * S::LD + off;
      const float x = group_sum<S::R>(dot_shared<S::DH>(q, kj)) * p.scale_log2;
      const bool masked = code[j] == 1;
      const float prob = exp2f((masked ? kMasked : x) - m) * rl;
      const float dp = group_sum<S::R>(dot_shared<S::DH>(dout, vs + j * S::LD + off));
      axpy_shared<S::DH>(dq, masked ? 0.f : prob * (dp - di), kj);
    }
  }
  store_own<D>(p.dq, dq, p.scale, b, h, row, p.T, p.H, r);
}

// ---------------------------------------------------------------- dK/dV

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_simt_kernel(const SimtParams p) {
  using S = Shape<D>;
  __shared__ __align__(16) float qs[kTile * S::LD];
  __shared__ __align__(16) float dos[kTile * S::LD];
  __shared__ float ms[kTile], rls[kTile], dis[kTile];
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x % S::R;
  const int key = blockIdx.x * S::ROWS + threadIdx.x / S::R;
  float k[S::DH], v[S::DH], dk[S::DH], dv[S::DH];
  load_own<D>(k, p.k, p.sk, b, h, key, p.T, r);
  load_own<D>(v, p.v, p.sv, b, h, key, p.T, r);
#pragma unroll
  for (int e = 0; e < S::DH; ++e) dk[e] = dv[e] = 0.f;
  const bool masked =
      key < p.T && p.mask != nullptr && p.mask[static_cast<int64_t>(b) * p.T + key] == 0;
  const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.T;
  const int off = r * (S::DH + 4);
  for (int i0 = 0; i0 < p.T; i0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, p.q, p.sq, b, h, i0, p.T);
    load_tile<D>(dos, p.dout, p.sdo, b, h, i0, p.T);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool valid = i0 + i < p.T;
      ms[i] = valid ? p.m[stat + i0 + i] : 0.f;
      rls[i] = valid ? 1.f / p.l[stat + i0 + i] : 0.f;
      dis[i] = valid ? p.di[stat + i0 + i] : 0.f;
    }
    __syncthreads();
    const int n = min(kTile, p.T - i0);
    for (int i = 0; i < n; ++i) {
      const float* qi = qs + i * S::LD + off;
      const float* doi = dos + i * S::LD + off;
      const float x = group_sum<S::R>(dot_shared<S::DH>(k, qi)) * p.scale_log2;
      const float prob = exp2f((masked ? kMasked : x) - ms[i]) * rls[i];
      const float dp = group_sum<S::R>(dot_shared<S::DH>(v, doi));
      axpy_shared<S::DH>(dv, prob, doi);
      axpy_shared<S::DH>(dk, masked ? 0.f : prob * (dp - dis[i]), qi);
    }
  }
  store_own<D>(p.dk, dk, p.scale, b, h, key, p.T, p.H, r);
  store_own<D>(p.dv, dv, 1.f, b, h, key, p.T, p.H, r);
}

// ----------------------------------------------------------------- launch

enum Kind { kDkv, kDq };

template <int D, Kind K>
int launch(const SimtParams& p, cudaStream_t stream) {
  void (*kernel)(SimtParams) = K == kDkv ? &flash_dkv_simt_kernel<D> : &flash_dq_simt_kernel<D>;
  const dim3 grid((p.T + Shape<D>::ROWS - 1) / Shape<D>::ROWS, p.H, p.B);
  kernel<<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <Kind K>
int dispatch(const SimtParams& p, int D, void* stream) {
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

SimtParams make_params(const void* q, const void* k, const void* v, const uint8_t* mask,
                          const void* dout, const float* m, const float* l, const float* di,
                          int B, int H, int T, const int64_t* strides, float sm_scale) {
  SimtParams p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.mask = mask;
  p.m = const_cast<float*>(m);
  p.l = const_cast<float*>(l);
  p.di = di;
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

int backward_dkv(const void* q, const void* k, const void* v, const uint8_t* mask,
                 const void* dout, const float* m, const float* l, const float* di, void* dk,
                 void* dv, int B, int H, int T, int D, const int64_t* strides, float sm_scale,
                 void* stream) {
  SimtParams p = make_params(q, k, v, mask, dout, m, l, di, B, H, T, strides, sm_scale);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return dispatch<kDkv>(p, D, stream);
}

int backward_dq(const void* q, const void* k, const void* v, const uint8_t* mask,
                const void* dout, const float* m, const float* l, const float* di, void* dq,
                int B, int H, int T, int D, const int64_t* strides, float sm_scale,
                void* stream) {
  SimtParams p = make_params(q, k, v, mask, dout, m, l, di, B, H, T, strides, sm_scale);
  p.dq = static_cast<float*>(dq);
  return dispatch<kDq>(p, D, stream);
}

}  // namespace

// The entry points, with flash_attention.cu's arguments, for f32 operands
// and outputs, on the statistics (m in base 2, l) that flash_attention_tf32.cu's
// forward saves; each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue (1) for a head width without a kernel.
extern "C" int flash_attention_backward_dkv_f32(const void* q, const void* k, const void* v,
                                                const uint8_t* mask, const void* dout,
                                                const float* m, const float* l, const float* di,
                                                void* dk, void* dv, int B, int H, int T, int D,
                                                const int64_t* strides, float sm_scale,
                                                void* stream) {
  return backward_dkv(q, k, v, mask, dout, m, l, di, dk, dv, B, H, T, D, strides, sm_scale,
                      stream);
}

extern "C" int flash_attention_backward_dq_f32(const void* q, const void* k, const void* v,
                                               const uint8_t* mask, const void* dout,
                                               const float* m, const float* l, const float* di,
                                               void* dq, int B, int H, int T, int D,
                                               const int64_t* strides, float sm_scale,
                                               void* stream) {
  return backward_dq(q, k, v, mask, dout, m, l, di, dq, B, H, T, D, strides, sm_scale, stream);
}
