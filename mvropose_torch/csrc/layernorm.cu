// LayerNorm and residual-add + LayerNorm on Hopper (sm_90a): one warp per row,
// writing y in the output type or, for the int8 matmuls that read it, its
// per-token int8 quantization.
//
// Replaces mvropose_tpu/ops/layernorm.py::_ln_kernel and ::_res_ln_kernel, the
// Pallas TPU kernels behind fused_layernorm and fused_residual_layernorm, with
// their arithmetic:
//   v     = f32(x)                     (LayerNorm)
//   v     = f32(x) + f32(h)            (residual: xnew = v written in x's type)
//   mean  = sum(v) / D,  var = sum(v * v) / D - mean * mean   (no clamp)
//   y     = (v - mean) * rsqrt(var + eps) * scale + bias      (scale, bias f32)
// so the residual variant normalizes the unrounded f32 sum, not xnew.
//
// What bounds it on an H100: bytes. At the serve shape (4100 rows of 768) a
// bf16 LayerNorm reads 6.3 MB and writes 6.3 MB (residual: 12.6 + 12.6 MB),
// a few microseconds at 3.35 TB/s, against ~0.1 GFLOP. The design follows:
//   * one warp per row, so the statistics reduce by shuffles alone, with no
//     shared memory and no block barrier, and rows past M return whole warps;
//   * 16-byte loads and stores (8 bf16 or 4 f32 per lane) where the row's
//     pointers are 16-byte aligned, then a scalar tail for the rest of the
//     row, so D need not be a multiple of 128 (the TPU's lane rule) nor of 8;
//   * pass 2 re-reads x (and h) instead of holding the row in registers: the
//     row was read by the same warp a moment earlier and comes from L1/L2,
//     and any D fits. Recomputing f32(x) + f32(h) gives the same f32 sum as
//     pass 1, bit for bit.
//
// The int8 output (kInt8) replaces the per-token quantization that the int8
// matmuls of q/k/v and fc1 did on y in a kernel of their own
// (mvropose_tpu/models/quantize.py:37 int8_matmul's s_x and x_q lines, in
// csrc/int8_gemm.cu int8_quantize_rows_kernel): y, rounded to the output
// type as the float output is, gives the row max m = max |y|, s_x =
// max(m, 1e-6) / 127 and x_q = rint(y / s_x) (csrc/int8_quantize.cuh), and
// x_q (int8, row-major, the GEMM's K-major A operand) and s_x (f32, one a
// row) are written instead of y. The same code computes y, so x_q and s_x
// are bit-equal to this kernel's y quantized by the rows kernel, which saves
// y's write, its re-read and a launch. The row max comes before any
// quantized value, so a third pass normalizes each chunk again from x (and
// h), which gives the same bits, and quantizes it. Holding y in registers
// from the max to the quantization instead takes ~75 registers a thread
// against ~45: 3 blocks of 256 threads an SM, not 5, so the serve shape's
// 513 blocks no longer fit one wave on 132 SMs; it was the slower of the two
// at 768 on the card (PERF.md), and limiting it to 64 registers spilled.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_quantize.cuh"  // Divisor, quantized_byte, pack4

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch and XLA cast
}

// N elements of T moved as whole 16-byte words.
template <typename T, int N>
struct alignas(16) Pack {
  T v[N];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}

template <typename T, int N>
__device__ __forceinline__ float abs_max(const Pack<T, N>& p, float m) {
#pragma unroll
  for (int k = 0; k < N; ++k) m = fmaxf(m, fabsf(to_f32(p.v[k])));
  return m;
}

// A chunk of N (8 or 4) rounded values quantized into N bytes at dst.
template <typename T, int N>
__device__ __forceinline__ void store_quantized(int8_t* dst, const Pack<T, N>& p, Divisor d) {
  uint32_t w[N / 4];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    w[k] = pack4(quantized_byte(to_f32(p.v[4 * k]), d), quantized_byte(to_f32(p.v[4 * k + 1]), d),
                 quantized_byte(to_f32(p.v[4 * k + 2]), d),
                 quantized_byte(to_f32(p.v[4 * k + 3]), d));
  }
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// Tin: x, h and xnew; Tout: y (or the type y is rounded to before its
// quantization). kResidual selects _res_ln_kernel's arithmetic; kInt8 writes
// xq and sx instead of y.
template <typename Tin, typename Tout, bool kResidual, bool kInt8>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const Tin* __restrict__ x, const Tin* __restrict__ h,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 Tin* __restrict__ xnew, Tout* __restrict__ y, int8_t* __restrict__ xq,
                 float* __restrict__ sx, int M, int D, float eps) {
  constexpr int kVec = 16 / sizeof(Tin);  // elements per 16-byte load of Tin
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // the whole warp leaves together: the shuffles stay full

  const int64_t off = static_cast<int64_t>(row) * D;
  const Tin* xr = x + off;
  const Tin* hr = kResidual ? h + off : nullptr;
  Tin* xnr = kResidual ? xnew + off : nullptr;
  Tout* yr = kInt8 ? nullptr : y + off;
  int8_t* qr = kInt8 ? xq + off : nullptr;
  const bool vec = aligned16(xr) && (kInt8 ? aligned16(qr) : aligned16(yr)) &&
                   aligned16(scale) && aligned16(bias) &&
                   (!kResidual || (aligned16(hr) && aligned16(xnr)));
  const int nvec = vec ? D / kVec : 0;  // 16-byte chunks; the rest is the scalar tail

  // Pass 1: f32 sums of v and v * v (and the residual written in x's type).
  float s = 0.f, ss = 0.f;
  for (int j = lane; j < nvec; j += 32) {
    const Pack<Tin, kVec> px = reinterpret_cast<const Pack<Tin, kVec>*>(xr)[j];
    Pack<Tin, kVec> ph;
    if constexpr (kResidual) ph = reinterpret_cast<const Pack<Tin, kVec>*>(hr)[j];
    Pack<Tin, kVec> pn;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v = to_f32(px.v[k]);
      if constexpr (kResidual) {
        v += to_f32(ph.v[k]);
        pn.v[k] = from_f32<Tin>(v);
      }
      s += v;
      ss += v * v;
    }
    if constexpr (kResidual) reinterpret_cast<Pack<Tin, kVec>*>(xnr)[j] = pn;
  }
  for (int i = nvec * kVec + lane; i < D; i += 32) {
    float v = to_f32(xr[i]);
    if constexpr (kResidual) {
      v += to_f32(hr[i]);
      xnr[i] = from_f32<Tin>(v);
    }
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / static_cast<float>(D);
  const float var = ss / static_cast<float>(D) - mean * mean;
  const float rstd = rsqrtf(var + eps);

  // y of chunk j and of value i, normalized, scaled, shifted and rounded to Tout.
  auto chunk = [&](int j) {
    const Pack<Tin, kVec> px = reinterpret_cast<const Pack<Tin, kVec>*>(xr)[j];
    Pack<Tin, kVec> ph;
    if constexpr (kResidual) ph = reinterpret_cast<const Pack<Tin, kVec>*>(hr)[j];
    const Pack<float, kVec> g = reinterpret_cast<const Pack<float, kVec>*>(scale)[j];
    const Pack<float, kVec> b = reinterpret_cast<const Pack<float, kVec>*>(bias)[j];
    Pack<Tout, kVec> py;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v = to_f32(px.v[k]);
      if constexpr (kResidual) v += to_f32(ph.v[k]);
      py.v[k] = from_f32<Tout>((v - mean) * rstd * g.v[k] + b.v[k]);
    }
    return py;
  };
  auto value = [&](int i) {
    float v = to_f32(xr[i]);
    if constexpr (kResidual) v += to_f32(hr[i]);
    return from_f32<Tout>((v - mean) * rstd * scale[i] + bias[i]);
  };

  if constexpr (!kInt8) {
    // Pass 2: y written in Tout.
    for (int j = lane; j < nvec; j += 32) reinterpret_cast<Pack<Tout, kVec>*>(yr)[j] = chunk(j);
    for (int i = nvec * kVec + lane; i < D; i += 32) yr[i] = value(i);
  } else {
    // Pass 2: the row max of |y|.
    float m = 0.f;
    for (int j = lane; j < nvec; j += 32) m = abs_max(chunk(j), m);
    for (int i = nvec * kVec + lane; i < D; i += 32) m = fmaxf(m, fabsf(to_f32(value(i))));
    const Divisor dv = divisor_of_max(warp_max(m));
    if (lane == 0) sx[row] = dv.s;
    // Pass 3: x_q = rint(y / s_x), each chunk normalized again.
    for (int j = lane; j < nvec; j += 32) store_quantized(qr + j * kVec, chunk(j), dv);
    for (int i = nvec * kVec + lane; i < D; i += 32) {
      qr[i] = static_cast<int8_t>(quantized_byte(to_f32(value(i)), dv) & 0xffu);
    }
  }
}

template <typename Tin, typename Tout, bool kResidual, bool kInt8>
int launch(const void* x, const void* h, const float* scale, const float* bias, void* xnew,
           void* y, int8_t* xq, float* sx, int M, int D, float eps, void* stream) {
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_kernel<Tin, Tout, kResidual, kInt8>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Tin*>(x), static_cast<const Tin*>(h), scale, bias,
          static_cast<Tin*>(xnew), static_cast<Tout*>(y), xq, sx, M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// The instance for a type pair (0 = f32, 1 = bf16; pairs (bf16, bf16),
// (f32, f32) and (bf16, f32)) and the residual flag, or
// cudaErrorInvalidValue (1) for a pair without one.
template <bool kInt8>
int dispatch(const void* x, const void* h, const float* scale, const float* bias, void* xnew,
             void* y, int8_t* xq, float* sx, int M, int D, float eps, int in_type, int out_type,
             int residual, void* stream) {
  using bf = __nv_bfloat16;
  const int pair = in_type * 2 + out_type;
  if (residual) {
    switch (pair) {
      case 3: return launch<bf, bf, true, kInt8>(x, h, scale, bias, xnew, y, xq, sx, M, D, eps, stream);
      case 0: return launch<float, float, true, kInt8>(x, h, scale, bias, xnew, y, xq, sx, M, D, eps, stream);
      case 2: return launch<bf, float, true, kInt8>(x, h, scale, bias, xnew, y, xq, sx, M, D, eps, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (pair) {
    case 3: return launch<bf, bf, false, kInt8>(x, h, scale, bias, xnew, y, xq, sx, M, D, eps, stream);
    case 0: return launch<float, float, false, kInt8>(x, h, scale, bias, xnew, y, xq, sx, M, D, eps, stream);
    case 2: return launch<bf, float, false, kInt8>(x, h, scale, bias, xnew, y, xq, sx, M, D, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (and h): (M, D) rows of the input type, contiguous; scale, bias: (D,) f32;
// y: (M, D) of the output type; xnew: (M, D) of the input type (residual
// only). Every pointer on the device of `stream`. Types: 0 = f32, 1 = bf16;
// (in, out) pairs (bf16, bf16), (f32, f32) and (bf16, f32). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue (1) for a
// type pair without an instance.
extern "C" int layernorm_fwd(const void* x, const void* h, const float* scale, const float* bias,
                             void* xnew, void* y, int M, int D, float eps, int in_type,
                             int out_type, int residual, void* stream) {
  return dispatch<false>(x, h, scale, bias, xnew, y, nullptr, nullptr, M, D, eps, in_type,
                         out_type, residual, stream);
}

// As layernorm_fwd, with y (rounded to the output type) quantized per row
// instead of written: xq (M, D) int8 contiguous, sx (M,) f32.
extern "C" int layernorm_int8_fwd(const void* x, const void* h, const float* scale,
                                  const float* bias, void* xnew, void* xq, float* sx, int M,
                                  int D, float eps, int in_type, int out_type, int residual,
                                  void* stream) {
  return dispatch<true>(x, h, scale, bias, xnew, nullptr, static_cast<int8_t*>(xq), sx, M, D,
                        eps, in_type, out_type, residual, stream);
}
