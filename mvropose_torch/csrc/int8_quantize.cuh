// The int8 quantization's arithmetic, shared by the kernels that quantize:
// csrc/layernorm.cu (the LayerNorm kernels' int8 output), csrc/int8_gemm.cu
// (int8_quantize_rows_kernel) and csrc/int8_attention.cu
// (int8_quantize_v_kernel). The reference (mvropose_tpu/models/quantize.py:37
// int8_matmul, mvropose_tpu/ops/attention.py:70-71) computes, per row or
// channel of values x with m = max |x|:
//   s = max(m, 1e-6) / 127      one rounded division
//   q = rint(x / s)             x / s one rounded division, rint half to even
// A division per value is the costly part: div.rn.f32 is a reciprocal on
// the special-function unit, a Newton step and a range check with a slow
// path. s is shared by the row, so its correctly rounded reciprocal
// r = RN(1 / s) is taken once, and each value takes Markstein's correction
// steps with r: q0 = RN(x r), q1 = RN(q0 + RN(x - s q0) r), and q2 = RN(q1
// + RN(x - s q1) r). q1 is within one ulp of x / s, and from such a q and
// r = RN(1 / s) the residual x - s q is exact and q2 is RN(x / s)
// (Markstein, IBM J. Res. Dev. 34, 1990; Muller et al., Handbook of
// Floating-Point Arithmetic, the FMA-based division). That holds where no
// step underflows: here |x| <= m and s >= 1e-6 / 127, so a quotient that
// can round to a nonzero integer has |x| >= s / 4 > 1.9e-9 and every
// residual stays a normal number; below that every step gives |q| < 1/2,
// as the division does. Five operations a value in place of the division's
// ten and its reciprocal; tests/test_torch_int8_quantize.py::
// test_markstein_steps_are_the_division holds the steps against the
// division value by value. Each step is an explicit `_rn`
// intrinsic, so nvcc contracts nothing into another rounding.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// A row's (or channel's) scale and its reciprocal.
struct Divisor {
  float s;  // max(m, 1e-6) / 127, one rounded division
  float r;  // RN(1 / s)
};

__device__ __forceinline__ Divisor divisor_of_max(float m) {
  const float s = __fdiv_rn(fmaxf(m, 1e-6f), 127.f);
  return {s, __frcp_rn(s)};
}

// x / d.s rounded to nearest: __fdiv_rn(x, d.s) for |x| <= 127.5 d.s wherever
// |x| >= d.s / 4 (an underflowing step below that leaves |q| < 1/2 all the same).
__device__ __forceinline__ float quotient(float x, Divisor d) {
  const float q0 = __fmul_rn(x, d.r);
  const float q1 = __fmaf_rn(__fmaf_rn(-d.s, q0, x), d.r, q0);
  return __fmaf_rn(__fmaf_rn(-d.s, q1, x), d.r, q1);
}

// rint(x / d.s) in [-127, 127] as the low byte of the result: x / s + 1.5 * 2^23
// rounds to an integer (half to even), which then sits in the low mantissa bits.
__device__ __forceinline__ uint32_t quantized_byte(float x, Divisor d) {
  return __float_as_uint(__fadd_rn(quotient(x, d), 12582912.0f));
}

// The low bytes of four words -> one word, a's in the lowest byte.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

}  // namespace
