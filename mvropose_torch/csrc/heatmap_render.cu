// Gaussian heatmap render on Hopper (sm_90a): one thread block per map.
//
// Replaces mvropose_tpu/ops/heatmap_render.py::_render_kernel, the Pallas TPU
// kernel behind render_heatmaps_pallas. For map m it reads one row
// (x, y, inv) = rows[m], inv = 1 / (2 sigma^2), and writes H*W f32 values
//   hm[r, c] = expf(-((c - x)^2 + (r - y)^2) * inv),
// then 0 wherever hm < f64_eps * (the peak of that map).
//
// What bounds it on an H100: it reads 12 bytes per map and writes H*W*4. At
// the full training shape (576 maps of 512x512, the blob images of 18 groups
// x 4 views x 8 keypoints) that is 604 MB of stores, ~180 us at 3.35 TB/s,
// and 151 M expf per sweep. The floor needs the map's peak before the first
// store. The design:
//   * one block of 256 threads per map and two sweeps. Sweep 1 evaluates
//     every value and reduces the max (warp shuffles, then shared memory);
//     sweep 2 evaluates every value again, applies the floor and stores.
//     The map is recomputed, never read back from memory.
//   * stores coalesce along W: a thread writes 4 consecutive values of a row
//     as one float4 when W % 4 == 0 (every row then starts on a 16-byte
//     boundary), one float at a time otherwise.
//   * the arithmetic is the plain version's, operation by operation:
//     __fsub_rn/__fmul_rn/__fadd_rn keep nvcc from contracting
//     dx*dx + dy*dy into an FMA, and expf is the full-precision expf (no
//     --use_fast_math), so on the card the kernel and the plain torch version
//     agree bit for bit.
//   * a map whose values all underflow has peak 0 and comes out all zeros, so
//     keypoints outside the map need no special case.
// Taking the peak in closed form, as expf of the smallest squared distance,
// would halve the expf work but is exact only if expf is monotone; that, and
// several blocks per map, are left for later work.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kF64Eps = 2.220446049250313e-16f;  // np.finfo(float).eps = 2^-52, exact in f32

__device__ __forceinline__ float sq_dist(float coord, float centre) {
  const float d = __fsub_rn(coord, centre);
  return __fmul_rn(d, d);
}

// exp(-(dx2 + dy2) * inv), rounded after each operation as the plain version is.
__device__ __forceinline__ float gaussian(float dx2, float dy2, float inv) {
  return expf(__fmul_rn(-__fadd_rn(dx2, dy2), inv));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
render_heatmaps_kernel(const float* __restrict__ rows, float* __restrict__ out, int height,
                       int width) {
  __shared__ float s_max[kWarps];
  const float x = rows[3 * static_cast<int64_t>(blockIdx.x)];
  const float y = rows[3 * static_cast<int64_t>(blockIdx.x) + 1];
  const float inv = rows[3 * static_cast<int64_t>(blockIdx.x) + 2];
  const int hw = height * width;
  float* map = out + static_cast<int64_t>(blockIdx.x) * hw;
  const bool vec4 = (width % 4) == 0;

  // Sweep 1: the peak of the map. Every value is >= 0, so 0 starts the max.
  float peak = 0.f;
  if (vec4) {
    for (int i = 4 * threadIdx.x; i < hw; i += 4 * kThreads) {
      const int c = i % width;
      const float dy2 = sq_dist(static_cast<float>(i / width), y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        peak = fmaxf(peak, gaussian(sq_dist(static_cast<float>(c + k), x), dy2, inv));
      }
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads) {
      const float dx2 = sq_dist(static_cast<float>(i % width), x);
      peak = fmaxf(peak, gaussian(dx2, sq_dist(static_cast<float>(i / width), y), inv));
    }
  }
  peak = warp_max(peak);
  if ((threadIdx.x & 31) == 0) {
    s_max[threadIdx.x >> 5] = peak;
  }
  __syncthreads();
  peak = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    peak = fmaxf(peak, s_max[w]);
  }
  const float zero_below = __fmul_rn(peak, kF64Eps);

  // Sweep 2: the values again, with the floor, stored along the rows.
  if (vec4) {
    for (int i = 4 * threadIdx.x; i < hw; i += 4 * kThreads) {
      const int c = i % width;
      const float dy2 = sq_dist(static_cast<float>(i / width), y);
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float h = gaussian(sq_dist(static_cast<float>(c + k), x), dy2, inv);
        v[k] = h < zero_below ? 0.f : h;
      }
      *reinterpret_cast<float4*>(map + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads) {
      const float dx2 = sq_dist(static_cast<float>(i % width), x);
      const float h = gaussian(dx2, sq_dist(static_cast<float>(i / width), y), inv);
      map[i] = h < zero_below ? 0.f : h;
    }
  }
}

}  // namespace

// rows: (M, 3) f32 [x, y, 1/(2 sigma^2)], contiguous; out: (M, H, W) f32,
// contiguous and 16-byte aligned, M*H*W < 2^31 - 1024; both on the device of
// `stream`. Returns cudaGetLastError() after the launch.
extern "C" int render_heatmaps_f32(const float* rows, float* out, int M, int H, int W,
                                   void* stream) {
  render_heatmaps_kernel<<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(rows, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
