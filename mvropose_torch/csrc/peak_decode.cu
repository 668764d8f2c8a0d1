// Heatmap peak decode on Hopper (sm_90a): one thread block per heatmap.
//
// Replaces mvropose_tpu/ops/peak_decode.py::_decode_kernel, the Pallas TPU
// kernel behind fused_peak_decode. For each map of H*W f32 values it writes
// one row of 8 floats:
//   [argmax_x, argmax_y, soft_x, soft_y, sigmoid(peak), peak, 0, 0]
// where the argmax is the FIRST index holding the peak (torch.argmax and the
// TPU kernel's min(where(hm >= peak, iota, hw)) agree on that), and soft_xy
// is the expectation of the pixel coordinates under
// p = exp((h - peak) * temperature).
//
// What bounds it on an H100: at the serve shape (4 views x 8 joints = 32 maps
// of 128x128) it reads 2 MB, about 0.6 us at 3.35 TB/s, with 32 blocks on 132
// SMs. So it is bound by launch and latency, not by bytes. Its gain over the
// plain torch path is that one launch replaces that path's several (argmax,
// gather, exp, sums, sigmoid, stack). The design follows from that:
//   * one block of 256 threads per map; threads stride over the map with
//     coalesced float4 loads where the row is 16-byte aligned;
//   * pass 1 keeps (value, index) per thread and reduces by warp shuffles,
//     then across warps in shared memory: larger value wins, ties go to the
//     smaller index;
//   * pass 2 re-reads the map (it is in L2 by then) and sums p, p*x and p*y
//     in f32; x = idx % W and y = idx / W come from index arithmetic, so no
//     coordinate grids are built or read.
// Splitting one map over several blocks, to fill the card at small M, is left
// for later work.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Larger value wins; on equal values the smaller index wins.
__device__ __forceinline__ void keep_better(float& val, int& idx, float other_val, int other_idx) {
  if (other_val > val || (other_val == val && other_idx < idx)) {
    val = other_val;
    idx = other_idx;
  }
}

__device__ __forceinline__ void warp_argmax(float& val, int& idx) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other_val = __shfl_down_sync(kFullMask, val, offset);
    const int other_idx = __shfl_down_sync(kFullMask, idx, offset);
    keep_better(val, idx, other_val, other_idx);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(kFullMask, v, offset);
  }
  return v;
}

__device__ __forceinline__ void accumulate(float h, int i, int width, float peak, float temperature,
                                           float& z, float& zx, float& zy) {
  const float p = expf((h - peak) * temperature);
  z += p;
  zx += p * static_cast<float>(i % width);
  zy += p * static_cast<float>(i / width);
}

__global__ void __launch_bounds__(kThreads)
peak_decode_kernel(const float* __restrict__ heatmaps, float* __restrict__ out, int hw, int width,
                   float temperature) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_sum[3][kWarps];
  __shared__ float s_peak;
  __shared__ int s_arg;

  const float* row = heatmaps + static_cast<int64_t>(blockIdx.x) * hw;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool vec4 = (hw % 4 == 0) && ((reinterpret_cast<uintptr_t>(row) & 15u) == 0);
  const float4* row4 = reinterpret_cast<const float4*>(row);

  // Pass 1: the peak and the first index that holds it. Each thread visits
  // its indices in increasing order, so a strict '>' keeps its first one.
  float best = -INFINITY;
  int best_idx = INT_MAX;
  if (vec4) {
    for (int j = tid; j < hw / 4; j += kThreads) {
      const float4 q = row4[j];
      keep_better(best, best_idx, q.x, 4 * j);
      keep_better(best, best_idx, q.y, 4 * j + 1);
      keep_better(best, best_idx, q.z, 4 * j + 2);
      keep_better(best, best_idx, q.w, 4 * j + 3);
    }
  } else {
    for (int i = tid; i < hw; i += kThreads) {
      keep_better(best, best_idx, row[i], i);
    }
  }
  warp_argmax(best, best_idx);
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_idx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? s_val[lane] : -INFINITY;
    best_idx = lane < kWarps ? s_idx[lane] : INT_MAX;
    warp_argmax(best, best_idx);
    if (lane == 0) {
      s_peak = best;
      s_arg = best_idx;
    }
  }
  __syncthreads();
  const float peak = s_peak;

  // Pass 2: softmax mass and its first moments, relative to the peak.
  float z = 0.f, zx = 0.f, zy = 0.f;
  if (vec4) {
    for (int j = tid; j < hw / 4; j += kThreads) {
      const float4 q = row4[j];
      accumulate(q.x, 4 * j, width, peak, temperature, z, zx, zy);
      accumulate(q.y, 4 * j + 1, width, peak, temperature, z, zx, zy);
      accumulate(q.z, 4 * j + 2, width, peak, temperature, z, zx, zy);
      accumulate(q.w, 4 * j + 3, width, peak, temperature, z, zx, zy);
    }
  } else {
    for (int i = tid; i < hw; i += kThreads) {
      accumulate(row[i], i, width, peak, temperature, z, zx, zy);
    }
  }
  z = warp_sum(z);
  zx = warp_sum(zx);
  zy = warp_sum(zy);
  if (lane == 0) {
    s_sum[0][warp] = z;
    s_sum[1][warp] = zx;
    s_sum[2][warp] = zy;
  }
  __syncthreads();
  if (warp == 0) {
    z = warp_sum(lane < kWarps ? s_sum[0][lane] : 0.f);
    zx = warp_sum(lane < kWarps ? s_sum[1][lane] : 0.f);
    zy = warp_sum(lane < kWarps ? s_sum[2][lane] : 0.f);
    if (lane == 0) {
      const int arg = s_arg;
      float* o = out + static_cast<int64_t>(blockIdx.x) * 8;
      o[0] = static_cast<float>(arg % width);
      o[1] = static_cast<float>(arg / width);
      o[2] = zx / z;
      o[3] = zy / z;
      o[4] = 1.f / (1.f + expf(-peak));
      o[5] = peak;
      o[6] = 0.f;
      o[7] = 0.f;
    }
  }
}

}  // namespace

// heatmaps: (M, H, W) f32, contiguous, on the device of `stream`.
// out: (M, 8) f32. Returns cudaGetLastError() after the launch.
extern "C" int peak_decode_f32(const float* heatmaps, float* out, int M, int H, int W,
                               float temperature, void* stream) {
  peak_decode_kernel<<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(heatmaps, out, H * W, W,
                                                                            temperature);
  return static_cast<int>(cudaGetLastError());
}
