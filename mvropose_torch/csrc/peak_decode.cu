// Heatmap peak decode on Hopper (sm_90a): a thread-block cluster per heatmap.
//
// Replaces mvropose_tpu/ops/peak_decode.py::_decode_kernel, the Pallas TPU
// kernel behind fused_peak_decode. For each map of H*W f32 values it writes
// one row of 8 floats:
//   [argmax_x, argmax_y, soft_x, soft_y, sigmoid(peak), peak, 0, 0]
// where the argmax is the FIRST index holding the peak (torch.argmax and the
// TPU kernel's min(where(hm >= peak, iota, hw)) agree on that), and soft_xy
// is the expectation of the pixel coordinates under
// p = exp((h - peak) * temperature). A map that holds a NaN decodes as the
// TPU kernel decodes it: jnp.max propagates the NaN and no value is >= NaN,
// so the peak is NaN and the argmax is index H*W (x = 0, y = H); the soft
// sums and the confidence are NaN.
//
// What bounds it on an H100: at the serve shape (4 views x 8 joints = 32 maps
// of 128x128) it reads 2 MB, about 0.6 us at 3.35 TB/s, which is below the
// cost of one launch. So it is bound by launch and latency: the design fills
// the card and keeps each value's path from memory short.
//   * C blocks a map (C in {1, 2, 4, 8}, the largest with M C <= the SM
//     count; the wrapper picks it), launched as thread-block clusters of C:
//     at the serve shape 4 blocks a map, 128 blocks on 132 SMs, where one
//     block a map left 100 SMs idle;
//   * one read: each block holds its slice of H W / C values in registers
//     (at the serve shape four float4 a thread, every load issued before any
//     is used) and takes the peak and the sums from there. Only a slice
//     larger than 16 float4 a thread (maps above 128x128 at C = 1) reads its
//     remainder twice, from L2;
//   * an exchange through distributed shared memory without a second
//     cluster-wide barrier: one cluster barrier, split (arrive right after
//     the blocks' mbarriers are initialized, wait just before the first
//     remote access), so it runs under the loads; then each block writes its
//     (peak, first index) into slot `rank` of every block's shared memory
//     with st.async, which counts the bytes on that block's mbarrier; each
//     block waits for its C pairs' bytes and picks the same winner from the
//     C slots in its own shared memory (larger value, smaller index on a
//     tie, any NaN first);
//   * each block sums p, p x and p y over its own values (x and y from one
//     integer division a float4) and writes the three partial sums into slot
//     `rank` of rank 0's shared memory the same way; rank 0 waits for their
//     bytes, adds them in rank order (deterministic, no atomics) and writes
//     the row. No block reads another block's shared memory, so a block
//     that has written its sums may exit. (st.async needs a launched
//     cluster: C = 1 is a cluster of one too.)
// (Exchanging by two cluster.sync()s and remote reads, or by remote stores
// and mbarrier arrivals with release at cluster scope, was slower: PERF.md.)

#include <climits>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// The winner of two (value, index) pairs: a NaN first (its index is the
// map's H W on every route), then the larger value, then the smaller index.
__device__ __forceinline__ void keep_better(float& val, int& idx, float other_val, int other_idx) {
  if (other_val != other_val ||
      (val == val && (other_val > val || (other_val == val && other_idx < idx)))) {
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

// Shared-memory addresses in the cluster window and the stores into another
// block's shared memory (PTX ISA: mapa, st.async).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The address of `local`'s counterpart in the shared memory of block `rank`.
__device__ __forceinline__ uint32_t remote_addr(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(local)), "r"(rank));
  return out;
}
// Write 8 (push2) or 16 (push4) bytes at `addr` in another block's shared
// memory and count them on its mbarrier at `bar` (both cluster addresses):
// the barrier's phase completes once the bytes it expects have landed, and
// they are visible to the threads that wait on it.
__device__ __forceinline__ void push2(uint32_t addr, uint32_t bar, uint32_t a, uint32_t b) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
      ::"r"(addr), "r"(a), "r"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void push4(uint32_t addr, uint32_t bar, float a, float b, float c) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(__float_as_uint(c)),
      "r"(0u), "r"(bar)
      : "memory");
}
// This block's one arrival on its own mbarrier, with the bytes it expects.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void wait_phase0(const uint64_t* bar) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
  }
}

// Four values of a group (elements e0 .. e0 + 3), those at or past `end`
// never read: one 16-byte load where the map allows (Vec), else four.
template <bool Vec>
__device__ __forceinline__ float4 load_group(const float* row, int e0, int end) {
  if constexpr (Vec) {
    return e0 < end ? *reinterpret_cast<const float4*>(row + e0) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(e0 < end ? row[e0] : 0.f, e0 + 1 < end ? row[e0 + 1] : 0.f,
                       e0 + 2 < end ? row[e0 + 2] : 0.f, e0 + 3 < end ? row[e0 + 3] : 0.f);
  }
}

__device__ __forceinline__ float lane_of(const float4& q, int c) {
  return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
}

// A thread's peak over a group: its indices come in increasing order, so a
// value equal to the best so far never replaces it (the first index wins).
__device__ __forceinline__ void group_max(const float4& q, int e0, int end, float& best,
                                          int& best_idx) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (e0 + c < end) keep_better(best, best_idx, lane_of(q, c), e0 + c);
  }
}

// The sums over a group: one integer division for its first element's
// (x, y), then a step along the row for each next one.
__device__ __forceinline__ void group_sums(const float4& q, int e0, int end, int width, float peak,
                                           float temperature, float& z, float& zx, float& zy) {
  int y = e0 / width, x = e0 - y * width;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c > 0 && ++x == width) {
      x = 0;
      ++y;
    }
    if (e0 + c < end) {
      const float p = expf((lane_of(q, c) - peak) * temperature);
      z += p;
      zx += p * static_cast<float>(x);
      zy += p * static_cast<float>(y);
    }
  }
}

// V float4 groups a thread held in registers: a block's first kThreads * 4 V
// values of its slice; the rest (`tail`) is read in both passes.
template <int V, bool Vec>
__global__ void __launch_bounds__(kThreads)
peak_decode_kernel(const float* __restrict__ heatmaps, float* __restrict__ out, int hw, int width,
                   int slice, float temperature) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_sum[3][kWarps];
  __shared__ int2 s_pairs[kMaxCluster];      // every block's (peak bits, first index), by rank
  __shared__ float4 s_parts[kMaxCluster];    // rank 0's: every block's partial sums, by rank
  __shared__ uint64_t s_bar[2];  // the pairs' bytes, and (rank 0's) the sums' bytes
  __shared__ float s_peak;
  __shared__ int s_arg;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int map = blockIdx.x / C;
  const float* row = heatmaps + static_cast<int64_t>(map) * hw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = rank * slice, end = min(start + slice, hw);
  const int held_end = min(end, start + 4 * kThreads * V);  // the tail: [held_end, end)
  auto first = [&](int i) { return start + 4 * (tid + i * kThreads); };  // group i's first element

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&s_bar[b]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect_bytes(&s_bar[0], C * sizeof(int2));
    if (rank == 0) expect_bytes(&s_bar[1], C * sizeof(float4));
  }
  // Every block of the cluster running, its barriers initialized, before
  // the first remote access: arrive now, wait after the loads.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // The slice, every load issued before any value is used.
  float4 q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = load_group<Vec>(row, first(i), held_end);

  // The block's peak and the first index that holds it.
  float best = -INFINITY;
  int best_idx = INT_MAX;
#pragma unroll
  for (int i = 0; i < V; ++i) group_max(q[i], first(i), held_end, best, best_idx);
  for (int e0 = held_end + 4 * tid; e0 < end; e0 += 4 * kThreads) {
    group_max(load_group<Vec>(row, e0, end), e0, end, best, best_idx);
  }
  if (best != best) best_idx = hw;  // a NaN: index H W, as the TPU kernel's
  warp_argmax(best, best_idx);
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_idx;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    best = lane < kWarps ? s_val[lane] : -INFINITY;
    best_idx = lane < kWarps ? s_idx[lane] : INT_MAX;
    warp_argmax(best, best_idx);
    best = __shfl_sync(kFullMask, best, 0);
    best_idx = __shfl_sync(kFullMask, best_idx, 0);
    if (lane < C) {  // this block's pair into slot `rank` of block `lane`
      push2(remote_addr(&s_pairs[rank], lane), remote_addr(&s_bar[0], lane), __float_as_uint(best),
            best_idx);
    }
  }

  // The map's peak: every block picks the same one of the C pairs.
  if (warp == 0) {
    wait_phase0(&s_bar[0]);
    best = lane < C ? __int_as_float(s_pairs[lane].x) : -INFINITY;
    best_idx = lane < C ? s_pairs[lane].y : INT_MAX;
    warp_argmax(best, best_idx);
    if (lane == 0) {
      s_peak = best;
      s_arg = best_idx;
    }
  }
  __syncthreads();
  const float peak = s_peak;

  // Softmax mass and its first moments, relative to the peak.
  float z = 0.f, zx = 0.f, zy = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    group_sums(q[i], first(i), held_end, width, peak, temperature, z, zx, zy);
  }
  for (int e0 = held_end + 4 * tid; e0 < end; e0 += 4 * kThreads) {
    group_sums(load_group<Vec>(row, e0, end), e0, end, width, peak, temperature, z, zx, zy);
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
    if (lane == 0) {  // into slot `rank` of rank 0's shared memory
      push4(remote_addr(&s_parts[rank], 0), remote_addr(&s_bar[1], 0), z, zx, zy);
    }
  }
  if (rank == 0 && tid == 0) {
    wait_phase0(&s_bar[1]);
    z = zx = zy = 0.f;
    for (int r = 0; r < C; ++r) {
      z += s_parts[r].x;
      zx += s_parts[r].y;
      zy += s_parts[r].z;
    }
    const int arg = s_arg;
    float* o = out + static_cast<int64_t>(map) * 8;
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

template <int V, bool Vec>
cudaError_t launch(const float* heatmaps, float* out, int M, int hw, int W, int C, int slice,
                   float temperature, cudaStream_t stream) {
  cudaLaunchConfig_t config{};
  config.gridDim = dim3(M * C);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, peak_decode_kernel<V, Vec>, heatmaps, out, hw, W, slice,
                            temperature);
}

template <bool Vec>
cudaError_t launch_held(int groups, const float* heatmaps, float* out, int M, int hw, int W, int C,
                        int slice, float temperature, cudaStream_t stream) {
  // The fewest float4 a thread that hold the slice, 16 at most.
  if (groups <= 1) return launch<1, Vec>(heatmaps, out, M, hw, W, C, slice, temperature, stream);
  if (groups <= 2) return launch<2, Vec>(heatmaps, out, M, hw, W, C, slice, temperature, stream);
  if (groups <= 4) return launch<4, Vec>(heatmaps, out, M, hw, W, C, slice, temperature, stream);
  if (groups <= 8) return launch<8, Vec>(heatmaps, out, M, hw, W, C, slice, temperature, stream);
  return launch<16, Vec>(heatmaps, out, M, hw, W, C, slice, temperature, stream);
}

}  // namespace

// heatmaps: (M, H, W) f32, contiguous, on the device of `stream`; C: the
// blocks a map, 1, 2, 4 or 8, launched as one thread-block cluster a map.
// out: (M, 8) f32. Returns the launch's error (a refused cluster launch
// included), cudaErrorInvalidValue (1) for another C.
extern "C" int peak_decode_f32(const float* heatmaps, float* out, int M, int H, int W, int C,
                               float temperature, void* stream) {
  if (C != 1 && C != 2 && C != 4 && C != kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hw = H * W;
  const int slice = ((hw + C - 1) / C + 3) / 4 * 4;  // a multiple of 4: 16-byte aligned slices
  const int groups = (slice / 4 + kThreads - 1) / kThreads;
  const bool vec = hw % 4 == 0 && (reinterpret_cast<uintptr_t>(heatmaps) & 15u) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_held<true>(groups, heatmaps, out, M, hw, W, C, slice, temperature, s)
          : launch_held<false>(groups, heatmaps, out, M, hw, W, C, slice, temperature, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
