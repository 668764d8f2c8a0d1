// Batched SVD of small f32 matrices on Hopper (sm_90a): one-sided Jacobi,
// one warp a matrix, lane i holding row i.
//
// Replaces jnp.linalg.svd on the pose path (mvropose_tpu/geometry/pnp.py:94,
// 109, 141, 166, 183 and rotations.py::kabsch): an XLA call in the
// reference, not a Pallas kernel. torch.linalg.svd on CUDA checks its
// convergence on the host, so it waits for the device, and each of its calls
// is several cuSOLVER launches; the pose step runs five SVD shapes per RANSAC
// and must never wait for the device. The shapes on the serve tick, batched
// over views x hypotheses: the DLT (2N, 12), the plane fit (N, 3), the
// homography (2N, 9) and two (3, 3) rotation projections, N = 7 or 8.
//
// Algorithm (Hestenes' one-sided Jacobi on A itself, not on A^T A, whose f32
// rounding would square the DLT system's condition number): for each column
// pair (p, q) the warp reduces alpha = |a_p|^2, beta = |a_q|^2 and
// gamma = a_p . a_q with butterfly shuffles (every lane gets the same bits,
// so every branch below is uniform across the warp), then rotates the two
// columns of A (each lane its own row's two entries) and of V (lane j holds
// row j of V) so that they become orthogonal. Sweeps over all pairs in
// cyclic order run until a sweep makes no rotation or kSweeps have run; a
// rotation is skipped where |gamma| <= eps sqrt(alpha) sqrt(beta), or where
// both columns are below eps |A|_F (numerically zero). Then
// sigma_k = |a_k|, ranked in descending order (a NaN ranks first, ties by
// column index, so the ranks are always a permutation), V's columns become
// Vh's rows in that order. For 3 x 3 input the kernel also writes U: the
// first two columns are a_k / sigma_k, the third their cross product, its
// sign taken from a_k; a column whose sigma is below 1e-6 sigma_0 is
// completed orthogonally instead (a rank-deficient M still gives a rotation
// U D V^T).
//
// What bounds it on an H100: latency, not bytes or operations. A matrix is
// at most 32 x 16 floats (2 KB); a sweep of a (16, 12) matrix is 66 pairs,
// each three dependent 5-step shuffle reductions. The serve tick's batches
// are 64 matrices (4 views x 16 hypotheses), one wave of warps; the design
// keeps everything in registers (the column loops are unrolled over the
// template width N, so the row is never indexed at run time), reduces a
// pair's three sums in one interleaved butterfly, and stops after the first
// sweep without a rotation.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // matrices a block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kRankTol = 1e-6f;  // sigma_k <= kRankTol sigma_0: a zero column of U
// The most sweeps: 6 reach f32 accuracy on random (32, 16) matrices, so 12
// leave room; the loop stops after a sweep without a rotation.
constexpr int kSweeps = 12;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// Three butterfly sums at once: their shuffles interleave, so the three
// reductions cost one reduction's latency.
__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float a2 = __shfl_xor_sync(kFullMask, a, offset);
    const float b2 = __shfl_xor_sync(kFullMask, b, offset);
    const float c2 = __shfl_xor_sync(kFullMask, c, offset);
    a += a2;
    b += b2;
    c += c2;
  }
}

__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize(float v[3]) {
  const float inv = 1.f / sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] *= inv;
}

// A unit vector orthogonal to the unit vector u: the axis where u is
// smallest, less its projection on u.
__device__ __forceinline__ void orthogonal(const float u[3], float out[3]) {
  const float ax = fabsf(u[0]), ay = fabsf(u[1]), az = fabsf(u[2]);
  const int i = (ax <= ay && ax <= az) ? 0 : (ay <= az ? 1 : 2);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = (k == i ? 1.f : 0.f) - u[i] * u[k];
  normalize(out);
}

// U of a 3 x 3 matrix from its rotated columns col[k] (k = 0..2, every lane
// holding all nine values), their norms and ranks; written by lane 0.
__device__ void write_u3(const float col[3][3], const float sigma[3], const int rank[3],
                         float* __restrict__ u) {
  float c[3][3], s[3];  // the columns and sigmas in rank order
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (rank[k] == r) {
        s[r] = sigma[k];
#pragma unroll
        for (int i = 0; i < 3; ++i) c[r][i] = col[k][i];
      }
    }
  }
  float u0[3], u1[3], u2[3];
  if (!(s[0] > 0.f)) {  // the zero matrix (or NaN): U = I
    u0[0] = 1.f, u0[1] = 0.f, u0[2] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) u0[i] = c[0][i] / s[0];
  }
  if (s[1] > kRankTol * s[0]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = c[1][i] / s[1];
  } else {
    orthogonal(u0, u1);
  }
  cross(u0, u1, u2);
  if (s[2] > kRankTol * s[0] && u2[0] * c[2][0] + u2[1] * c[2][1] + u2[2] * c[2][2] < 0.f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u2[i] = -u2[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[3 * i + 0] = u0[i];
    u[3 * i + 1] = u1[i];
    u[3 * i + 2] = u2[i];
  }
}

template <int N>
__global__ void __launch_bounds__(32 * kWarps)
small_svd_kernel(const float* __restrict__ a, float* __restrict__ s, float* __restrict__ vh,
                 float* __restrict__ u, int batch, int m) {
  const int lane = threadIdx.x & 31;
  const int64_t mat = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (mat >= batch) return;  // the whole warp leaves together
  const float* src = a + mat * m * N;
  float row[N];   // row `lane` of A (0 past m), rotated in place
  float vrow[N];  // row `lane` of V (lanes < N), from the identity
#pragma unroll
  for (int k = 0; k < N; ++k) {
    row[k] = lane < m ? src[lane * N + k] : 0.f;
    vrow[k] = lane == k ? 1.f : 0.f;
  }
  // Columns below eps |A|_F are numerically zero: rotating two of them only
  // picks a basis of a null space of dimension > 1, which is arbitrary, and
  // would go on for every sweep on rounding noise.
  float frob2 = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) frob2 += row[k] * row[k];
  const float tiny = FLT_EPSILON * FLT_EPSILON * warp_sum(frob2);
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        float alpha = row[p] * row[p], beta = row[q] * row[q], gamma = row[p] * row[q];
        warp_sum3(alpha, beta, gamma);
        if (fabsf(gamma) > FLT_EPSILON * sqrtf(alpha) * sqrtf(beta) &&
            (alpha > tiny || beta > tiny)) {
          const float zeta = (beta - alpha) / (2.f * gamma);
          const float t = copysignf(1.f, zeta) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
          const float c = 1.f / sqrtf(1.f + t * t);
          const float sn = c * t;
          const float ap = row[p], aq = row[q];
          row[p] = c * ap - sn * aq;
          row[q] = sn * ap + c * aq;
          const float vp = vrow[p], vq = vrow[q];
          vrow[p] = c * vp - sn * vq;
          vrow[q] = sn * vp + c * vq;
          rotated = true;
        }
      }
    }
    if (!rotated) break;
  }
  float sigma[N], key[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sigma[k] = sqrtf(warp_sum(row[k] * row[k]));
    key[k] = isnan(sigma[k]) ? INFINITY : sigma[k];
  }
  int rank[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) r += (key[j] > key[k]) || (key[j] == key[k] && j < k);
    rank[k] = r;
  }
  const int kmin = m < N ? m : N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (lane == 0 && rank[k] < kmin) s[mat * kmin + rank[k]] = sigma[k];
    if (lane < N) vh[mat * N * N + rank[k] * N + lane] = vrow[k];
  }
  if constexpr (N == 3) {
    if (u != nullptr) {
      float col[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int i = 0; i < 3; ++i) col[k][i] = __shfl_sync(kFullMask, row[k], i);
      }
      if (lane == 0) write_u3(col, sigma, rank, u + mat * 9);
    }
  }
}

template <int N>
int launch(const float* a, float* s, float* vh, float* u, int batch, int m,
           cudaStream_t stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  small_svd_kernel<N><<<blocks, 32 * kWarps, 0, stream>>>(a, s, vh, u, batch, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (batch, m, n) f32, contiguous, 1 <= m <= 32, 1 <= n <= 16; s: (batch,
// min(m, n)); vh: (batch, n, n); u: (batch, 3, 3) or null, only for m = n = 3;
// all on the device of `stream`. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int small_svd_f32(const float* a, float* s, float* vh, float* u, int batch, int m,
                             int n, void* stream) {
  if (m < 1 || m > 32 || (u != nullptr && (m != 3 || n != 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(a, s, vh, u, batch, m, st);
    case 2: return launch<2>(a, s, vh, u, batch, m, st);
    case 3: return launch<3>(a, s, vh, u, batch, m, st);
    case 4: return launch<4>(a, s, vh, u, batch, m, st);
    case 5: return launch<5>(a, s, vh, u, batch, m, st);
    case 6: return launch<6>(a, s, vh, u, batch, m, st);
    case 7: return launch<7>(a, s, vh, u, batch, m, st);
    case 8: return launch<8>(a, s, vh, u, batch, m, st);
    case 9: return launch<9>(a, s, vh, u, batch, m, st);
    case 10: return launch<10>(a, s, vh, u, batch, m, st);
    case 11: return launch<11>(a, s, vh, u, batch, m, st);
    case 12: return launch<12>(a, s, vh, u, batch, m, st);
    case 13: return launch<13>(a, s, vh, u, batch, m, st);
    case 14: return launch<14>(a, s, vh, u, batch, m, st);
    case 15: return launch<15>(a, s, vh, u, batch, m, st);
    case 16: return launch<16>(a, s, vh, u, batch, m, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
