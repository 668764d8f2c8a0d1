// Batched SVD of small f32 matrices on Hopper (sm_90a): one-sided Jacobi in
// rounds of disjoint column pairs, W lanes a matrix (W the power of two >=
// max(m, n), a template parameter), 32 / W matrices a warp, lane r of a
// matrix's group holding row r of A and row r of V.
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
// Algorithm: Hestenes' one-sided Jacobi on A itself, not on A^T A, whose f32
// rounding would square the DLT system's condition number.
//  * Scale: A is multiplied by the power of two 2^-e that brings its largest
//    entry into [0.5, 1) (exact; sigma is scaled back by 2^e at the end), so
//    no square or sum below overflows or reaches the subnormals.
//  * Order: a sweep is n2 - 1 rounds of disjoint pairs, n2 = n rounded up to
//    even (an odd n gets a phantom zero column, whose pairs are never
//    computed), in round-robin ("circle method") order. The columns sit in
//    n2 register slots; a round pairs slot i with slot n2 - 1 - i, then the
//    columns in slots 1 .. n2 - 1 turn one slot (slot 0, the phantom for odd
//    n, stays). Every pair of columns meets exactly once a sweep, and after a
//    sweep every column is back in its own slot. The slots are registers
//    indexed by constants; a turn is register moves, and one round is the
//    whole body of the sweep loop (a few hundred instructions).
//  * A round: each lane forms gamma = a_p . a_q of every pair from its row
//    and the group reduces them in one interleaved butterfly over xor
//    offsets below W (the group's own lanes; every lane gets the same bits).
//    alpha = |a_p|^2 and beta = |a_q|^2 need no reduction: each sweep starts
//    from the columns' exact squared norms (one butterfly), and each
//    rotation carries them: alpha' = c^2 alpha - 2 c s gamma + s^2 beta,
//    beta' = s^2 alpha + 2 c s gamma + c^2 beta. Lane j of the group then
//    computes pair j's rotation and the group takes each pair's (c, s) from
//    its lane by one shuffle each, so a round's special-function work is one
//    pair's, not every pair's on every lane, and all the pairs' rotations
//    are applied to their columns of A and of V together. W is a template
//    parameter, so the butterflies have no run-time bounds. (Reducing alpha,
//    beta and gamma of every pair a round, computing every rotation on every
//    lane and W a run-time value: 42.2 us at the DLT's (64, 16, 12) on an
//    H100, `chip_smoke.phase_small_svd`, against 22.6 us.)
//  * Rotation: with d = beta - alpha and g = 2 gamma, the angle 2 theta has
//    cos = |d| / h, sin = sign(d) g / h, h = sqrt(d^2 + g^2); then c =
//    cos theta = (1 + cos) k, s = sin theta = sin k, k = 1 / sqrt((1 + cos)^2
//    + sin^2) (|theta| <= pi / 4, tan theta the smaller root of t^2 + 2 (d /
//    g) t - 1 = 0). 1 / h and k are rsqrt.approx on the special-function
//    unit, k with one Newton step, so c^2 + s^2 = 1 to rounding and V stays
//    orthogonal (the error of 1 / h only moves the angle, at 1e-7). No IEEE
//    division or square root runs in the sweep loop.
//  * Stop: a pair is rotated only where
//        gamma^2 > (kNoise eps)^2 |A|_F^2 max(alpha, beta),  kNoise = 4:
//    the rotation would move the smaller column by about |gamma| /
//    sqrt(max(alpha, beta)), and below kNoise eps |A|_F that is less than A's
//    own rounding moves it. The test implies the usual relative one,
//    |gamma| <= eps sqrt(alpha beta) (min(alpha, beta) <= |A|_F^2), and it
//    ends the rotations among the columns of a null space of dimension > 1,
//    which settle at a few eps |A|_F with mutual cosines of O(1) and were
//    rotated again every sweep under the relative test alone. A pair not
//    rotated takes c = 1, s = 0 (its warp's other pairs and matrices share
//    the instructions); a warp leaves after a sweep in which none of its
//    matrices rotated, or after kSweeps.
//  * Then sigma_k = |a_k| 2^e, ranked in descending order (a NaN ranks first,
//    ties by column index, so the ranks are always a permutation), V's
//    columns become Vh's rows in that order. For 3 x 3 input the kernel also
//    writes U: the first two columns are a_k / sigma_k, the third their cross
//    product, its sign taken from a_k; a column whose sigma is below 1e-6
//    sigma_0 is completed orthogonally instead (a rank-deficient M still
//    gives a rotation U D V^T).
//
// What bounds it on an H100: latency, not bytes or operations. A matrix is
// at most 32 x 16 floats (2 KB); the serve tick's batches are 64 matrices (4
// views x 16 hypotheses), 2 a warp at the DLT's (16, 12), each warp a block
// of its own, so the batch spreads over 32 SMs. A sweep's serial chain is
// its rounds (11 at n = 12, 15 at n = 16, 9 at n = 9, 3 at n = 3), each a
// butterfly of log2 W steps, one pair's rotation on the special-function
// unit and one shuffle; the rounds' pairs (6, 8, 4, 1 at those n) are
// independent of each other. Random (16, 12) matrices and fr3's RANSAC DLT
// systems stop after 5-7 sweeps.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kRankTol = 1e-6f;  // sigma_k <= kRankTol sigma_0: a zero column of U
// The most sweeps: the inputs above stop after 5-7, so 12 leave room; the
// loop stops after a sweep without a rotation.
constexpr int kSweeps = 12;
// A pair whose rotation would move a column by less than kNoise eps |A|_F is
// not rotated (see the note above).
constexpr float kNoise = 4.f;

// The special-function unit's 1 / sqrt(x) (about 2 ulp), flushing
// subnormals: every argument below is a normal number where its result is used.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^k for |k| <= 126.
__device__ __forceinline__ float exp2i(int k) { return __int_as_float((k + 127) << 23); }

// x 2^k for |k| <= 252, by two factors in range: exact where the result is normal.
__device__ __forceinline__ float scale2(float x, int k) {
  return x * exp2i(k / 2) * exp2i(k - k / 2);
}

// Sums over a matrix's group of W lanes: xor offsets below W stay inside the
// group, and every lane ends with the same bits. The K sums' shuffles
// interleave, so they cost one reduction's latency.
template <int W, int K>
__device__ __forceinline__ void group_sums(float (&v)[K]) {
#pragma unroll
  for (int offset = W / 2; offset > 0; offset >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFullMask, v[k], offset);
  }
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int offset = W / 2; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}

// The rotation (c, s) that makes columns p and q orthogonal, from alpha =
// |a_p|^2, beta = |a_q|^2 and gamma = a_p . a_q; c = 1, s = 0 where !rot.
__device__ __forceinline__ void jacobi_rotation(float alpha, float beta, float gamma, bool rot,
                                                float& c, float& s) {
  const float d = beta - alpha, g = 2.f * gamma;
  const float h2 = fmaf(d, d, g * g);
  const float inv_h = rsqrt_approx(h2);
  const float cos2 = fabsf(d) * inv_h, sin2 = copysignf(1.f, d) * g * inv_h;
  const float q = fmaf(1.f + cos2, 1.f + cos2, sin2 * sin2);
  float k = rsqrt_approx(q);
  k *= fmaf(-0.5f * q * k, k, 1.5f);  // Newton: c^2 + s^2 = 1 to rounding
  c = rot ? (1.f + cos2) * k : 1.f;
  s = rot ? sin2 * k : 0.f;
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
// of its group holding all nine values), their norms and ranks; written by
// the group's lane 0.
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

template <int N, int W>
__global__ void __launch_bounds__(32)
small_svd_kernel(const float* __restrict__ a, float* __restrict__ s, float* __restrict__ vh,
                 float* __restrict__ u, int batch, int m) {
  static_assert(N <= W && W <= 32, "a lane for each row of V");
  constexpr int kSlots = N + (N & 1);  // n2: n rounded up to even
  constexpr int kFirst = N & 1;        // column k sits in slot k + kFirst
  constexpr int kPairs = N / 2;        // a round's pairs without the phantom
  constexpr int kSums = kPairs > 0 ? kPairs : 1;  // n = 1: no pair
  const int lane = threadIdx.x;
  const int r = lane % W;  // the row this lane holds
  const int64_t mat = (static_cast<int64_t>(blockIdx.x) * 32 + lane) / W;
  const bool live = mat < batch;  // a group past the batch holds zeros
  float col[kSlots];   // col[slot]: A's entry (r, the column in that slot)
  float vcol[kSlots];  // the same of V (rows < n), from the identity
  float norm2[kSlots];  // the columns' squared norms, the same on every lane
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = k - kFirst;  // the column in slot k (-1: the phantom)
    col[k] = live && r < m && j >= 0 ? a[(mat * m + r) * N + j] : 0.f;
    vcol[k] = r == j ? 1.f : 0.f;
    amax = fmaxf(amax, fabsf(col[k]));
  }
  amax = group_max<W>(amax);
  int e = 0;
  if (amax > 0.f && amax <= FLT_MAX) frexpf(amax, &e);
  float frob2[1] = {0.f};
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    col[k] = scale2(col[k], -e);
    frob2[0] += col[k] * col[k];
  }
  group_sums<W>(frob2);
  const float noise2 = kNoise * kNoise * FLT_EPSILON * FLT_EPSILON * frob2[0];
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) norm2[k] = col[k] * col[k];
    group_sums<W>(norm2);
#pragma unroll 1
    for (int round = 0; round < kSlots - 1; ++round) {
      float ga[kSums] = {};
#pragma unroll
      for (int j = 0; j < kPairs; ++j) ga[j] = col[kFirst + j] * col[kSlots - 1 - kFirst - j];
      group_sums<W>(ga);
      // Lane j computes pair j's rotation.
      float al = norm2[kFirst], be = norm2[kSlots - 1 - kFirst], gj = ga[0];
#pragma unroll
      for (int j = 1; j < kPairs; ++j) {
        if (r == j) {
          al = norm2[kFirst + j];
          be = norm2[kSlots - 1 - kFirst - j];
          gj = ga[j];
        }
      }
      const bool rot = r < kPairs && gj * gj > noise2 * fmaxf(al, be);
      float cj, sj;
      jacobi_rotation(al, be, gj, rot, cj, sj);
      rotated |= rot;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int p = kFirst + j, q = kSlots - 1 - kFirst - j;
        const float c = __shfl_sync(kFullMask, cj, j, W);
        const float sn = __shfl_sync(kFullMask, sj, j, W);
        const float ap = col[p], aq = col[q];
        col[p] = c * ap - sn * aq;
        col[q] = sn * ap + c * aq;
        const float vp = vcol[p], vq = vcol[q];
        vcol[p] = c * vp - sn * vq;
        vcol[q] = sn * vp + c * vq;
        const float alpha = norm2[p], beta = norm2[q], cs2 = 2.f * c * sn * ga[j];
        norm2[p] = fmaxf(fmaf(c * c, alpha, fmaf(sn * sn, beta, -cs2)), 0.f);
        norm2[q] = fmaxf(fmaf(sn * sn, alpha, fmaf(c * c, beta, cs2)), 0.f);
      }
      // The columns in slots 1 .. n2 - 1 turn one slot.
      const float c1 = col[1], v1 = vcol[1], n1 = norm2[1];
#pragma unroll
      for (int k = 1; k < kSlots - 1; ++k) {
        col[k] = col[k + 1];
        vcol[k] = vcol[k + 1];
        norm2[k] = norm2[k + 1];
      }
      col[kSlots - 1] = c1;
      vcol[kSlots - 1] = v1;
      norm2[kSlots - 1] = n1;
    }
    if (!__any_sync(kFullMask, rotated)) break;
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) norm2[k] = col[k] * col[k];
  group_sums<W>(norm2);
  float sigma[N], key[N];  // sigma of the scaled A; key: NaN ranks first
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sigma[k] = sqrtf(norm2[k + kFirst]);
    key[k] = isnan(sigma[k]) ? INFINITY : sigma[k];
  }
  int rank[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int rk = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) rk += (key[j] > key[k]) || (key[j] == key[k] && j < k);
    rank[k] = rk;
  }
  const int kmin = m < N ? m : N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (live && r == 0 && rank[k] < kmin) s[mat * kmin + rank[k]] = scale2(sigma[k], e);
    if (live && r < N) vh[mat * N * N + rank[k] * N + r] = vcol[k + kFirst];
  }
  if constexpr (N == 3 && W == 4) {
    if (u != nullptr) {  // m = 3
      float cols[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int i = 0; i < 3; ++i) cols[k][i] = __shfl_sync(kFullMask, col[k + kFirst], i, W);
      }
      if (live && r == 0) write_u3(cols, sigma, rank, u + mat * 9);
    }
  }
}

template <int N, int W>
int launch_width(const float* a, float* s, float* vh, float* u, int batch, int m,
           cudaStream_t stream) {
  const int warps = (batch + 32 / W - 1) / (32 / W);
  small_svd_kernel<N, W><<<warps, 32, 0, stream>>>(a, s, vh, u, batch, m);
  return static_cast<int>(cudaGetLastError());
}

// W: the power of two >= max(m, n).
template <int N>
int launch(const float* a, float* s, float* vh, float* u, int batch, int m,
           cudaStream_t stream) {
  const int rows = m > N ? m : N;
  if constexpr (N <= 1) {
    if (rows <= 1) return launch_width<N, 1>(a, s, vh, u, batch, m, stream);
  }
  if constexpr (N <= 2) {
    if (rows <= 2) return launch_width<N, 2>(a, s, vh, u, batch, m, stream);
  }
  if constexpr (N <= 4) {
    if (rows <= 4) return launch_width<N, 4>(a, s, vh, u, batch, m, stream);
  }
  if constexpr (N <= 8) {
    if (rows <= 8) return launch_width<N, 8>(a, s, vh, u, batch, m, stream);
  }
  if (rows <= 16) return launch_width<N, 16>(a, s, vh, u, batch, m, stream);
  return launch_width<N, 32>(a, s, vh, u, batch, m, stream);
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
