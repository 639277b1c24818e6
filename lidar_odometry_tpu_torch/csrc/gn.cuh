// The Gauss-Newton tail shared by K2b (icp.cu, the single-device ICP) and
// K11d (shard.cu, the sharded ICP): the 6x6 solve of (H + 1e-8 I) x = -g
// and the retract T <- T * SE3(Exp(dw), dt) with the convergence test.
//
// Replaces: the JAX package's ops/icp.py _gn_step tail (jnp.linalg.solve,
// the finite check, lie.se3_from_exp_rt) and the same lines of
// parallel/sharded_map.py robust_icp_loop.gn_round (:363-372). One
// thread runs them: a few hundred dependent flops, so their time is the
// chain's latency. Both stay in registers with no call in the chain: the
// elimination is unrolled, its row swaps are selects (no run-time index,
// which would put the matrix on the stack), each pivot's reciprocal is
// taken once, and the retract takes one sincospif and common.cuh's
// reciprocal and square root in place of the IEEE operations, whose slow
// paths are calls (sinf's and cosf's large-argument reduction also keeps
// an array on the stack).
#pragma once
#include "common.cuh"

namespace lo {

__device__ __forceinline__ void load_T(const float* T, float R[3][3], float t[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = T[4 * i + j];
    t[i] = T[4 * i + 3];
  }
}

__device__ __forceinline__ bool finite3(const float* x) {
  return isfinite(x[0]) && isfinite(x[1]) && isfinite(x[2]);
}

// sqrt(x) for x >= 0, subnormal x included (fast_sqrt's rsqrt flushes
// them): those are scaled by 2^48 first, the root by 2^-24 after.
__device__ __forceinline__ float sqrt_nonneg(float x) {
  const bool tiny = x < 1.17549435e-38f;
  const float r = fast_sqrt(tiny ? x * 281474976710656.f : x);
  return tiny ? r * 5.96046448e-8f : r;
}

// Solve (H + 1e-8 I) x = -g, Gaussian elimination with partial pivoting
// (the first row of the largest magnitude), as LAPACK's getrf takes it.
// hg holds the 21 upper entries of H row by row, then g (6). A zero or
// non-finite pivot leaves x non-finite, which the retract takes as no step.
__device__ __forceinline__ void solve6(const float* hg, float x[6]) {
  float A[6][7];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) {
      A[a][b] = hg[k];
      A[b][a] = hg[k];
      ++k;
    }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    A[a][a] += 1e-8f;
    A[a][6] = -hg[21 + a];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float v = fabsf(A[r][c]);
      piv = v > best ? r : piv;
      best = v > best ? v : best;
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const bool s = r == piv;
#pragma unroll
      for (int j = c; j < 7; ++j) {
        const float a = A[c][j], b = A[r][j];
        A[c][j] = s ? b : a;
        A[r][j] = s ? a : b;
      }
    }
    const float inv = fast_rcp(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] * inv;
#pragma unroll
      for (int j = c + 1; j < 7; ++j) A[r][j] = __fmaf_rn(-f, A[c][j], A[r][j]);
    }
  }
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float s = A[r][6];
#pragma unroll
    for (int j = r + 1; j < 6; ++j) s = __fmaf_rn(-A[r][j], x[j], s);
    x[r] = s * fast_rcp(A[r][r]);
  }
}

// T_new = T * SE3(Exp(dw), dt) for the increment x = [dt | dw], zeroed
// unless all six entries are finite (Rodrigues with the small-angle
// branch at theta < 1e-6). Returns |dt| < tol_t && |dw| < tol_r.
__device__ __forceinline__ bool gn_retract(const float* T, const float x[6], float tol_t,
                                           float tol_r, float T_new[16]) {
  const bool ok = finite3(x) && finite3(x + 3);
  const float dt[3] = {ok ? x[0] : 0.f, ok ? x[1] : 0.f, ok ? x[2] : 0.f};
  const float dw[3] = {ok ? x[3] : 0.f, ok ? x[4] : 0.f, ok ? x[5] : 0.f};
  const float theta = sqrt_nonneg(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]);
  // the small-angle branch I + hat(dw), or Rodrigues on the unit axis;
  // sincospif(theta / pi): its reduction is exact, with no stack array
  const bool small = theta < 1e-6f;
  const float inv = small ? 0.f : fast_rcp(theta);
  float s, c;
  sincospif(theta * 0.318309886f, &s, &c);
  const float ax = dw[0] * inv, ay = dw[1] * inv, az = dw[2] * inv;
  const float Kh[3][3] = {{0.f, -az, ay}, {az, 0.f, -ax}, {-ay, ax, 0.f}};
  const float c1m = 1.0f - c;
  float E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float kk = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) kk += Kh[i][m] * Kh[m][j];
      const float big = (i == j ? 1.f : 0.f) + s * Kh[i][j] + c1m * kk;
      const float hat = i == j ? 1.f : (i == 0 ? (j == 1 ? -dw[2] : dw[1])
                                      : i == 1 ? (j == 0 ? dw[2] : -dw[0])
                                               : (j == 0 ? -dw[1] : dw[0]));
      E[i][j] = small ? hat : big;
    }
  const float D[4][4] = {{E[0][0], E[0][1], E[0][2], dt[0]},
                         {E[1][0], E[1][1], E[1][2], dt[1]},
                         {E[2][0], E[2][1], E[2][2], dt[2]},
                         {0.f, 0.f, 0.f, 1.f}};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) v += T[4 * i + m] * D[m][j];
      T_new[4 * i + j] = v;
    }
  const float dt_n = sqrt_nonneg(dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]);
  return dt_n < tol_t && theta < tol_r;
}

}  // namespace lo
