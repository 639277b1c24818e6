// The Gauss-Newton tail shared by K2b (icp.cu, the single-device ICP) and
// K11d (shard.cu, the sharded ICP): the 6x6 solve of (H + 1e-8 I) x = -g
// and the retract T <- T * SE3(Exp(dw), dt) with the convergence test.
//
// Replaces: the JAX package's ops/icp.py _gn_step tail (jnp.linalg.solve,
// the finite check, lie.se3_from_exp_rt) and the same lines of
// parallel/sharded_map.py robust_icp_loop.gn_round (:363-372). One
// thread runs them; they are a few hundred dependent flops.
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

// Solve (H + 1e-8 I) x = -g, Gaussian elimination with partial pivoting.
// hg holds the 21 upper entries of H row by row, then g (6).
__device__ void solve6(const float* hg, float x[6]) {
  float A[6][7];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      A[a][b] = hg[k];
      A[b][a] = hg[k];
      ++k;
    }
  for (int a = 0; a < 6; ++a) {
    A[a][a] += 1e-8f;
    A[a][6] = -hg[21 + a];
  }
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[r][c]) > best) { best = fabsf(A[r][c]); piv = r; }
    if (piv != c)
      for (int j = 0; j < 7; ++j) { const float tmp = A[c][j]; A[c][j] = A[piv][j]; A[piv][j] = tmp; }
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
      for (int j = c; j < 7; ++j) A[r][j] -= f * A[c][j];
    }
  }
  for (int r = 5; r >= 0; --r) {
    float s = A[r][6];
    for (int j = r + 1; j < 6; ++j) s -= A[r][j] * x[j];
    x[r] = s / A[r][r];
  }
}

// T_new = T * SE3(Exp(dw), dt) for the increment x = [dt | dw], zeroed
// unless all six entries are finite (Rodrigues with the small-angle
// branch). Returns |dt| < tol_t && |dw| < tol_r.
__device__ bool gn_retract(const float* T, const float x[6], float tol_t, float tol_r,
                           float T_new[16]) {
  const bool ok = finite3(x) && finite3(x + 3);
  const float dt[3] = {ok ? x[0] : 0.f, ok ? x[1] : 0.f, ok ? x[2] : 0.f};
  const float dw[3] = {ok ? x[3] : 0.f, ok ? x[4] : 0.f, ok ? x[5] : 0.f};
  const float theta = sqrtf(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]);
  float E[3][3];
  if (theta < 1e-6f) {
    const float H[3][3] = {{1.f, -dw[2], dw[1]}, {dw[2], 1.f, -dw[0]}, {-dw[1], dw[0], 1.f}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) E[i][j] = H[i][j];
  } else {
    const float ax = dw[0] / theta, ay = dw[1] / theta, az = dw[2] / theta;
    const float Kh[3][3] = {{0.f, -az, ay}, {az, 0.f, -ax}, {-ay, ax, 0.f}};
    const float s = sinf(theta), c1m = 1.0f - cosf(theta);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float kk = 0.f;
        for (int m = 0; m < 3; ++m) kk += Kh[i][m] * Kh[m][j];
        E[i][j] = (i == j ? 1.f : 0.f) + s * Kh[i][j] + c1m * kk;
      }
  }
  const float D[4][4] = {{E[0][0], E[0][1], E[0][2], dt[0]},
                         {E[1][0], E[1][1], E[1][2], dt[1]},
                         {E[2][0], E[2][1], E[2][2], dt[2]},
                         {0.f, 0.f, 0.f, 1.f}};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float v = 0.f;
      for (int m = 0; m < 4; ++m) v += T[4 * i + m] * D[m][j];
      T_new[4 * i + j] = v;
    }
  const float dt_n = sqrtf(dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]);
  return dt_n < tol_t && theta < tol_r;
}

}  // namespace lo
