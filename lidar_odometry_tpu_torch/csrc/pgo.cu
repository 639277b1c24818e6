// K10 pgo: one Gauss-Newton iteration of the "distributed" pose-graph
// backend in float64, as four entry points launched in turn on one stream.
//
// Replaces the JAX package's parallel/distributed_pgo.py:589 _gn_device (the
// jitted while_loop of gn_optimize_device, :696), iteration by iteration:
//  * K10a lo_pgo_linearize — _linearize_device (:521): prior and between
//    factors into diag (n_pad,6,6), off (n_pad-1,6,6), b (n_pad,6) and the
//    loop blocks lb (L,6,6). Two kernels: one thread a factor evaluates its
//    SE(3) log error, J_from = -Ad(hx^-1) and its weighted blocks in
//    registers into a per-factor scratch; then one thread a pose sums its
//    incident blocks in the order of the host-built lists (inc_*, chain_*),
//    the order of the JAX scatter-adds, so with no atomics the sums are the
//    same in every run. One more thread a loop edge gathers its block.
//  * K10b lo_pgo_eliminate — _eliminate_interior_spd under vmap (:450) with
//    _gn_device's interior packing (:610-619): one warp a partition packs its
//    front-padded interior rows straight from the plan, then runs the
//    forward chain (Dt = D_i - L_i C_prev, a register 6x6 Cholesky and the
//    13 right-hand columns [U | E | b], one column a lane) and the backward
//    chain F, G, g, and writes the Schur blocks. C, E and d go to global
//    scratch (the chain is max_m long and does not fit in shared memory).
//  * K10c lo_pgo_reduced_solve — the separator system (:625-647): one block
//    assembles Hs ((6D)^2, in global memory: 1.5 MB at D = 73, beyond an
//    SM's shared memory, and D is not capped) and bs in the order of the
//    JAX scatter-adds, factors Hs in place by a right-looking Cholesky in
//    6-column panels, and solves the two triangular systems.
//  * K10d lo_pgo_backsub_retract — :649-686: one thread a padded pose
//    computes its dx; block partials of |dx|^2 and of non-finite entries go
//    to scratch; the last block to finish (a threadfence + a ticket counter
//    it resets) sums them in block order, retracts every pose where dx is all
//    finite and writes the loop state.
//
// Loop state st (4 doubles) = [it, |dx|, ok, active], active being the
// while_loop's condition it < max_iters && |dx| >= tol && ok; every kernel
// returns at once when active is 0, so the host issues max_iters rounds
// without reading anything back. A non-positive (or NaN) Cholesky pivot
// gives NaN, as jnp.linalg.cholesky does, and ok turns false through the
// finiteness test. Both Cholesky factorisations read (A + A^T) / 2, the
// input jnp.linalg.cholesky symmetrises.
//
// Bounds on the H100 at the KITTI-00-sized graph (n_pad = 4096, M = 4096,
// L = 32, D = 73, max_m = 395): every kernel moves a few MB at most
// (K10b reads ~5 MB of blocks and writes ~17 MB of F, G, g and scratch:
// ~7 us at 3.35 TB/s) and does a few hundred MFLOP (K10c's Cholesky of
// a 438 x 438 system: 28 MFLOP, ~0.4 us at 67 TFLOP/s f64), so each is
// bound by its sequential depth and launch cost, not by the card: K10b is
// a chain of max_m dependent 6x6 steps in each partition, K10c a chain of
// D dependent panels on one SM. Simple and right first; the designs keep
// the summation order fixed, which makes two calls bit-equal.
#include "common.cuh"
#include <math.h>

namespace {

constexpr double LIE_EPS = 1e-10;        // reference kEpsLie
constexpr int FAC_THREADS = 128;
constexpr int ASM_THREADS = 256;
constexpr int RED_THREADS = 1024;
constexpr int BACKSUB_THREADS = 256;     // distributed_pgo.py _BACKSUB_THREADS

__device__ __forceinline__ double clip1(double x) {  // jnp.clip, NaN kept
  return x < -1.0 ? -1.0 : (x > 1.0 ? 1.0 : x);
}

// ---- SE(3) in GTSAM [rot, trans] order, the JAX batched helpers' branches ----

__device__ void se3_log(const double R[3][3], const double t[3], double xi[6]) {
  const double tr = R[0][0] + R[1][1] + R[2][2];
  const double theta = acos(clip1((tr - 1.0) * 0.5));
  const bool small = theta < LIE_EPS;
  const double denom = small ? 1.0 : 2.0 * sin(small ? 1.0 : theta);
  const double factor = small ? 0.5 : theta / denom;
  const double w[3] = {(R[2][1] - R[1][2]) * factor, (R[0][2] - R[2][0]) * factor,
                       (R[1][0] - R[0][1]) * factor};
  const double th = sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  const bool sm = th < LIE_EPS;
  const double safe = sm ? 1.0 : th;
  const double a[3] = {w[0] / safe, w[1] / safe, w[2] / safe};
  const double W[3][3] = {{0.0, -a[2], a[1]}, {a[2], 0.0, -a[0]}, {-a[1], a[0], 0.0}};
  double Wt[3], WWt[3];
  for (int i = 0; i < 3; ++i) Wt[i] = W[i][0] * t[0] + W[i][1] * t[1] + W[i][2] * t[2];
  for (int i = 0; i < 3; ++i) WWt[i] = W[i][0] * Wt[0] + W[i][1] * Wt[1] + W[i][2] * Wt[2];
  const double tan_half = tan(0.5 * safe);
  const double c1 = 0.5 * th, c2 = 1.0 - th / (2.0 * tan_half);
  for (int i = 0; i < 3; ++i) {
    xi[i] = w[i];
    xi[3 + i] = sm ? t[i] : t[i] - c1 * Wt[i] + c2 * WWt[i];
  }
}

// T <- T * Exp(xi): R <- R dR, t <- R dt + t, the bottom row set to [0 0 0 1].
__device__ void retract(double* T, const double xi[6]) {
  const double w[3] = {xi[0], xi[1], xi[2]}, u[3] = {xi[3], xi[4], xi[5]};
  const double theta = sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  const bool small = theta < LIE_EPS;
  const double safe = small ? 1.0 : theta;
  const double W[3][3] = {{0.0, -w[2], w[1]}, {w[2], 0.0, -w[0]}, {-w[1], w[0], 0.0}};
  double WW[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) WW[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  const double s = sin(safe), c = cos(safe);
  const double cr1 = s / safe, cr2 = (1.0 - c) / (safe * safe);
  const double cv2 = (safe - s) / (safe * safe * safe);
  double dR[3][3], V[3][3], dt[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double I = i == j ? 1.0 : 0.0;
      dR[i][j] = small ? I + W[i][j] : I + cr1 * W[i][j] + cr2 * WW[i][j];
      V[i][j] = I + cr2 * W[i][j] + cv2 * WW[i][j];
    }
  for (int i = 0; i < 3; ++i)
    dt[i] = small ? u[i] : V[i][0] * u[0] + V[i][1] * u[1] + V[i][2] * u[2];
  double R[3][3], t[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[i][j] = T[4 * i + j];
    t[i] = T[4 * i + 3];
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T[4 * i + j] = R[i][0] * dR[0][j] + R[i][1] * dR[1][j] + R[i][2] * dR[2][j];
    T[4 * i + 3] = R[i][0] * dt[0] + R[i][1] * dt[1] + R[i][2] * dt[2] + t[i];
  }
  T[12] = 0.0; T[13] = 0.0; T[14] = 0.0; T[15] = 1.0;
}

// ---- 6x6 Cholesky of (A + A^T) / 2 and its solve, in registers ----

__device__ void chol6(const double* A, double Lc[6][6]) {
  for (int j = 0; j < 6; ++j) {
    double s = (A[6 * j + j] + A[6 * j + j]) * 0.5;
    for (int q = 0; q < j; ++q) s -= Lc[j][q] * Lc[j][q];
    const double ljj = s > 0.0 ? sqrt(s) : NAN;   // not positive definite: NaN
    Lc[j][j] = ljj;
    for (int i = j + 1; i < 6; ++i) {
      double v = (A[6 * i + j] + A[6 * j + i]) * 0.5;
      for (int q = 0; q < j; ++q) v -= Lc[i][q] * Lc[j][q];
      Lc[i][j] = v / ljj;
    }
  }
}

// x <- A^-1 x given the factor Lc of A: forward, then backward substitution.
__device__ void cho_solve6(const double Lc[6][6], double x[6]) {
  for (int i = 0; i < 6; ++i) {
    double v = x[i];
    for (int q = 0; q < i; ++q) v -= Lc[i][q] * x[q];
    x[i] = v / Lc[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double v = x[i];
    for (int q = i + 1; q < 6; ++q) v -= Lc[q][i] * x[q];
    x[i] = v / Lc[i][i];
  }
}

// ---------------------------------------------------------------------------
// K10a
// ---------------------------------------------------------------------------

// One thread a factor. Scratch rows: prior k -> fac36[k] = info, fac6[k] =
// rhs; between k -> fac36[P+k] = blk_ff, fac36[P+M+k] = blk_tt,
// fac36[P+2M+k] = Hij_lo, fac6[P+k] = rhs_f, fac6[P+M+k] = rhs_t.
__global__ void __launch_bounds__(FAC_THREADS)
factor_kernel(const double* __restrict__ poses, const int* __restrict__ prior_key,
              const double* __restrict__ prior_meas, const double* __restrict__ prior_sqrtI,
              const int* __restrict__ prior_valid, int P, const int* __restrict__ bt_from,
              const int* __restrict__ bt_to, const double* __restrict__ bt_meas,
              const double* __restrict__ bt_sqrtI, const int* __restrict__ bt_valid, int M,
              const double* __restrict__ st, double* __restrict__ fac36,
              double* __restrict__ fac6) {
  if (st[3] == 0.0) return;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < P) {
    if (!prior_valid[f]) return;
    const double* T = poses + 16 * (size_t)prior_key[f];
    const double* Mm = prior_meas + 16 * (size_t)f;
    const double* S = prior_sqrtI + 36 * (size_t)f;
    double Re[3][3], te[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)   // Rm^T Rp
        Re[i][j] = Mm[i] * T[j] + Mm[4 + i] * T[4 + j] + Mm[8 + i] * T[8 + j];
      te[i] = Mm[i] * (T[3] - Mm[3]) + Mm[4 + i] * (T[7] - Mm[7]) + Mm[8 + i] * (T[11] - Mm[11]);
    }
    double err[6];
    se3_log(Re, te, err);
    double info[36];
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) {
        double v = 0.0;
        for (int q = 0; q < 6; ++q) v += S[6 * q + i] * S[6 * q + j];
        info[6 * i + j] = v;
      }
    for (int e = 0; e < 36; ++e) fac36[36 * (size_t)f + e] = info[e];
    for (int i = 0; i < 6; ++i) {
      double v = 0.0;
      for (int q = 0; q < 6; ++q) v += info[6 * i + q] * err[q];
      fac6[6 * (size_t)f + i] = -v;
    }
    return;
  }
  const int k = f - P;
  if (k >= M || !bt_valid[k]) return;
  const int from = bt_from[k], to = bt_to[k];
  const double* Tf = poses + 16 * (size_t)from;
  const double* Tt = poses + 16 * (size_t)to;
  const double* Mm = bt_meas + 16 * (size_t)k;
  const double* S = bt_sqrtI + 36 * (size_t)k;
  double Rhx[3][3], thx[3], Re[3][3], te[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)     // R_f^T R_t
      Rhx[i][j] = Tf[i] * Tt[j] + Tf[4 + i] * Tt[4 + j] + Tf[8 + i] * Tt[8 + j];
    thx[i] = Tf[i] * (Tt[3] - Tf[3]) + Tf[4 + i] * (Tt[7] - Tf[7]) + Tf[8 + i] * (Tt[11] - Tf[11]);
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)     // R_m^T R_hx
      Re[i][j] = Mm[i] * Rhx[0][j] + Mm[4 + i] * Rhx[1][j] + Mm[8 + i] * Rhx[2][j];
    te[i] = Mm[i] * (thx[0] - Mm[3]) + Mm[4 + i] * (thx[1] - Mm[7]) + Mm[8 + i] * (thx[2] - Mm[11]);
  }
  double err[6];
  se3_log(Re, te, err);
  // hx^-1 = (R_hx^T, -R_hx^T t_hx); J_from = -Ad(hx^-1) = -[[Ri, 0], [skew(ti) Ri, Ri]]
  double Ri[3][3], ti[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Ri[i][j] = Rhx[j][i];
  for (int i = 0; i < 3; ++i) ti[i] = -(Ri[i][0] * thx[0] + Ri[i][1] * thx[1] + Ri[i][2] * thx[2]);
  const double K[3][3] = {{0.0, -ti[2], ti[1]}, {ti[2], 0.0, -ti[0]}, {-ti[1], ti[0], 0.0}};
  double J[6][6];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      J[i][j] = -Ri[i][j];
      J[i][3 + j] = -0.0;
      J[3 + i][j] = -(K[i][0] * Ri[0][j] + K[i][1] * Ri[1][j] + K[i][2] * Ri[2][j]);
      J[3 + i][3 + j] = -Ri[i][j];
    }
  // Jw_f = S J_from (J_to = I, so Jw_t = S); ew = S err
  double Jw[6][6], ew[6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) {
      double v = 0.0;
      for (int q = 0; q < 6; ++q) v += S[6 * i + q] * J[q][j];
      Jw[i][j] = v;
    }
    double v = 0.0;
    for (int q = 0; q < 6; ++q) v += S[6 * i + q] * err[q];
    ew[i] = v;
  }
  double* ff = fac36 + 36 * (size_t)(P + k);
  double* tt = fac36 + 36 * (size_t)(P + M + k);
  double* hl = fac36 + 36 * (size_t)(P + 2 * M + k);
  const bool lo_is_from = from < to;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      double a = 0.0, c = 0.0, h = 0.0;
      for (int q = 0; q < 6; ++q) {
        a += Jw[q][i] * Jw[q][j];        // Jw_f^T Jw_f
        c += S[6 * q + i] * S[6 * q + j];  // Jw_t^T Jw_t
      }
      // Hij = Jw_f^T Jw_t, stored as H[lo, hi]: Hij, or Hij^T when to < from
      const int a_ = lo_is_from ? i : j, b_ = lo_is_from ? j : i;
      for (int q = 0; q < 6; ++q) h += Jw[q][a_] * S[6 * q + b_];
      ff[6 * i + j] = a;
      tt[6 * i + j] = c;
      hl[6 * i + j] = h;
    }
  for (int i = 0; i < 6; ++i) {
    double rf = 0.0, rt = 0.0;
    for (int q = 0; q < 6; ++q) {
      rf += Jw[q][i] * ew[q];
      rt += S[6 * q + i] * ew[q];
    }
    fac6[6 * (size_t)(P + k) + i] = -rf;
    fac6[6 * (size_t)(P + M + k) + i] = -rt;
  }
}

// One thread a pose (diag, b, off) and then one a loop edge (lb).
__global__ void __launch_bounds__(ASM_THREADS)
assemble_kernel(const double* __restrict__ pad_reg, int n_pad, int P, int M,
                const int* __restrict__ loop_bt, const int* __restrict__ loop_valid, int L,
                const int* __restrict__ inc_ptr, const int* __restrict__ inc_ent,
                const int* __restrict__ chain_ptr, const int* __restrict__ chain_ent,
                const double* __restrict__ st, const double* __restrict__ fac36,
                const double* __restrict__ fac6, double* __restrict__ diag,
                double* __restrict__ off, double* __restrict__ b, double* __restrict__ lb) {
  if (st[3] == 0.0) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_pad) {
    double acc[36], bb[6];
    for (int e = 0; e < 36; ++e) acc[e] = e % 7 == 0 ? pad_reg[t] : 0.0;
    for (int i = 0; i < 6; ++i) bb[i] = 0.0;
    for (int j = inc_ptr[t]; j < inc_ptr[t + 1]; ++j) {
      const int e = inc_ent[j];
      for (int q = 0; q < 36; ++q) acc[q] += fac36[36 * (size_t)e + q];
      for (int i = 0; i < 6; ++i) bb[i] += fac6[6 * (size_t)e + i];
    }
    for (int q = 0; q < 36; ++q) diag[36 * (size_t)t + q] = acc[q];
    for (int i = 0; i < 6; ++i) b[6 * (size_t)t + i] = bb[i];
    if (t < n_pad - 1) {
      for (int q = 0; q < 36; ++q) acc[q] = 0.0;
      for (int j = chain_ptr[t]; j < chain_ptr[t + 1]; ++j) {
        const double* h = fac36 + 36 * (size_t)(P + 2 * M + chain_ent[j]);
        for (int q = 0; q < 36; ++q) acc[q] += h[q];
      }
      for (int q = 0; q < 36; ++q) off[36 * (size_t)t + q] = acc[q];
    }
  } else if (t < n_pad + L) {
    const int l = t - n_pad;
    const double* h = fac36 + 36 * (size_t)(P + 2 * M + loop_bt[l]);
    for (int q = 0; q < 36; ++q) lb[36 * (size_t)l + q] = loop_valid[l] ? h[q] : 0.0;
  }
}

// ---------------------------------------------------------------------------
// K10b
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
eliminate_kernel(const double* __restrict__ diag, const double* __restrict__ off,
                 const double* __restrict__ b, const int* __restrict__ int_idx,
                 const int* __restrict__ valid, const int* __restrict__ off_idx,
                 const int* __restrict__ ovalid, const int* __restrict__ has_left,
                 const int* __restrict__ left_off, const int* __restrict__ lsep_row,
                 const int* __restrict__ uright_off, const int* __restrict__ ur_valid,
                 int max_m, int m_off, const double* __restrict__ st, double* __restrict__ Cs,
                 double* __restrict__ Es, double* __restrict__ ds, double* __restrict__ F,
                 double* __restrict__ G, double* __restrict__ g, double* __restrict__ S,
                 double* __restrict__ r) {
  if (st[3] == 0.0) return;
  const int k = blockIdx.x, lane = threadIdx.x;
  __shared__ double sC[36], sE[36], sd[6];   // the previous row's C, E, d; later F, G, g
  __shared__ double sL[36], sDt[36], sR[78];  // L_i, Dt and the 6 x 13 right-hand side
  __shared__ double sLl[36], sUr[36];         // H[first, sep_l]^T and H[last, sep_r]
  __shared__ double sF0[36], sG0[36], sg0[6];
  const int* vrow = valid + (size_t)k * max_m;
  const int* irow = int_idx + (size_t)k * max_m;
  const int* orow = off_idx + (size_t)k * m_off;
  const int* ovrow = ovalid + (size_t)k * m_off;
  const size_t base = (size_t)k * max_m;
  const int lrow = lsep_row[k];
  int first = max_m;   // the first valid row (rows are front-padded)
  for (int q = 0; q < max_m; ++q)
    if (vrow[q]) { first = q; break; }
  const bool any_valid = first < max_m;
  if (first == max_m) first = 0;
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e % 6;
    sC[e] = 0.0;
    sE[e] = 0.0;
    sLl[e] = has_left[k] ? off[36 * (size_t)left_off[k] + 6 * j + i] : 0.0;
    sUr[e] = ur_valid[k] ? off[36 * (size_t)uright_off[k] + e] : 0.0;
  }
  if (lane < 6) sd[lane] = 0.0;
  double Lc[6][6];
  __syncthreads();

  // ---- forward chain ----
  for (int row = 0; row < max_m; ++row) {
    const bool v = vrow[row] != 0;
    const double* Di = diag + 36 * (size_t)irow[row];
    const double* bi = b + 6 * (size_t)irow[row];
    const bool has_u = row < max_m - 1 && ovrow[row];
    const double* Ui = off + 36 * (size_t)orow[row < max_m - 1 ? row : 0];
    const bool has_l = row > 0 && ovrow[row - 1];
    const double* Li = off + 36 * (size_t)orow[row > 0 ? row - 1 : 0];
    for (int e = lane; e < 36; e += 32) {   // L_i = Oint[row-1]^T
      const int i = e / 6, j = e % 6;
      sL[e] = has_l ? Li[6 * j + i] : 0.0;
    }
    __syncthreads();
    for (int e = lane; e < 36; e += 32) {
      const int i = e / 6, j = e % 6;
      double dt = i == j ? 1.0 : 0.0, rE = 0.0;
      if (v) {
        double lc = 0.0, le = 0.0;
        for (int q = 0; q < 6; ++q) {
          lc += sL[6 * i + q] * sC[6 * q + j];
          le += sL[6 * i + q] * sE[6 * q + j];
        }
        dt = Di[e] - lc;
        rE = (row == lrow ? sLl[e] : 0.0) - le;
      }
      sDt[e] = dt;
      sR[13 * i + j] = has_u ? Ui[e] : 0.0;
      sR[13 * i + 6 + j] = rE;
    }
    if (lane < 6) {
      double rb = 0.0;
      if (v) {
        double ld = 0.0;
        for (int q = 0; q < 6; ++q) ld += sL[6 * lane + q] * sd[q];
        rb = bi[lane] - ld;
      }
      sR[13 * lane + 12] = rb;
    }
    __syncthreads();
    if (lane < 13) {   // each lane factors Dt itself and solves its column
      chol6(sDt, Lc);
      double x[6];
      for (int i = 0; i < 6; ++i) x[i] = sR[13 * i + lane];
      cho_solve6(Lc, x);
      for (int i = 0; i < 6; ++i) {
        if (lane < 6) {
          const double c = v ? x[i] : 0.0;
          sC[6 * i + lane] = c;
          Cs[36 * (base + row) + 6 * i + lane] = c;
        } else if (lane < 12) {
          sE[6 * i + lane - 6] = x[i];
          Es[36 * (base + row) + 6 * i + lane - 6] = x[i];
        } else {
          sd[i] = x[i];
          ds[6 * (base + row) + i] = x[i];
        }
      }
    }
    __syncthreads();
  }

  // ---- the last row: F = E, G = Dt^-1 U_right, g = d ----
  if (lane < 6) {   // lanes 0..5 hold the last row's factor in Lc
    double x[6];
    for (int i = 0; i < 6; ++i) x[i] = sUr[6 * i + lane];
    cho_solve6(Lc, x);
    for (int i = 0; i < 6; ++i) sDt[6 * i + lane] = x[i];   // G_last, kept in sDt
  }
  __syncthreads();
  // F_next, G_next, g_next live in sC (F), sDt (G), sd (g) from here on
  for (int e = lane; e < 36; e += 32) {
    sC[e] = sE[e];
    F[36 * (base + max_m - 1) + e] = sE[e];
    G[36 * (base + max_m - 1) + e] = sDt[e];
    if (first == max_m - 1) { sF0[e] = sE[e]; sG0[e] = sDt[e]; }
  }
  if (lane < 6) {
    g[6 * (base + max_m - 1) + lane] = sd[lane];
    if (first == max_m - 1) sg0[lane] = sd[lane];
  }
  __syncthreads();

  // ---- backward chain: F_i = E_i - C_i F_next, G_i = -C_i G_next, g_i = d_i - C_i g_next ----
  for (int row = max_m - 2; row >= 0; --row) {
    const bool v = vrow[row] != 0;
    for (int e = lane; e < 36; e += 32) sL[e] = Cs[36 * (base + row) + e];   // C_i
    __syncthreads();
    double out[3];
    int n_out = 0;
    for (int e = lane; e < 78; e += 32) {
      double val = 0.0;
      if (v) {
        if (e < 36) {
          const int i = e / 6, j = e % 6;
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += sL[6 * i + q] * sC[6 * q + j];
          val = Es[36 * (base + row) + e] - acc;
        } else if (e < 72) {
          const int i = (e - 36) / 6, j = (e - 36) % 6;
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += -sL[6 * i + q] * sDt[6 * q + j];
          val = acc;
        } else {
          const int i = e - 72;
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += sL[6 * i + q] * sd[q];
          val = ds[6 * (base + row) + i] - acc;
        }
      }
      out[n_out++] = val;
    }
    __syncthreads();
    n_out = 0;
    for (int e = lane; e < 78; e += 32) {
      const double val = out[n_out++];
      if (e < 36) {
        sC[e] = val;
        F[36 * (base + row) + e] = val;
        if (row == first) sF0[e] = val;
      } else if (e < 72) {
        sDt[e - 36] = val;
        G[36 * (base + row) + e - 36] = val;
        if (row == first) sG0[e - 36] = val;
      } else {
        sd[e - 72] = val;
        g[6 * (base + row) + e - 72] = val;
        if (row == first) sg0[e - 72] = val;
      }
    }
    __syncthreads();
  }

  // ---- Schur blocks: S_ll = -Lt F0, S_lr = -Lt G0, S_rl = -Ut Fm, S_rr = -Ut Gm,
  //      r_l = -Lt g0, r_r = -Ut gm, with Lt = H[sep_l, first], Ut = H[sep_r, last] ----
  // (Fm, Gm, gm are the last row's: rows max_m-1 of F, G, g in global memory)
  for (int e = lane; e < 4 * 36 + 12; e += 32) {
    double val = 0.0;
    if (any_valid) {
      if (e < 144) {
        const int blk = e / 36, i = (e % 36) / 6, j = e % 6;
        const bool left = blk < 2;
        const double* X = blk == 0 ? sF0 : blk == 1 ? sG0
                        : blk == 2 ? F + 36 * (base + max_m - 1) : G + 36 * (base + max_m - 1);
        double acc = 0.0;
        for (int q = 0; q < 6; ++q)
          acc += -(left ? sLl[6 * q + i] : sUr[6 * q + i]) * X[6 * q + j];
        val = acc;
      } else {
        const int i = (e - 144) % 6;
        const bool left = e - 144 < 6;
        const double* x = left ? sg0 : g + 6 * (base + max_m - 1);
        double acc = 0.0;
        for (int q = 0; q < 6; ++q) acc += (left ? sLl[6 * q + i] : sUr[6 * q + i]) * x[q];
        val = -acc;
      }
    }
    if (e < 144) S[144 * (size_t)k + e] = val;
    else r[12 * (size_t)k + e - 144] = val;
  }
}

// ---------------------------------------------------------------------------
// K10c
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(RED_THREADS)
reduced_kernel(const double* __restrict__ diag, const double* __restrict__ off,
               const double* __restrict__ b, const double* __restrict__ lb,
               const double* __restrict__ S, const double* __restrict__ r,
               const int* __restrict__ seps, const int* __restrict__ adj_mask,
               const int* __restrict__ adj_off, const int* __restrict__ loop_a,
               const int* __restrict__ loop_b, const int* __restrict__ loop_valid, int D, int L,
               const double* __restrict__ st, double* __restrict__ Hs, double* __restrict__ bs,
               double* __restrict__ pan, double* __restrict__ xs) {
  if (st[3] == 0.0) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = 6 * D;
  __shared__ double Ld[6][6];
  __shared__ double yv[6];

  // ---- assembly, each entry's terms in the order of the JAX scatter-adds ----
  for (size_t e = tid; e < (size_t)N * N; e += nt) {
    const int row = (int)(e / N), col = (int)(e % N);
    const int I = row / 6, i = row % 6, J = col / 6, j = col % 6;
    double v = 0.0;
    if (I == J) {
      v = diag[36 * (size_t)seps[I] + 6 * i + j] + S[144 * (size_t)I + 108 + 6 * i + j];
      if (I + 1 < D) v += S[144 * (size_t)(I + 1) + 6 * i + j];            // S_ll of I+1
    } else if (J == I + 1) {
      v = S[144 * (size_t)J + 36 + 6 * i + j];                             // S_lr of J
      if (adj_mask[I]) v += off[36 * (size_t)adj_off[I] + 6 * i + j];
    } else if (I == J + 1) {
      v = S[144 * (size_t)I + 72 + 6 * i + j];                             // S_rl of I
      if (adj_mask[J]) v += off[36 * (size_t)adj_off[J] + 6 * j + i];
    }
    Hs[e] = v;
  }
  for (int row = tid; row < N; row += nt) {
    const int I = row / 6, i = row % 6;
    double v = b[6 * (size_t)seps[I] + i] + r[12 * (size_t)I + 6 + i];
    if (I + 1 < D) v += r[12 * (size_t)(I + 1) + i];                       // r_l of I+1
    bs[row] = v;
  }
  __syncthreads();
  if (tid < 36) {   // loop blocks (a < b) in loop order, then their transposes
    const int i = tid / 6, j = tid % 6;
    for (int l = 0; l < L; ++l)
      if (loop_valid[l])
        Hs[(size_t)(6 * loop_a[l] + i) * N + 6 * loop_b[l] + j] += lb[36 * (size_t)l + 6 * i + j];
    for (int l = 0; l < L; ++l)
      if (loop_valid[l])
        Hs[(size_t)(6 * loop_b[l] + i) * N + 6 * loop_a[l] + j] += lb[36 * (size_t)l + 6 * j + i];
  }
  __syncthreads();
  // the lower triangle becomes (Hs + Hs^T) / 2
  for (size_t e = tid; e < (size_t)N * N; e += nt) {
    const int row = (int)(e / N), col = (int)(e % N);
    if (col < row) Hs[e] = (Hs[e] + Hs[(size_t)col * N + row]) * 0.5;
  }
  __syncthreads();

  // ---- right-looking Cholesky in 6-column panels, in place (lower) ----
  for (int J = 0; J < D; ++J) {
    const int j0 = 6 * J;
    if (tid == 0) {
      for (int j = 0; j < 6; ++j) {
        double s = Hs[(size_t)(j0 + j) * N + j0 + j];
        for (int q = 0; q < j; ++q) s -= Ld[j][q] * Ld[j][q];
        const double ljj = s > 0.0 ? sqrt(s) : NAN;
        Ld[j][j] = ljj;
        for (int i = j + 1; i < 6; ++i) {
          double v = Hs[(size_t)(j0 + i) * N + j0 + j];
          for (int q = 0; q < j; ++q) v -= Ld[i][q] * Ld[j][q];
          Ld[i][j] = v / ljj;
        }
      }
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j <= i; ++j) Hs[(size_t)(j0 + i) * N + j0 + j] = Ld[i][j];
    }
    __syncthreads();
    // the panel below: L[i, j0:j0+6] = A[i, j0:j0+6] Ld^-T
    for (int i = j0 + 6 + tid; i < N; i += nt) {
      double x[6];
      for (int c = 0; c < 6; ++c) {
        double v = Hs[(size_t)i * N + j0 + c];
        for (int q = 0; q < c; ++q) v -= x[q] * Ld[c][q];
        x[c] = v / Ld[c][c];
      }
      for (int c = 0; c < 6; ++c) {
        Hs[(size_t)i * N + j0 + c] = x[c];
        pan[6 * (size_t)i + c] = x[c];
      }
    }
    __syncthreads();
    // trailing update of the lower triangle: A[i][c] -= sum_q L[i][q] L[c][q]
    const int R = N - j0 - 6;
    for (size_t e = tid; e < (size_t)R * R; e += nt) {
      const int i = j0 + 6 + (int)(e / R), c = j0 + 6 + (int)(e % R);
      if (c > i) continue;
      double acc = 0.0;
      for (int q = 0; q < 6; ++q) acc += pan[6 * (size_t)i + q] * pan[6 * (size_t)c + q];
      Hs[(size_t)i * N + c] -= acc;
    }
    __syncthreads();
  }

  // ---- L y = bs, then L^T x = y, in 6-row steps (bs holds y, then x) ----
  for (int J = 0; J < D; ++J) {
    const int j0 = 6 * J;
    if (tid == 0)
      for (int c = 0; c < 6; ++c) {
        double v = bs[j0 + c];
        for (int q = 0; q < c; ++q) v -= Hs[(size_t)(j0 + c) * N + j0 + q] * yv[q];
        yv[c] = v / Hs[(size_t)(j0 + c) * N + j0 + c];
        bs[j0 + c] = yv[c];
      }
    __syncthreads();
    for (int i = j0 + 6 + tid; i < N; i += nt) {
      double acc = 0.0;
      for (int q = 0; q < 6; ++q) acc += Hs[(size_t)i * N + j0 + q] * yv[q];
      bs[i] -= acc;
    }
    __syncthreads();
  }
  for (int J = D - 1; J >= 0; --J) {
    const int j0 = 6 * J;
    if (tid == 0)
      for (int c = 5; c >= 0; --c) {
        double v = bs[j0 + c];
        for (int q = c + 1; q < 6; ++q) v -= Hs[(size_t)(j0 + q) * N + j0 + c] * yv[q];
        yv[c] = v / Hs[(size_t)(j0 + c) * N + j0 + c];
        bs[j0 + c] = yv[c];
      }
    __syncthreads();
    for (int i = tid; i < j0; i += nt) {
      double acc = 0.0;
      for (int q = 0; q < 6; ++q) acc += Hs[(size_t)(j0 + q) * N + i] * yv[q];
      bs[i] -= acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < N; e += nt) xs[e] = bs[e];
}

// ---------------------------------------------------------------------------
// K10d
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BACKSUB_THREADS)
backsub_kernel(const double* __restrict__ xs, const double* __restrict__ F,
               const double* __restrict__ G, const double* __restrict__ g,
               const int* __restrict__ has_left, const int* __restrict__ xl_idx,
               const int* __restrict__ pose_row, const double* __restrict__ real_mask, int n_pad,
               int max_m, int max_iters, double tol, double* __restrict__ st,
               double* __restrict__ dx, double* __restrict__ partials,
               unsigned int* __restrict__ counter, double* __restrict__ poses) {
  __shared__ double red[2][BACKSUB_THREADS / 32];
  __shared__ bool last;
  __shared__ bool ok_s;
  if (st[3] == 0.0) return;
  const int tid = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + tid;
  double ss = 0.0, bad = 0.0;
  if (p < n_pad) {
    const int code = pose_row[p];
    double x[6];
    if (code < 0) {
      for (int a = 0; a < 6; ++a) x[a] = xs[6 * (size_t)(-code - 1) + a];
    } else {
      const int k = code / max_m;
      const double* Fr = F + 36 * (size_t)code;
      const double* Gr = G + 36 * (size_t)code;
      const double* gr = g + 6 * (size_t)code;
      const double* xr = xs + 6 * (size_t)k;
      double xl[6];
      for (int q = 0; q < 6; ++q) xl[q] = has_left[k] ? xs[6 * (size_t)xl_idx[k] + q] : 0.0;
      for (int a = 0; a < 6; ++a) {
        double fx = 0.0, gx = 0.0;
        for (int q = 0; q < 6; ++q) {
          fx += Fr[6 * a + q] * xl[q];
          gx += Gr[6 * a + q] * xr[q];
        }
        x[a] = (gr[a] - fx) - gx;
      }
    }
    for (int a = 0; a < 6; ++a) {
      const double v = x[a] * real_mask[p];
      dx[6 * (size_t)p + a] = v;
      ss += v * v;
      bad += isfinite(v) ? 0.0 : 1.0;
    }
  }
  // block sums in warp order, then the partials in block order by the last block
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_down_sync(0xffffffffu, ss, o);
    bad += __shfl_down_sync(0xffffffffu, bad, o);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = ss;
    red[1][tid >> 5] = bad;
  }
  __syncthreads();
  if (tid == 0) {
    double s0 = 0.0, s1 = 0.0;
    for (int w = 0; w < BACKSUB_THREADS / 32; ++w) {
      s0 += red[0][w];
      s1 += red[1][w];
    }
    partials[2 * blockIdx.x] = s0;
    partials[2 * blockIdx.x + 1] = s1;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  if (tid == 0) {
    double s0 = 0.0, s1 = 0.0;
    for (unsigned int bk = 0; bk < gridDim.x; ++bk) {
      s0 += __ldcg(partials + 2 * bk);
      s1 += __ldcg(partials + 2 * bk + 1);
    }
    const double dxn = sqrt(s0);
    const bool ok = s1 == 0.0;
    const double it = st[0] + 1.0;
    st[0] = it;
    st[1] = dxn;
    st[2] = ok ? 1.0 : 0.0;
    st[3] = (it < (double)max_iters && dxn >= tol && ok) ? 1.0 : 0.0;
    ok_s = ok;
    *counter = 0u;   // ready for the next iteration's launch
  }
  __syncthreads();
  if (!ok_s) return;
  for (int q = tid; q < n_pad; q += blockDim.x) {
    double xi[6];
    for (int a = 0; a < 6; ++a) xi[a] = __ldcg(dx + 6 * (size_t)q + a);
    retract(poses + 16 * (size_t)q, xi);
  }
}

inline int nblocks(int n, int t) { return (n + t - 1) / t; }

}  // namespace

LO_EXPORT int lo_pgo_linearize(const double* poses, int n_pad, const double* pad_reg,
                               const int* prior_key, const double* prior_meas,
                               const double* prior_sqrtI, const int* prior_valid, int P,
                               const int* bt_from, const int* bt_to, const double* bt_meas,
                               const double* bt_sqrtI, const int* bt_valid, int M,
                               const int* loop_bt, const int* loop_valid, int L,
                               const int* inc_ptr, const int* inc_ent, const int* chain_ptr,
                               const int* chain_ent, const double* st, double* fac36,
                               double* fac6, double* diag, double* off, double* b, double* lb,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  factor_kernel<<<max(1, nblocks(P + M, FAC_THREADS)), FAC_THREADS, 0, s>>>(
      poses, prior_key, prior_meas, prior_sqrtI, prior_valid, P, bt_from, bt_to, bt_meas,
      bt_sqrtI, bt_valid, M, st, fac36, fac6);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  assemble_kernel<<<max(1, nblocks(n_pad + L, ASM_THREADS)), ASM_THREADS, 0, s>>>(
      pad_reg, n_pad, P, M, loop_bt, loop_valid, L, inc_ptr, inc_ent, chain_ptr, chain_ent,
      st, fac36, fac6, diag, off, b, lb);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_pgo_eliminate(const double* diag, const double* off, const double* b,
                               const int* int_idx, const int* valid, const int* off_idx,
                               const int* ovalid, const int* has_left, const int* left_off,
                               const int* lsep_row, const int* uright_off, const int* ur_valid,
                               int D, int max_m, int m_off, const double* st, double* Cs,
                               double* Es, double* ds, double* F, double* G, double* g,
                               double* S, double* r, void* stream) {
  eliminate_kernel<<<D, 32, 0, (cudaStream_t)stream>>>(
      diag, off, b, int_idx, valid, off_idx, ovalid, has_left, left_off, lsep_row, uright_off,
      ur_valid, max_m, m_off, st, Cs, Es, ds, F, G, g, S, r);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_pgo_reduced_solve(const double* diag, const double* off, const double* b,
                                   const double* lb, const double* S, const double* r,
                                   const int* seps, const int* adj_mask, const int* adj_off,
                                   const int* loop_a, const int* loop_b, const int* loop_valid,
                                   int D, int L, const double* st, double* Hs, double* bs,
                                   double* pan, double* xs, void* stream) {
  reduced_kernel<<<1, RED_THREADS, 0, (cudaStream_t)stream>>>(
      diag, off, b, lb, S, r, seps, adj_mask, adj_off, loop_a, loop_b, loop_valid, D, L, st,
      Hs, bs, pan, xs);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_pgo_backsub_retract(const double* xs, const double* F, const double* G,
                                     const double* g, const int* has_left, const int* xl_idx,
                                     const int* pose_row, const double* real_mask, int n_pad,
                                     int max_m, int max_iters, double tol, double* st,
                                     double* dx, double* partials, unsigned int* counter,
                                     double* poses, void* stream) {
  backsub_kernel<<<nblocks(n_pad, BACKSUB_THREADS), BACKSUB_THREADS, 0, (cudaStream_t)stream>>>(
      xs, F, G, g, has_left, xl_idx, pose_row, real_mask, n_pad, max_m, max_iters, tol, st, dx,
      partials, counter, poses);
  return (int)cudaGetLastError();
}
