// K10 pgo: one Gauss-Newton iteration of the "distributed" pose-graph
// backend in float64, as four entry points launched in turn on one stream.
//
// Replaces the JAX package's parallel/distributed_pgo.py:589 _gn_device (the
// jitted while_loop of gn_optimize_device, :696), iteration by iteration:
//  * K10a lo_pgo_linearize — _linearize_device (:521): prior and between
//    factors into diag (n_pad,6,6), off (n_pad-1,6,6), b (n_pad,6) and the
//    loop blocks lb (L,6,6). One kernel, no scratch: a half-warp a pose
//    evaluates each incident factor (its SE(3) log error and J_from =
//    -Ad(hx^-1), a lane a factor) and sums the weighted blocks, an output
//    entry a lane, in the order of the host-built lists (inc_*, chain_*),
//    the order of the JAX scatter-adds, so with no atomics the sums are the
//    same in every run. One more half-warp a loop edge evaluates its block
//    (the design is at the kernel).
//  * K10b lo_pgo_eliminate — _eliminate_interior_spd under vmap (:450) with
//    _gn_device's interior packing (:610-619): a block of two warps a
//    partition, one staging its interior rows straight from the plan into
//    a shared-memory ring, the other running the forward chain (Dt = D_i -
//    L_i C_prev, a 6x6 Cholesky with reciprocal pivots, the 13 right-hand
//    columns [U | E | b], one column a lane) and the backward chain F, G,
//    g, and writing the Schur blocks. C, E and d go to global scratch,
//    staged back for the backward chain (the chain is max_m long and is
//    not capped; the design is at the kernel).
//  * K10c lo_pgo_reduced_solve — the separator system (:625-647): a cluster
//    of 8 CTAs assembles Hs ((6D)^2, in global memory: 1.5 MB at D = 73,
//    beyond an SM's shared memory, and D is not capped) and bs in the order
//    of the JAX scatter-adds, factors Hs in place by a right-looking
//    Cholesky in 24-column panels whose trailing updates run on the fp64
//    tensor cores, with bs as one more row (the forward solve), and solves
//    L^T x = y (the design is at the kernel).
//  * K10d lo_pgo_backsub_retract — :649-686: one thread-block cluster of
//    BACKSUB_CLUSTER CTAs (16, a non-portable size; an error where the
//    card refuses it), one thread a padded pose. Each thread computes its
//    dx in registers; the CTAs' sums of |dx|^2 and of non-finite entries
//    meet in distributed shared memory, every CTA summing them in rank
//    order, so all agree on ok; each thread's pose, read at the start, is retracted
//    while the cluster barrier completes and stored where ok. Rank 0
//    writes the loop state. Past BACKSUB_CLUSTER x 256 poses a thread
//    takes every (cluster x 256)-th pose and recomputes the dx of all but
//    its first for the retraction.
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
// (K10b reads ~5 MB of blocks and writes ~17 MB of F, G and g, and ~18 MB
// of scratch it reads back: ~12 us at 3.35 TB/s) and does a few hundred
// MFLOP (K10c's Cholesky of a 438 x 438 system: 28 MFLOP, ~0.4 us at 67
// TFLOP/s f64), so each is
// bound by its sequential depth and launch cost, not by the card: K10b is
// a chain of max_m dependent 6x6 steps in each partition, K10c a chain of
// ceil(D / 4) dependent panels, each a warp's 24-column factor, a row
// solve, a tensor-core update and two cluster barriers. The designs keep
// the summation order fixed, which makes two calls bit-equal.
#include "common.cuh"
#include <cooperative_groups.h>
#include <math.h>

namespace {

constexpr double LIE_EPS = 1e-10;        // reference kEpsLie
constexpr int BACKSUB_THREADS = 256;     // threads a CTA of K10d's cluster
constexpr int BACKSUB_CLUSTER = 16;      // CTAs of K10d's cluster (distributed_pgo.py BACKSUB_SHAPE)

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

__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool fill) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(fill ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n" : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"((unsigned)__cvta_generic_to_shared(p)),
               "r"(v) : "memory");
}

// ---------------------------------------------------------------------------
// K10a
// ---------------------------------------------------------------------------
//
// One launch, no scratch: a half-warp a padded pose (diag, b, off), then a
// half-warp a loop edge (lb). Bytes bound it (at n_pad 4096 ~4.8 MB, ~1.4
// us at 3.35 TB/s; ~10 MFLOP f64); what it takes beyond is a pose's chain:
// three dependent load rounds (list, factor, poses) and the header's
// serial fp64 arithmetic, then a few rounds of products:
//  * A pose's tasks are its incident factor blocks (inc_ent: prior k,
//    between k as "from", between k as "to") and then its chain couplings
//    (chain_ent), in the order of the host-built lists. A round takes up to
//    LIN_SLOTS of them: a lane a task reads its list entry, the half-warp
//    stages the tasks' sqrt-information rows S into shared memory with
//    cp.async, and meanwhile each task's lane evaluates its factor's header
//    (the SE(3) log error and J_from = -Ad(hx^-1)) in registers, into
//    shared memory.
//  * Every 6x6 product is split by output entry over the 16 lanes: lane h
//    takes entries h and 16 + h, lanes 0-3 entry 32 + h, lanes 4-9 entry
//    h - 4 of the six-vector, so no lane holds a 36-double array. Each
//    entry is a q = 0..5 dot product summed from 0.0; a lane adds its
//    entries to its own accumulators in the lists' order, and a half-warp
//    writes each row as 288 contiguous bytes.
//  * Two poses a warp: at 128 registers an SM holds 16 warps, so the
//    n_pad / 2 warps of n_pad 4096 run in one wave, and the two halves'
//    headers run side by side.
//  * A between factor is evaluated by both its end poses (and once more
//    for its chain coupling), with the same code, so with the same bits.
//    No value is added atomically: two calls are bit-equal.
// The double acos, sin and tan of se3_log keep their slow-path argument
// reduction, which is the kernel's only stack.
constexpr int LIN_WARPS = 4;           // warps a CTA, two poses each
constexpr int LIN_POSES = 2 * LIN_WARPS;
constexpr int LIN_SLOTS = 8;           // tasks a pose evaluates a round
enum { TASK_PRIOR = 0, TASK_FROM = 1, TASK_TO = 2, TASK_CHAIN = 3 };

struct LinPose {
  double S[LIN_SLOTS][36];   // the tasks' sqrt-information rows
  double J[LIN_SLOTS][36];   // J_from of a between task
  double err[LIN_SLOTS][6];  // the log error
  double W[36];              // Jw = S J, or a prior's information
  double ew[6];              // S err
  int kind[LIN_SLOTS], fac[LIN_SLOTS], lo_is_from[LIN_SLOTS];
};

// a[0] b[0] + ... + a[5 sa] b[5 sb], summed from 0.0 in q order
__device__ __forceinline__ double dot6(const double* a, int sa, const double* b, int sb) {
  double v = 0.0;
#pragma unroll
  for (int q = 0; q < 6; ++q) v += a[q * sa] * b[q * sb];
  return v;
}

// Entry e = 6 i + j of A^T B for 6x6 row-major A, B.
__device__ __forceinline__ double tprod(const double* A, const double* B, int e) {
  return dot6(A + e / 6, 6, B + e % 6, 6);
}

// A prior factor's error at its pose T.
__device__ void prior_header(const double* __restrict__ T, const double* __restrict__ Mm,
                             double* err) {
  double Re[3][3], te[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)   // Rm^T Rp
      Re[i][j] = Mm[i] * T[j] + Mm[4 + i] * T[4 + j] + Mm[8 + i] * T[8 + j];
    te[i] = Mm[i] * (T[3] - Mm[3]) + Mm[4 + i] * (T[7] - Mm[7]) + Mm[8 + i] * (T[11] - Mm[11]);
  }
  double e[6];
  se3_log(Re, te, e);
  for (int i = 0; i < 6; ++i) err[i] = e[i];
}

// A between factor's error and J_from.
__device__ void between_header(const double* __restrict__ Tf, const double* __restrict__ Tt,
                               const double* __restrict__ Mm, double* err, double* Jout) {
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
  double e[6];
  se3_log(Re, te, e);
  for (int i = 0; i < 6; ++i) err[i] = e[i];
  // hx^-1 = (R_hx^T, -R_hx^T t_hx); J_from = -Ad(hx^-1) = -[[Ri, 0], [skew(ti) Ri, Ri]]
  double Ri[3][3], ti[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Ri[i][j] = Rhx[j][i];
  for (int i = 0; i < 3; ++i) ti[i] = -(Ri[i][0] * thx[0] + Ri[i][1] * thx[1] + Ri[i][2] * thx[2]);
  const double K[3][3] = {{0.0, -ti[2], ti[1]}, {ti[2], 0.0, -ti[0]}, {-ti[1], ti[0], 0.0}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Jout[6 * i + j] = -Ri[i][j];
      Jout[6 * i + 3 + j] = -0.0;
      Jout[6 * (3 + i) + j] = -(K[i][0] * Ri[0][j] + K[i][1] * Ri[1][j] + K[i][2] * Ri[2][j]);
      Jout[6 * (3 + i) + 3 + j] = -Ri[i][j];
    }
}

// Entry e of Jw = S J (row-major S and J of slot s).
__device__ __forceinline__ double sj(const LinPose& sp, int s, int e) {
  return dot6(sp.S[s] + 6 * (e / 6), 1, sp.J[s] + e % 6, 6);
}

// Entry e of Hij = Jw_f^T Jw_t (J_to = I, so Jw_t = S) as H[lo, hi]: Hij,
// or its transpose where to < from.
__device__ __forceinline__ double coupling(const LinPose& sp, int s, int e, bool lo_is_from) {
  const int i = e / 6, j = e % 6;
  return dot6(sp.W + (lo_is_from ? i : j), 6, sp.S[s] + (lo_is_from ? j : i), 6);
}

__global__ void __launch_bounds__(LIN_WARPS * 32)
linearize_kernel(const double* __restrict__ poses, int n_pad, const double* __restrict__ pad_reg,
                 const double* __restrict__ prior_meas, const double* __restrict__ prior_sqrtI,
                 int P, const int* __restrict__ bt_from, const int* __restrict__ bt_to,
                 const double* __restrict__ bt_meas, const double* __restrict__ bt_sqrtI, int M,
                 const int* __restrict__ loop_bt, const int* __restrict__ loop_valid, int L,
                 const int* __restrict__ inc_ptr, const int* __restrict__ inc_ent,
                 const int* __restrict__ chain_ptr, const int* __restrict__ chain_ent,
                 const double* __restrict__ st, double* __restrict__ diag,
                 double* __restrict__ off, double* __restrict__ b, double* __restrict__ lb) {
  __shared__ LinPose smem[LIN_POSES];
  if (st[3] == 0.0) return;
  const int h = threadIdx.x & 15, half = threadIdx.x >> 4;
  const unsigned mask = 0xffffu << (16 * (half & 1));
  const int p = blockIdx.x * LIN_POSES + half;
  if (p >= n_pad + L) return;
  LinPose& sp = smem[half];
  // ---- tasks
  // the pose's lists (a loop edge: its one coupling)
  int i0 = 0, n_inc = 0, c0 = 0, n_task = 1;
  if (p < n_pad) {
    i0 = __ldg(inc_ptr + p);
    n_inc = __ldg(inc_ptr + p + 1) - i0;
    c0 = __ldg(chain_ptr + p);
    n_task = n_inc + (p < n_pad - 1 ? __ldg(chain_ptr + p + 1) - c0 : 0);
  } else if (!__ldg(loop_valid + (p - n_pad))) {
    n_task = 0;
  }
  // lane h: matrix entries h, 16 + h and (lanes 0-3) 32 + h; lanes 4-9
  // entry h - 4 of the six-vector in place of the third
  const int e0 = h, e1 = 16 + h, e2 = 32 + h, v = h - 4;
  const bool third = h < 4, vec = h >= 4 && h < 10;
  const bool real = p < n_pad;
  double d0 = real && e0 % 7 == 0 ? pad_reg[p] : 0.0;   // diag
  double d1 = real && e1 % 7 == 0 ? pad_reg[p] : 0.0;
  double d2 = real && third && e2 % 7 == 0 ? pad_reg[p] : 0.0;  // or b
  double o0 = 0.0, o1 = 0.0, o2 = 0.0;                  // off, or lb
  for (int base = 0; base < n_task; base += LIN_SLOTS) {
    const int ns = min(LIN_SLOTS, n_task - base);
    int kind = TASK_CHAIN, f = 0;
    if (h < ns) {
      const int t = base + h;
      if (!real) {
        f = __ldg(loop_bt + (p - n_pad));
      } else if (t < n_inc) {
        const int e = __ldg(inc_ent + i0 + t);
        kind = e < P ? TASK_PRIOR : (e < P + M ? TASK_FROM : TASK_TO);
        f = kind == TASK_PRIOR ? e : (kind == TASK_FROM ? e - P : e - P - M);
      } else {
        f = __ldg(chain_ent + c0 + t - n_inc);
      }
      sp.kind[h] = kind;
      sp.fac[h] = f;
    }
    __syncwarp(mask);
    // ---- stage
    // the tasks' S rows, in flight while the headers run
    for (int q = h; q < 36 * ns; q += 16) {
      const int s = q / 36, e = q - 36 * s;
      const double* src = sp.kind[s] == TASK_PRIOR ? prior_sqrtI : bt_sqrtI;
      cp_async8(&sp.S[s][e], src + 36 * (size_t)sp.fac[s] + e, true);
    }
    cp_async_commit();
    // ---- header
    // a lane a task: the SE(3) error and J_from
    if (h < ns) {
      if (kind == TASK_PRIOR) {
        prior_header(poses + 16 * (size_t)p, prior_meas + 16 * (size_t)f, sp.err[h]);
      } else {
        const int from = __ldg(bt_from + f), to = __ldg(bt_to + f);
        between_header(poses + 16 * (size_t)from, poses + 16 * (size_t)to,
                       bt_meas + 16 * (size_t)f, sp.err[h], sp.J[h]);
        sp.lo_is_from[h] = from < to;
      }
    }
    cp_async_wait<0>();
    __syncwarp(mask);
    // ---- blocks
    // a task at a time, an output entry a lane, in the lists' order
    for (int s = 0; s < ns; ++s) {
      const double* S = sp.S[s];
      switch (sp.kind[s]) {
        case TASK_PRIOR: {     // info = S^T S; b -= info err
          const double a0 = tprod(S, S, e0), a1 = tprod(S, S, e1);
          d0 += a0;
          d1 += a1;
          sp.W[e0] = a0;
          sp.W[e1] = a1;
          if (third) {
            const double a2 = tprod(S, S, e2);
            d2 += a2;
            sp.W[e2] = a2;
          }
          __syncwarp(mask);
          if (vec) d2 += -dot6(sp.W + 6 * v, 1, sp.err[s], 1);
          break;
        }
        case TASK_FROM: {      // Jw^T Jw; b -= Jw^T ew
          sp.W[e0] = sj(sp, s, e0);
          sp.W[e1] = sj(sp, s, e1);
          if (third) sp.W[e2] = sj(sp, s, e2);
          else if (vec) sp.ew[v] = dot6(S + 6 * v, 1, sp.err[s], 1);
          __syncwarp(mask);
          d0 += tprod(sp.W, sp.W, e0);
          d1 += tprod(sp.W, sp.W, e1);
          if (third) d2 += tprod(sp.W, sp.W, e2);
          else if (vec) d2 += -dot6(sp.W + v, 6, sp.ew, 1);
          break;
        }
        case TASK_TO: {        // J_to = I: S^T S; b -= S^T ew
          if (vec) sp.ew[v] = dot6(S + 6 * v, 1, sp.err[s], 1);
          __syncwarp(mask);
          d0 += tprod(S, S, e0);
          d1 += tprod(S, S, e1);
          if (third) d2 += tprod(S, S, e2);
          else if (vec) d2 += -dot6(S + v, 6, sp.ew, 1);
          break;
        }
        default: {             // the chain coupling (or loop block) H[lo, hi]
          sp.W[e0] = sj(sp, s, e0);
          sp.W[e1] = sj(sp, s, e1);
          if (third) sp.W[e2] = sj(sp, s, e2);
          __syncwarp(mask);
          const bool lf = sp.lo_is_from[s];
          o0 += coupling(sp, s, e0, lf);
          o1 += coupling(sp, s, e1, lf);
          if (third) o2 += coupling(sp, s, e2, lf);
        }
      }
      __syncwarp(mask);
    }
  }
  // ---- store
  // 288-byte rows, a half-warp each
  double* row = real ? diag + 36 * (size_t)p : lb + 36 * (size_t)(p - n_pad);
  if (real) {
    row[e0] = d0;
    row[e1] = d1;
    if (third) row[e2] = d2;
    else if (vec) b[6 * (size_t)p + v] = d2;
    if (p == n_pad - 1) return;
    row = off + 36 * (size_t)p;
  }
  row[e0] = o0;
  row[e1] = o1;
  if (third) row[e2] = o2;
}

// ---------------------------------------------------------------------------
// K10b
// ---------------------------------------------------------------------------
//
// One block a partition: warp 0 walks the interior chain, warp 1 stages
// its inputs. The chain is the whole cost (max_m dependent 6x6 steps), so
// the design takes everything that does not depend on the recurrence off
// the chain warp:
//  * Staging (warp 1). It copies each row the chain will read into a ring
//    of EL_RING rows in shared memory with cp.async, one commit group a
//    row, and publishes a row (a release store of its sequence number)
//    once the group EL_LAG rows later has been issued and the row's own
//    has completed; it takes a slot again only once warp 0 has released
//    it. Forward rows are [D_R | U_R | b_R] (U zero-filled where ovalid is
//    0, by cp.async's source size), their plan indices from a window of 32
//    rows each lane loads one window ahead; backward rows are the forward
//    chain's [C | E | d | valid] from global scratch, staged once warp 0
//    has finished the forward chain. Any max_m runs: the ring holds
//    EL_RING rows, whatever the chain's length. Warp 1 also writes the
//    front-padded rows of F, G and g (zeros) at the end.
//  * One factor a row, no division (warp 0). Lane c < 6 holds column c of
//    C, lanes 6..11 the columns of E and lane 12 d (the forward chain's 13
//    right-hand columns [U | E | b]). Each lane forms its column of the
//    next row's Dt = D - L C (lanes 0..5) or right-hand side (L E, L d)
//    from its own column, so the only exchange a row is Dt through shared
//    memory (double-buffered, one __syncwarp). Every lane then factors
//    (Dt + Dt^T) / 2 itself with the pivots' reciprocal square roots, the
//    hardware approximation refined by one third-order Newton step, and
//    solves its column by multiplying by them: 6 reciprocal square roots
//    a row and no IEEE division or square root on the chain. A
//    non-positive or NaN pivot gives NaN, as jnp.linalg.cholesky does,
//    and NaN spreads to every output. Lane roles are per-lane offsets, not
//    branches; a row's inputs are loaded from the ring into registers
//    while the row before it is factored; a lane writes its column to
//    scratch as three 16-byte stores (the scratch row is lane-major:
//    column c of C at 6c).
//  * The backward chain needs no exchange at all: lanes 6..11 hold the
//    columns of F (F_last = E_last), lanes 0..5 those of G (G_last =
//    Dt_last^-1 U_right, solved with the last row's factor every lane
//    still holds) and lane 12 g, each updated from its own column and the
//    staged C_R. The Schur blocks come from the columns the lanes hold at
//    the chain's two ends.
//  * Front padding is skipped: the chain starts at the first valid row
//    (rows before it are exactly zero in C, E, d, F, G and g), or at the
//    last row when none is valid.
// Every product is summed in the order of the JAX program's 6x6 products
// (q = 0..5), no value is added atomically, so two calls are bit-equal.
// The "// ---- " comments mark the phases for tools/k10b_phase_stamps.py.

constexpr int EL_RING = 16;                // rows staged in shared memory
constexpr int EL_LAG = 6;                  // groups issued after a row before it is published
constexpr int EL_FREE = 4;                 // warp 0 releases slots every EL_FREE rows
constexpr int EL_ROW = 80;                 // doubles a staged row (79 used)

// 1/sqrt(s) of a Cholesky pivot: rsqrt.approx (~2^-22 relative) refined by
// one third-order Newton step (error ~(5/16) e^3, below double's epsilon)
// for normal s; NaN where s is not positive (or NaN).
__device__ __forceinline__ double pivot_rsqrt(double s) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(s));
  const double e = fma(-(s * y), y, 1.0);
  y = fma(y * e, fma(0.375, e, 0.5), y);
  return s > 0.0 ? y : NAN;
}

__global__ void __launch_bounds__(64)
eliminate_kernel(const double* __restrict__ diag, const double* __restrict__ off,
                 const double* __restrict__ b, const int* __restrict__ int_idx,
                 const int* __restrict__ valid, const int* __restrict__ off_idx,
                 const int* __restrict__ ovalid, const int* __restrict__ has_left,
                 const int* __restrict__ left_off, const int* __restrict__ lsep_row,
                 const int* __restrict__ uright_off, const int* __restrict__ ur_valid,
                 int max_m, int m_off, const double* __restrict__ st,
                 double* __restrict__ scratch, double* __restrict__ F, double* __restrict__ G,
                 double* __restrict__ g, double* __restrict__ S, double* __restrict__ r) {
  if (st[3] == 0.0) return;
  const int k = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ __align__(16) double ring[EL_RING][EL_ROW];
  __shared__ __align__(16) double sDt[2][36];
  __shared__ __align__(16) double sLl[36];  // H[first, sep_l]^T
  __shared__ __align__(16) double sUr[36];  // H[last, sep_r]
  __shared__ __align__(16) double sZero[36];
  __shared__ int ready, freed, fwd_done;    // warp 1 -> 0, warp 0 -> 1, warp 0 -> 1
  const int* vrow = valid + (size_t)k * max_m;
  const size_t base = (size_t)k * max_m;

  // ---- prologue: first valid row, couplings ----
  int first = max_m;   // each warp scans for itself
  for (int q0 = 0; q0 < max_m && first == max_m; q0 += 128) {
    int vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int R = q0 + 32 * u + lane;
      vv[u] = R < max_m ? vrow[R] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned m = __ballot_sync(FULL, vv[u] != 0);
      if (m && first == max_m) first = q0 + 32 * u + __ffs(m) - 1;
    }
  }
  const bool any_valid = first < max_m;
  const int s0 = any_valid ? first : max_m - 1;   // the chain's first row
  const int n_fwd = max_m - s0 + 1;               // staged forward rows: s0 - 1 .. max_m - 1
  const int n_seq = n_fwd + max_m - 1 - s0;       // then backward rows max_m - 2 .. s0
  if (warp == 0) {
    const bool hl = has_left[k] != 0, hu_r = ur_valid[k] != 0;
    const int lo_ = left_off[k], ur_ = uright_off[k];
    for (int e = lane; e < 36; e += 32) {
      const int i = e / 6, j = e % 6;
      sLl[e] = hl ? off[36 * (size_t)lo_ + 6 * j + i] : 0.0;
      sUr[e] = hu_r ? off[36 * (size_t)ur_ + e] : 0.0;
      sZero[e] = 0.0;
    }
    if (lane == 0) { ready = -1; freed = -1; fwd_done = 0; }
  }
  __syncthreads();

  if (warp == 1) {
    // ---- the staging warp ----
    const int* irow = int_idx + (size_t)k * max_m;
    const int* orow = off_idx + (size_t)k * m_off;
    const int* ovrow = ovalid + (size_t)k * m_off;
    // the plan window: lane l holds row wb + l's entries (c_*) and row
    // wb + 32 + l's (n_*, loaded a window ahead; rows clamped into range)
    int wb = ((s0 - 1) >> 5) << 5;   // floor to a multiple of 32 (s0 - 1 may be -1)
    int c_ii, c_vv, c_oi, c_ov, n_ii, n_vv, n_oi, n_ov;
    auto fetch = [&](int w0, int& ii, int& vv, int& oi, int& ov) {
      const int R = min(max(w0 + lane, 0), max_m - 1);
      const int Ro = min(R, m_off - 1);
      ii = irow[R];
      vv = vrow[R];
      oi = orow[Ro];
      ov = ovrow[Ro];
    };
    fetch(wb, c_ii, c_vv, c_oi, c_ov);
    fetch(wb + 32, n_ii, n_vv, n_oi, n_ov);
    int free_seen = -1;
    for (int q = 0; q < n_seq; ++q) {
      if (q >= EL_RING) {   // the slot's last row must be released
        while (free_seen < q - EL_RING) free_seen = load_acquire(&freed);
      }
      double* slot = ring[q % EL_RING];
      if (q < n_fwd) {
        const int R = s0 - 1 + q;   // rows move one at a time: at most one window on
        if (R >= wb + 32) {
          c_ii = n_ii; c_vv = n_vv; c_oi = n_oi; c_ov = n_ov;
          wb += 32;
          fetch(wb + 32, n_ii, n_vv, n_oi, n_ov);
        }
        const int src = (R - wb) & 31;
        const int ii = __shfl_sync(FULL, c_ii, src), vv = __shfl_sync(FULL, c_vv, src);
        const int oi = __shfl_sync(FULL, c_oi, src), ov = __shfl_sync(FULL, c_ov, src);
        const bool inr = R >= 0 && R < max_m;
        const bool v = inr && vv != 0;
        const bool hu = inr && R < max_m - 1 && ov != 0;
        for (int e = lane; e < 78; e += 32) {
          const bool is_u = e >= 36 && e < 72;
          const double* p = e < 36 ? diag + 36 * (size_t)ii + e
                          : (is_u ? off + 36 * (size_t)oi + (e - 36)
                                  : b + 6 * (size_t)ii + (e - 72));
          cp_async8(slot + e, p, is_u ? hu : v);
        }
        if (lane == 0) slot[78] = v ? 1.0 : 0.0;
      } else {
        if (q == n_fwd) {   // the scratch rows: publish every forward row, then wait for them
          cp_async_wait<0>();
          __syncwarp();
          if (lane == 0) store_release(&ready, q - 1);
          while (!load_acquire(&fwd_done)) {}
        }
        const int R = max_m - 2 - (q - n_fwd);
        const double* p = scratch + EL_ROW * (base + R);
        for (int e = 2 * lane; e < EL_ROW; e += 64) cp_async16(slot + e, p + e);
      }
      cp_async_commit();
      if (q >= EL_LAG) {
        cp_async_wait<EL_LAG>();
        __syncwarp();
        if (lane == 0) store_release(&ready, q - EL_LAG);
      }
    }
    cp_async_wait<0>();
    __syncwarp();
    if (lane == 0) store_release(&ready, n_seq - 1);
    for (size_t e = lane; e < (size_t)s0 * 36; e += 32) {   // the padded rows: zeros
      F[36 * base + e] = 0.0;
      G[36 * base + e] = 0.0;
    }
    for (size_t e = lane; e < (size_t)s0 * 6; e += 32) g[6 * base + e] = 0.0;
    return;
  }

  // ---- the chain warp ----
  // lane roles: kind 0 (lanes 0..5) a column of C, then of G; kind 1 (6..11)
  // a column of E, then of F; kind 2 (lane 12) d, then g; lanes 13..31
  // compute lane 12's column and write nothing
  const int kind = lane < 6 ? 0 : (lane < 12 ? 1 : 2);
  const int col = lane < 6 ? lane : (lane < 12 ? lane - 6 : 0);
  const bool writer = lane < 13;
  const int lrow = lsep_row[k];
  // the forward right-hand side X[a] = cur[xo + xs a] (kind 0: D_R's column,
  // kind 2: b_R) or lx[xs a] (kind 1: Lleft's column at row lrow, else 0)
  const int xo = kind == 0 ? col : 72, xs = kind == 2 ? 1 : 6;
  const int uo = 36 + col;                       // kind 0's solve: U_R's column
  const int so_ = kind == 2 ? 72 : 6 * (kind == 1 ? 6 + col : col);   // its scratch column
  int known = -1;   // the last row warp 1 has published, as last read
  auto wait_row = [&](int q) {
    while (known < q) known = load_acquire(&ready);
  };
  // warp 1 may take the slots of rows up to q again. A relaxed store: the
  // values every lane loaded from those slots have been used by the chain
  // (a later row's products depend on them) before any lane gets here.
  auto release = [&](int q) {
    __syncwarp();
    if (lane == 0) *(volatile int*)&freed = q;
  };

  // ---- forward chain ----
  // A row's inputs are loaded from the ring into registers one row before
  // they are used, so the chain itself reads only its Dt exchange: L
  // (U_{R-1}, 36 values, every lane), X (6), the kind-0 lane's column of
  // U_R (6) and the valid flag.
  double Lr[36], Xr[6], Ur[6];
  bool vr;
  auto load_fwd = [&](int R, int q) {   // row R is sequence number q; q - 1 holds U_{R-1}
    const double* cur = ring[q % EL_RING];
    const double2* u2 = reinterpret_cast<const double2*>(ring[(q - 1) % EL_RING] + 36);
#pragma unroll
    for (int h = 0; h < 18; ++h) {
      const double2 t = u2[h];
      Lr[2 * h] = t.x;
      Lr[2 * h + 1] = t.y;
    }
    const double* xp = kind == 1 ? (R == lrow ? sLl + col : sZero) : cur + xo;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      Xr[a] = xp[xs * a];
      Ur[a] = cur[uo + 6 * a];
    }
    vr = cur[78] != 0.0;
  };
  double y[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};   // the lane's column of the last row
  double Lc[6][6], inv[6];                         // the last row's factor
  wait_row(1);
  load_fwd(s0, 1);
  for (int R = s0; R < max_m; ++R) {
    const int q = R - s0 + 1;
    // ---- fwd: Dt column and right-hand sides ----
    const bool v = vr;
    double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int qq = 0; qq < 6; ++qq)   // acc[a] += L_R[a][qq] y[qq] = U_{R-1}[qq][a] y[qq]
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[a] += Lr[6 * qq + a] * y[qq];
    double x[6], uc[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      x[a] = v ? Xr[a] - acc[a] : (kind == 0 && a == col ? 1.0 : 0.0);
      uc[a] = Ur[a];
    }
    double* dt = sDt[R & 1];
    if (kind == 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a) dt[6 * a + col] = x[a];
    }
    __syncwarp();
    if ((q & (EL_FREE - 1)) == 0 && lane == 0) *(volatile int*)&freed = q - 2;
    // ---- fwd: the next row's inputs ----
    if (R + 1 < max_m) {
      wait_row(q + 1);
      load_fwd(R + 1, q + 1);
    }
    // ---- fwd: factor ----
    double A[36];
#pragma unroll
    for (int h = 0; h < 18; ++h) {
      const double2 t = reinterpret_cast<const double2*>(dt)[h];
      A[2 * h] = t.x;
      A[2 * h + 1] = t.y;
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      double s = A[6 * j + j];
#pragma unroll
      for (int qq = 0; qq < j; ++qq) s -= Lc[j][qq] * Lc[j][qq];
      inv[j] = pivot_rsqrt(s);
#pragma unroll
      for (int i = j + 1; i < 6; ++i) {
        double w = (A[6 * i + j] + A[6 * j + i]) * 0.5;
#pragma unroll
        for (int qq = 0; qq < j; ++qq) w -= Lc[i][qq] * Lc[j][qq];
        Lc[i][j] = w * inv[j];
      }
    }
    // ---- fwd: solve ----
    double z[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double w = kind == 0 ? uc[i] : x[i];
#pragma unroll
      for (int qq = 0; qq < i; ++qq) w -= Lc[i][qq] * z[qq];
      z[i] = w * inv[i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
      double w = z[i];
#pragma unroll
      for (int qq = i + 1; qq < 6; ++qq) w -= Lc[qq][i] * z[qq];
      z[i] = w * inv[i];
    }
    // ---- fwd: stores ----
#pragma unroll
    for (int a = 0; a < 6; ++a) y[a] = (kind == 0 && !v) ? 0.0 : z[a];
    if (writer && R < max_m - 1) {
      double2* out = reinterpret_cast<double2*>(scratch + EL_ROW * (base + R) + so_);
      out[0] = make_double2(y[0], y[1]);
      out[1] = make_double2(y[2], y[3]);
      out[2] = make_double2(y[4], y[5]);
      if (lane == 0) scratch[EL_ROW * (base + R) + 78] = v ? 1.0 : 0.0;
    }
  }
  // the scratch rows are in place: warp 1 may stage them
  __threadfence();
  release(n_fwd - 1);
  if (lane == 0) store_release(&fwd_done, 1);

  // ---- the last row: F = E, G = Dt^-1 U_right, g = d; S_rl, S_rr, r_r ----
  if (kind == 0) {
    double z[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double w = sUr[6 * i + col];
#pragma unroll
      for (int qq = 0; qq < i; ++qq) w -= Lc[i][qq] * z[qq];
      z[i] = w * inv[i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
      double w = z[i];
#pragma unroll
      for (int qq = i + 1; qq < 6; ++qq) w -= Lc[qq][i] * z[qq];
      z[i] = w * inv[i];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) y[a] = z[a];
  }
  // kind 0: a column of G, kind 1 of F, kind 2 g, from here on; a lane
  // writes its column of row R at out + R * ostride, entry a at a * oa
  double* const out_base = kind == 0 ? G + 36 * base + col
                         : (kind == 1 ? F + 36 * base + col : g + 6 * base);
  const int ostride = kind == 2 ? 6 : 36, oa = kind == 2 ? 1 : 6;
  auto store_row = [&](int R) {
    if (!writer) return;
    double* o = out_base + (size_t)R * ostride;
#pragma unroll
    for (int a = 0; a < 6; ++a) o[oa * a] = y[a];
  };
  // Schur blocks of one end: S_l* = -Lt X0 (M = sLl) or S_r* = -Ut Xm
  // (M = sUr), each lane its column; r = -(M^T x) on lane 12
  auto schur = [&](const double* M, int blk_f, int blk_g, int r_at) {
    if (!writer) return;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double acc = 0.0;
      if (kind == 2) {
#pragma unroll
        for (int qq = 0; qq < 6; ++qq) acc += M[6 * qq + i] * y[qq];
        r[12 * (size_t)k + r_at + i] = any_valid ? -acc : 0.0;
      } else {
#pragma unroll
        for (int qq = 0; qq < 6; ++qq) acc += -(M[6 * qq + i]) * y[qq];
        S[144 * (size_t)k + 36 * (kind == 1 ? blk_f : blk_g) + 6 * i + col] =
            any_valid ? acc : 0.0;
      }
    }
  };
  store_row(max_m - 1);
  schur(sUr, 2, 3, 6);

  // ---- backward chain: F_R = E_R - C_R F, G_R = -C_R G, g_R = d_R - C_R g ----
  // a row's C_R (columns), X (kind 1: E_R's column, kind 2: d_R; kind 0:
  // zeros) and valid flag, loaded one row ahead as in the forward chain
  const int bo = kind == 1 ? 36 + 6 * col : 72;
  double Cr[36], Xb[6];
  bool vb;
  auto load_bwd = [&](int q) {
    const double* cr = ring[q % EL_RING];   // C_R | E_R | d_R | valid
    const double2* c2 = reinterpret_cast<const double2*>(cr);
#pragma unroll
    for (int h = 0; h < 18; ++h) {
      const double2 t = c2[h];
      Cr[2 * h] = t.x;
      Cr[2 * h + 1] = t.y;
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) Xb[a] = kind == 0 ? 0.0 : cr[bo + a];
    vb = cr[78] != 0.0;
  };
  if (max_m - 2 >= s0) {
    wait_row(n_fwd);
    load_bwd(n_fwd);
  }
  for (int R = max_m - 2; R >= s0; --R) {
    const int q = n_fwd + (max_m - 2 - R);
    // ---- bwd: F, G, g ----
    double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int qq = 0; qq < 6; ++qq)   // acc[a] += C_R[a][qq] y[qq]
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[a] += Cr[6 * qq + a] * y[qq];
    double x[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) x[a] = vb ? Xb[a] - acc[a] : 0.0;
    // ---- bwd: the next row's inputs ----
    if (R - 1 >= s0) {
      wait_row(q + 1);
      load_bwd(q + 1);
    }
    // ---- bwd: stores ----
#pragma unroll
    for (int a = 0; a < 6; ++a) y[a] = x[a];
    store_row(R);
    if ((q & (EL_FREE - 1)) == 0) release(q);
  }
  // ---- Schur blocks of the first row: S_ll, S_lr, r_l ----
  schur(sLl, 0, 1, 0);
}

// ---------------------------------------------------------------------------
// K10c
// ---------------------------------------------------------------------------
//
// One thread-block cluster of RED_CLUSTER CTAs (the cluster makes them
// co-resident and gives the hardware barrier that orders the steps; no
// other CTA runs the solve). The working matrix A, (NR x NR) doubles with
// NR = N + 1 rounded up to 8, lives in global memory (1.5 MB at D = 73, in
// L2; D is not capped): its lower triangle holds (Hs + Hs^T) / 2, row N
// holds bs (so the forward solve rides along as one more row of the
// factorisation and row N ends as y = L^-1 bs), rows past N are zero.
//
//  1. Assembly, over the cluster: every lower entry from the separators'
//     diagonal blocks, the Schur blocks and the adjacent couplings, each
//     entry's terms in the order of the JAX scatter-adds, averaged with its
//     transpose; then (after a cluster barrier) the loop blocks' entries
//     recomputed with every loop's term added in loop order.
//  2. Right-looking blocked Cholesky in panels of PW = 24 columns (four
//     separators). A panel's 24 x 24 diagonal block is factored by warp 0
//     of every CTA alike (a row a lane, in registers, pivots broadcast by
//     shuffles; the column is scaled by the pivot's reciprocal square root,
//     as LAPACK's dpotf2 scales by a reciprocal); a non-positive or NaN
//     pivot gives NaN. The rows below it are
//     spread over the cluster by 8-row tile rows (tile row I belongs to CTA
//     I mod RED_CLUSTER), one thread a row solving x L11^T = a. A cluster
//     barrier publishes the panel; each CTA copies it into shared memory
//     (up to CH tile rows at once) and updates its own tile rows' part of
//     the trailing lower triangle, A[I][J] -= P_I P_J^T, on the fp64 tensor
//     cores (mma.sync m8n8k4 f64: a warp a tile row by 4 tile columns, 6
//     k-steps). Tiles whose panel rows are all exactly zero are skipped (the
//     update would add only zeros; the sums that are made keep their
//     order). A second barrier ends the step.
//  3. The backward solve L^T x = y by CTA 0 alone, panel by panel from the
//     last: warp 0 solves the 24 x 24 triangle with shuffles, the other
//     warps update y for the columns before the panel.
//
// Every sum has a fixed order and no double is added atomically, so two
// calls give bit-equal results.

constexpr int RED_CLUSTER = 8;                 // CTAs of the cluster (portable size)
constexpr int RED_THREADS = 512;
constexpr int RED_WARPS = RED_THREADS / 32;
constexpr int PW = 24;                         // panel width
constexpr int RS = 28;                         // doubles a panel row in shared memory
constexpr int CH = 64;                         // panel tile rows in shared memory at once
constexpr int RED_SMEM = (CH * 8 * RS + PW * PW + PW) * 8 + CH * 4;
constexpr unsigned FULL = 0xffffffffu;

// H[row][col] of the assembled separator system before the loop blocks
// (the JAX scatter-adds' order within each entry).
__device__ __forceinline__ double h_base(const double* __restrict__ diag,
                                         const double* __restrict__ off,
                                         const double* __restrict__ S,
                                         const int* __restrict__ seps,
                                         const int* __restrict__ adj_mask,
                                         const int* __restrict__ adj_off, int D, int row,
                                         int col) {
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
  return v;
}

// The entry (row, col) and its transpose with the loop blocks added: every
// loop (a, b) adds its block at (a, b) in loop order, then every loop its
// transpose at (b, a). hr and hc hold the two entries without them.
__device__ __forceinline__ void h_loops(double& hr, double& hc, const double* __restrict__ lb,
                                        const int* __restrict__ loop_a,
                                        const int* __restrict__ loop_b,
                                        const int* __restrict__ loop_valid, int L, int row,
                                        int col) {
  const int I = row / 6, i = row % 6, J = col / 6, j = col % 6;
  for (int l = 0; l < L; ++l) {   // the first pass: blocks at (a, b)
    if (!loop_valid[l]) continue;
    if (loop_a[l] == I && loop_b[l] == J) hr += lb[36 * (size_t)l + 6 * i + j];
    if (loop_a[l] == J && loop_b[l] == I) hc += lb[36 * (size_t)l + 6 * j + i];
  }
  for (int l = 0; l < L; ++l) {   // the second pass: transposes at (b, a)
    if (!loop_valid[l]) continue;
    if (loop_b[l] == I && loop_a[l] == J) hr += lb[36 * (size_t)l + 6 * j + i];
    if (loop_b[l] == J && loop_a[l] == I) hc += lb[36 * (size_t)l + 6 * i + j];
  }
}

// D += A B on the fp64 tensor cores: A 8x4 row-major (a = A[g][t]), B 4x8
// column-major (b = B[t][g]), D 8x8 (d0, d1 = D[g][2t], D[g][2t+1]), with
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(RED_THREADS, 1)
reduced_kernel(const double* __restrict__ diag, const double* __restrict__ off,
               const double* __restrict__ b, const double* __restrict__ lb,
               const double* __restrict__ S, const double* __restrict__ r,
               const int* __restrict__ seps, const int* __restrict__ adj_mask,
               const int* __restrict__ adj_off, const int* __restrict__ loop_a,
               const int* __restrict__ loop_b, const int* __restrict__ loop_valid, int D, int L,
               const double* __restrict__ st, double* __restrict__ A, double* __restrict__ xs) {
  if (st[3] == 0.0) return;   // every CTA alike, so no barrier is left waiting
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, ln = tid & 31, wid = tid >> 5;
  const int N = 6 * D, NA = N + 1, NR = (NA + 7) & ~7, NT = NR / 8;
  const int P = (N + PW - 1) / PW;
  extern __shared__ double4 smem_raw[];
  double* chunk = reinterpret_cast<double*>(smem_raw);   // CH * 8 rows x RS
  double* L11t = chunk + CH * 8 * RS;                    // PW x PW, L11 transposed
  double* rinv = L11t + PW * PW;                         // PW
  int* nz = reinterpret_cast<int*>(rinv + PW);           // CH

  // ---- 1. assembly: a warp a row, its lower part ----
  const int gw = rank * RED_WARPS + wid, nw = RED_CLUSTER * RED_WARPS;
  for (int row = gw; row < NR; row += nw) {
    const int band = 6 * (row / 6 - 1);   // the first column of the blocks next to row's
    for (int col = ln; col <= row; col += 32) {
      double v = 0.0;
      if (row < N) {
        if (col >= band) {
          v = h_base(diag, off, S, seps, adj_mask, adj_off, D, row, col);
          if (col < row) v = (v + h_base(diag, off, S, seps, adj_mask, adj_off, D, col, row)) * 0.5;
        }
      } else if (row == N && col < N) {
        const int I = col / 6, i = col % 6;
        v = b[6 * (size_t)seps[I] + i] + r[12 * (size_t)I + 6 + i];
        if (I + 1 < D) v += r[12 * (size_t)(I + 1) + i];                 // r_l of I+1
      }
      __stcg(A + (size_t)row * NR + col, v);
    }
  }
  cluster.sync();
  const int gt = rank * RED_THREADS + tid, gn = RED_CLUSTER * RED_THREADS;
  for (int e = gt; e < 36 * L; e += gn) {   // loop blocks, each once
    const int l = e / 36, i = (e % 36) / 6, j = e % 6;
    if (!loop_valid[l]) continue;
    const int la = loop_a[l], lbb = loop_b[l];
    bool seen = false;
    for (int q = 0; q < l; ++q)
      seen |= loop_valid[q] && ((loop_a[q] == la && loop_b[q] == lbb) ||
                                (loop_a[q] == lbb && loop_b[q] == la));
    if (seen) continue;
    const int row = 6 * max(la, lbb) + i, col = 6 * min(la, lbb) + j;
    if (col > row) continue;
    double hr = h_base(diag, off, S, seps, adj_mask, adj_off, D, row, col);
    double hc = h_base(diag, off, S, seps, adj_mask, adj_off, D, col, row);
    h_loops(hr, hc, lb, loop_a, loop_b, loop_valid, L, row, col);
    __stcg(A + (size_t)row * NR + col, col < row ? (hr + hc) * 0.5 : hr);
  }
  cluster.sync();

  // ---- 2. blocked Cholesky, y = L^-1 bs in row N ----
  for (int p = 0; p < P; ++p) {
    const int c0 = p * PW, w = min(PW, N - c0), c1 = c0 + w;
    if (wid == 0) {   // the diagonal block, a row a lane
      double a[PW];
#pragma unroll
      for (int j = 0; j < PW; ++j)
        a[j] = ln < w && j <= ln ? __ldcg(A + (size_t)(c0 + ln) * NR + c0 + j) : 0.0;
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        if (j < w) {
          const double piv = __shfl_sync(FULL, a[j], j);
          const double ri = piv > 0.0 ? rsqrt(piv) : NAN;
          const double l = ln == j ? piv * ri : a[j] * ri;
          if (ln >= j) a[j] = l;
#pragma unroll
          for (int k = j + 1; k < PW; ++k) {
            const double lk = __shfl_sync(FULL, l, k);
            if (k < w && ln >= k) a[k] -= l * lk;
          }
          if (ln == 0) rinv[j] = ri;
        }
      }
#pragma unroll
      for (int j = 0; j < PW; ++j)
        if (ln < w && j <= ln) L11t[j * PW + ln] = a[j];
    }
    __syncthreads();
    // the panel below: this CTA's rows in [c1, NA), x = a L11^-T a row a thread
    const int tr = c1 / 8;
    const int I0 = tr + ((rank - tr % RED_CLUSTER) % RED_CLUSTER + RED_CLUSTER) % RED_CLUSTER;
    for (int q = tid;; q += RED_THREADS) {
      const int row = 8 * (I0 + RED_CLUSTER * (q / 8)) + q % 8;
      if (row >= NA) break;
      if (row < c1) continue;
      double* arow = A + (size_t)row * NR + c0;
      double x[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c) x[c] = c < w ? __ldcg(arow + c) : 0.0;
#pragma unroll
      for (int c = 0; c < PW; ++c)
        if (c < w) {
          x[c] *= rinv[c];
#pragma unroll
          for (int k = c + 1; k < PW; ++k)
            if (k < w) x[k] -= x[c] * L11t[c * PW + k];
        }
#pragma unroll
      for (int c = 0; c < PW; ++c)
        if (c < w) __stcg(arow + c, x[c]);
    }
    cluster.sync();
    // L11 into A once every CTA has read the block (CTA 0's copy, for step 3)
    if (rank == 0 && tid < w)
      for (int j = 0; j <= tid; ++j) __stcg(A + (size_t)(c0 + tid) * NR + c0 + j, L11t[j * PW + tid]);
    if (p + 1 == P) break;
    // the trailing update of this CTA's tile rows, P_J from shared memory
    const int g = ln >> 2, t = ln & 3;
    for (int J0 = tr; J0 < NT; J0 += CH) {
      const int J1 = min(NT, J0 + CH);
      if (tid < CH) nz[tid] = 0;
      __syncthreads();
      for (int e = tid; e < 8 * (J1 - J0) * (PW / 2); e += RED_THREADS) {
        const int rr = e / (PW / 2), cc = 2 * (e % (PW / 2));
        const double2 v = __ldcg(reinterpret_cast<const double2*>(
            A + (size_t)(8 * J0 + rr) * NR + c0 + cc));
        *reinterpret_cast<double2*>(chunk + rr * RS + cc) = v;
        if (v.x != 0.0 || v.y != 0.0) nz[rr / 8] = 1;
      }
      __syncthreads();
      // tasks: (tile row I of this CTA, I >= J0) x (4 tile columns J in [J0, min(I + 1, J1)))
      const int Ia = J0 + ((rank - J0 % RED_CLUSTER) % RED_CLUSTER + RED_CLUSTER) % RED_CLUSTER;
      int task = wid, before = 0;
      for (int I = Ia; I < NT; I += RED_CLUSTER) {
        const bool in_chunk = I < J1;
        const int nj = min(I + 1, J1) - J0;
        const int ng = (!in_chunk || nz[I - J0]) ? (nj + 3) / 4 : 0;
        for (; task < before + ng; task += RED_WARPS) {
          const int jb = J0 + 4 * (task - before);
          double av[PW / 4];   // -P_I[g][4kk + t]
          if (in_chunk) {
            const double* ar = chunk + ((I - J0) * 8 + g) * RS + t;
#pragma unroll
            for (int kk = 0; kk < PW / 4; ++kk) av[kk] = -ar[4 * kk];
          } else {
            const double* ar = A + (size_t)(8 * I + g) * NR + c0 + t;
#pragma unroll
            for (int kk = 0; kk < PW / 4; ++kk) av[kk] = -__ldcg(ar + 4 * kk);
          }
          double2 cv[4];
          bool on[4];
          double* crow = A + (size_t)(8 * I + g) * NR + 2 * t;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            on[jj] = jb + jj - J0 < nj && nz[jb + jj - J0];
            if (on[jj]) cv[jj] = __ldcg(reinterpret_cast<const double2*>(crow + 8 * (jb + jj)));
          }
#pragma unroll
          for (int kk = 0; kk < PW / 4; ++kk)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (on[jj])
                dmma(cv[jj].x, cv[jj].y, av[kk],
                     chunk[((jb + jj - J0) * 8 + g) * RS + 4 * kk + t]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (on[jj]) __stcg(reinterpret_cast<double2*>(crow + 8 * (jb + jj)), cv[jj]);
        }
        before += ng;
      }
      __syncthreads();
    }
    cluster.sync();
  }
  if (rank != 0) return;

  // ---- 3. L^T x = y, panel by panel from the last; y updated in row N ----
  double* y = A + (size_t)N * NR;
  double* xp = chunk;   // the panel's x
  for (int p = P - 1; p >= 0; --p) {
    const int c0 = p * PW, w = min(PW, N - c0);
    // warps 1..: the first of their columns before the panel, loaded before x is known
    const int c = tid - 32;
    const bool mine = c >= 0 && c < c0;
    double lv[PW], yc = 0.0;
    if (mine) {
#pragma unroll
      for (int q = 0; q < PW; ++q) lv[q] = q < w ? __ldcg(A + (size_t)(c0 + q) * NR + c) : 0.0;
      yc = __ldcg(y + c);
    }
    if (wid == 0) {
      double lc[PW];   // lane i: L[c0 + j][c0 + i] for j > i
#pragma unroll
      for (int j = 0; j < PW; ++j)
        lc[j] = ln < w && j > ln && j < w ? __ldcg(A + (size_t)(c0 + j) * NR + c0 + ln) : 0.0;
      const double ri = ln < w ? 1.0 / __ldcg(A + (size_t)(c0 + ln) * NR + c0 + ln) : 0.0;
      double yi = ln < w ? __ldcg(y + c0 + ln) : 0.0, xi = 0.0;
#pragma unroll
      for (int j = PW - 1; j >= 0; --j)
        if (j < w) {
          const double xj = __shfl_sync(FULL, yi * ri, j);
          if (ln == j) xi = xj;
          if (ln < j) yi -= lc[j] * xj;
        }
      if (ln < w) {
        xp[ln] = xi;
        xs[c0 + ln] = xi;
      }
    }
    __syncthreads();
    if (mine) {
      double acc = 0.0;
#pragma unroll
      for (int q = 0; q < PW; ++q)
        if (q < w) acc += lv[q] * xp[q];
      __stcg(y + c, yc - acc);
    }
    for (int cc = c + RED_THREADS - 32; c >= 0 && cc < c0; cc += RED_THREADS - 32) {
      double acc = 0.0;
      for (int q = 0; q < w; ++q) acc += __ldcg(A + (size_t)(c0 + q) * NR + cc) * xp[q];
      __stcg(y + cc, __ldcg(y + cc) - acc);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K10d
// ---------------------------------------------------------------------------

// The back-substituted update of one pose, real_mask applied: xs at a
// separator (code < 0), else g - F x_left - G x_right of its interior
// row, in the JAX einsums' order. A thread reads its own rows as 16-byte
// vectors (their starts are 16-byte aligned: 288 and 48 bytes a row).
// Staging a warp's rows through shared memory with coalesced cp.async
// copies instead was slower at the PGO path's shape (7.7 us against 4.0
// for this phase, H100 80GB HBM3 at 700 W), so each thread loads its own.
__device__ __forceinline__ void backsub_dx(const double* __restrict__ xs,
                                           const double* __restrict__ F,
                                           const double* __restrict__ G,
                                           const double* __restrict__ g,
                                           const int* __restrict__ has_left,
                                           const int* __restrict__ xl_idx, int code, int max_m,
                                           double m, double x[6]) {
  if (code < 0) {
    const double2* xr = reinterpret_cast<const double2*>(xs + 6 * (size_t)(-code - 1));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double2 v = __ldg(xr + a);
      x[2 * a] = v.x * m;
      x[2 * a + 1] = v.y * m;
    }
    return;
  }
  const int k = code / max_m;
  const double2* Fr = reinterpret_cast<const double2*>(F + 36 * (size_t)code);
  const double2* Gr = reinterpret_cast<const double2*>(G + 36 * (size_t)code);
  const double2* gr = reinterpret_cast<const double2*>(g + 6 * (size_t)code);
  const double2* xr = reinterpret_cast<const double2*>(xs + 6 * (size_t)k);
  const bool left = __ldg(has_left + k) != 0;
  const double* xlr = xs + 6 * (size_t)__ldg(xl_idx + k);
  double xv[6], xl[6], gv[6];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const double2 a = __ldg(xr + q), b = __ldg(gr + q);
    xv[2 * q] = a.x;
    xv[2 * q + 1] = a.y;
    gv[2 * q] = b.x;
    gv[2 * q + 1] = b.y;
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) xl[q] = left ? __ldg(xlr + q) : 0.0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    double f[6], h[6];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const double2 u = __ldg(Fr + 3 * a + q), v = __ldg(Gr + 3 * a + q);
      f[2 * q] = u.x;
      f[2 * q + 1] = u.y;
      h[2 * q] = v.x;
      h[2 * q + 1] = v.y;
    }
    double fx = 0.0, gx = 0.0;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      fx += f[q] * xl[q];
      gx += h[q] * xv[q];
    }
    x[a] = ((gv[a] - fx) - gx) * m;
  }
}

// One cluster; thread tid of CTA rank takes the poses p0 = rank * 256 + tid,
// p0 + stride, ... (stride = the cluster's threads). The sums run in a
// fixed order (a thread's entries, warp shuffles down, the 8 warps in
// order, the 256-pose blocks in order, each from 0.0), so two calls give
// the same bits, and at one pose a thread so does a grid of 256-thread
// blocks summing the same way; a CTA past the poses adds 0.0, which
// changes no sum's bits. The first pose's retraction is
// computed while the cluster barrier completes and stored once every CTA
// has agreed that dx is finite.
__global__ void __launch_bounds__(BACKSUB_THREADS, 1)
backsub_kernel(const double* __restrict__ xs, const double* __restrict__ F,
               const double* __restrict__ G, const double* __restrict__ g,
               const int* __restrict__ has_left, const int* __restrict__ xl_idx,
               const int* __restrict__ pose_row, const double* __restrict__ real_mask, int n_pad,
               int max_m, int max_iters, double tol, double* __restrict__ st,
               double* __restrict__ poses) {
  namespace cg = cooperative_groups;
  __shared__ double part[2];                        // this CTA's sums, read by every CTA
  __shared__ double red[2][BACKSUB_THREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  // every CTA reads st[3] before the barrier that rank 0 writes it after,
  // so all leave here together or none does
  if (st[3] == 0.0) return;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank(), nct = (int)cluster.num_blocks();
  const bool writer = rank == 0 && tid == 0;        // writes the loop state
  const double it = writer ? st[0] + 1.0 : 0.0;     // read now, not after the barrier
  const int stride = nct * BACKSUB_THREADS;
  const int p0 = rank * BACKSUB_THREADS + tid;
  // ---- dx: the thread's poses, the first kept in registers
  double x0[6];
  double ss = 0.0, bad = 0.0;
  if (p0 < n_pad) {
    backsub_dx(xs, F, G, g, has_left, xl_idx, __ldg(pose_row + p0), max_m,
               __ldg(real_mask + p0), x0);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      ss += x0[a] * x0[a];
      bad += isfinite(x0[a]) ? 0.0 : 1.0;
    }
  }
  for (int p = p0 + stride; p < n_pad; p += stride) {
    double x[6];
    backsub_dx(xs, F, G, g, has_left, xl_idx, __ldg(pose_row + p), max_m,
               __ldg(real_mask + p), x);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      ss += x[a] * x[a];
      bad += isfinite(x[a]) ? 0.0 : 1.0;
    }
  }
  // ---- sums: warp shuffles, the CTA's warps in order (the first pose on its way)
  double T[16];
  if (p0 < n_pad) {
    const double2* tp = reinterpret_cast<const double2*>(poses + 16 * (size_t)p0);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const double2 v = tp[q];
      T[2 * q] = v.x;
      T[2 * q + 1] = v.y;
    }
  }
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
    part[0] = s0;
    part[1] = s1;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  // ---- retract: the first pose's, while the barrier completes
  if (p0 < n_pad) retract(T, x0);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  // ---- cluster: every CTA's sums, in rank order, in every warp
  double a = 0.0, b = 0.0;
  if ((tid & 31) < nct) {
    const double* rp = cluster.map_shared_rank(part, tid & 31);
    a = rp[0];
    b = rp[1];
  }
  double s0 = 0.0, s1 = 0.0;
  for (int r = 0; r < nct; ++r) {
    s0 += __shfl_sync(0xffffffffu, a, r);
    s1 += __shfl_sync(0xffffffffu, b, r);
  }
  // done with the other CTAs' shared memory; the wait before the exit
  // keeps this CTA's until every CTA has read it
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  const double dxn = sqrt(s0);
  const bool ok = s1 == 0.0;
  if (writer) {
    st[0] = it;
    st[1] = dxn;
    st[2] = ok ? 1.0 : 0.0;
    st[3] = (it < (double)max_iters && dxn >= tol && ok) ? 1.0 : 0.0;
  }
  // ---- store: the poses where every dx is finite
  if (ok) {
    if (p0 < n_pad) {
      double2* tp = reinterpret_cast<double2*>(poses + 16 * (size_t)p0);
#pragma unroll
      for (int q = 0; q < 8; ++q) tp[q] = make_double2(T[2 * q], T[2 * q + 1]);
    }
    for (int p = p0 + stride; p < n_pad; p += stride) {
      double x[6];
      backsub_dx(xs, F, G, g, has_left, xl_idx, __ldg(pose_row + p), max_m,
                 __ldg(real_mask + p), x);
      retract(poses + 16 * (size_t)p, x);
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// K10d's launch: one cluster of BACKSUB_CLUSTER CTAs.
void backsub_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cfg = {};
  cfg.gridDim = dim3(BACKSUB_CLUSTER, 1, 1);
  cfg.blockDim = dim3(BACKSUB_THREADS, 1, 1);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = BACKSUB_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Sets the non-portable cluster size K10d needs and checks with
// cudaOccupancyMaxActiveClusters that one cluster of BACKSUB_CLUSTER CTAs
// fits: an error where the card refuses it.
cudaError_t backsub_check(const cudaLaunchConfig_t& cfg) {
  cudaError_t e =
      cudaFuncSetAttribute(backsub_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  int fit = 0;
  e = cudaOccupancyMaxActiveClusters(&fit, backsub_kernel, &cfg);
  if (e != cudaSuccess) return e;
  return fit >= 1 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

inline int nblocks(int n, int t) { return (n + t - 1) / t; }

}  // namespace

LO_EXPORT int lo_pgo_linearize(const double* poses, int n_pad, const double* pad_reg,
                               const double* prior_meas, const double* prior_sqrtI, int P,
                               const int* bt_from, const int* bt_to, const double* bt_meas,
                               const double* bt_sqrtI, int M, const int* loop_bt,
                               const int* loop_valid, int L, const int* inc_ptr,
                               const int* inc_ent, const int* chain_ptr, const int* chain_ent,
                               const double* st, double* diag, double* off, double* b,
                               double* lb, void* stream) {
  linearize_kernel<<<max(1, nblocks(n_pad + L, LIN_POSES)), LIN_WARPS * 32, 0,
                     (cudaStream_t)stream>>>(
      poses, n_pad, pad_reg, prior_meas, prior_sqrtI, P, bt_from, bt_to, bt_meas, bt_sqrtI, M,
      loop_bt, loop_valid, L, inc_ptr, inc_ent, chain_ptr, chain_ent, st, diag, off, b, lb);
  return (int)cudaGetLastError();
}

// scratch: (D, max_m, 80) doubles, the forward chain's C, E, d (a column
// at a time) and valid flag of each row for the backward chain.
LO_EXPORT int lo_pgo_eliminate(const double* diag, const double* off, const double* b,
                               const int* int_idx, const int* valid, const int* off_idx,
                               const int* ovalid, const int* has_left, const int* left_off,
                               const int* lsep_row, const int* uright_off, const int* ur_valid,
                               int D, int max_m, int m_off, const double* st, double* scratch,
                               double* F, double* G, double* g, double* S, double* r,
                               void* stream) {
  eliminate_kernel<<<D, 64, 0, (cudaStream_t)stream>>>(
      diag, off, b, int_idx, valid, off_idx, ovalid, has_left, left_off, lsep_row, uright_off,
      ur_valid, max_m, m_off, st, scratch, F, G, g, S, r);
  return (int)cudaGetLastError();
}

// A: (NR, NR) doubles of scratch, NR = 6 D + 1 rounded up to 8. One
// cluster of RED_CLUSTER CTAs, launched with its cluster dimension.
LO_EXPORT int lo_pgo_reduced_solve(const double* diag, const double* off, const double* b,
                                   const double* lb, const double* S, const double* r,
                                   const int* seps, const int* adj_mask, const int* adj_off,
                                   const int* loop_a, const int* loop_b, const int* loop_valid,
                                   int D, int L, const double* st, double* A, double* xs,
                                   void* stream) {
  cudaError_t e = cudaFuncSetAttribute(reduced_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       RED_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RED_CLUSTER, 1, 1);
  cfg.blockDim = dim3(RED_THREADS, 1, 1);
  cfg.dynamicSmemBytes = RED_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RED_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, reduced_kernel, diag, off, b, lb, S, r, seps, adj_mask, adj_off,
                         loop_a, loop_b, loop_valid, D, L, st, A, xs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K10c's launch shape: cluster CTAs, panel width, threads a CTA, dynamic
// shared memory a CTA (bytes).
LO_EXPORT void lo_pgo_reduced_solve_shape(int* out) {
  out[0] = RED_CLUSTER;
  out[1] = PW;
  out[2] = RED_THREADS;
  out[3] = RED_SMEM;
}

// K10d's launch shape as backsub_config builds it: cluster CTAs, threads a
// CTA, CTAs a launch.
LO_EXPORT void lo_pgo_backsub_retract_shape(int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  backsub_config(cfg, attr);
  out[0] = (int)attr.val.clusterDim.x;
  out[1] = (int)cfg.blockDim.x;
  out[2] = (int)cfg.gridDim.x;
}

LO_EXPORT int lo_pgo_backsub_retract(const double* xs, const double* F, const double* G,
                                     const double* g, const int* has_left, const int* xl_idx,
                                     const int* pose_row, const double* real_mask, int n_pad,
                                     int max_m, int max_iters, double tol, double* st,
                                     double* poses, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  backsub_config(cfg, attr);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t e = backsub_check(cfg);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, backsub_kernel, xs, F, G, g, has_left, xl_idx, pose_row,
                         real_mask, n_pad, max_m, max_iters, tol, st, poses);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
