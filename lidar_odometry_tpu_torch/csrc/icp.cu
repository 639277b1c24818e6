// K2 icp_iteration: one Gauss-Newton iteration of surfel-mode ICP, as two
// launches (PKO's alpha, kernel K3, sits between them: it needs every
// normalised residual before any weight exists).
//
// Replaces: the JAX package's ops/icp.py:196 icp_optimize's loop body —
// _surfel_correspondences (:121, with ops/voxel_map.py:815 lookup_surfels,
// _bucket_find :169 and _hash_bucket :119), _robust_weights (:71) and
// _gn_step (:91): the normal equations, the 6x6 solve and the retract.
//
// Bounds on the H100 at N = 14336 features, c1 = 65536:
//  * icp_correspond touches N x (12 + 1 + 128 + 32) B of input (points,
//    mask, one 128-B bucket row, one 32-B surfel row) and writes N x 17 B:
//    ~2.7 MB, ~0.8 us at 3.35 TB/s. Its dependent random reads per point
//    make it latency-bound at this size; in practice launch-bound. Design:
//    one thread per point, T from the device (no host read), no shared
//    memory; 56 blocks of 256 threads keep every probe in flight at once.
//    A thread's chain is three dependent rounds: the done flag, T (three
//    16-byte loads) and the point, issued together; the bucket row as six
//    16-byte loads (common.cuh's probe, the last matching cell winning);
//    the 32-byte surfel row.
//    Instances: one launch computes every (lane, shard) instance of an
//    ICP iteration on blockIdx.y. Instance g has its own points, mask and
//    outputs, takes lane g / per_lane's T and flags, and reads the map
//    tables at lane x a lane stride + shard x a shard stride (shard = g
//    mod per_lane): a rank's shards are equal row ranges of its tables
//    (parallel/sharded_map.py local_view), the data x map step's lanes
//    hold a map each, and the blocked runner's lanes share one map (lane
//    strides 0, per_lane 1).
//    A point's arithmetic does not depend on the instance, so each
//    instance is bit-equal to a launch of its own.
//  * icp_normal_eq reads N x 33 B (~0.5 MB, ~0.14 us) and does ~90 flops
//    per point (~1.3 MFLOP, ~0.02 us at 67 TFLOP/s fp32): launch- and
//    latency-bound. Design: one thread-block cluster of NE_CLUSTER = 8
//    CTAs a lane (the portable size; its CTAs co-resident on one GPC,
//    their shared memory one address space). A thread takes the points
//    rank * NE_THREADS + tid + k * 8 * NE_THREADS, NE_UNROLL of them at a
//    time; the lane's state (flags, T, scale, count, alpha index) and the
//    first NE_UNROLL points come in one round of loads, before the done
//    test (a load round costs ~1 us on the H100). The thread accumulates
//    the 27 sums (the robust weight from common.cuh's fast_div, IEEE's
//    quotient for normal operands, without the slow-path call); a warp
//    reduce-scatter (31 shuffles) and shared memory reduce them per CTA
//    in warp order; each CTA stores its 27
//    partials into rank 0's shared memory, and after one cluster barrier
//    rank 0 adds them in rank order: a fixed order that depends on n
//    alone, with no global partials, fence or ticket. Its thread 0 then
//    (gn.cuh, shared with the sharded ICP's K11d) solves the 6x6 system by
//    Gaussian elimination with partial pivoting in registers, retracts
//    T <- T * (Exp(dw), dt) and updates done / failed / n_corr. The
//    whole iteration tail stays in one launch with no host read and no
//    scratch memory. The "// ---- " comments mark the kernel's phases for
//    tools/k2b_phase_stamps.py.
//  * Lanes: B independent solves against one shared map (the blocked
//    multi-sequence runner, JAX icp_optimize under vmap) run in one launch
//    of each kernel, lane b on blockIdx.y = b with its own points, pose,
//    flags, scale and alpha index; icp_normal_eq gives each lane a
//    cluster of its own. A lane's partition and rank-order sum depend on
//    n alone, never on B, so lane b of a B-lane launch is bit-identical
//    to a one-lane launch on lane b's inputs. A lane whose solve is done
//    returns at once (every CTA of its cluster alike, so no barrier is
//    left waiting) while the others iterate (the vmapped while_loop's
//    frozen lanes). The single-stream and loop solves are B = 1.
//    An optional weight residual `rw` sets the robust weights in place of
//    |r|: the loop-closure ICP (ops/icp.py:258 icp_optimize_loop) weights
//    each point by its centroid-plane distance while its residual is taken
//    against the nearest neighbour. Without it (nullptr) the arithmetic is
//    the odometry path's, unchanged.
#include <cooperative_groups.h>

#include "gn.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NSUM = 27;   // 21 upper-triangle entries of H, then g
constexpr int NE_CLUSTER = 8;    // CTAs of a lane's cluster (the portable size)
constexpr int NE_THREADS = 512;
constexpr int NE_WARPS = NE_THREADS / 32;
constexpr int NE_UNROLL = 4;     // points a thread loads at once

__global__ void __launch_bounds__(THREADS)
correspond_kernel(const float* __restrict__ pts, const bool* __restrict__ mask, int n,
                  int per_lane, const float* __restrict__ T, const int* __restrict__ flags,
                  const int* __restrict__ index, long long index_lane, long long index_shard,
                  int n_buckets, const float* __restrict__ surfel, long long surfel_lane,
                  long long surfel_shard, int c1, float inv, float max_dist,
                  float* __restrict__ nrm, float* __restrict__ resid, bool* __restrict__ valid) {
  const size_t inst = blockIdx.y, lane_ix = inst / per_lane, shard = inst % per_lane;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T += 16 * lane_ix;
  flags += 3 * lane_ix;
  pts += inst * n * 3;
  mask += inst * n;
  nrm += inst * n * 3;
  resid += inst * n;
  valid += inst * n;
  index += lane_ix * index_lane + shard * index_shard;
  surfel += lane_ix * surfel_lane + shard * surfel_shard;
  // the done flag, T, the point and its mask: independent loads, issued together
  const int done = flags[0];
  float R[3][3], t[3];
  const float4* T4 = reinterpret_cast<const float4*>(T);
  const float4 r0 = T4[0], r1 = T4[1], r2 = T4[2];
  R[0][0] = r0.x; R[0][1] = r0.y; R[0][2] = r0.z; t[0] = r0.w;
  R[1][0] = r1.x; R[1][1] = r1.y; R[1][2] = r1.z; t[1] = r1.w;
  R[2][0] = r2.x; R[2][1] = r2.y; R[2][2] = r2.z; t[2] = r2.w;
  const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  const bool m = mask[i];
  if (done) return;  // a done solve writes nothing
  float w[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) w[r] = R[r][0] * px + R[r][1] * py + R[r][2] * pz + t[r];
  uint32_t hi, lo;
  lo::pack_key((int)floorf(w[0] * inv), (int)floorf(w[1] * inv), (int)floorf(w[2] * inv), hi, lo);
  const int slot = lo::probe(index, (uint32_t)(n_buckets - 1), hi, lo);
  const float* row = surfel + 8 * (size_t)min(max(slot, 0), c1 - 1);
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  // row = [n(3) | centroid(3) | planarity | has]
  const float r = a.x * (w[0] - a.w) + a.y * (w[1] - b.x) + a.z * (w[2] - b.y);
  nrm[3 * i] = a.x;
  nrm[3 * i + 1] = a.y;
  nrm[3 * i + 2] = a.z;
  resid[i] = r;
  valid[i] = slot >= 0 && b.w > 0.5f && m && fabsf(r) <= max_dist;
}

__global__ void __cluster_dims__(NE_CLUSTER, 1, 1) __launch_bounds__(NE_THREADS)
normal_eq_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                 const float* __restrict__ resid, const float* __restrict__ rw,
                 const bool* __restrict__ valid, int n,
                 const float* __restrict__ T, const float* __restrict__ scale,
                 const int* __restrict__ flags, const int* __restrict__ aux,
                 const float* __restrict__ alphas, int use_pko, float fixed_delta, int robust,
                 int cauchy, int min_corr, float tol_t, float tol_r,
                 float* __restrict__ T_out, int* __restrict__ flags_out, float* __restrict__ hg) {
  namespace cg = cooperative_groups;
  __shared__ float red[NSUM][NE_WARPS];
  __shared__ float part[NE_CLUSTER][NSUM];   // rank 0's: every CTA's partial sums
  __shared__ float sums[NSUM];
  const size_t lane_ix = blockIdx.y;
  pts += lane_ix * n * 3;
  nrm += lane_ix * n * 3;
  resid += lane_ix * n;
  if (rw != nullptr) rw += lane_ix * n;
  valid += lane_ix * n;
  T += 16 * lane_ix;
  scale += lane_ix;
  flags += 3 * lane_ix;
  aux += 2 * lane_ix;
  T_out += 16 * lane_ix;
  flags_out += 3 * lane_ix;
  hg += NSUM * lane_ix;
  const int tid = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // the lane's state, one round of independent loads: the flags, T, the
  // scale, the count and the alpha index
  const int done = flags[0], failed = flags[1], n_corr = flags[2];
  float Tin[16], R[3][3];
#pragma unroll
  for (int k = 0; k < 16; ++k) Tin[k] = T[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = Tin[4 * i + j];
  const float denom = fmaxf(scale[0], 1e-6f);
  const int count = aux[0], a_ix = aux[1];
  // and the thread's first NE_UNROLL points, in the same round
  constexpr int stride = NE_CLUSTER * NE_THREADS;
  const int first = rank * NE_THREADS + tid;
  bool v[NE_UNROLL];
  float r[NE_UNROLL], ra[NE_UNROLL], nn[NE_UNROLL][3], pp[NE_UNROLL][3];
  auto load_points = [&](int i0) {
#pragma unroll
    for (int u = 0; u < NE_UNROLL; ++u) {
      const int i = i0 + u * stride;
      v[u] = false;
      if (i < n) {
        v[u] = valid[i];
        r[u] = resid[i];
        ra[u] = rw != nullptr ? rw[i] : r[u];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          nn[u][j] = nrm[3 * i + j];
          pp[u][j] = pts[3 * i + j];
        }
      }
    }
  };
  load_points(first);
  if (done) {  // done: pass the state through (every CTA of the cluster returns)
    if (rank == 0 && tid == 0) {
#pragma unroll
      for (int k = 0; k < 16; ++k) T_out[k] = Tin[k];
      flags_out[0] = done;
      flags_out[1] = failed;
      flags_out[2] = n_corr;
    }
    return;
  }
  // every CTA of the cluster has started before any writes into rank 0's
  // shared memory: arrive now, wait just before the writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const float delta = use_pko ? alphas[a_ix] : fixed_delta;

  // ---- per-point sums
  float acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.f;
  for (int i0 = first; i0 < n; i0 += NE_UNROLL * stride) {
#pragma unroll
    for (int u = 0; u < NE_UNROLL; ++u) {
      if (!v[u]) continue;
      const float rn = lo::fast_div(fabsf(ra[u]), denom);
      float w = 1.0f;
      if (robust) {
        if (cauchy) {
          const float q = lo::fast_div(rn, delta);
          w = lo::fast_div(1.0f, 1.0f + q * q);
        } else {
          w = rn > delta ? lo::fast_div(delta, fmaxf(rn, 1e-30f)) : 1.0f;
        }
      }
      float J[6];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        J[j] = nn[u][0] * R[0][j] + nn[u][1] * R[1][j] + nn[u][2] * R[2][j];
      J[3] = pp[u][1] * J[2] - pp[u][2] * J[1];
      J[4] = pp[u][2] * J[0] - pp[u][0] * J[2];
      J[5] = pp[u][0] * J[1] - pp[u][1] * J[0];
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] += J[a] * (J[b] * w);
      const float wr = w * r[u];
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += J[a] * wr;
    }
    if (i0 + NE_UNROLL * stride < n) load_points(i0 + NE_UNROLL * stride);
  }

  // ---- block reduce: lane k of each warp holds the warp's sum k
  const float mine = lo::warp_reduce_scatter(acc);
  const int warp = tid / 32, wl = tid % 32;
  if (wl < NSUM) red[wl][warp] = mine;
  __syncthreads();

  // ---- cluster reduce: the CTAs' partials into rank 0, added in rank order
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid < NSUM) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < NE_WARPS; ++wi) s += red[tid][wi];
    cluster.map_shared_rank(&part[0][0], 0)[rank * NSUM + tid] = s;
  }
  cluster.sync();
  if (rank != 0) return;
  if (tid < NSUM) {
    float s = part[0][tid];
#pragma unroll
    for (int c = 1; c < NE_CLUSTER; ++c) s += part[c][tid];
    sums[tid] = s;
    hg[tid] = s;
  }
  __syncthreads();
  if (tid != 0) return;

  // ---- solve6
  float x[6];
  lo::solve6(sums, x);

  // ---- gn_retract
  float Tn[16];
  const bool conv = lo::gn_retract(Tin, x, tol_t, tol_r, Tn);

  // ---- outputs
  const bool insufficient = count < min_corr;
  const bool step = !insufficient;   // not done here
#pragma unroll
  for (int k = 0; k < 16; ++k) T_out[k] = step ? Tn[k] : Tin[k];
  flags_out[0] = insufficient || (step && conv);
  flags_out[1] = failed || insufficient;
  flags_out[2] = step ? count : n_corr;
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// One launch over `instances` (lane, shard) instances of n points each;
// instance g = lane * per_lane + shard reads its lane's T and flags and
// the map tables at lane * *_lane + shard * *_shard elements (int32 for
// index, f32 for surfel). T, index and surfel must be 16-byte aligned.
LO_EXPORT int lo_icp_correspond(const float* pts, const bool* mask, int n, int instances,
                                int per_lane, const float* T, const int* flags, const int* index,
                                long long index_lane, long long index_shard, int n_buckets,
                                const float* surfel, long long surfel_lane,
                                long long surfel_shard, int c1, float inv, float max_dist,
                                float* nrm, float* resid, bool* valid, void* stream) {
  const dim3 grid(max(1, blocks(n)), instances);
  correspond_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      pts, mask, n, per_lane, T, flags, index, index_lane, index_shard, n_buckets, surfel,
      surfel_lane, surfel_shard, c1, inv, max_dist, nrm, resid, valid);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_icp_normal_eq(const float* pts, const float* nrm, const float* resid,
                               const float* rw, const bool* valid, int n, int lanes,
                               const float* T, const float* scale, const int* flags,
                               const int* aux, const float* alphas, int use_pko,
                               float fixed_delta, int robust, int cauchy, int min_corr,
                               float tol_t, float tol_r, float* T_out, int* flags_out,
                               float* hg, void* stream) {
  const dim3 grid(NE_CLUSTER, lanes);   // a cluster a lane (__cluster_dims__)
  normal_eq_kernel<<<grid, NE_THREADS, 0, (cudaStream_t)stream>>>(
      pts, nrm, resid, rw, valid, n, T, scale, flags, aux, alphas, use_pko, fixed_delta, robust,
      cauchy, min_corr, tol_t, tol_r, T_out, flags_out, hg);
  return (int)cudaGetLastError();
}

// K2b's launch shape: CTAs a lane's cluster, threads a CTA, points a
// thread loads at once.
LO_EXPORT void lo_icp_normal_eq_shape(int* out) {
  out[0] = NE_CLUSTER;
  out[1] = NE_THREADS;
  out[2] = NE_UNROLL;
}
