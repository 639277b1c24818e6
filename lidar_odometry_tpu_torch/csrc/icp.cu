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
//    per point (~1.3 MFLOP, ~0.02 us at 67 TFLOP/s fp32): launch-bound.
//    Design: a grid-stride loop accumulates the 27 sums per thread, warp
//    shuffles and shared memory reduce them per block, and the last block
//    to finish (a threadfence + a ticket counter the wrapper zeroes) adds
//    the block partials in block order, so the result is deterministic;
//    its thread 0 then (gn.cuh, shared with the sharded ICP's K11d) solves
//    the 6x6 system by Gaussian elimination with partial pivoting, retracts
//    T <- T * (Exp(dw), dt) and updates done / failed / n_corr. The whole
//    iteration tail stays in one launch with no host read.
//  * Lanes: B independent solves against one shared map (the blocked
//    multi-sequence runner, JAX icp_optimize under vmap) run in one launch
//    of each kernel, lane b on blockIdx.y = b with its own points, pose,
//    flags, scale and alpha index. icp_normal_eq gives each lane its own
//    partials region and its own ticket counter (the wrapper zeroes the
//    counters on the launch's stream), so the last block of lane b sums
//    only lane b's partials. A lane's grid-stride partition and
//    block-order sum depend on n alone, never on B, so lane b of a B-lane
//    launch is bit-identical to a one-lane launch on lane b's inputs. A lane whose solve is done
//    returns at once while the others iterate (the vmapped while_loop's
//    frozen lanes). The single-stream and loop solves are B = 1.
//    An optional weight residual `rw` sets the robust weights in place of
//    |r|: the loop-closure ICP (ops/icp.py:258 icp_optimize_loop) weights
//    each point by its centroid-plane distance while its residual is taken
//    against the nearest neighbour. Without it (nullptr) the arithmetic is
//    the odometry path's, unchanged.
#include "gn.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NSUM = 27;   // 21 upper-triangle entries of H, then g

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
normal_eq_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                 const float* __restrict__ resid, const float* __restrict__ rw,
                 const bool* __restrict__ valid, int n,
                 const float* __restrict__ T, const float* __restrict__ scale,
                 const int* __restrict__ flags, const int* __restrict__ aux,
                 const float* __restrict__ alphas, int use_pko, float fixed_delta, int robust,
                 int cauchy, int min_corr, float tol_t, float tol_r,
                 float* __restrict__ partials, unsigned int* __restrict__ counter,
                 float* __restrict__ T_out, int* __restrict__ flags_out, float* __restrict__ hg) {
  __shared__ float red[NSUM][THREADS / 32];
  __shared__ float sums[NSUM];
  __shared__ bool last;
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
  partials += lane_ix * gridDim.x * NSUM;
  counter += lane_ix;
  T_out += 16 * lane_ix;
  flags_out += 3 * lane_ix;
  hg += NSUM * lane_ix;
  const int tid = threadIdx.x;
  if (flags[0]) {  // done: pass the state through
    if (blockIdx.x == 0 && tid < 16) T_out[tid] = T[tid];
    if (blockIdx.x == 0 && tid < 3) flags_out[tid] = flags[tid];
    return;
  }
  float R[3][3], t[3];
  lo::load_T(T, R, t);
  const float delta = use_pko ? alphas[aux[1]] : fixed_delta;
  const float denom = fmaxf(scale[0], 1e-6f);

  float acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.f;
  for (int i = blockIdx.x * blockDim.x + tid; i < n; i += gridDim.x * blockDim.x) {
    if (!valid[i]) continue;
    const float r = resid[i];
    const float rn = fabsf(rw != nullptr ? rw[i] : r) / denom;
    float w = 1.0f;
    if (robust) {
      if (cauchy) {
        const float q = rn / delta;
        w = 1.0f / (1.0f + q * q);
      } else {
        w = rn > delta ? delta / fmaxf(rn, 1e-30f) : 1.0f;
      }
    }
    const float n0 = nrm[3 * i], n1 = nrm[3 * i + 1], n2 = nrm[3 * i + 2];
    const float p0 = pts[3 * i], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
    float J[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) J[j] = n0 * R[0][j] + n1 * R[1][j] + n2 * R[2][j];
    J[3] = p1 * J[2] - p2 * J[1];
    J[4] = p2 * J[0] - p0 * J[2];
    J[5] = p0 * J[1] - p1 * J[0];
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += J[a] * (J[b] * w);
    const float wr = w * r;
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += J[a] * wr;
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (tid < NSUM) {
    float s = 0.f;
    for (int wi = 0; wi < THREADS / 32; ++wi) s += red[tid][wi];
    partials[blockIdx.x * NSUM + tid] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // ---- last block: sum the partials in block order, solve, retract ----
  if (tid < NSUM) {
    float s = 0.f;
    for (int b = 0; b < gridDim.x; ++b) s += __ldcg(partials + b * NSUM + tid);
    sums[tid] = s;
    hg[tid] = s;
  }
  __syncthreads();
  if (tid != 0) return;
  float x[6];
  lo::solve6(sums, x);
  float Tn[16];
  const bool conv = lo::gn_retract(T, x, tol_t, tol_r, Tn);
  const int count = aux[0];
  const bool insufficient = count < min_corr;
  const bool step = !insufficient;   // not done here
  for (int k = 0; k < 16; ++k) T_out[k] = step ? Tn[k] : T[k];
  flags_out[0] = insufficient || (step && conv);
  flags_out[1] = flags[1] || insufficient;
  flags_out[2] = step ? count : flags[2];
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
                               const float* T,
                               const float* scale,
                               const int* flags, const int* aux, const float* alphas,
                               int use_pko, float fixed_delta, int robust, int cauchy,
                               int min_corr, float tol_t, float tol_r, float* partials,
                               unsigned int* counter, float* T_out, int* flags_out, float* hg,
                               void* stream) {
  const dim3 grid(max(1, min(128, blocks(n))), lanes);
  normal_eq_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      pts, nrm, resid, rw, valid, n, T, scale, flags, aux, alphas, use_pko, fixed_delta, robust,
      cauchy, min_corr, tol_t, tol_r, partials, counter, T_out, flags_out, hg);
  return (int)cudaGetLastError();
}
