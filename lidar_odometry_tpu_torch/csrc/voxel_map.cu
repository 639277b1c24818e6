// K4 map update: the compute-bearing bodies of the keyframe map update.
//
// Replaces: the JAX package's ops/voxel_map.py:349 update_map — its
// radius-eviction scan (evict_stage, :407-415), its per-voxel accumulate
// (segment_sum + the unique row scatter-add, :498-548) and its surfel
// recompute (_block_stats :330 + utils/eigh3.py eigh3 + the planarity
// verdict, :609-621). The set bookkeeping around them (sorts, cumsums,
// claims, unique index writes) stays in torch, as the JAX side used the
// same kind of XLA primitive for it.
//
// Bounds on the H100 (c1 = 65536 parents, p = 14336 points):
//  * map_evict_scan reads all of l0_data, 65536 x 27 x 16 B = 28.3 MB, and
//    writes 64 KB: ~8.5 us at 3.35 TB/s; ~20 flops per row is far below
//    the flop bound. Bytes bound it. Design: one thread per parent walks
//    its 27 contiguous 16-byte rows (float4 loads; neighbouring threads'
//    rows share cache lines through L1), does the divide-free test
//    |sum - cnt*s|^2 > d^2 * cnt^2, and any-reduces in a register, so the
//    per-row verdicts never reach memory. A device flag gates the stage
//    without a host read.
//  * map_scatter_add moves p x (12 + 8 + 2 + 1 + 8 + 8) B in and touches at
//    most p rows of 16 B: ~0.8 MB, ~0.25 us at 3.35 TB/s, so launch latency
//    and its dependent load rounds bound it (~1 us a round). Design: one
//    thread a sorted position, all active, three rounds: (1) its s_idx
//    and, as 4-byte words, the block's firstk and valid_s flags; (2) one
//    gather at s_idx of its point and, at a run leader, of placed, pslot
//    and ch_off, from which the leader computes its target row as the JAX
//    program does (placed ? pslot * 27 + ch_off : the sink); [valid | xyz]
//    goes to shared memory; (3) the leader's read of its target row,
//    issued before the block's barrier. The leader then finds its run's end
//    from the block's firstk bits (a ballot a warp), folds the run's rows
//    out of shared memory left to right, in the order of the JAX
//    segment_sum (invalid rows add zeros, which leaves every sum's bits
//    as they were), reads only the tail of a run that crosses the block's
//    end from global memory, and adds the total to its unique row: no
//    atomics, no second pass. An unplaced leader (the padding rows' run
//    among them) leaves at once; the sink row is never written.
//  * map_surfel_recompute reads 27 x 16 B per live recomputed parent (at
//    most p of them, ~6 MB at the bulk tier) and does ~300 flops each plus
//    one eigh3: bytes bound it, in 432 B blocks at random slots, but at the
//    sizes the update gives it (a few thousand live parents) a launch is a
//    few dependent rounds: the slot, the block, the sums, the eigen-solve.
//    Design: a warp a parent, a lane a child. The warp reads its slot,
//    then the block in one coalesced round (lane k child k); one ballot
//    gives the count and the live mask; each lane divides its own centroid
//    (fast_div, IEEE's quotient); the mean and the 6 covariance entries are
//    butterfly sums over the 32 lanes (lanes 27-31 add zeros), so the plain
//    twin pads to 32 and halves 16, 8, 4, 2, 1 to sum in the same order.
//    Lane 0 runs eigh3 in registers with the fast divisions and square
//    roots (common.cuh) and writes the 8-float surfel row, the
//    verdict and the 27-bit live-child mask that the deletion step uses. A
//    dead row (slot < 0) or a parent without a live child writes the twin's
//    constant row with no eigen-solve. Eight warps a block: R = 14336 is
//    1792 blocks, R = 65536 8192, both many waves over the 132 SMs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SR_WARPS = THREADS / 32;   // K4c's parents a block

__device__ __forceinline__ float d2cnt(float4 v, const float* s) {
  // |sum - cnt * s|^2, rounded as the JAX program rounds it
  const float rx = __fsub_rn(v.y, __fmul_rn(v.x, s[0]));
  const float ry = __fsub_rn(v.z, __fmul_rn(v.x, s[1]));
  const float rz = __fsub_rn(v.w, __fmul_rn(v.x, s[2]));
  return __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz));
}

__global__ void __launch_bounds__(THREADS)
evict_scan_kernel(const float4* __restrict__ l0, int c1, const float* __restrict__ sensors,
                  int n_sensors, float maxd2, const bool* __restrict__ enabled,
                  bool* __restrict__ cand) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= c1) return;
  if (!*enabled) {
    cand[p] = false;
    return;
  }
  bool any = false;
  const float4* rows = l0 + (size_t)p * lo::NCH;
  for (int k = 0; k < lo::NCH; ++k) {
    const float4 v = rows[k];
    if (!(v.x > 0.f)) continue;
    float d2 = d2cnt(v, sensors);
    for (int s = 1; s < n_sensors; ++s) d2 = fminf(d2, d2cnt(v, sensors + 3 * s));
    any |= d2 > __fmul_rn(__fmul_rn(maxd2, v.x), v.x);
  }
  cand[p] = any;
}

// K4b: one thread a sorted position i = blockIdx.x * THREADS + threadIdx.x.
__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(const float* __restrict__ pts, const long long* __restrict__ s_idx,
                   const bool* __restrict__ firstk, const bool* __restrict__ valid_s,
                   const bool* __restrict__ placed, const long long* __restrict__ pslot,
                   const long long* __restrict__ ch_off, int p, long long nrows,
                   float4* __restrict__ l0) {
  __shared__ unsigned flag_w[2][THREADS / 4];   // the block's firstk, valid_s: 4 rows a word
  __shared__ unsigned lead_bits[THREADS / 32];  // the block's firstk, a bit a row
  __shared__ float4 rows[THREADS];              // [valid | xyz] of each row's point
  const int tid = threadIdx.x;
  const int base = blockIdx.x * THREADS;
  const int n = min(THREADS, p - base);
  // ---- rows: the sorted index, and the flags as words
  const long long s = tid < n ? __ldg(s_idx + base + tid) : 0;
  if (tid < THREADS / 2) {
    const int which = tid / (THREADS / 4), q = 4 * (tid % (THREADS / 4));
    const unsigned char* f = reinterpret_cast<const unsigned char*>(which ? valid_s : firstk) + base;
    unsigned w = 0u;
    if (q + 4 <= n && (reinterpret_cast<uintptr_t>(f + q) & 3u) == 0u) {
      w = __ldg(reinterpret_cast<const unsigned*>(f + q));
    } else {
      for (int k = 0; k < 4; ++k)
        if (q + k < n) w |= (unsigned)__ldg(f + q + k) << (8 * k);
    }
    flag_w[which][q / 4] = w;
  }
  __syncthreads();
  const bool lead = tid >= n || reinterpret_cast<const unsigned char*>(flag_w[0])[tid] != 0;
  const bool valid = tid < n && reinterpret_cast<const unsigned char*>(flag_w[1])[tid] != 0;
  // ---- gather: the point, and at a leader the parts of its target
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const float* q = pts + 3 * s;
    v = make_float4(1.0f, __ldg(q), __ldg(q + 1), __ldg(q + 2));
  }
  long long t = -1;
  if (tid < n && lead) {
    const bool pl = __ldg(reinterpret_cast<const unsigned char*>(placed) + s) != 0;
    const long long ps = __ldg(pslot + s), co = __ldg(ch_off + s);
    t = pl ? ps * lo::NCH + co : nrows;
    if (t < 0 || t >= nrows) t = -1;    // the sink: dropped, as mode="drop" drops it
  }
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t >= 0) r = l0[t];                // the target row, read before the barrier
  rows[tid] = v;
  const unsigned bits = __ballot_sync(0xffffffffu, lead);
  if ((tid & 31) == 0) lead_bits[tid >> 5] = bits;
  __syncthreads();
  if (t < 0) return;
  // ---- fold: the run's rows in this block, left to right
  int w = tid >> 5;
  unsigned after = lead_bits[w] & ~((2u << (tid & 31)) - 1u);   // leaders after tid
  while (after == 0u && ++w < THREADS / 32) after = lead_bits[w];
  const int end = after ? 32 * w + __ffs(after) - 1 : THREADS;
  float c = 0.f, x = 0.f, y = 0.f, z = 0.f;
#pragma unroll 4
  for (int j = tid; j < end; ++j) {
    const float4 a = rows[j];
    c = __fadd_rn(c, a.x);
    x = __fadd_rn(x, a.y);
    y = __fadd_rn(y, a.z);
    z = __fadd_rn(z, a.w);
  }
  // ---- tail: a run that crosses the block's end, from global memory
  if (end == THREADS) {
    for (int j = base + THREADS; j < p && !firstk[j]; ++j) {
      if (!valid_s[j]) continue;
      const float* q = pts + 3 * s_idx[j];
      c = __fadd_rn(c, 1.0f);
      x = __fadd_rn(x, q[0]);
      y = __fadd_rn(y, q[1]);
      z = __fadd_rn(z, q[2]);
    }
  }
  // ---- write: one read-modify-write of the unique target row
  r.x = __fadd_rn(r.x, c);
  r.y = __fadd_rn(r.y, x);
  r.z = __fadd_rn(r.z, y);
  r.w = __fadd_rn(r.w, z);
  l0[t] = r;
}

// K4c: a warp a parent (i = blockIdx.x * SR_WARPS + warp), a lane a child.
__global__ void __launch_bounds__(THREADS)
surfel_recompute_kernel(const float4* __restrict__ l0, const long long* __restrict__ r_slot,
                        int r_n, int c1, float thr, float* __restrict__ srow,
                        bool* __restrict__ non_planar, int* __restrict__ kidmask) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * SR_WARPS + threadIdx.x / 32;
  if (i >= r_n) return;                 // the whole warp
  // ---- load: the slot, then the parent's children, a lane each
  const long long s = r_slot[i];
  const bool ok = s >= 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 v = ok && lane < lo::NCH
                       ? l0[(size_t)min(s, (long long)(c1 - 1)) * lo::NCH + lane] : zero;
  const bool live = v.x > 0.f;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  float4* o = reinterpret_cast<float4*>(srow + 8 * (size_t)i);
  if (mask == 0u) {
    // no live child: the twin's row of a zero covariance (eigh3 of 0 gives
    // the normal (0, 0, 1) and planarity 0)
    if (lane == 0) {
      o[0] = make_float4(0.f, 0.f, 1.f, 0.f);
      o[1] = make_float4(0.f, 0.f, 0.f, 1.f);
      non_planar[i] = ok && 0.f > thr;
      kidmask[i] = 0;
    }
    return;
  }
  // ---- sums: the mean of the live centroids, then the covariance
  const float w = live ? 1.f : 0.f;
  const float d = fmaxf(v.x, 1.0f);
  const float cen[3] = {lo::fast_div(v.y, d), lo::fast_div(v.z, d), lo::fast_div(v.w, d)};
  float m[3] = {__fmul_rn(cen[0], w), __fmul_rn(cen[1], w), __fmul_rn(cen[2], w)};
  lo::warp_sums(m);
  const float denom = (float)__popc(mask);
  float mean[3], e[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mean[a] = lo::fast_div(m[a], denom);
    e[a] = __fmul_rn(__fsub_rn(cen[a], mean[a]), w);
  }
  float c[6] = {__fmul_rn(e[0], e[0]), __fmul_rn(e[0], e[1]), __fmul_rn(e[0], e[2]),
                __fmul_rn(e[1], e[1]), __fmul_rn(e[1], e[2]), __fmul_rn(e[2], e[2])};
  lo::warp_sums(c);
  if (lane != 0) return;
  // ---- eigen-solve on lane 0
  const float c00 = lo::fast_div(c[0], denom), c01 = lo::fast_div(c[1], denom);
  const float c02 = lo::fast_div(c[2], denom), c11 = lo::fast_div(c[3], denom);
  const float c12 = lo::fast_div(c[4], denom), c22 = lo::fast_div(c[5], denom);
  const float A[3][3] = {{c00, c01, c02}, {c01, c11, c12}, {c02, c12, c22}};
  float lam[3], nrm[3];
  lo::eigvals3(A, lam);
  // ---- eigenvector
  lo::eigvec_for(A, lam[0], nrm);
  // ---- outputs
  const float plan = lo::fast_div(lam[0], lam[2] + 1e-6f);
  o[0] = make_float4(nrm[0], nrm[1], nrm[2], mean[0]);
  o[1] = make_float4(mean[1], mean[2], plan, 1.0f);
  non_planar[i] = ok && plan > thr;
  kidmask[i] = (int)mask;
}

inline int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

LO_EXPORT int lo_map_evict_scan(const float* l0, int c1, const float* sensors, int n_sensors,
                                float maxd2, const bool* enabled, bool* cand, void* stream) {
  evict_scan_kernel<<<max(1, blocks(c1)), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)l0, c1, sensors, n_sensors, maxd2, enabled, cand);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_map_scatter_add(const float* pts, const long long* s_idx, const bool* firstk,
                                 const bool* valid_s, const bool* placed, const long long* pslot,
                                 const long long* ch_off, int p, long long nrows, float* l0,
                                 void* stream) {
  scatter_add_kernel<<<max(1, blocks(p)), THREADS, 0, (cudaStream_t)stream>>>(
      pts, s_idx, firstk, valid_s, placed, pslot, ch_off, p, nrows, (float4*)l0);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_map_surfel_recompute(const float* l0, const long long* r_slot, int r_n, int c1,
                                      float thr, float* srow, bool* non_planar, int* kidmask,
                                      void* stream) {
  surfel_recompute_kernel<<<max(1, (r_n + SR_WARPS - 1) / SR_WARPS), THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float4*)l0, r_slot, r_n, c1, thr, srow, non_planar, kidmask);
  return (int)cudaGetLastError();
}
