// K11 shard kernels: the sharded surfel map's ownership compaction and the
// sharded ICP's per-shard normal equations, sample and replicated solve.
//
// Replaces: the JAX package's parallel/sharded_map.py
//   K11a shard_own: owner_of_points (:92) and _compact_owned (:125);
//   K11b shard_alpha_normal_eq: robust_icp_loop.gn_round's per-alpha
//        (A, n) @ (n, 42) product (:312-345), the no-PKO w_rob @ Z
//        (:357-366) and the iteration-0 moments (:378-386);
//   K11c shard_sample: the per-shard stratified sample (:331-337, with
//        ops/pko.py:274 stratified_sample);
//   K11d shard_gn_select: gn_round after the psum (:346-370) and the
//        while_loop's state rules (:388-413).
//
// Layout. A launch covers G = lanes x n_local shard instances, instance
// g = lane * n_local + k holding global shard first + k of its lane's
// map. Every instance's work depends on its own inputs and on n alone,
// never on G, so instance k of a G-instance launch is bit-identical to a
// one-instance launch on instance k's inputs. A lane whose ICP solve is
// done (flags[0]) returns at once, as the JAX while_loop stops.
//
// The moments and the per-alpha systems of all shards meet between
// launches: the caller gathers each shard's row in global shard order
// (parallel/mesh.py ShardGroup.all_gather, no copy on one rank) and
// K11b, K11c and K11d sum those rows in shard order themselves, so two
// calls are bit-equal and a 2-rank x 2-shard layout sums exactly as a
// 1-rank x 4-shard one.
//
// Bounds on the H100 at kitti.yaml's N = 16384 features over S = 4 shards
// (cap = 7936 owned rows a shard), A = 101 alphas:
//  * K11a reads N x 13 B and writes 4 x 7936 x 17 B (~0.75 MB, ~0.2 us at
//    3.35 TB/s), so a launch is its dependent rounds: the points' load,
//    the ranks' scans, the write. Design: one cluster of 8 CTAs a lane
//    covers all n_local shards of the lane in one pass; the cluster takes
//    the points in tiles of 8 x 2048, CTA r the r-th run of 2048 of each
//    tile and each thread 4 consecutive points, whose owners it computes
//    once (transform and hash as the twin rounds them). A point's rank in
//    its shard is the count of the shard's points before it in index
//    order (the JAX lax.sort's stable order): earlier tiles, earlier CTAs
//    of the tile (their totals read through distributed shared memory
//    after one cluster barrier), earlier warps (a scan of the warps'
//    totals), earlier lanes (one shuffle scan of the counts of all 8
//    shards packed 8 bits each in two words) and earlier points of the
//    thread. Only the cluster's 8 SMs store the ~0.5 MB of outputs, so the
//    stores are made wide: each CTA stages its owned points in shared
//    memory by shard and rank and writes them in that order (a warp's rows
//    are neighbours in the output), and the slots past a shard's total
//    get row N - 1 as 16-byte stores spread over the cluster. The
//    owner-only mode is one thread a record.
//  * K11b needs 54 flops per valid owned point per alpha, the 27
//    multiply-adds of the 21 upper entries of J J^T and the 6 of J r
//    (~0.15 GFLOP for the four shards, ~2 us at 67 TFLOP/s fp32), on ~1 MB
//    of inputs: bound by operations. It is the product W (A, n) @ Z (n,
//    27) of sharded_map.py:318-330, and the design follows: a thread-block
//    cluster of 8 CTAs (the portable size) for each (group of 32 alphas,
//    instance), whose 64 warps take the instance's rows in 16-row blocks
//    (block b to warp b mod 64, so the owned rows at the front spread
//    evenly over them all). The lane's state and each warp's first
//    chunk come in one round of loads. A warp reads its chunk once, a row
//    a lane (the next chunk's loads in flight meanwhile), and computes each
//    valid row's J, its 27 alpha-free products and rn = |r| / scale (one
//    division a row, common.cuh's fast_div; for Huber its reciprocal)
//    into shared memory; then lane l, holding the 27 sums of alpha 32 g +
//    l in registers, walks the chunk's valid rows (a ballot) two at a
//    time, their products read as broadcast 16-byte loads, and adds its
//    weight (Huber delta / rn, Cauchy 1 / (1 + (rn / delta)^2) with 1 /
//    delta taken once) times each product. The warps' sums are added in a
//    fixed order, warp order in a CTA then rank order over the cluster
//    through distributed shared memory (each CTA sends each rank its
//    share of the outputs, and after one cluster barrier each rank adds
//    its eighth), so the result depends on n alone. The moments
//    (iteration 0) are one CTA an instance.
//  * K11c reads each instance's flags and q <= 100 of its residuals (~8 KB
//    at S = 4), so a launch is its dependent rounds: the flags' load, the
//    scan, the search, the residuals' gather. Design: a slice of K11b's
//    grid (one more cluster an instance, beside the alpha groups'), so on
//    the ICP's rounds it takes no launch of its own; only rank 0 of the
//    slice's cluster works. Its 256 threads read the flags 16 bytes at a
//    time (a chunk: 16 flags as a 16-bit mask, counted with __popc; the
//    row is read from its 16-byte aligned start, the bytes outside it
//    masked off, so any n and any row offset take wide loads), tiles of
//    1024 chunks, a tile's chunk j to thread j mod 256 (coalesced). The
//    chunks' counts are scanned with warp shuffles and one cross-warp
//    step (warp 0 scans the 4 x 8 warp totals), two barriers a tile,
//    into a shared-memory table of inclusive counts; thread t < q then
//    binary-searches its stratum's rank in the table and takes the bit
//    in the chunk's mask with __fns (no second pass over the flags), and
//    the q residuals come in one round of loads. One CTA is enough: inside
//    K11b's launch the slice runs beside the alpha groups' clusters and
//    the launch takes K11b's own time, so spreading it over the cluster's
//    8 CTAs (one more cluster barrier, ~1 us) cannot pay. Standalone
//    (shard_sample), the same kernel launches with the sample slice alone.
//  * K11d is one block per lane over a few KB: K3's GMM fit and JS argmin
//    (gmm.cuh) and K2b's solve and retract (gn.cuh); latency-bound.
#include <cooperative_groups.h>

#include "gmm.cuh"
#include "gn.cuh"

namespace {

constexpr int OWN_CLUSTER = 8;      // CTAs of a lane's K11a cluster
constexpr int OWN_THREADS = 512;
constexpr int OWN_WARPS = OWN_THREADS / 32;
constexpr int OWN_P = 4;            // consecutive points a thread takes of a tile
constexpr int OWN_TILE = OWN_THREADS * OWN_P;   // points a CTA takes of a tile
constexpr int OWN_MAX_LOCAL = 8;    // local shards a launch covers
constexpr int NE_CLUSTER = 8;       // CTAs of an (alpha group, instance)'s cluster
constexpr int NE_THREADS = 256;
constexpr int NE_WARPS = NE_THREADS / 32;
constexpr int NE_Z = 27;            // 21 upper entries of J J^T, then J r (6)
constexpr int NE_ROW = 28;          // a row in shared memory: its 27 products, rn
constexpr int NE_OUT = NE_Z * 32;   // a cluster's sums: 27 for each of its 32 alphas
constexpr int NE_DEPTH = 2;         // chunks a warp has in flight
constexpr int MOM_THREADS = 256;
constexpr int SMP_V = 4;            // chunks of 16 flags a thread loads at once
constexpr int SMP_TILE = NE_THREADS * SMP_V;   // chunks a tile
constexpr int SMP_MAX_CHUNKS = 4096;           // the table: rows of up to 65536 - 15 flags
constexpr int SELECT_THREADS = 1024;
constexpr int MAX_Q = 100;          // samples a shard draws
constexpr int MAX_A = 128;          // alpha rows of K11d's JS table
constexpr int MAX_G = 128;          // grid points of K11d's JS table

// The owning shard of a point: a second hash of its parent cell's key
// (independent of the bucket hash), mod n_shards. uint32 arithmetic.
__device__ __forceinline__ int owner_of(float x, float y, float z, float inv,
                                        uint32_t n_shards) {
  uint32_t hi, lo;
  lo::pack_key((int)floorf(__fmul_rn(x, inv)), (int)floorf(__fmul_rn(y, inv)),
               (int)floorf(__fmul_rn(z, inv)), hi, lo);
  uint32_t h = (hi * 0x85EBCA77u) ^ (lo * 0xC2B2AE3Du);
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = h ^ (h >> 15);
  return (int)(h % n_shards);
}

// R p + t, each product and sum rounded in this order (the plain twin's
// elementwise order), so that the owner agrees bit for bit.
__device__ __forceinline__ void transform(float R[3][3], const float t[3], float px,
                                          float py, float pz, float w[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    w[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(px, R[r][0]), __fmul_rn(py, R[r][1])),
                               __fmul_rn(pz, R[r][2])),
                     t[r]);
}

// The field k (8 bits at 8 (k % 4)) of a pair of packed counts.
__device__ __forceinline__ int field8(unsigned lo4, unsigned hi4, int k) {
  return (int)(((k < 4 ? lo4 : hi4) >> (8 * (k & 3))) & 0xffu);
}

// The field k (16 bits at 16 (k % 2)) of four words of packed counts.
__device__ __forceinline__ int field16(const unsigned* w, int k) {
  return (int)((w[k >> 1] >> (16 * (k & 1))) & 0xffffu);
}

// p[j] = v(j) for j in [j0, j1), element j by thread t of nt (the
// cluster's threads): 16-byte stores where aligned, single elements at the
// two ends. 32-bit indices: a per-element 64-bit modulo is a software loop.
template <typename T, typename F>
__device__ __forceinline__ void fill(T* p, int j0, int j1, int t, int nt, F v) {
  constexpr int V = 16 / sizeof(T);
  const int past = (int)(reinterpret_cast<uintptr_t>(p + j0) / sizeof(T) % V);
  const int b0 = min(j1, j0 + (V - past) % V), nq = (j1 - b0) / V, b1 = b0 + nq * V;
  for (int j = j0 + t; j < b0; j += nt) p[j] = v(j);
  for (int j = b1 + t; j < j1; j += nt) p[j] = v(j);
  uint4* q = reinterpret_cast<uint4*>(p + b0);
  for (int i = t; i < nq; i += nt) {
    union { T e[V]; uint4 u; } w;
#pragma unroll
    for (int c = 0; c < V; ++c) w.e[c] = v(b0 + i * V + c);
    q[i] = w.u;
  }
}

// K11a, compaction mode: one cluster of OWN_CLUSTER CTAs a lane
// (blockIdx.y), covering the lane's n_local shards first .. first +
// n_local - 1 (instances lane * n_local + k).
__global__ void __cluster_dims__(OWN_CLUSTER, 1, 1) __launch_bounds__(OWN_THREADS)
own_compact_kernel(const float* __restrict__ pts, const bool* __restrict__ mask, int n,
                   const float* __restrict__ T, int n_shards, int first, int n_local, int cap,
                   float inv, float* __restrict__ p_own, bool* __restrict__ ok,
                   int* __restrict__ sel, int* __restrict__ over) {
  namespace cg = cooperative_groups;
  // by tile parity, so that one tile's writes never meet the last one's reads
  __shared__ unsigned wpk[2][OWN_WARPS][2];   // each warp's counts, 8 bits a shard
  __shared__ unsigned wex[2][OWN_WARPS][4];   // earlier warps' counts, 16 bits a shard
  __shared__ unsigned ctot[2][4];             // the CTA's counts, 16 bits a shard
  __shared__ int base[2][OWN_MAX_LOCAL];      // ranks before the CTA's run
  __shared__ int run[OWN_MAX_LOCAL];          // the shards' points in earlier tiles
  __shared__ int coff[OWN_MAX_LOCAL + 1];     // the shards' first slots in the staging
  __shared__ float stage_p[3 * OWN_TILE];     // the CTA's owned points, by shard then rank
  __shared__ int stage_i[OWN_TILE];           // and their indices
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.y, tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  pts += (size_t)lane * n * 3;
  mask += (size_t)lane * n;
  const size_t g0 = (size_t)lane * n_local;
  const bool xf = T != nullptr;
  float R[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}}, t[3] = {0.f, 0.f, 0.f};
  if (xf) lo::load_T(T + 16 * lane, R, t);
  const uint32_t ns = (uint32_t)n_shards;
  if (tid < OWN_MAX_LOCAL) run[tid] = 0;
  const int tiles = (n + OWN_CLUSTER * OWN_TILE - 1) / (OWN_CLUSTER * OWN_TILE);
  for (int tile = 0; tile < tiles; ++tile) {
    const int par = tile & 1;
    const int i0 = (tile * OWN_CLUSTER + rank) * OWN_TILE + tid * OWN_P;
    // ---- owners: each point's local shard once (-1: masked, or another rank's)
    float x[OWN_P][3];
    int own[OWN_P];
#pragma unroll
    for (int u = 0; u < OWN_P; ++u) {
      const int i = i0 + u;
      // the point's load does not wait for its mask's: one load round
#pragma unroll
      for (int j = 0; j < 3; ++j) x[u][j] = i < n ? pts[3 * i + j] : 0.f;
      own[u] = -1;
      if (i < n && mask[i]) {
        float w[3] = {x[u][0], x[u][1], x[u][2]};
        if (xf) transform(R, t, w[0], w[1], w[2], w);
        const int k = owner_of(w[0], w[1], w[2], inv, ns) - first;
        own[u] = (unsigned)k < (unsigned)n_local ? k : -1;
      }
    }
    // ---- ranks in the warp: the 8 shards' counts packed in two words, one scan
    unsigned lo4 = 0u, hi4 = 0u;
#pragma unroll
    for (int u = 0; u < OWN_P; ++u) {
      const int k = own[u];
      if (k >= 0) {
        const unsigned one = 1u << (8 * (k & 3));
        if (k < 4) lo4 += one; else hi4 += one;
      }
    }
    unsigned ilo = lo4, ihi = hi4;   // inclusive: at most 32 x OWN_P = 128 a field
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned a = __shfl_up_sync(0xffffffffu, ilo, off);
      const unsigned b = __shfl_up_sync(0xffffffffu, ihi, off);
      if (wl >= off) { ilo += a; ihi += b; }
    }
    if (wl == 31) { wpk[par][warp][0] = ilo; wpk[par][warp][1] = ihi; }
    __syncthreads();
    // ---- ranks in the CTA: warp 0 scans the warps' counts, 16 bits a shard
    if (warp == 0) {
      unsigned v[4] = {0u, 0u, 0u, 0u};
      if (wl < OWN_WARPS) {
        const unsigned a = wpk[par][wl][0], b = wpk[par][wl][1];
        v[0] = (a & 0xffu) | ((a & 0xff00u) << 8);
        v[1] = ((a >> 16) & 0xffu) | ((a >> 24) << 16);
        v[2] = (b & 0xffu) | ((b & 0xff00u) << 8);
        v[3] = ((b >> 16) & 0xffu) | ((b >> 24) << 16);
      }
      unsigned inc[4] = {v[0], v[1], v[2], v[3]};   // at most OWN_TILE a field
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned a = __shfl_up_sync(0xffffffffu, inc[q], off);
          if (wl >= off) inc[q] += a;
        }
      }
      if (wl < OWN_WARPS) {
#pragma unroll
        for (int q = 0; q < 4; ++q) wex[par][wl][q] = inc[q] - v[q];
      }
      if (wl == 31) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < OWN_MAX_LOCAL; ++k) {
          coff[k] = acc;
          acc += field16(inc, k);
        }
        coff[OWN_MAX_LOCAL] = acc;
#pragma unroll
        for (int q = 0; q < 4; ++q) ctot[par][q] = inc[q];
      }
    }
    __syncthreads();
    // every CTA's counts are read after the cluster barrier; the staging
    // needs none of them, so it runs while the barrier completes
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
    // ---- writes: each owned point into the staging, by shard then rank in the CTA
    unsigned slo = ilo - lo4, shi = ihi - hi4;   // exclusive, then past each point
#pragma unroll
    for (int u = 0; u < OWN_P; ++u) {
      const int k = own[u];
      if (k < 0) continue;
      const int j = coff[k] + field16(wex[par][warp], k) + field8(slo, shi, k);
      const unsigned one = 1u << (8 * (k & 3));
      if (k < 4) slo += one; else shi += one;
      stage_p[3 * j] = x[u][0];
      stage_p[3 * j + 1] = x[u][1];
      stage_p[3 * j + 2] = x[u][2];
      stage_i[j] = i0 + u;
    }
    // ---- ranks in the cluster: every CTA's counts through distributed shared memory
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (tid < n_local) {
      const int k = tid;
      int before = 0, all = 0;
#pragma unroll
      for (int q = 0; q < OWN_CLUSTER; ++q) {
        const unsigned wq = cluster.map_shared_rank(&ctot[par][k >> 1], q)[0];
        const int c = (int)((wq >> (16 * (k & 1))) & 0xffffu);
        before += q < rank ? c : 0;
        all += c;
      }
      base[par][k] = run[k] + before;
      run[k] += all;
    }
    if (tile == tiles - 1)   // the last read of another CTA's shared memory
      asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
    __syncthreads();
    // ---- write-out: the staged rows in order, each below cap at its rank
    for (int j = tid; j < coff[n_local]; j += OWN_THREADS) {
      int k = 0;
      while (j >= coff[k + 1]) ++k;
      const int r = base[par][k] + j - coff[k];
      if (r >= cap) continue;
      const size_t at = (g0 + k) * (size_t)cap + r;
      p_own[3 * at] = stage_p[3 * j];
      p_own[3 * at + 1] = stage_p[3 * j + 1];
      p_own[3 * at + 2] = stage_p[3 * j + 2];
      sel[at] = stage_i[j];
      ok[at] = true;
    }
  }
  // ---- tail: slots past the owned points hold row n - 1, as the clipped sort does
  const float lx = pts[3 * (n - 1)], ly = pts[3 * (n - 1) + 1], lz = pts[3 * (n - 1) + 2];
  const int ct = rank * OWN_THREADS + tid, nct = OWN_CLUSTER * OWN_THREADS;
  for (int k = 0; k < n_local; ++k) {
    const size_t g = (g0 + k) * (size_t)cap;   // the instance's first row
    const int t0 = min(run[k], cap);
    fill(p_own + 3 * g, 3 * t0, 3 * cap, ct, nct, [=](int j) {
      const unsigned c = (unsigned)j % 3u;
      return c == 0u ? lx : (c == 1u ? ly : lz);
    });
    fill(ok + g, t0, cap, ct, nct, [](int) { return false; });
    fill(sel + g, t0, cap, ct, nct, [=](int) { return n - 1; });
  }
  if (rank == 0 && tid < n_local) over[g0 + tid] = max(run[tid] - cap, 0);
  // no CTA leaves while another may still read its shared memory
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// K11a, owner-only mode: one thread a point.
__global__ void own_ids_kernel(const float* __restrict__ pts, int n, int n_shards, float inv,
                               int* __restrict__ owner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  owner[i] = owner_of(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], inv, (uint32_t)n_shards);
}

// The iteration-0 scale std / 6 from the gathered raw moments [sum w |
// sum |r| w | sum r^2 w] of n_shards shards, summed in shard order.
__device__ __forceinline__ float scale_from_moments(const float* mom, int n_shards) {
  float m0 = mom[0], m1 = mom[1], m2 = mom[2];
  for (int s = 1; s < n_shards; ++s) {
    m0 = __fadd_rn(m0, mom[3 * s]);
    m1 = __fadd_rn(m1, mom[3 * s + 1]);
    m2 = __fadd_rn(m2, mom[3 * s + 2]);
  }
  const float n0 = fmaxf(m0, 1.0f);
  const float mean = __fdiv_rn(m1, n0);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(m2, n0), __fmul_rn(mean, mean)), 0.0f);
  return __fdiv_rn(__fsqrt_rn(var), 6.0f);
}

// K11b, moments mode: one block per instance, the raw moments [sum w |
// sum |r| w | sum r^2 w] at out[0..2], zero for a done lane.
__global__ void __launch_bounds__(MOM_THREADS)
moments_kernel(const float* __restrict__ resid, const bool* __restrict__ valid, int n,
               int n_local, const int* __restrict__ flags, int ld, float* __restrict__ out) {
  __shared__ float red[3][MOM_THREADS / 32];
  const int g = blockIdx.x, lane = g / n_local, tid = threadIdx.x;
  resid += (size_t)g * n;
  valid += (size_t)g * n;
  out += (size_t)g * ld;
  float acc[3] = {0.f, 0.f, 0.f};
  if (!flags[3 * lane]) {
    for (int i0 = tid; i0 < n; i0 += 4 * MOM_THREADS) {
      bool v[4];
      float ra[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * MOM_THREADS;
        v[u] = i < n && valid[i];
        ra[u] = i < n ? fabsf(resid[i]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!v[u]) continue;
        acc[0] += 1.f;
        acc[1] += ra[u];
        acc[2] += ra[u] * ra[u];
      }
    }
  }
  lo::warp_sums(acc);
  if (tid % 32 == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) red[k][tid / 32] = acc[k];
  }
  __syncthreads();
  if (tid < 3) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < MOM_THREADS / 32; ++w) s += red[tid][w];
    out[tid] = s;
  }
}

// K11c's sample slice for one instance (row resid, valid of n entries;
// its global shard me): q draws of |r| / scale over the valid entries'
// ranks (feature order) with the shard's uniforms, written (times ok) at
// out[me * q + t] and ok at out[S q + me * q + t], zeros in every other
// shard's slots. One CTA of NE_THREADS; `smem` the CTA's scratch (the
// kernel's zs). A done lane writes nothing.
__device__ __forceinline__ void sample_slice(const float* __restrict__ resid,
                                             const bool* __restrict__ valid, int n, int me,
                                             const int* __restrict__ flags,
                                             const float* __restrict__ mom, int n_shards,
                                             const float* __restrict__ u, int q,
                                             float* __restrict__ out, int* smem) {
  int* incl = smem;                                   // [SMP_MAX_CHUNKS] counts through a chunk
  unsigned short* bits = reinterpret_cast<unsigned short*>(incl + SMP_MAX_CHUNKS);   // its mask
  int* wtot = reinterpret_cast<int*>(bits + SMP_MAX_CHUNKS);   // [SMP_V][NE_WARPS] warp totals
  int* wexc = wtot + SMP_V * NE_WARPS;                // their exclusive scan
  int* ttot = wexc + SMP_V * NE_WARPS;                // the tile's total
  const int t = threadIdx.x, warp = t / 32, wl = t % 32;
  // one round of loads: the lane's flag, its moments, the thread's uniform
  // and its first tile's chunks
  const int done = flags[0];
  const float uj = t < q ? u[me * q + t] : 0.f;
  // the row from its 16-byte aligned start: chunk j holds bytes [16 j, 16 j + 16)
  const int head = (int)(reinterpret_cast<uintptr_t>(valid) & 15u);
  const uint4* row = reinterpret_cast<const uint4*>(valid - head);
  const int span = head + n, chunks = (span + 15) / 16;
  const int tiles = (chunks + SMP_TILE - 1) / SMP_TILE;
  auto load = [&](int tile, uint4 (&w)[SMP_V]) {
#pragma unroll
    for (int v = 0; v < SMP_V; ++v) {
      const int j = tile * SMP_TILE + v * NE_THREADS + t;
      w[v] = j < chunks ? row[j] : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 w[SMP_V];
  load(0, w);
  if (done) return;
  const float denom = fmaxf(scale_from_moments(mom, n_shards), 1e-6f);
  const int m = n_shards * q;
  for (int j = t; j < m; j += NE_THREADS) {   // other shards' slots
    if (j / q == me) continue;
    out[j] = 0.f;
    out[m + j] = 0.f;
  }
  // ---- sample: the flags' counts, a tile at a time
  int base = 0;   // valid flags in earlier tiles
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile > 0) load(tile, w);
    unsigned mk[SMP_V];
    int c[SMP_V];
#pragma unroll
    for (int v = 0; v < SMP_V; ++v) {
      // a byte's flag (0 or 1) to its bit: 4 bytes to 4 bits by one multiply
      const uint32_t x[4] = {w[v].x, w[v].y, w[v].z, w[v].w};
      unsigned b = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) b |= (((x[e] & 0x01010101u) * 0x01020408u) >> 24) << (4 * e);
      // only the bytes of the row
      const int p0 = 16 * (tile * SMP_TILE + v * NE_THREADS + t);
      if (p0 < head) b &= 0xffffu << (head - p0);
      if (p0 + 16 > span) b &= p0 >= span ? 0u : 0xffffu >> (p0 + 16 - span);
      mk[v] = b;
      c[v] = __popc(b);
    }
    int in[SMP_V];   // inclusive over the warp's lanes, row v of the tile
#pragma unroll
    for (int v = 0; v < SMP_V; ++v) in[v] = c[v];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int v = 0; v < SMP_V; ++v) {
        const int a = __shfl_up_sync(0xffffffffu, in[v], o);
        if (wl >= o) in[v] += a;
      }
    }
    if (wl == 31) {
#pragma unroll
      for (int v = 0; v < SMP_V; ++v) wtot[v * NE_WARPS + warp] = in[v];
    }
    __syncthreads();
    if (warp == 0) {   // the tile's 32 warp totals in chunk order (v, warp)
      const int x = wtot[wl];
      int s = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, s, o);
        if (wl >= o) s += a;
      }
      wexc[wl] = s - x;
      if (wl == 31) ttot[0] = s;
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < SMP_V; ++v) {
      const int j = tile * SMP_TILE + v * NE_THREADS + t;
      if (j < chunks) {
        incl[j] = base + wexc[v * NE_WARPS + warp] + in[v];
        bits[j] = (unsigned short)mk[v];
      }
    }
    base += ttot[0];
  }
  __syncthreads();
  // ---- sample: thread t's stratum, its rank's chunk by a binary search, the bit by __fns
  const int nv = base;
  if (t >= q) return;
  const int k = (int)floorf(__fdiv_rn(__fmul_rn(__fadd_rn((float)t, uj), (float)nv), (float)q));
  // t < nv: rank k clipped to [0, nv - 1]; t >= nv: the first valid entry (rank 0)
  const int want = t < nv ? min(max(k, 0), nv - 1) : 0;
  int idx = 0;   // no valid entry: entry 0, as the JAX program's zero-filled table
  if (nv > 0) {
    int lo = 0, hi = chunks - 1;   // the first chunk whose count passes want
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (incl[mid] > want) hi = mid; else lo = mid + 1;
    }
    const int before = lo > 0 ? incl[lo - 1] : 0;
    idx = 16 * lo + (int)__fns(bits[lo], 0u, want - before + 1) - head;
  }
  // ---- sample: the residuals, one round
  const float okf = t < nv ? 1.f : 0.f;
  const float v = __fdiv_rn(fabsf(resid[idx]), denom);
  out[me * q + t] = __fmul_rn(v, okf);
  out[m + me * q + t] = okf;
}

// K11b: one cluster of NE_CLUSTER CTAs per (alpha group, instance) =
// (blockIdx.y, blockIdx.z); lane l of every warp sums alpha 32 y + l.
// out[a * 42 + (0..35)] = sum of w_a vec(J J^T), out[a * 42 + 36 + (0..5)]
// = sum of w_a J r, and out[ld - 1] the count (group 0 writes it).
__global__ void __cluster_dims__(NE_CLUSTER, 1, 1) __launch_bounds__(NE_THREADS, 2)
alpha_ne_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                const float* __restrict__ resid, const bool* __restrict__ valid, int n,
                int n_local, const float* __restrict__ T, const int* __restrict__ flags,
                const float* __restrict__ mom, int n_shards, const float* __restrict__ alphas,
                int n_alpha, int robust, int cauchy, int ld, float* __restrict__ out,
                const float* __restrict__ u, int q, int first, int off) {
  namespace cg = cooperative_groups;
  // a warp's chunk: 32 rows of NE_ROW floats; after the walk, the warps'
  // sums; in the sample slice, its tables
  __shared__ __align__(16) float zs[NE_WARPS * 32 * NE_ROW];
  __shared__ float inbox[NE_OUT + NE_CLUSTER];   // every CTA's sums of this rank's outputs
  __shared__ int cnt[NE_WARPS];
  const int g = blockIdx.z, lane = g / n_local;
  if ((int)blockIdx.y * 32 >= n_alpha) {   // past the alpha groups: the sample slice
    if (blockIdx.x == 0)                   // the slice's cluster rank 0
      sample_slice(resid + (size_t)g * n, valid + (size_t)g * n, n, first + g % n_local,
                   flags + 3 * lane, mom + (size_t)lane * n_shards * 3, n_shards, u, q,
                   out + (size_t)g * ld + off, reinterpret_cast<int*>(zs));
    return;
  }
  pts += (size_t)g * n * 3;
  nrm += (size_t)g * n * 3;
  resid += (size_t)g * n;
  valid += (size_t)g * n;
  out += (size_t)g * ld;
  mom += (size_t)lane * n_shards * 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  // Rows in 16-row blocks, block b to warp b mod W of the W = 64 warps of
  // the cluster; a warp's chunk k is its blocks 2k and 2k + 1 (a half-warp
  // each), so the owned rows at the front spread evenly over the warps.
  constexpr int n_warps = NE_CLUSTER * NE_WARPS;
  const int wc = rank * NE_WARPS + warp;
  const int chunks = (n + 32 * n_warps - 1) / (32 * n_warps);
  auto load = [&](int k, float (&x)[8]) {
    const int i = 16 * (wc + n_warps * (2 * k + wl / 16)) + wl % 16;
    const bool in = k < chunks && i < n;
    x[0] = in && valid[i] ? 1.f : 0.f;
    x[1] = in ? resid[i] : 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      x[2 + j] = in ? nrm[3 * i + j] : 0.f;
      x[5 + j] = in ? pts[3 * i + j] : 0.f;
    }
  };
  // one round of loads: the lane's flag, pose, moments and this lane's
  // alpha, and the warp's first NE_DEPTH chunks (a load round costs ~1 us
  // on the H100, longer than a chunk's walk)
  const int done = flags[3 * lane];
  float R[3][3], t[3];
  lo::load_T(T + 16 * lane, R, t);
  const int alpha = min((int)blockIdx.y * 32 + wl, n_alpha - 1);
  const float delta = alphas[alpha];
  float buf[NE_DEPTH][8];
#pragma unroll
  for (int u = 0; u < NE_DEPTH; ++u) load(u, buf[u]);
  if (done) return;                      // every CTA of the cluster alike
  // every CTA of the cluster has started before any writes into another's
  // shared memory: arrive now, wait just before the writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const float denom = fmaxf(scale_from_moments(mom, n_shards), 1e-6f);
  const float inv_delta = lo::fast_rcp(delta);
  const bool huber = robust && !cauchy;
  float acc[NE_Z];
#pragma unroll
  for (int k = 0; k < NE_Z; ++k) acc[k] = 0.f;
  int count = 0;
  float* zw = zs + warp * 32 * NE_ROW;
  for (int kb = 0; kb < chunks; kb += NE_DEPTH) {
#pragma unroll
    for (int u = 0; u < NE_DEPTH; ++u) {
      if (kb + u >= chunks) break;
      float* cur = buf[u];
      // ---- a chunk's rows: J, the 27 products and rn, a row a lane
      const bool v = cur[0] != 0.f;
      if (v) {
        const float r = cur[1];
        const float n0 = cur[2], n1 = cur[3], n2 = cur[4];
        const float p0 = cur[5], p1 = cur[6], p2 = cur[7];
        float J[6];
#pragma unroll
        for (int j = 0; j < 3; ++j) J[j] = n0 * R[0][j] + n1 * R[1][j] + n2 * R[2][j];
        J[3] = p1 * J[2] - p2 * J[1];
        J[4] = p2 * J[0] - p0 * J[2];
        J[5] = p0 * J[1] - p1 * J[0];
        float z[NE_ROW];
        int k = 0;
#pragma unroll
        for (int x = 0; x < 6; ++x)
#pragma unroll
          for (int y = x; y < 6; ++y) z[k++] = J[x] * J[y];
#pragma unroll
        for (int x = 0; x < 6; ++x) z[21 + x] = J[x] * r;
        // Huber takes 1 / rn (rn > delta as 1 / rn < 1 / delta), Cauchy rn
        const float rn = lo::fast_div(fabsf(r), denom);
        z[27] = huber ? lo::fast_rcp(fmaxf(rn, 1e-30f)) : rn;
        float4* row = reinterpret_cast<float4*>(zw + wl * NE_ROW);
#pragma unroll
        for (int q = 0; q < NE_ROW / 4; ++q)
          row[q] = make_float4(z[4 * q], z[4 * q + 1], z[4 * q + 2], z[4 * q + 3]);
      }
      load(kb + u + NE_DEPTH, buf[u]);   // this slot's next chunk
      unsigned mask = __ballot_sync(0xffffffffu, v);
      count += __popc(mask);
      __syncwarp();
      // ---- the walk: the valid rows' weighted products into the lane's alpha, two at a time
      while (mask) {
        const int j0 = __ffs(mask) - 1;
        mask &= mask - 1;
        const bool two = mask != 0;
        const int j1 = two ? __ffs(mask) - 1 : j0;
        mask &= mask - 1;
        float z[2][NE_ROW];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* row = reinterpret_cast<const float4*>(zw + (h ? j1 : j0) * NE_ROW);
#pragma unroll
          for (int q = 0; q < NE_ROW / 4; ++q) {
            const float4 f = row[q];
            z[h][4 * q] = f.x; z[h][4 * q + 1] = f.y; z[h][4 * q + 2] = f.z; z[h][4 * q + 3] = f.w;
          }
        }
        float w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = z[h][27];
          w[h] = 1.0f;
          if (huber) {
            w[h] = x < inv_delta ? delta * x : 1.0f;
          } else if (robust) {
            const float q = x * inv_delta;
            w[h] = lo::fast_rcp(1.0f + q * q);
          }
        }
#pragma unroll
        for (int k = 0; k < NE_Z; ++k) acc[k] += w[0] * z[0][k];
        if (two) {
#pragma unroll
          for (int k = 0; k < NE_Z; ++k) acc[k] += w[1] * z[1][k];
        }
      }
      __syncwarp();
    }
  }

  // ---- the CTA's sums, in warp order, sent to the rank that writes them
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NE_Z; ++k) zs[(warp * NE_Z + k) * 32 + wl] = acc[k];
  if (wl == 0) cnt[warp] = count;
  __syncthreads();
  constexpr int per = NE_OUT / NE_CLUSTER;   // outputs a rank writes
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int o = tid; o < NE_OUT; o += NE_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NE_WARPS; ++w) s += zs[w * NE_OUT + o];
    cluster.map_shared_rank(inbox, o / per)[rank * per + o % per] = s;
  }
  if (tid == 0) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < NE_WARPS; ++w) c += cnt[w];
    cluster.map_shared_rank(inbox, 0)[NE_OUT + rank] = (float)c;
  }

  // ---- the cluster's sums, in rank order: each rank writes 1 / 8 of the outputs
  cluster.sync();
  if (tid < per) {
    const int o = rank * per + tid, z = o / 32, a = blockIdx.y * 32 + o % 32;
    float s = inbox[tid];
#pragma unroll
    for (int q = 1; q < NE_CLUSTER; ++q) s += inbox[q * per + tid];
    if (a < n_alpha) {
      float* oa = out + (size_t)a * 42;
      if (z < 21) {
        int x = 0, base = 0;
        while (z >= base + 6 - x) { base += 6 - x; ++x; }
        const int y = x + z - base;
        oa[x * 6 + y] = s;
        oa[y * 6 + x] = s;
      } else {
        oa[36 + z - 21] = s;
      }
    }
  }
  if (tid == per && rank == 0 && blockIdx.y == 0) {
    float c = inbox[NE_OUT];
#pragma unroll
    for (int q = 1; q < NE_CLUSTER; ++q) c += inbox[NE_OUT + q];
    out[ld - 1] = c;
  }
}

// K11d's solve and retract on thread 0, out of line: inlined into the
// 1024-thread kernel (64 registers a thread) the unrolled 6x6 elimination
// costs the kernel's other phases their register allocation.
__device__ __noinline__ bool select_tail(const float* h, const float* T, float tol_t,
                                         float tol_r, float* Tn) {
  float dx[6];
  lo::solve6(h, dx);
  return lo::gn_retract(T, dx, tol_t, tol_r, Tn);
}

// K11d: one block per lane over the gathered (n_shards, ld) buffer.
__global__ void __launch_bounds__(SELECT_THREADS)
gn_select_kernel(const float* __restrict__ buf, int n_shards, int ld, int n_alpha, int q,
                 int use_pko, const float* __restrict__ T, const int* __restrict__ flags,
                 const int* __restrict__ pick, const float* __restrict__ r_grid,
                 const float* __restrict__ Q, int n_grid, int min_corr, float tol_t,
                 float tol_r, float* __restrict__ T_out, int* __restrict__ flags_out,
                 int* __restrict__ info) {
  __shared__ float samp[lo::GMM_MAX_M];
  __shared__ float oks[lo::GMM_MAX_M];
  __shared__ float gw[lo::GMM_KC], gmu[lo::GMM_KC], gvar[lo::GMM_KC];
  __shared__ float P[MAX_G];
  __shared__ float cost[MAX_A];
  __shared__ float hg[42];
  __shared__ float meanv;
  __shared__ int best_s;
  const int lane = blockIdx.x, t = threadIdx.x;
  buf += (size_t)lane * n_shards * ld;
  T += 16 * lane;
  flags += 3 * lane;
  T_out += 16 * lane;
  flags_out += 3 * lane;
  info += 2 * lane;
  if (flags[0]) {  // done: pass the state through
    if (t < 16) T_out[t] = T[t];
    if (t < 3) flags_out[t] = flags[t];
    if (t == 0) { info[0] = 0; info[1] = 0; }
    return;
  }
  if (t == 0) best_s = 0;
  if (use_pko) {
    const int m = n_shards * q;
    const int off_s = n_alpha * 42, off_o = off_s + m;
    for (int j = t; j < m; j += SELECT_THREADS) {
      float s = buf[off_s + j], o = buf[off_o + j];
      for (int sh = 1; sh < n_shards; ++sh) {
        s = __fadd_rn(s, buf[(size_t)sh * ld + off_s + j]);
        o = __fadd_rn(o, buf[(size_t)sh * ld + off_o + j]);
      }
      samp[j] = s;
      oks[j] = o;
    }
    __syncthreads();
    if (t == 0) {
      // slots of shards with too few valid residuals take the mean of the
      // filled ones (the sums in double, then rounded)
      double ss = 0.0, so = 0.0;
      for (int j = 0; j < m; ++j) { ss += samp[j]; so += oks[j]; }
      meanv = __fdiv_rn((float)ss, fmaxf((float)so, 1.0f));
    }
    __syncthreads();
    for (int j = t; j < m; j += SELECT_THREADS)
      if (!(oks[j] > 0.5f)) samp[j] = meanv;
    __syncthreads();
    if (t < 32) lo::gmm_fit_warp(samp, m, pick, gw, gmu, gvar);
    __syncthreads();
    const int best = lo::js_argmin_block(gw, gmu, gvar, r_grid, Q, n_alpha, n_grid, P, cost);
    if (t == 0) best_s = best;
  }
  __syncthreads();
  const int best = best_s;
  if (t < 42) {
    float s = buf[(size_t)best * 42 + t];
    for (int sh = 1; sh < n_shards; ++sh) s = __fadd_rn(s, buf[(size_t)sh * ld + best * 42 + t]);
    hg[t] = s;
  }
  __syncthreads();
  if (t != 0) return;
  float count = buf[ld - 1];
  for (int sh = 1; sh < n_shards; ++sh) count = __fadd_rn(count, buf[(size_t)sh * ld + ld - 1]);
  float h[27];
  int k = 0;
  for (int x = 0; x < 6; ++x)
    for (int y = x; y < 6; ++y) h[k++] = hg[x * 6 + y];
  for (int x = 0; x < 6; ++x) h[21 + x] = hg[36 + x];
  float Tn[16];
  const bool conv = select_tail(h, T, tol_t, tol_r, Tn);
  const bool insufficient = count < (float)min_corr;
  const bool step = !insufficient;   // not done here
  const int n_corr = (int)rintf(count);
  for (int i = 0; i < 16; ++i) T_out[i] = step ? Tn[i] : T[i];
  flags_out[0] = insufficient || (step && conv);
  flags_out[1] = flags[1] || insufficient;
  flags_out[2] = step ? n_corr : flags[2];
  info[0] = best;
  info[1] = n_corr;
}

}  // namespace

LO_EXPORT int lo_shard_own(const float* pts, const bool* mask, int n, int lanes, const float* T,
                           int n_shards, int first, int n_local, int cap, float inv,
                           float* p_own, bool* ok, int* sel, int* over, int* owner,
                           void* stream) {
  if (owner != nullptr) {
    const int total = n * lanes;
    own_ids_kernel<<<max(1, (total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        pts, total, n_shards, inv, owner);
  } else {
    if (n < 1 || cap < 1 || cap > n || n_local < 1 || n_local > OWN_MAX_LOCAL || lanes < 1)
      return (int)cudaErrorInvalidValue;
    const dim3 grid(OWN_CLUSTER, lanes);   // __cluster_dims__
    own_compact_kernel<<<grid, OWN_THREADS, 0, (cudaStream_t)stream>>>(
        pts, mask, n, T, n_shards, first, n_local, cap, inv, p_own, ok, sel, over);
  }
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_shard_alpha_normal_eq(const float* pts, const float* nrm, const float* resid,
                                       const bool* valid, int n, int instances, int n_local,
                                       const float* T, const int* flags, const float* mom,
                                       int n_shards, const float* alphas, int n_alpha,
                                       int robust, int cauchy, int moments, int ld, float* out,
                                       const float* u, int q, int first, int off,
                                       void* stream) {
  if (moments) {
    moments_kernel<<<instances, MOM_THREADS, 0, (cudaStream_t)stream>>>(resid, valid, n, n_local,
                                                                         flags, ld, out);
  } else {
    if (n_alpha < 0 || ld < n_alpha * 42 + 1 || (n_alpha == 0 && u == nullptr))
      return (int)cudaErrorInvalidValue;
    // with u, one more cluster an instance: K11c's sample slice
    if (u != nullptr && (q < 1 || q > MAX_Q || n < 1 || n + 15 > 16 * SMP_MAX_CHUNKS ||
                         off < n_alpha * 42 || off + 2 * n_shards * q > ld))
      return (int)cudaErrorInvalidValue;
    const int groups = (n_alpha + 31) / 32 + (u != nullptr);
    const dim3 grid(NE_CLUSTER, groups, instances);   // __cluster_dims__
    alpha_ne_kernel<<<grid, NE_THREADS, 0, (cudaStream_t)stream>>>(
        pts, nrm, resid, valid, n, n_local, T, flags, mom, n_shards, alphas, n_alpha, robust,
        cauchy, ld, out, u, q, first, off);
  }
  return (int)cudaGetLastError();
}

// K11b's launch shape: CTAs a cluster, threads a CTA, alphas a cluster.
LO_EXPORT void lo_shard_alpha_normal_eq_shape(int* out) {
  out[0] = NE_CLUSTER;
  out[1] = NE_THREADS;
  out[2] = 32;
}

// K11c alone: K11b's kernel with the sample slice and no alpha group.
LO_EXPORT int lo_shard_sample(const float* resid, const bool* valid, int n, int instances,
                              int n_local, int first, const int* flags, const float* mom,
                              int n_shards, const float* u, int q, int off, int ld, float* out,
                              void* stream) {
  return lo_shard_alpha_normal_eq(nullptr, nullptr, resid, valid, n, instances, n_local, nullptr,
                                  flags, mom, n_shards, nullptr, 0, 0, 0, 0, ld, out, u, q,
                                  first, off, stream);
}

LO_EXPORT int lo_shard_gn_select(const float* buf, int lanes, int n_shards, int ld, int n_alpha,
                                 int q, int use_pko, const float* T, const int* flags,
                                 const int* pick, const float* r_grid, const float* Q,
                                 int n_grid, int min_corr, float tol_t, float tol_r,
                                 float* T_out, int* flags_out, int* info, void* stream) {
  if (use_pko && (n_alpha > MAX_A || n_grid > MAX_G || n_shards * q > lo::GMM_MAX_M))
    return (int)cudaErrorInvalidValue;
  gn_select_kernel<<<lanes, SELECT_THREADS, 0, (cudaStream_t)stream>>>(
      buf, n_shards, ld, n_alpha, q, use_pko, T, flags, pick, r_grid, Q, n_grid, min_corr,
      tol_t, tol_r, T_out, flags_out, info);
  return (int)cudaGetLastError();
}
