// K6 point-table k-NN: the loop-closure ICP's correspondence search against a
// keyframe's world cloud binned into voxels.
//
// Replaces: the JAX package's ops/knn.py:47 build_point_table (its dense
// bin -> first-index grid, the window origin and the fits flag; the key sort
// stays torch.sort, as the JAX side used lax.sort), ops/knn.py:112 knn_query
// (with _bin_starts :83, both the dense-grid and the binary-search path) and
// ops/knn.py:152 nn1_distance (knn_query with k = 1).
//
// Bounds on the H100 (loop query of 8192 rows against a 16384-row table):
//  * point_grid reads 16384 x (8 + 12) B and writes the 128 x 128 x 32 grid
//    (2 MB) whole: ~2.3 MB, ~0.7 us at the memory's rate. Design: one
//    launch of 16 clusters of 8 CTAs x 512 threads, each cluster owning a
//    sixteenth of the grid: it fills its slice with c (two 16-byte stores
//    a thread over 128 SMs, started at once: the fill needs no origin),
//    reduces every row's bin window itself (warp redux, the CTAs' partials
//    pushed into each other's shared memory; L2 serves the 16 clusters'
//    reads of the 0.3 MB of rows), and after one cluster barrier, which
//    orders its slice's fill before its scatter, writes the first sorted
//    index of each occupied in-window bin of its slice. The window origin
//    and the fits flag stay on the device; no host read, no torch fill.
//    (Two CTAs of 512 fit an SM, so the 128 CTAs run in one wave; at 1024
//    threads and 40 registers only one does, and on an H100 the launch
//    took 7.6 us where this takes 5.3.)
//  * point_knn probes (2r+1)^3 bins x W entries a query: at r = 1, W = 8,
//    216 candidates, ~10 flops each, ~18 MFLOP and ~1.2 MB of distinct
//    reads a launch: far below both bounds; the dependent rounds of reads
//    into the table (which stays in L2) bound it. Design: one warp a query
//    (8 a block). Lane l takes bins l, l + 32, ... of the window in the JAX
//    offset order (dx outer, dz inner): one round of grid reads (or binary
//    searches of the sorted keys when the table does not fit the window),
//    then the bin's W rows, their keys and points all loaded before any is
//    used (in chunks of CH = 4, 8 or 16 rows; k = 1 always 4). Each lane
//    keeps its own K nearest by (squared distance, candidate index), then
//    the warp pops the K smallest (common.cuh topk_pop: a redux.sync
//    minimum a pop), which is jax.lax.top_k's order on ties; lanes j < 3K
//    write the (K, 3) neighbours as one coalesced row. The distance's
//    square root is common.cuh's fast_sqrt (no slow-path call). The
//    (N, M*W) candidate tensor of the JAX program never reaches memory. A
//    device flag returns a finished solve's launch at once (the whole warp
//    leaves). Two entry points of one template: point_knn (k = 5, the
//    plane fits) and point_nn1 (k = 1, the inlier ratio).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int GX = 128, GY = 128, GZ = 32;
constexpr int GRID_THREADS = 512;
constexpr int KNN_WARPS = 8;                 // queries a block
constexpr int KNN_THREADS = 32 * KNN_WARPS;
constexpr long long INVALID_KEY = 0x7FFFFFFFFFFFFFFFLL;
constexpr int BIG = 1 << 20;

// The int64 sort key of a voxel: (iz << 32) + ((ix+32768)<<16 | (iy+32768)),
// which orders like the JAX (hi, lo) key pair.
__device__ __forceinline__ long long sort_key(int ix, int iy, int iz) {
  const unsigned int low = ((((unsigned int)(ix + 32768)) & 0xFFFFu) << 16) |
                           (((unsigned int)(iy + 32768)) & 0xFFFFu);
  return ((long long)iz << 32) + (long long)low;
}

__device__ __forceinline__ int vcoord(float p, float inv) {
  return (int)floorf(__fmul_rn(p, inv));
}

// key_s (c,) sorted int64 bin keys (INVALID_KEY last), pts_s (c, 3) in
// the same order; grid (GX * GY * GZ,) int32, 16-byte aligned; meta (5,)
// [origin xyz | fits | n_valid].
//
// GRID_CLUSTERS clusters of GRID_CLUSTER CTAs; cluster q owns the grid's
// slice q (lx in 8 q .. 8 q + 7) and computes the window from every row
// itself, so that no cluster waits for another. CTA r of a cluster fills
// its share of the slice with c (two 16-byte stores a thread, issued at
// once: the fill needs no origin) and reduces rows j * 4096 + r * 512 +
// tid (j < 4) of each round of 16384 (the first round kept in registers)
// to their min and max bin coordinates and count: warp redux, then warp 0
// over the CTA's warps. Each CTA stores its partial into every CTA of its
// cluster; one cluster barrier then orders the slice's fill before its
// scatter and every partial before the merge. Each CTA merges the 8
// partials itself and writes, of its rows, the first sorted index of each
// occupied in-window bin that lies in its cluster's slice.
constexpr int GRID_CLUSTER = 8;                   // CTAs a cluster
constexpr int GRID_CLUSTERS = 16;                 // clusters a launch: grid slices
constexpr int GRID_PER = 4;                       // rows a thread takes a round
constexpr int GRID_TILE = GRID_CLUSTER * GRID_THREADS * GRID_PER;   // rows a round
constexpr int SLICE_X = GX / GRID_CLUSTERS;       // lx of a slice
constexpr int SLICE_VEC = SLICE_X * GY * GZ / 4;  // 16-byte words of a slice
constexpr int FILL_PER = SLICE_VEC / (GRID_CLUSTER * GRID_THREADS);   // a thread's fill stores
constexpr int GRID_WARPS = GRID_THREADS / 32;
constexpr int NRED = 7;                           // min xyz | max xyz | count
static_assert(SLICE_VEC % (GRID_CLUSTER * GRID_THREADS) == 0, "the fill splits evenly");

__device__ __forceinline__ void load_row(const long long* __restrict__ key_s,
                                         const float* __restrict__ pts_s, int i, float inv,
                                         long long& k, long long& prev, int (&v)[3]) {
  k = __ldg(key_s + i);
  prev = i > 0 ? __ldg(key_s + i - 1) : INVALID_KEY;
#pragma unroll
  for (int d = 0; d < 3; ++d) v[d] = vcoord(__ldg(pts_s + 3 * i + d), inv);
}

__device__ __forceinline__ void add_row(long long k, const int (&v)[3], int (&red)[NRED]) {
  if (k == INVALID_KEY) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    red[d] = min(red[d], v[d]);
    red[3 + d] = max(red[3 + d], v[d]);
  }
  ++red[6];
}

__device__ __forceinline__ void warp_window(int (&red)[NRED]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    red[d] = __reduce_min_sync(0xffffffffu, red[d]);
    red[3 + d] = __reduce_max_sync(0xffffffffu, red[3 + d]);
  }
  red[6] = __reduce_add_sync(0xffffffffu, red[6]);
}

__global__ void __launch_bounds__(GRID_THREADS)
point_grid_kernel(const long long* __restrict__ key_s, const float* __restrict__ pts_s, int c,
                  float inv, int4* __restrict__ grid, int* __restrict__ meta) {
  namespace cg = cooperative_groups;
  __shared__ int wred[GRID_WARPS][NRED];
  __shared__ int part[GRID_CLUSTER][NRED];        // every CTA's partial
  __shared__ int win[NRED];                       // the merged window
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), q = blockIdx.x / GRID_CLUSTER;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // every CTA has started before any stores into its shared memory (the
  // wait before those stores)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  // ---- loads
  // this thread's rows of the first round and the key before each
  long long k0[GRID_PER], p0[GRID_PER];
  int v0[GRID_PER][3];
#pragma unroll
  for (int j = 0; j < GRID_PER; ++j) {
    const int i = (j * GRID_CLUSTER + rank) * GRID_THREADS + tid;
    k0[j] = p0[j] = INVALID_KEY;
    v0[j][0] = v0[j][1] = v0[j][2] = 0;
    if (i < c) load_row(key_s, pts_s, i, inv, k0[j], p0[j], v0[j]);
  }
  // ---- fill
  int4* mine = grid + (q * GRID_CLUSTER + rank) * (SLICE_VEC / GRID_CLUSTER) + tid;
#pragma unroll
  for (int j = 0; j < FILL_PER; ++j) mine[j * GRID_THREADS] = make_int4(c, c, c, c);
  // ---- window
  // this thread's rows, then the warp's, then the CTA's (warp 0)
  int red[NRED] = {BIG, BIG, BIG, -BIG, -BIG, -BIG, 0};
#pragma unroll
  for (int j = 0; j < GRID_PER; ++j) add_row(k0[j], v0[j], red);
  for (int t = GRID_TILE; t < c; t += GRID_TILE)
#pragma unroll
    for (int j = 0; j < GRID_PER; ++j) {
      const int i = t + (j * GRID_CLUSTER + rank) * GRID_THREADS + tid;
      if (i >= c) break;
      long long k, p;
      int v[3];
      load_row(key_s, pts_s, i, inv, k, p, v);
      add_row(k, v, red);
    }
  warp_window(red);
  if (lane == 0)
#pragma unroll
    for (int x = 0; x < NRED; ++x) wred[warp][x] = red[x];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int x = 0; x < NRED; ++x)
      red[x] = lane < GRID_WARPS ? wred[lane][x] : x < 3 ? BIG : x < 6 ? -BIG : 0;
    warp_window(red);
  }
  // ---- merge
  // lane x of warp 0 stores the partial into CTA x's shared memory; after
  // the barrier each CTA holds all of its cluster's
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (warp == 0 && lane < GRID_CLUSTER) {
    int* dst = cluster.map_shared_rank(&part[0][0], lane) + rank * NRED;
#pragma unroll
    for (int x = 0; x < NRED; ++x) dst[x] = red[x];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (tid < NRED) {
    int m = part[0][tid];
#pragma unroll
    for (int r = 1; r < GRID_CLUSTER; ++r) {
      const int x = part[r][tid];
      m = tid < 3 ? min(m, x) : tid < 6 ? max(m, x) : m + x;
    }
    win[tid] = m;
  }
  __syncthreads();
  const int o[3] = {win[0], win[1], win[2]};
  if (blockIdx.x == 0 && tid == 0) {
    meta[0] = o[0];
    meta[1] = o[1];
    meta[2] = o[2];
    meta[3] = win[6] > 0 && win[3] - o[0] < GX && win[4] - o[1] < GY && win[5] - o[2] < GZ;
    meta[4] = win[6];
  }
  // ---- scatter
  // each in-window bin of this cluster's slice: its first sorted row
  int* gi = reinterpret_cast<int*>(grid);
  for (int t = 0; t < c; t += GRID_TILE)
#pragma unroll
    for (int j = 0; j < GRID_PER; ++j) {
      const int i = t + (j * GRID_CLUSTER + rank) * GRID_THREADS + tid;
      if (i >= c) break;
      long long k = k0[j], p = p0[j];
      int v[3] = {v0[j][0], v0[j][1], v0[j][2]};
      if (t) load_row(key_s, pts_s, i, inv, k, p, v);
      if (k == INVALID_KEY || k == p) continue;
      const int lx = v[0] - o[0], ly = v[1] - o[1], lz = v[2] - o[2];
      if (lx < SLICE_X * q || lx >= SLICE_X * (q + 1) || ly < 0 || ly >= GY || lz < 0 ||
          lz >= GZ)
        continue;
      gi[(lx * GY + ly) * GZ + lz] = i;
    }
}

// First sorted index whose key is >= k (lower bound), in [0, c].
__device__ __forceinline__ int lower_bound(const long long* __restrict__ key_s, int c,
                                           long long k) {
  int lo = 0, hi = c;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_s[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int K, int CH>
__global__ void __launch_bounds__(KNN_THREADS)
point_knn_kernel(const float* __restrict__ q, int n, const int* __restrict__ flags,
                 const long long* __restrict__ key_s, const float* __restrict__ pts_s, int c,
                 const int* __restrict__ grid, const int* __restrict__ meta, float inv,
                 int radius, int width, float* __restrict__ nb, bool* __restrict__ ok_out,
                 float* __restrict__ dist) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * KNN_WARPS + (threadIdx.x >> 5);   // this warp's query
  if (i >= n || (flags != nullptr && flags[0])) return;        // the whole warp leaves
  // ---- the query's bin and the table's window
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  const int cx = vcoord(qx, inv), cy = vcoord(qy, inv), cz = vcoord(qz, inv);
  const bool fits = meta[3] != 0;
  const int ox = meta[0], oy = meta[1], oz = meta[2];
  const int side = 2 * radius + 1, n_bins = side * side * side;
  unsigned long long key[K];
  int val[K];   // the candidate's table row, its ok flag in bit 31
#pragma unroll
  for (int s = 0; s < K; ++s) {
    key[s] = lo::NO_KEY;
    val[s] = c - 1;
  }
  for (int m0 = 0; m0 < n_bins; m0 += 32) {
    const int m = m0 + lane;
    if (m < n_bins) {
      // ---- bins: the first sorted row of the lane's bin
      const int bx = cx + m / (side * side) - radius;
      const int by = cy + (m / side) % side - radius;
      const int bz = cz + m % side - radius;
      const long long bkey = sort_key(bx, by, bz);
      int start;
      if (fits) {
        const int lx = bx - ox, ly = by - oy, lz = bz - oz;
        const bool inside = lx >= 0 && lx < GX && ly >= 0 && ly < GY && lz >= 0 && lz < GZ;
        start = inside ? grid[(lx * GY + ly) * GZ + lz] : c;
      } else {
        start = lower_bound(key_s, c, bkey);
      }
      // ---- candidates: the bin's rows, CH at a time, every load issued first
      for (int w0 = 0; w0 < width; w0 += CH) {
        long long kg[CH];
        float px[CH], py[CH], pz[CH];
#pragma unroll
        for (int w = 0; w < CH; ++w) {
          const int g = min(start + w0 + w, c - 1);
          kg[w] = key_s[g];
          px[w] = pts_s[3 * g];
          py[w] = pts_s[3 * g + 1];
          pz[w] = pts_s[3 * g + 2];
        }
#pragma unroll
        for (int w = 0; w < CH; ++w) {
          if (w0 + w >= width) break;
          const int g = min(start + w0 + w, c - 1);
          const bool okc = kg[w] == bkey && kg[w] != INVALID_KEY;
          const float ex = __fsub_rn(px[w], qx), ey = __fsub_rn(py[w], qy),
                      ez = __fsub_rn(pz[w], qz);
          const float d2 = okc ? __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                           __fmul_rn(ez, ez))
                               : INFINITY;
          lo::topk_insert(key, val, lo::topk_key(d2, (unsigned)(m * width + w0 + w)),
                          g | (okc ? (int)0x80000000 : 0));
        }
      }
    }
  }
  // ---- merge: the warp's K nearest, lane s keeps the s-th
  unsigned long long kept = lo::NO_KEY;
  int kept_v = c - 1;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    int v;
    const unsigned long long win = lo::topk_pop<32, K>(key, val, v);
    if (lane == s) {
      kept = win;
      kept_v = v;
    }
  }
  // ---- write: lanes j < 3K the neighbours' coordinates, lanes s < K flag and distance
  const int gv = __shfl_sync(0xffffffffu, kept_v, min(lane / 3, K - 1));
  if (lane < 3 * K)
    nb[(size_t)i * 3 * K + lane] = pts_s[3 * (size_t)(gv & 0x7FFFFFFF) + lane % 3];
  if (lane < K) {
    const bool okw = kept_v < 0;
    const size_t o = (size_t)i * K + lane;
    ok_out[o] = okw;
    const float d2 = __uint_as_float((unsigned)(kept >> 32));
    dist[o] = okw ? lo::fast_sqrt(fmaxf(d2, 0.f)) : INFINITY;
  }
}

// One launch: CH, the rows a lane loads at once, from the bucket width
// (k = 1: always 4).
template <int K>
int launch_knn(const float* q, int n, const int* flags, const long long* key_s,
               const float* pts_s, int c, const int* grid, const int* meta, float inv,
               int radius, int width, float* nb, bool* ok, float* dist, void* stream) {
  if (radius < 0 || width < 1) return (int)cudaErrorInvalidValue;
  const int blocks = max(1, (n + KNN_WARPS - 1) / KNN_WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (K == 1) {   // at CH = 8 or 16 ptxas keeps 12 bytes of k = 1's state on a stack
    point_knn_kernel<K, 4><<<blocks, KNN_THREADS, 0, st>>>(q, n, flags, key_s, pts_s, c, grid,
                                                           meta, inv, radius, width, nb, ok, dist);
  } else if (width <= 4) {
    point_knn_kernel<K, 4><<<blocks, KNN_THREADS, 0, st>>>(q, n, flags, key_s, pts_s, c, grid,
                                                           meta, inv, radius, width, nb, ok, dist);
  } else if (width <= 8) {
    point_knn_kernel<K, 8><<<blocks, KNN_THREADS, 0, st>>>(q, n, flags, key_s, pts_s, c, grid,
                                                           meta, inv, radius, width, nb, ok, dist);
  } else {
    point_knn_kernel<K, 16><<<blocks, KNN_THREADS, 0, st>>>(q, n, flags, key_s, pts_s, c, grid,
                                                            meta, inv, radius, width, nb, ok,
                                                            dist);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K6a's launch shape: CTAs a cluster, threads a CTA, CTAs a launch.
LO_EXPORT void lo_point_grid_shape(int* out) {
  out[0] = GRID_CLUSTER;
  out[1] = GRID_THREADS;
  out[2] = GRID_CLUSTER * GRID_CLUSTERS;
}

LO_EXPORT int lo_point_grid(const long long* key_s, const float* pts_s, int c, float inv,
                            int* grid, int* meta, void* stream) {
  if (c < 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)grid & 15) return (int)cudaErrorMisalignedAddress;   // 16-byte fill
  return (int)lo::launch_clusters(point_grid_kernel, GRID_CLUSTER * GRID_CLUSTERS, GRID_THREADS,
                                  GRID_CLUSTER, (cudaStream_t)stream, key_s, pts_s, c, inv,
                                  (int4*)grid, meta);
}

LO_EXPORT int lo_point_knn(const float* q, int n, const int* flags, const long long* key_s,
                           const float* pts_s, int c, const int* grid, const int* meta,
                           float inv, int radius, int width, float* nb, bool* ok,
                           float* dist, void* stream) {
  return launch_knn<5>(q, n, flags, key_s, pts_s, c, grid, meta, inv, radius, width, nb, ok,
                       dist, stream);
}

LO_EXPORT int lo_point_nn1(const float* q, int n, const int* flags, const long long* key_s,
                           const float* pts_s, int c, const int* grid, const int* meta,
                           float inv, int radius, int width, float* nb, bool* ok,
                           float* dist, void* stream) {
  return launch_knn<1>(q, n, flags, key_s, pts_s, c, grid, meta, inv, radius, width, nb, ok,
                       dist, stream);
}
