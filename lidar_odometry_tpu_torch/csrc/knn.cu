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
//    (2 MB, filled by the wrapper) at the first index of each occupied bin:
//    ~0.1 MB of reads, latency-bound. Design: one block of 1024 threads, a
//    block min/max of the bin coordinates in shared memory (the window
//    origin and the fits flag stay on the device), then a second pass that
//    writes each bin's first sorted index: no host read, one launch.
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
#include "common.cuh"

namespace {

constexpr int GX = 128, GY = 128, GZ = 32;
constexpr int GRID_THREADS = 1024;
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

__global__ void __launch_bounds__(GRID_THREADS)
point_grid_kernel(const long long* __restrict__ key_s, const float* __restrict__ pts_s, int c,
                  float inv, int* __restrict__ grid, int* __restrict__ meta) {
  __shared__ int smin[3], smax[3], scount;
  const int tid = threadIdx.x;
  if (tid < 3) {
    smin[tid] = BIG;
    smax[tid] = -BIG;
  }
  if (tid == 0) scount = 0;
  __syncthreads();
  int mn[3] = {BIG, BIG, BIG}, mx[3] = {-BIG, -BIG, -BIG}, cnt = 0;
  for (int i = tid; i < c; i += blockDim.x) {
    if (key_s[i] == INVALID_KEY) continue;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int v = vcoord(pts_s[3 * i + d], inv);
      mn[d] = min(mn[d], v);
      mx[d] = max(mx[d], v);
    }
    ++cnt;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    atomicMin(&smin[d], mn[d]);
    atomicMax(&smax[d], mx[d]);
  }
  atomicAdd(&scount, cnt);
  __syncthreads();
  const int o[3] = {smin[0], smin[1], smin[2]};
  const bool fits = scount > 0 && smax[0] - o[0] < GX && smax[1] - o[1] < GY &&
                    smax[2] - o[2] < GZ;
  if (tid == 0) {
    meta[0] = o[0];
    meta[1] = o[1];
    meta[2] = o[2];
    meta[3] = fits;
    meta[4] = scount;
  }
  for (int i = tid; i < c; i += blockDim.x) {
    const long long k = key_s[i];
    if (k == INVALID_KEY || (i > 0 && key_s[i - 1] == k)) continue;
    const int lx = vcoord(pts_s[3 * i], inv) - o[0];
    const int ly = vcoord(pts_s[3 * i + 1], inv) - o[1];
    const int lz = vcoord(pts_s[3 * i + 2], inv) - o[2];
    if (lx < 0 || lx >= GX || ly < 0 || ly >= GY || lz < 0 || lz >= GZ) continue;
    grid[(lx * GY + ly) * GZ + lz] = i;
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

LO_EXPORT int lo_point_grid(const long long* key_s, const float* pts_s, int c, float inv,
                            int* grid, int* meta, void* stream) {
  point_grid_kernel<<<1, GRID_THREADS, 0, (cudaStream_t)stream>>>(key_s, pts_s, c, inv, grid,
                                                                   meta);
  return (int)cudaGetLastError();
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
