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
//    reads a launch: far below both bounds; the random reads into the
//    table (which stays in L2) and the per-thread top-k bound it. Design:
//    one thread per query walks the bins in the JAX offset order, keeps a
//    register top-k sorted by (squared distance, candidate index), which is
//    jax.lax.top_k's order on ties, and writes only the k winners: the
//    (N, M*W) candidate tensor of the JAX program never reaches memory. A
//    device flag returns a finished solve's launch at once. Two entry
//    points of one template: point_knn (k = 5, the plane fits) and
//    point_nn1 (k = 1, the inlier ratio).
#include "common.cuh"

namespace {

constexpr int GX = 128, GY = 128, GZ = 32;
constexpr int GRID_THREADS = 1024;
constexpr int KNN_THREADS = 128;
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

template <int K>
__global__ void __launch_bounds__(KNN_THREADS)
point_knn_kernel(const float* __restrict__ q, int n, const int* __restrict__ flags,
                 const long long* __restrict__ key_s, const float* __restrict__ pts_s, int c,
                 const int* __restrict__ grid, const int* __restrict__ meta, float inv,
                 int radius, int width, float* __restrict__ nb, bool* __restrict__ ok_out,
                 float* __restrict__ dist) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || (flags != nullptr && flags[0])) return;
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  const int cx = vcoord(qx, inv), cy = vcoord(qy, inv), cz = vcoord(qz, inv);
  const bool fits = meta[3] != 0;
  const int ox = meta[0], oy = meta[1], oz = meta[2];
  float bd[K];
  int bi[K], bg[K];
  bool bo[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0x7FFFFFFF;
    bg[j] = c - 1;
    bo[j] = false;
  }
  int m = 0;
  for (int dx = -radius; dx <= radius; ++dx)
    for (int dy = -radius; dy <= radius; ++dy)
      for (int dz = -radius; dz <= radius; ++dz, ++m) {
        const int bx = cx + dx, by = cy + dy, bz = cz + dz;
        const long long key = sort_key(bx, by, bz);
        int start;
        if (fits) {
          const int lx = bx - ox, ly = by - oy, lz = bz - oz;
          const bool inside = lx >= 0 && lx < GX && ly >= 0 && ly < GY && lz >= 0 && lz < GZ;
          start = inside ? grid[(lx * GY + ly) * GZ + lz] : c;
        } else {
          start = lower_bound(key_s, c, key);
        }
        for (int w = 0; w < width; ++w) {
          const int g = min(start + w, c - 1);
          const long long kg = key_s[g];
          const bool okc = kg == key && kg != INVALID_KEY;
          float d2 = INFINITY;
          if (okc) {
            const float ex = __fsub_rn(pts_s[3 * g], qx);
            const float ey = __fsub_rn(pts_s[3 * g + 1], qy);
            const float ez = __fsub_rn(pts_s[3 * g + 2], qz);
            d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
          }
          const int idx = m * width + w;
          // insert (d2, idx) into the list kept sorted by (distance, index)
          if (!(d2 < bd[K - 1] || (d2 == bd[K - 1] && idx < bi[K - 1]))) continue;
          int p = K - 1;
          while (p > 0 && (d2 < bd[p - 1] || (d2 == bd[p - 1] && idx < bi[p - 1]))) {
            bd[p] = bd[p - 1];
            bi[p] = bi[p - 1];
            bg[p] = bg[p - 1];
            bo[p] = bo[p - 1];
            --p;
          }
          bd[p] = d2;
          bi[p] = idx;
          bg[p] = g;
          bo[p] = okc;
        }
      }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t o = (size_t)i * K + j;
    nb[3 * o] = pts_s[3 * bg[j]];
    nb[3 * o + 1] = pts_s[3 * bg[j] + 1];
    nb[3 * o + 2] = pts_s[3 * bg[j] + 2];
    ok_out[o] = bo[j];
    dist[o] = bo[j] ? sqrtf(fmaxf(bd[j], 0.f)) : INFINITY;
  }
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
  point_knn_kernel<5><<<max(1, (n + KNN_THREADS - 1) / KNN_THREADS), KNN_THREADS, 0,
                        (cudaStream_t)stream>>>(q, n, flags, key_s, pts_s, c, grid, meta, inv,
                                                radius, width, nb, ok, dist);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_point_nn1(const float* q, int n, const int* flags, const long long* key_s,
                           const float* pts_s, int c, const int* grid, const int* meta,
                           float inv, int radius, int width, float* nb, bool* ok,
                           float* dist, void* stream) {
  point_knn_kernel<1><<<max(1, (n + KNN_THREADS - 1) / KNN_THREADS), KNN_THREADS, 0,
                        (cudaStream_t)stream>>>(q, n, flags, key_s, pts_s, c, grid, meta, inv,
                                                radius, width, nb, ok, dist);
  return (int)cudaGetLastError();
}
