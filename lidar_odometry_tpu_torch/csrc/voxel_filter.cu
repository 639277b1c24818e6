// K1 voxel_filter: per-voxel centroids of key-sorted scan points.
//
// Replaces: the JAX package's ops/voxel_filter.py:50 voxel_filter, the part
// after the key sort (segment starts, counts, prefix-sum differences of
// corner-relative coordinates, padded centroid output). The sort itself is
// torch.sort on the int64 key.
//
// Bound on the H100: the work is ~16k points x 28 B in and 14k x 13 B out,
// about 0.6 MB, so the memory bound is ~0.2 us and the kernel is bound by
// launch latency and by the serial block scan, not by bytes or flops.
//
// Lanes: B independent scans (the blocked multi-sequence runner, JAX
// voxel_filter under vmap) take one block each (gridDim.x = B); block b
// offsets every pointer to lane b's rows and then runs the single-scan
// body unchanged, so lane b of a B-lane launch is bit-identical to a
// one-lane launch on lane b's inputs. The single-stream filter is B = 1.
//
// Design: ONE block of 1024 threads per lane. Each thread owns a
// contiguous chunk of the sorted array, counts the segment starts in it, and a block scan
// turns the counts into segment numbers. The thread then walks the run of
// every segment that starts in its chunk, summing exact integer counts and
// coordinates relative to the voxel corner (which keeps magnitudes below
// the voxel size, so the float sum loses nothing to world-scale
// coordinates), and writes the centroid. Segments past the output
// capacity are dropped; the count still reports every voxel. One block
// means no second pass and no atomics: at this size a grid would spend
// more on its cross-block scan than it saves.
#include "common.cuh"

namespace {

constexpr long long INVALID_KEY = 0x7FFFFFFFFFFFFFFFLL;
constexpr int THREADS = 1024;

__device__ __forceinline__ bool is_start(const long long* key_s, int i) {
  const long long k = key_s[i];
  return k != INVALID_KEY && (i == 0 || key_s[i - 1] != k);
}

__global__ void __launch_bounds__(THREADS)
voxel_filter_kernel(const long long* __restrict__ key_s, const long long* __restrict__ perm,
                    const float* __restrict__ pts, int n, int cap, float inv, float voxel,
                    float* __restrict__ cent, bool* __restrict__ mask, int* __restrict__ n_voxels) {
  __shared__ int scan[THREADS];
  const size_t lane_ix = blockIdx.x;
  key_s += lane_ix * n;
  perm += lane_ix * n;
  pts += lane_ix * n * 3;
  cent += lane_ix * cap * 3;
  mask += lane_ix * cap;
  n_voxels += lane_ix;
  const int t = threadIdx.x;
  const int chunk = (n + THREADS - 1) / THREADS;
  const int b0 = min(n, t * chunk);
  const int b1 = min(n, b0 + chunk);

  int c = 0;
  for (int i = b0; i < b1; ++i) c += is_start(key_s, i);
  const int incl = lo::block_inclusive_scan(c, scan);
  const int total = scan[THREADS - 1];
  int s = incl - c;

  for (int i = b0; i < b1; ++i) {
    if (!is_start(key_s, i)) continue;
    if (s < cap) {
      const long long k = key_s[i];
      const float* p0 = pts + 3 * perm[i];
      float corner[3], sum[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < 3; ++d) corner[d] = __fmul_rn(floorf(__fmul_rn(p0[d], inv)), voxel);
      float cnt = 0.f;
      for (int j = i; j < n && key_s[j] == k; ++j) {
        const float* p = pts + 3 * perm[j];
#pragma unroll
        for (int d = 0; d < 3; ++d) sum[d] = __fadd_rn(sum[d], __fsub_rn(p[d], corner[d]));
        cnt += 1.0f;
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) cent[3 * s + d] = __fadd_rn(corner[d], sum[d] / fmaxf(cnt, 1.0f));
    }
    ++s;
  }
  if (t == 0) *n_voxels = total;
  for (int k = t; k < cap; k += THREADS) {
    const bool live = k < total;
    mask[k] = live;
    if (!live) {
      cent[3 * k] = 0.f;
      cent[3 * k + 1] = 0.f;
      cent[3 * k + 2] = 0.f;
    }
  }
}

}  // namespace

LO_EXPORT int lo_voxel_filter(const long long* key_s, const long long* perm, const float* pts,
                              int n, int lanes, int cap, float inv, float voxel, float* cent,
                              bool* mask, int* n_voxels, void* stream) {
  voxel_filter_kernel<<<lanes, THREADS, 0, (cudaStream_t)stream>>>(key_s, perm, pts, n, cap,
                                                                   inv, voxel, cent, mask,
                                                                   n_voxels);
  return (int)cudaGetLastError();
}
