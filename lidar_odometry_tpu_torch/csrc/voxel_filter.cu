// K1 voxel_filter: per-voxel centroids of key-sorted scan points.
//
// Replaces: the JAX package's ops/voxel_filter.py:50 voxel_filter, the part
// after the key sort (segment starts, counts, prefix-sum differences of
// corner-relative coordinates, padded centroid output). The sort itself is
// torch.sort on the int64 key.
//
// Bound on the H100: the work is ~16k points x 28 B in and 14k x 13 B out,
// about 0.6 MB, so the memory bound is ~0.2 us; the kernel is bound by
// latency: a launch, a few dependent global round trips and the walk of
// the longest segment.
//
// Design: a grid of CTAs over the sorted array (gridDim.y = B lanes, each
// lane's pointers offset to its rows, so lane b of a B-lane launch is
// bit-identical to a one-lane launch on lane b's inputs). A CTA takes a
// tile of THREADS sorted entries, one entry a thread: the loads of key_s
// and perm are coalesced, and every thread gathers its point through perm
// at once, into shared memory.
// Segment starts (key_s[i] != key_s[i-1], INVALID_KEY sorting last and
// never starting one) are numbered by a warp ballot, a scan of the warp
// counts and a decoupled look-back over the lane's tile descriptors
// (status and count in one 64-bit word: aggregate, then inclusive prefix).
// The thread holding a segment's first entry walks the segment in sorted
// order, from shared memory and past the tile's end from global memory,
// summing exact counts and coordinates relative to the voxel corner (which
// keeps magnitudes below the voxel size, so the float sum loses nothing to
// world-scale coordinates) with __fadd_rn / __fsub_rn, the order and
// rounding of the one-block design it replaces, and writes the centroid
// and its mask entry. Segments past the output capacity are dropped; the
// count still reports every voxel. The CTA that holds a lane's last tile
// knows the lane's total from its inclusive prefix and writes the count
// and the empty rows [total, cap).
//
// Scratch: the descriptors, the lane tickets and a done counter, which the
// last CTA to finish (a threadfence and the done ticket) sets back to zero,
// so the wrapper's buffer is zero before every launch with no memset launch.
// The grid is one CTA a tile and lane. A CTA takes its tile from the lane's
// ticket when it starts, so tiles are handed out in the order the CTAs
// run: a look-back only ever waits on a CTA that is already running, however
// many CTAs the card holds at once and whatever else it runs.
#include "common.cuh"

namespace {

constexpr long long INVALID_KEY = 0x7FFFFFFFFFFFFFFFLL;
constexpr int THREADS = 512;   // entries a tile, one a thread
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long ST_AGG = 1ull << 32;      // the tile's own count
constexpr unsigned long long ST_PREFIX = 2ull << 32;   // the count through the tile

__device__ __forceinline__ unsigned long long load_desc(const unsigned long long* p) {
  return *(volatile const unsigned long long*)p;
}

__device__ __forceinline__ void store_desc(unsigned long long* p, unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// Segment starts before tile t of a lane: the sum of the predecessors'
// counts back to the nearest inclusive prefix, 32 descriptors at a time.
// Run by one whole warp; every lane returns the sum.
__device__ int look_back(const unsigned long long* desc, int t, int ln) {
  int excl = 0;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - ln;
    unsigned long long d = idx >= 0 ? load_desc(desc + idx) : ST_PREFIX;
    while (__any_sync(FULL, (d >> 32) == 0))
      if ((d >> 32) == 0) d = load_desc(desc + idx);
    const unsigned pre = __ballot_sync(FULL, (d >> 32) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    int v = ln <= stop ? (int)(d & 0xffffffffu) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    excl += v;
    if (pre) return excl;
  }
}

__global__ void __launch_bounds__(THREADS)
voxel_filter_kernel(const long long* __restrict__ key_s, const long long* __restrict__ perm,
                    const float* __restrict__ pts, int n, int cap, float inv,
                    float voxel, float* __restrict__ cent, bool* __restrict__ mask,
                    int* __restrict__ n_voxels, unsigned long long* __restrict__ scratch) {
  __shared__ long long skey[THREADS];
  __shared__ float sp[3][THREADS];
  __shared__ int wsum[WARPS];
  __shared__ int s_tile, s_excl, s_total;
  __shared__ bool s_last;
  const int lane_ix = blockIdx.y, lanes = gridDim.y, tiles = gridDim.x;
  const int tid = threadIdx.x, wid = tid >> 5, ln = tid & 31;
  unsigned long long* desc = scratch + (size_t)lane_ix * tiles;
  unsigned long long* ticket = scratch + (size_t)lanes * tiles + lane_ix;
  unsigned long long* done = scratch + (size_t)lanes * tiles + lanes;
  key_s += (size_t)lane_ix * n;
  perm += (size_t)lane_ix * n;
  pts += (size_t)lane_ix * n * 3;
  cent += (size_t)lane_ix * cap * 3;
  mask += (size_t)lane_ix * cap;

  if (tid == 0) s_tile = (int)atomicAdd(ticket, 1ull);
  __syncthreads();
  const int t = s_tile;
  const int base = t * THREADS, i = base + tid;
  const long long k = i < n ? key_s[i] : INVALID_KEY;
  const long long kprev = i > 0 && i < n ? key_s[i - 1] : INVALID_KEY;
  const bool start = k != INVALID_KEY && (i == 0 || kprev != k);
  skey[tid] = k;
  if (k != INVALID_KEY) {
    const float* p = pts + 3 * perm[i];
    sp[0][tid] = p[0];
    sp[1][tid] = p[1];
    sp[2][tid] = p[2];
  }
  // number the starts: warp ballots, a scan of the warp counts, look-back
  const unsigned bal = __ballot_sync(FULL, start);
  if (ln == 0) wsum[wid] = __popc(bal);
  __syncthreads();
  if (wid == 0) {
    const int c = ln < WARPS ? wsum[ln] : 0;
    int v = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, v, o);
      if (ln >= o) v += u;
    }
    const int agg = __shfl_sync(FULL, v, 31);
    if (ln < WARPS) wsum[ln] = v - c;
    int excl = 0;
    if (t == 0) {
      if (ln == 0) store_desc(desc, ST_PREFIX | (unsigned)agg);
    } else {
      if (ln == 0) store_desc(desc + t, ST_AGG | (unsigned)agg);
      excl = look_back(desc, t, ln);
      if (ln == 0) store_desc(desc + t, ST_PREFIX | (unsigned)(excl + agg));
    }
    if (ln == 0) {
      s_excl = excl;
      s_total = excl + agg;   // the lane's count when t is its last tile
    }
  }
  __syncthreads();
  const int s = s_excl + wsum[wid] + __popc(bal & ((1u << ln) - 1u));
  if (start && s < cap) {
    mask[s] = true;
    float corner[3], sum[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < 3; ++d) corner[d] = __fmul_rn(floorf(__fmul_rn(sp[d][tid], inv)), voxel);
    float cnt = 0.f;
    for (int j = i; j < n; ++j) {
      const int jl = j - base;
      float p[3];
      if (jl < THREADS) {
        if (skey[jl] != k) break;
        p[0] = sp[0][jl];
        p[1] = sp[1][jl];
        p[2] = sp[2][jl];
      } else {
        if (key_s[j] != k) break;
        const float* q = pts + 3 * perm[j];
        p[0] = q[0];
        p[1] = q[1];
        p[2] = q[2];
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) sum[d] = __fadd_rn(sum[d], __fsub_rn(p[d], corner[d]));
      cnt += 1.0f;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) cent[3 * s + d] = __fadd_rn(corner[d], sum[d] / fmaxf(cnt, 1.0f));
  }
  if (t == tiles - 1) {   // the lane's total is known: the count and the empty rows
    const int total = s_total;
    if (tid == 0) n_voxels[lane_ix] = total;
    for (int q = total + tid; q < cap; q += THREADS) {
      mask[q] = false;
      cent[3 * q] = 0.f;
      cent[3 * q + 1] = 0.f;
      cent[3 * q + 2] = 0.f;
    }
  }

  // the last CTA to finish sets the scratch back to zero for the next launch
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1ull) == (unsigned long long)tiles * lanes - 1;
  }
  __syncthreads();
  if (s_last)
    for (size_t q = tid; q < (size_t)lanes * tiles + lanes + 1; q += THREADS) scratch[q] = 0ull;
}

}  // namespace

// scratch: lanes * tiles + lanes + 1 zeroed 64-bit words (tiles =
// max(1, ceil(n / THREADS))), left zeroed by the launch.
LO_EXPORT int lo_voxel_filter(const long long* key_s, const long long* perm, const float* pts,
                              int n, int lanes, int cap, float inv, float voxel, float* cent,
                              bool* mask, int* n_voxels, unsigned long long* scratch,
                              void* stream) {
  const int tiles = max(1, (n + THREADS - 1) / THREADS);
  const dim3 grid(tiles, lanes);
  voxel_filter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      key_s, perm, pts, n, cap, inv, voxel, cent, mask, n_voxels, scratch);
  return (int)cudaGetLastError();
}
