// K9 map rehash after a pose-graph correction: map_bulk_index (K9a, the
// fresh index's slots, bucket cells and rows) and map_bulk_merge (K9b, the
// merge and child-row scatter).
//
// Replaces: the JAX package's ops/voxel_map.py:1029 bulk_build as
// transform_and_rehash (:992) calls it — _bulk_index (:967: each distinct
// parent's rank in its bucket, its slot from the running count of placed
// parents) with _write_bulk (:1138) and the meta rows (:1096-1102) in K9a;
// the same-key merge (the segment sums of count and weighted centroid,
// :1048-1070) and the child scatter (_bucket_find of each merged voxel's
// parent in the fresh index and the four unique row writes, :1104-1117) in
// K9b. The sorts stay torch.sort (lax.sort on the JAX side); the record keys,
// the bucket hash that the sort orders by and the compaction of the distinct
// parents are elementwise torch and prefix sums (ops/voxel_map.py
// bulk_plan); the surfel recompute of every slot is K4c (csrc/voxel_map.cu).
//
// Bounds on the H100 (c1 = 65536 parents, up to 4 c1 = 262144 live records):
//  * map_bulk_index reads the sorted bucket keys and permutation (16 B a
//    parent) and the keys (8 B), writes and rereads one int a parent and
//    writes 12 B of index and 16 B of meta a placed parent: ~3.9 MB, ~1.2 us.
//    Design: one block of 1024 threads. Each sorted position finds its cell
//    by walking back over at most 8 equal bucket keys (a cell past 8 is not
//    placed), and writes it by original index; after a block barrier each
//    thread takes a contiguous run of original indices, a block scan of the
//    per-thread counts gives every placed parent its rank, hence its slot
//    (counting down from the top, as the JAX free stack), and the thread
//    writes the index cell (slot, hi, lo) and the meta row. One launch
//    replaces a scatter, a cummax, a cumsum and five scatters.
//  * map_bulk_merge: the records in key order (8 + 8 B of key and index,
//    16 B of count and centroid read through the index), one probe of a
//    128-B bucket row per merged voxel, and 16 B written per merged voxel:
//    ~12 MB at most, ~3.6 us at 3.35 TB/s. The reads through the sort
//    permutation are random, so latency bounds it in practice. Design: one
//    thread per merged voxel (a run leader in the sorted order) sums its run
//    in that order — the order of the JAX segment sum, so the totals come
//    out the same — derives its parent key and child offset from the run's
//    key, probes the new index with the bucket probe of common.cuh and
//    writes its child row: the merged records of the JAX program (c0 x 4
//    floats and two key arrays) never reach memory, and the placed /
//    dropped counts are two atomics on the device.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int INDEX_THREADS = 1024;

// b_s (n,): the parents' bucket keys in sorted order, n_buckets for a dead
// entry; i_s (n,): the sort permutation; khi, klo (n,): the parent keys by
// original index (as int32 bits). cp (n,) is scratch: each parent's cell position b * 8 +
// cell, or -1 when it is not placed.
__global__ void __launch_bounds__(INDEX_THREADS)
bulk_index_kernel(const long long* __restrict__ b_s, const long long* __restrict__ i_s,
                  const int* __restrict__ khi, const int* __restrict__ klo, int n, int n_buckets,
                  int slot_from_top, int* __restrict__ cp, int* __restrict__ index,
                  int* __restrict__ meta, int* __restrict__ n_placed) {
  __shared__ int buf[INDEX_THREADS];
  for (int p = threadIdx.x; p < n; p += INDEX_THREADS) {
    const long long b = b_s[p];
    int c = 0;
    while (c < lo::BUCKET && p - c > 0 && b_s[p - c - 1] == b) ++c;
    cp[i_s[p]] = (b < n_buckets && c < lo::BUCKET) ? (int)b * lo::BUCKET + c : -1;
  }
  __syncthreads();
  const int per = (n + INDEX_THREADS - 1) / INDEX_THREADS;
  const int i0 = min(n, (int)threadIdx.x * per), i1 = min(n, i0 + per);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += cp[i] >= 0;
  int rank = lo::block_inclusive_scan(mine, buf) - mine;
  for (int i = i0; i < i1; ++i) {
    const int c = cp[i];
    if (c < 0) continue;
    if (rank < slot_from_top) {
      const int slot = slot_from_top - 1 - rank;
      int* cell = index + (size_t)(c >> 3) * lo::ROW + (c & 7);
      cell[0] = slot;
      cell[lo::BUCKET] = khi[i];
      cell[2 * lo::BUCKET] = klo[i];
      int4* row = (int4*)meta + slot;
      *row = make_int4(khi[i], klo[i], -1, c);
    }
    ++rank;
  }
  if (threadIdx.x == 0) *n_placed = min(buf[INDEX_THREADS - 1], slot_from_top);
}

__device__ __forceinline__ int floordiv3(int a) { return a >= 0 ? a / 3 : -((2 - a) / 3); }

__global__ void __launch_bounds__(THREADS)
bulk_merge_kernel(const long long* __restrict__ s_key, const long long* __restrict__ s_idx,
                  const bool* __restrict__ first, const float* __restrict__ cnt,
                  const float* __restrict__ cen, int m, const int* __restrict__ index,
                  int n_buckets, float4* __restrict__ l0, int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m || !first[i]) return;
  const long long key = s_key[i];
  float c = 0.f, x = 0.f, y = 0.f, z = 0.f;
  int j = i;
  do {
    const long long r = s_idx[j];
    const float w = cnt[r];
    c = __fadd_rn(c, w);
    x = __fadd_rn(x, __fmul_rn(cen[3 * r], w));
    y = __fadd_rn(y, __fmul_rn(cen[3 * r + 1], w));
    z = __fadd_rn(z, __fmul_rn(cen[3 * r + 2], w));
    ++j;
  } while (j < m && s_key[j] == key);
  // the run's voxel, its parent and child offset (floor division by 3)
  const int iz = (int)(key >> 32);
  const unsigned int klo = (unsigned int)(key & 0xFFFFFFFFLL);
  const int ix = (int)(klo >> 16) - 32768, iy = (int)(klo & 0xFFFFu) - 32768;
  const int px = floordiv3(ix), py = floordiv3(iy), pz = floordiv3(iz);
  uint32_t phi, plo;
  lo::pack_key(px, py, pz, phi, plo);
  const int slot = lo::probe(index, (uint32_t)(n_buckets - 1), phi, plo);
  if (slot < 0) {
    atomicAdd(counts + 1, 1);
    return;
  }
  const int off = ((ix - 3 * px) * 3 + (iy - 3 * py)) * 3 + (iz - 3 * pz);
  l0[(size_t)slot * lo::NCH + off] = make_float4(c, x, y, z);
  atomicAdd(counts, 1);
}

}  // namespace

LO_EXPORT int lo_map_bulk_index(const long long* b_s, const long long* i_s, const int* khi,
                                const int* klo, int n, int n_buckets, int slot_from_top, int* cp,
                                int* index, int* meta, int* n_placed, void* stream) {
  bulk_index_kernel<<<1, INDEX_THREADS, 0, (cudaStream_t)stream>>>(
      b_s, i_s, khi, klo, n, n_buckets, slot_from_top, cp, index, meta, n_placed);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_map_bulk_merge(const long long* s_key, const long long* s_idx, const bool* first,
                                const float* cnt, const float* cen, int m, const int* index,
                                int n_buckets, float* l0, int* counts, void* stream) {
  bulk_merge_kernel<<<max(1, (m + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      s_key, s_idx, first, cnt, cen, m, index, n_buckets, (float4*)l0, counts);
  return (int)cudaGetLastError();
}
