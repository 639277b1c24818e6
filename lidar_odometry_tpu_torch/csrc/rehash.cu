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
//  * map_bulk_index reads the live parents' sorted bucket keys and
//    permutation (16 B each; the dead sort after them) and the placed
//    parents' keys (8 B), and writes 12 B of index and 16 B of meta a
//    placed parent: ~0.5 MB, ~0.15 us at the surfel map's ~9800 parents;
//    its dependent rounds and the placed parents' scattered stores bound
//    it. Design: one thread-block
//    cluster of INDEX_CLUSTER CTAs x INDEX_THREADS (16 x 1024, a
//    non-portable size; an error where the card refuses it). The walk: a
//    CTA stages 4 runs of 1024 sorted bucket keys (and the 8 before each)
//    in shared memory, the runs dealt over the cluster so that the live
//    parents, which sort first, spread over it; each sorted position finds
//    its cell by walking back over at most 8 equal keys there (a cell past
//    8 is not placed) and stores its cell position at its original index
//    in a global scratch of n ints (256 KB at c1 = 65536, L2-resident;
//    rounds of 65536 positions). The count: the original indices
//    are dealt to the CTAs in chunks of 128, a warp a chunk, 4 neighbouring
//    indices a lane, so that the placed parents (a rehash's are a prefix
//    of the indices) spread over every CTA's stores (scattered stores from
//    one SM cost ~1.4 ns each); after a cluster barrier a warp scan gives
//    each lane its rank in its chunk, the chunk counts are exchanged
//    through distributed shared memory, and one warp's scan over them
//    gives each chunk its offset: rank = placed entries of lower index,
//    hence the slot (counting down from the top, as the JAX free stack).
//    Each thread writes its index cells (slot, hi, lo) and meta rows; the
//    last CTA writes the count. One launch replaces a scatter, a cummax, a
//    cumsum and five scatters.
//  * map_bulk_merge: the live records' flags, keys and indices in key
//    order (17 B), their count and centroid (16 B, read through the
//    index), one dead key (where they end: dead records sort last, and
//    the rest is not read), one probe of a 128-B bucket row per merged
//    voxel and 16 B written per merged voxel: 6.1 MB at the surfel map's
//    262144 records (38045 live, 33984 merged voxels), ~1.8 us at 3.35
//    TB/s; 1.5 MB at a sharded shard's 1769472 records (9340 live, 8267
//    merged voxels), ~0.45 us. The reads through the sort permutation are
//    random, and each run of equal keys is a chain of reads, so the
//    dependent load rounds bound it in practice. Design: a warp a tile of
//    32 sorted records, a lane a record, the tiles dealt over the warps of
//    at most four CTAs an SM. Round 1: the tile's run-leader flags and its
//    first key (a tile whose first key is dead lies past every live
//    record, since dead keys sort last: the warp stops there), and the
//    same for the warp's next tile. Round 2, in a tile with a leader:
//    every lane's key and sort index, and in lanes below MERGE_EXTRA those
//    of the MERGE_EXTRA records after the tile. Round 3: each record's
//    count and centroid through its index, and each leader's probe of the
//    fresh index (its parent key needs only its own key). (Reading the
//    first tile's keys and indices with its flags, whether it is live or
//    not, saved no time and cost a stack.) Past ~1 us of dependent rounds
//    the random 32-byte sectors of the gathers and probes take the time.
//    A leader then sums its run from its neighbours' registers by
//    shuffles, in the run's order (the order of the JAX segment sum, so
//    the totals come out the same); only a run that goes on past the
//    MERGE_EXTRA records after the tile continues with a serial loop. The
//    leader writes its child row: the merged records of the JAX program
//    (c0 x 4 floats and two key arrays) never reach memory. The placed and
//    dropped counts are summed in the CTA; each is added, with a ticket in
//    its high half, into its own 64-bit word of a scratch that the wrapper
//    keeps zeroed (K1's way): the CTA that draws a word's last ticket
//    holds that count's total, writes it and sets the word back to zero,
//    so no fill is launched before a call. (One word for the ticket and
//    both counts left 24 bits a count, M < 2^24; a fence between the
//    counts' word and a ticket's word cost ~1.2 us.)
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int INDEX_CLUSTER = 16;                        // CTAs of K9a's cluster
constexpr int INDEX_THREADS = 1024;                      // threads a CTA
constexpr int INDEX_WARPS = INDEX_THREADS / 32;
constexpr int INDEX_RUN = lo::BUCKET + INDEX_THREADS;     // a staged run of keys, 8 before it
constexpr int INDEX_CHUNK = 128;                         // original indices a warp counts: 4 a lane
constexpr int INDEX_TILE = INDEX_CLUSTER * INDEX_WARPS * INDEX_CHUNK;   // indices a round: 65536

// How load4 reads: the read-only path (inputs), or L2 (the scratch that
// other CTAs of the launch wrote).
enum Via { INPUT, L2 };

template <Via V>
__device__ __forceinline__ int4 ld16(const int* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  return V == INPUT ? __ldg(q) : __ldcg(q);
}

template <Via V>
__device__ __forceinline__ int ld4(const int* p) {
  return V == INPUT ? __ldg(p) : __ldcg(p);
}

// p[i .. i + 3] (p + i 16-byte aligned) as one 16-byte load where all four
// lie below `end`; `fill` past it.
template <Via V>
__device__ __forceinline__ void load4(const int* p, int i, int end, int fill, int (&v)[4]) {
  if (i + 4 <= end) {
    const int4 q = ld16<V>(p + i);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < end ? ld4<V>(p + i + j) : fill;
  }
}

// The index cells and meta rows of four neighbouring original indices:
// their cell positions c, key bits kh and kl, `rank` the placed entries of
// lower index.
__device__ __forceinline__ void write4(const int (&c)[4], const int (&kh)[4], const int (&kl)[4],
                                       int rank, int slot_from_top, int* __restrict__ index,
                                       int* __restrict__ meta) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c[j] < 0) continue;
    if (rank < slot_from_top) {
      const int slot = slot_from_top - 1 - rank;
      int* cell = index + (size_t)(c[j] >> 3) * lo::ROW + (c[j] & 7);
      cell[0] = slot;
      cell[lo::BUCKET] = kh[j];
      cell[2 * lo::BUCKET] = kl[j];
      reinterpret_cast<int4*>(meta)[slot] = make_int4(kh[j], kl[j], -1, c[j]);
    }
    ++rank;
  }
}

// b_s (n,): the parents' bucket keys in sorted order, n_buckets for a dead
// entry; i_s (n,): the sort permutation; khi, klo (n,): the parent keys by
// original index (as int32 bits, 16-byte aligned). A position's cell
// position is b * 8 + cell, or -1 where it is not placed; cp (n,) is the
// scratch that holds them by original index.
//
// Both phases go in rounds of INDEX_TILE, dealt to the CTAs so that the
// live parents (which sort first, and of a rehash are a prefix of the
// indices) spread over the cluster. The walk: CTA r takes the round's runs
// 16 j + r (j < 4) of INDEX_THREADS sorted positions. The count and the
// writes: chunk q of INDEX_CHUNK original indices goes to CTA q % 16, its
// warp q / 16.
__global__ void __launch_bounds__(INDEX_THREADS)
bulk_index_kernel(const long long* __restrict__ b_s, const long long* __restrict__ i_s,
                  const int* __restrict__ khi, const int* __restrict__ klo, int n, int n_buckets,
                  int slot_from_top, int* __restrict__ cp, int* __restrict__ index,
                  int* __restrict__ meta, int* __restrict__ n_placed) {
  namespace cg = cooperative_groups;
  __shared__ int bs[4 * INDEX_RUN];                    // 4 runs of bucket keys, 8 before each
  __shared__ int wt[INDEX_WARPS];                      // this CTA's chunk counts, read by all
  __shared__ int all[INDEX_CLUSTER * INDEX_WARPS];     // every CTA's chunk counts of the round
  __shared__ int off[INDEX_WARPS + 1];                 // each warp's offset; the round's total
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the sorted positions and the original indices go in rounds of
  // INDEX_TILE; in a round every CTA takes 4 runs of INDEX_THREADS sorted
  // positions (run 16 j + rank), and the live parents, which sort first,
  // spread over the cluster
  const int rounds = max(1, (n + INDEX_TILE - 1) / INDEX_TILE);
  // ---- walk
  for (int t = 0; t < rounds; ++t) {
    // each run's permutation entries and bucket keys, and the 8 keys
    // before it, all loads in one round
    long long ix[4], bk[4], before = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = t * INDEX_TILE + ((j * INDEX_CLUSTER + rank) * INDEX_THREADS) + tid;
      ix[j] = p < n ? __ldg(i_s + p) : 0;
      bk[j] = p < n ? __ldg(b_s + p) : -1;
    }
    if (tid < 4 * lo::BUCKET) {
      const int g = t * INDEX_TILE + (((tid / lo::BUCKET) * INDEX_CLUSTER + rank) * INDEX_THREADS)
                    - lo::BUCKET + tid % lo::BUCKET;
      before = g >= 0 && g < n ? __ldg(b_s + g) : -1;
    }
    if (tid < 4 * lo::BUCKET) bs[(tid / lo::BUCKET) * INDEX_RUN + tid % lo::BUCKET] = (int)before;
#pragma unroll
    for (int j = 0; j < 4; ++j) bs[j * INDEX_RUN + lo::BUCKET + tid] = (int)bk[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = t * INDEX_TILE + ((j * INDEX_CLUSTER + rank) * INDEX_THREADS) + tid;
      if (p >= n) break;
      const int* run = bs + j * INDEX_RUN + lo::BUCKET + tid;
      const int b = run[0];
      int c = 0;
      while (c < lo::BUCKET && run[-1 - c] == b) ++c;
      cp[ix[j]] = (b < n_buckets && c < lo::BUCKET) ? b * lo::BUCKET + c : -1;
    }
    __syncthreads();
  }
  // every CTA's cell positions stored before any is read
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  // ---- count
  int carry = 0;                      // placed entries of the rounds before
  for (int r = 0; r < rounds; ++r) {
    const int i = r * INDEX_TILE + (((warp * INDEX_CLUSTER + rank) * INDEX_CHUNK) | (4 * lane));
    int c[4], hi[4], lw[4];
    load4<L2>(cp, i, n, -1, c);
    load4<INPUT>(khi, i, n, 0, hi);
    load4<INPUT>(klo, i, n, 0, lw);
    int mine = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) mine += c[j] >= 0;
    int x = mine;                     // the warp's inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    // the last round's readers of wt are done (their arrive below)
    if (r) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (lane == 31) wt[warp] = x;
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    // ---- offsets
    // every CTA's chunk counts of the round through distributed shared
    // memory; each warp's offset = the counts of every chunk before its
    if (tid < INDEX_CLUSTER * INDEX_WARPS)
      all[tid] = cluster.map_shared_rank(wt, tid / INDEX_WARPS)[tid % INDEX_WARPS];
    // no CTA reads another's shared memory again this round: arrive now,
    // wait before wt is written again (or at the end)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    __syncthreads();
    if (warp == 0) {
      int col = 0, before = 0;        // warp `lane`'s chunks over the CTAs; those of lower rank
#pragma unroll
      for (int q = 0; q < INDEX_CLUSTER; ++q) {
        const int v = all[q * INDEX_WARPS + lane];
        col += v;
        before += q < rank ? v : 0;
      }
      int s = col;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      off[lane] = s - col + before;
      if (lane == 31) off[INDEX_WARPS] = s;
    }
    __syncthreads();
    // ---- write
    write4(c, hi, lw, carry + off[warp] + x - mine, slot_from_top, index, meta);
    carry += off[INDEX_WARPS];
    __syncthreads();
  }
  if (rank == INDEX_CLUSTER - 1 && tid == 0) *n_placed = min(carry, slot_from_top);
  // ---- finish
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ int floordiv3(int a) { return a >= 0 ? a / 3 : -((2 - a) / 3); }

constexpr int MERGE_THREADS = 256;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
constexpr int MERGE_CTAS_PER_SM = 4;                 // the grid: at most this many CTAs an SM
constexpr int MERGE_EXTRA = 8;                        // records after its tile a warp reads
constexpr long long DEAD_KEY = 0x7FFFFFFFFFFFFFFFLL;  // INVALID_SORT_KEY: dead records sort last
constexpr unsigned FULL = 0xffffffffu;

// A record's count and centroid through its sort index r (raw), and its
// [count | count * centroid].
__device__ __forceinline__ float4 gather(const float* __restrict__ cnt,
                                        const float* __restrict__ cen, long long r) {
  return make_float4(__ldg(cnt + r), __ldg(cen + 3 * r), __ldg(cen + 3 * r + 1),
                     __ldg(cen + 3 * r + 2));
}

__device__ __forceinline__ float4 weigh(float4 g) {
  return make_float4(g.x, __fmul_rn(g.y, g.x), __fmul_rn(g.z, g.x), __fmul_rn(g.w, g.x));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                     __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

// The sorted records: s_key (m,) keys (DEAD_KEY for a dead record, all of
// them last), s_idx (m,) the permutation, first (m,) the run leaders of
// live keys; cnt (m,) and cen (m, 3) by record. scratch: two 64-bit words,
// zero before the launch and after it, [CTAs done : 32 | placed : 32] and
// [CTAs done : 32 | dropped : 32] (a count is at most m < 2^31, so the low
// half never carries into the high one). counts (2,): placed, dropped.
__global__ void __launch_bounds__(MERGE_THREADS)
bulk_merge_kernel(const long long* __restrict__ s_key, const long long* __restrict__ s_idx,
                  const bool* __restrict__ first, const float* __restrict__ cnt,
                  const float* __restrict__ cen, int m, const int* __restrict__ index,
                  int n_buckets, float4* __restrict__ l0, unsigned long long* __restrict__ scratch,
                  int* __restrict__ counts) {
  __shared__ int wsum[2][MERGE_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (m + 31) >> 5, stride = gridDim.x * MERGE_WARPS;
  int placed = 0, dropped = 0;
  int t = blockIdx.x * MERGE_WARPS + warp;
  // ---- flags
  // a tile's leader flags and first key; the loop fetches the next tile's
  // while it works on this one
  bool lead = false;
  long long head = DEAD_KEY;
  if (t < n_tiles) {
    lead = 32 * t + lane < m && first[32 * t + lane];
    head = __ldg(s_key + 32 * t);
  }
  while (t < n_tiles) {
    const int tn = t + stride;
    bool lead_n = false;
    long long head_n = DEAD_KEY;
    if (tn < n_tiles) {
      lead_n = 32 * tn + lane < m && first[32 * tn + lane];
      head_n = __ldg(s_key + 32 * tn);
    }
    const unsigned leaders = __ballot_sync(FULL, lead);
    if (!leaders && head == DEAD_KEY) break;     // this tile and every later one are dead
    if (leaders) {
      // ---- records
      // each lane's key and sort index, and in lanes below MERGE_EXTRA
      // those of the records after the tile (dead keys and index 0 past m)
      const int base = 32 * t, p = base + lane, px = base + 32 + lane;
      long long key = DEAD_KEY, idx = 0, key_x = DEAD_KEY, idx_x = 0;
      if (p < m) {
        key = __ldg(s_key + p);
        idx = __ldg(s_idx + p);
      }
      if (lane < MERGE_EXTRA && px < m) {
        key_x = __ldg(s_key + px);
        idx_x = __ldg(s_idx + px);
      }
      // ---- gather and probe
      // every lane's record and extra record through its index (a dead
      // record's index is a valid one; past M it is 0), issued before the
      // leaders' probes of their parents, so that all go out in one round
      const float4 g = gather(cnt, cen, idx), g_x = gather(cnt, cen, idx_x);
      // the run's voxel, its parent and child offset (floor division by 3)
      const int iz = (int)(key >> 32);
      const unsigned int klo = (unsigned int)(key & 0xFFFFFFFFLL);
      const int ix = (int)(klo >> 16) - 32768, iy = (int)(klo & 0xFFFFu) - 32768;
      const int qx = floordiv3(ix), qy = floordiv3(iy), qz = floordiv3(iz);
      const int off = ((ix - 3 * qx) * 3 + (iy - 3 * qy)) * 3 + (iz - 3 * qz);
      int slot = -1;
      if (lead) {
        uint32_t phi, plo;
        lo::pack_key(qx, qy, qz, phi, plo);
        slot = lo::probe(index, (uint32_t)(n_buckets - 1), phi, plo);
      }
      const float4 v = weigh(g), v_x = weigh(g_x);
      // ---- runs
      // bit q of `cont`: record q of the window (the tile's 32, then the
      // MERGE_EXTRA after it) has the key of record q - 1
      const long long up = __shfl_up_sync(FULL, key, 1), last = __shfl_sync(FULL, key, 31);
      const long long up_x = __shfl_up_sync(FULL, key_x, 1);
      const unsigned c_in = __ballot_sync(FULL, lane > 0 && key == up);
      const unsigned c_x = __ballot_sync(FULL, lane < MERGE_EXTRA && key_x != DEAD_KEY &&
                                                   key_x == (lane == 0 ? last : up_x));
      const unsigned long long cont = (unsigned long long)c_in | ((unsigned long long)c_x << 32);
      const int len = lead ? __ffsll((long long)~(cont >> (lane + 1))) : 0;
      const int steps = __reduce_max_sync(FULL, (unsigned)len);
      // ---- sums
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < steps; ++k) {
        const int q = lane + k;
        const float4 a = shfl4(v, q & 31), b = shfl4(v_x, (q - 32) & 31);
        if (k < len) acc = add4(acc, q < 32 ? a : b);
      }
      if (lead && lane + len == 32 + MERGE_EXTRA) {
        // a run longer than the window goes on serially
        for (int j = base + 32 + MERGE_EXTRA; j < m && __ldg(s_key + j) == key; ++j)
          acc = add4(acc, weigh(gather(cnt, cen, __ldg(s_idx + j))));
      }
      // ---- store
      if (slot >= 0) l0[(size_t)slot * lo::NCH + off] = acc;
      placed += __popc(__ballot_sync(FULL, lead && slot >= 0));
      dropped += __popc(__ballot_sync(FULL, lead && slot < 0));
    }
    t = tn;
    lead = lead_n;
    head = head_n;
  }
  // ---- counts
  if (lane == 0) {
    wsum[0][warp] = placed;
    wsum[1][warp] = dropped;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    // each count with its own ticket: the CTA that draws a word's last
    // ticket holds that count's total; the two atomics are in flight at once
    unsigned long long mine = 1ull << 32;
#pragma unroll
    for (int w = 0; w < MERGE_WARPS; ++w) mine += (unsigned long long)wsum[threadIdx.x][w];
    const unsigned long long before = atomicAdd(scratch + threadIdx.x, mine);
    if ((before >> 32) == gridDim.x - 1) {
      counts[threadIdx.x] = (int)(unsigned)(before + mine);
      scratch[threadIdx.x] = 0;
    }
  }
}

// K9a's launch: one cluster of INDEX_CLUSTER CTAs (a non-portable size,
// set and checked with cudaOccupancyMaxActiveClusters: an error where the
// card refuses it).
void bulk_index_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cfg = {};
  cfg.gridDim = dim3(INDEX_CLUSTER, 1, 1);
  cfg.blockDim = dim3(INDEX_THREADS, 1, 1);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = INDEX_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

// K9a's launch shape as bulk_index_config builds it: cluster CTAs, threads
// a CTA, CTAs a launch.
LO_EXPORT void lo_map_bulk_index_shape(int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  bulk_index_config(cfg, attr);
  out[0] = (int)attr.val.clusterDim.x;
  out[1] = (int)cfg.blockDim.x;
  out[2] = (int)cfg.gridDim.x;
}

// cp: n ints of scratch (16-byte aligned).
LO_EXPORT int lo_map_bulk_index(const long long* b_s, const long long* i_s, const int* khi,
                                const int* klo, int n, int n_buckets, int slot_from_top, int* cp,
                                int* index, int* meta, int* n_placed, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)khi | (uintptr_t)klo | (uintptr_t)meta | (uintptr_t)cp) & 15))
    return (int)cudaErrorMisalignedAddress;             // 16-byte loads and meta rows
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  bulk_index_config(cfg, attr);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(bulk_index_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  int fit = 0;
  e = cudaOccupancyMaxActiveClusters(&fit, bulk_index_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, bulk_index_kernel, b_s, i_s, khi, klo, n, n_buckets,
                         slot_from_top, cp, index, meta, n_placed);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// scratch: the wrapper's two zeroed 64-bit words (left zeroed).
LO_EXPORT int lo_map_bulk_merge(const long long* s_key, const long long* s_idx, const bool* first,
                                const float* cnt, const float* cen, int m, const int* index,
                                int n_buckets, float* l0, unsigned long long* scratch, int* counts,
                                void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (m + 31) / 32;
  const int grid = max(1, min(MERGE_CTAS_PER_SM * sms, (tiles + MERGE_WARPS - 1) / MERGE_WARPS));
  bulk_merge_kernel<<<grid, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      s_key, s_idx, first, cnt, cen, m, index, n_buckets, (float4*)l0, scratch, counts);
  return (int)cudaGetLastError();
}
