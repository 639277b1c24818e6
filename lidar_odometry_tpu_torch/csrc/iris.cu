// K8 LiDAR-Iris place recognition: the descriptor image, its binary codes,
// and the masked Hamming comparison against the keyframe database.
//
// Replaces: the JAX package's ops/iris.py:50 iris_image (K8a), the log-Gabor
// product of ops/iris.py:105 iris_feature (:114, K8g) and its sign /
// magnitude encoding and row packing (:115-120, K8b; the row FFT and the
// inverse FFT stay torch.fft),
// and the Hamming search of ops/iris.py:144 _hamming_over_shifts with the
// forward / 180-degree choice of ops/iris.py:165 _compare_one, as batched by
// compare_batch (:186) and compare_batch_packed (:196) (K8c; the phase
// correlation that estimates each shift stays torch.fft + argmax).
//
// Bounds on the H100:
//  * iris_image reads B x 16384 x 13 B of keyframe clouds and writes
//    B x 80 x 360 x 4 B: ~0.33 MB a keyframe, ~0.1 us; atomics on a few
//    thousand occupied pixels and launch latency bound it. Design: one
//    thread per point computes its range ring, yaw column and height bit
//    and ORs the bit into its pixel (atomicOr on an int image the wrapper
//    zeroes): the JAX (80, 360, 8) count volume is never built.
//  * gabor_product reads the 80 x 360 complex row spectra of a keyframe
//    (230 KB) and the 4 x 360 filters, and writes 4 x 80 x 360 complex
//    products (0.92 MB): ~0.34 us, bytes bound it. Design: a block takes
//    GABOR_ROWS spectrum rows of one keyframe and stages the 4 x 360
//    filters in shared memory; each thread takes a pair of neighbouring
//    spectrum elements (neighbouring threads on neighbouring columns),
//    reads them once as 16 bytes, and writes their products for the 4
//    scales as 16 bytes each, coalesced across the warp. Index arithmetic
//    is 32-bit, divisions by compile-time constants. Each product is re
//    and im times the real filter value (the products PyTorch's complex x
//    real-valued complex multiply rounds to).
//  * iris_encode reads the 4 x 80 x 360 complex responses (0.9 MB a
//    keyframe) and writes 2 x 20 x 360 words (57.6 KB): ~0.3 us, bytes
//    bound it. Word w < 10 packs re > 0 of the stacked rows 32 w .. 32 w +
//    31, word w + 10 im > 0 of the same rows, and both M words the same
//    magnitude bits, so each response is read once: a thread takes 8 of a
//    word's 32 rows at a column pair (eight 16-byte loads, all issued
//    before any use; neighbouring lanes on neighbouring quarters and column
//    pairs, so a warp's load is four whole 128-byte lines), and the four
//    quarters of a word meet by two shuffles; quarter q then stores word
//    q of [T w, T w + 10, M w, M w + 10] as 8 bytes. b = 1 gives 57 CTAs
//    of 128 threads. |z| < 1e-4 after the 1/N scale is undone is tested
//    as re^2 + im^2 < x0, x0 the least float32 whose correctly rounded
//    square root is >= 1e-4 (ops/iris.py MAG_SQ_THRESHOLD): the same bit
//    as sqrtf's for every input, NaN and inf included, with no IEEE square
//    root (whose slow path ends its basic block in a call). The squares
//    and the sum are rounded one at a time (no FMA), as the twin's are.
//    The (640, 360) bool stacks never reach memory.
//  * iris_hamming: per candidate, 2 orientations x 5 shifts of an OR, an
//    XOR, an AND-NOT and two popcounts over 7200 words of T and M: K <= 32
//    candidates read ~1.9 MB of DB rows (L2 serves the repeats) and do
//    ~14 M integer ops: far below the card's rates. The popcounts (16 a
//    clock on an SM) and the dependent rounds bound it. Design: one
//    cluster of 8 CTAs a candidate (so that K = 1 runs on 8 SMs), each
//    reading its eighth of the candidate's words once as 16-byte loads
//    straight from the device DB by index (no gathered copy) and pairing
//    each with the query's words at all 10 (orientation, shift) pairs from
//    a copy of the query rows staged in shared memory once for each
//    orientation, rolled so that no modulo is left in the inner loop; the
//    20 counts stay in registers until one warp reduction, one store into
//    the cluster's rank 0 and one cluster barrier; ten lanes of rank 0
//    take a distance each, and lane 0 picks the first minimum over the
//    shifts and the better orientation: one (distance, bias) row per
//    candidate is all that is written (bit-equal to the plain version:
//    exact integer counts, one correctly rounded division a pair).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 80, COLS = 360, WORDS = 20, NSCALE = 4;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
iris_image_kernel(const float* __restrict__ pts, const bool* __restrict__ mask, int b, int n,
                  float deg, int* __restrict__ img) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)b * n || !mask[i]) return;
  const int k = (int)(i / n);
  const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
  const float dis = sqrtf(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  const float yaw = __fadd_rn(__fmul_rn(atan2f(y, x), deg), 180.0f);
  const int q_dis = min(max((int)floorf(dis), 0), ROWS - 1);
  const int q_arc = min(max((int)ceilf(__fadd_rn(z, 5.0f)), 0), 7);
  const int q_yaw = min(max((int)floorf(__fadd_rn(yaw, 0.5f)), 0), COLS - 1);
  atomicOr(img + (size_t)k * ROWS * COLS + q_dis * COLS + q_yaw, 1 << q_arc);
}

// resp: (B, NSCALE, ROWS, COLS) complex64 as float pairs, the inverse FFT's
// output before the scale; T, M: (B, WORDS, COLS) 32-bit words, bit j of
// word w at column c = stacked row 32 w + j. Thread i: quarter q = i % 4,
// column pair cp, word row w < 10, keyframe k (outermost).
constexpr int ENC_THREADS = 128;
constexpr int ENC_PAIRS = COLS / 2;
constexpr int ENC_PER_KF = 4 * ENC_PAIRS * (WORDS / 2);   // threads a keyframe: 7200

__global__ void __launch_bounds__(ENC_THREADS)
iris_encode_kernel(const float4* __restrict__ resp, int b, float scale, float x0,
                   int2* __restrict__ T, int2* __restrict__ M) {
  const int i = blockIdx.x * ENC_THREADS + threadIdx.x;
  if (i >= b * ENC_PER_KF) return;        // whole warps: ENC_PER_KF is a multiple of 32
  const int q = i & 3, cp = (i >> 2) % ENC_PAIRS, kw = (i >> 2) / ENC_PAIRS;
  const int k = kw / (WORDS / 2), w = kw % (WORDS / 2);
  // ---- loads
  // rows 32 w + 8 q .. + 7 (< 320: every stacked row of the word is a
  // response row), one 16-byte column pair each
  const float4* src = resp + ((size_t)k * NSCALE * ROWS + 32 * w + 8 * q) * ENC_PAIRS + cp;
  float4 z[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) z[j] = __ldg(src + j * ENC_PAIRS);
  // ---- bits
  // [re > 0, im > 0, |z| < 1e-4] of the two columns
  unsigned int re0 = 0, im0 = 0, m0 = 0, re1 = 0, im1 = 0, m1 = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = __fmul_rn(z[j].x, scale), c = __fmul_rn(z[j].y, scale);
    const float d = __fmul_rn(z[j].z, scale), e = __fmul_rn(z[j].w, scale);
    const int at = 8 * q + j;
    re0 |= (unsigned int)(a > 0.f) << at;
    im0 |= (unsigned int)(c > 0.f) << at;
    m0 |= (unsigned int)(__fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c)) < x0) << at;
    re1 |= (unsigned int)(d > 0.f) << at;
    im1 |= (unsigned int)(e > 0.f) << at;
    m1 |= (unsigned int)(__fadd_rn(__fmul_rn(d, d), __fmul_rn(e, e)) < x0) << at;
  }
  // ---- merge
  // the word's four quarters, lanes 4 t .. 4 t + 3
  constexpr unsigned int FULL = 0xffffffffu;
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    re0 |= __shfl_xor_sync(FULL, re0, o);
    im0 |= __shfl_xor_sync(FULL, im0, o);
    m0 |= __shfl_xor_sync(FULL, m0, o);
    re1 |= __shfl_xor_sync(FULL, re1, o);
    im1 |= __shfl_xor_sync(FULL, im1, o);
    m1 |= __shfl_xor_sync(FULL, m1, o);
  }
  // ---- store
  // quarter q writes T[w], T[w + 10], M[w], M[w + 10]
  const int row = (k * WORDS + w + (q & 1) * (WORDS / 2)) * ENC_PAIRS + cp;
  if (q == 0) T[row] = make_int2((int)re0, (int)re1);
  else if (q == 1) T[row] = make_int2((int)im0, (int)im1);
  else M[row] = make_int2((int)m0, (int)m1);
}

// spec: (B, ROWS, COLS) complex64; filt: (NSCALE, COLS) f32; out: (B,
// NSCALE, ROWS, COLS) complex64. Block (row group g, keyframe k).
constexpr int GABOR_ROWS = 4;                            // spectrum rows a block
constexpr int GABOR_PAIRS = GABOR_ROWS * COLS / 2;       // element pairs a block
constexpr int GABOR_PER = (GABOR_PAIRS + THREADS - 1) / THREADS;

__global__ void __launch_bounds__(THREADS)
gabor_product_kernel(const float4* __restrict__ spec, const float* __restrict__ filt,
                     float4* __restrict__ out) {
  __shared__ float2 fs[NSCALE * COLS / 2];
  const int k = blockIdx.y, r0 = blockIdx.x * GABOR_ROWS;
  // this block's spectrum pairs, read before the filters are staged
  const float4* src = spec + ((size_t)k * ROWS + r0) * (COLS / 2);
  float4 z[GABOR_PER];
#pragma unroll
  for (int j = 0; j < GABOR_PER; ++j) {
    const int p = threadIdx.x + j * THREADS;
    if (p < GABOR_PAIRS) z[j] = src[p];
  }
  const float2* f2 = reinterpret_cast<const float2*>(filt);
  for (int i = threadIdx.x; i < NSCALE * COLS / 2; i += THREADS) fs[i] = f2[i];
  __syncthreads();
  float4* dst = out + ((size_t)k * NSCALE * ROWS + r0) * (COLS / 2);
#pragma unroll
  for (int j = 0; j < GABOR_PER; ++j) {
    const int p = threadIdx.x + j * THREADS;
    if (p >= GABOR_PAIRS) break;
    const int cp = p % (COLS / 2);
#pragma unroll
    for (int s = 0; s < NSCALE; ++s) {
      const float2 f = fs[s * (COLS / 2) + cp];
      dst[s * ROWS * (COLS / 2) + p] =
          make_float4(__fmul_rn(z[j].x, f.x), __fmul_rn(z[j].y, f.x), __fmul_rn(z[j].z, f.y),
                      __fmul_rn(z[j].w, f.y));
    }
  }
}

// ---- K8c
// dbT, dbM: (R, WORDS, COLS) code DB, 16-byte aligned; the query is row
// qidx, candidate k row cand[k]; shifts (K, 2) s0 of the forward and the
// flipped orientation; out (K, 2) [distance | bias].
//
// A cluster of HAM_CLUSTER CTAs a candidate; CTA r takes the candidate's
// 16-byte chunks HAM_CHUNKS r .. + HAM_CHUNKS - 1 of T and of M (chunk g:
// word row g / 90, columns 4 (g % 90) .. + 3), a thread one chunk of each,
// loaded once. Candidate column j of orientation o (flip f = 0 or 180)
// meets query column j + f - s at shift s = s0 + off, off in [-2, 2]. So
// each CTA stages the query's word rows that its chunks touch once for each
// orientation, rolled by base = f - s0 - 2 (mod 360) and padded to 364
// words: then the 8 query words that chunk j meets at all 5 shifts are the
// two aligned 16-byte words j and j + 4 of the staged row, with no modulo.
// Each thread keeps the 20 counts (masked and differing bits of the 10
// (orientation, shift) pairs) in registers; the warps sum them with redux,
// each CTA stores its 20 sums into rank 0's shared memory, and after one
// cluster barrier ten lanes of rank 0 take a distance each and lane 0
// picks as the JAX program does.
constexpr int HAM_CLUSTER = 8;                                  // CTAs a candidate
constexpr int HAM_THREADS = 256;
constexpr int ROW_CHUNKS = COLS / 4;                            // 16-byte chunks a word row
constexpr int HAM_CHUNKS = WORDS * ROW_CHUNKS / HAM_CLUSTER;    // chunks a CTA: 225
constexpr int HAM_ROWS = 3;          // word rows a CTA's chunks touch (225 r / 90 .. + 2)
constexpr int HAM_QW = COLS + 4;     // words of a staged query row
constexpr int NPAIR = 10;            // (orientation, shift) pairs
constexpr int NCOUNT = 2 * NPAIR;    // pair p: masked bits at 2 p, differing bits at 2 p + 1
constexpr int HAM_STAGE = 2 * HAM_ROWS * COLS;                  // query words a CTA stages
constexpr int HAM_STAGE_PER = (HAM_STAGE + HAM_THREADS - 1) / HAM_THREADS;
static_assert(WORDS * ROW_CHUNKS % HAM_CLUSTER == 0 && HAM_CHUNKS <= HAM_THREADS, "K8c split");

__device__ __forceinline__ int pmod(int c) { return ((c % COLS) + COLS) % COLS; }

__global__ void __launch_bounds__(HAM_THREADS)
iris_hamming_kernel(const int4* __restrict__ dbT, const int4* __restrict__ dbM, int qidx,
                    const int* __restrict__ cand, const int* __restrict__ shifts,
                    const bool* __restrict__ valid, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  __shared__ __align__(16) unsigned int qs[2][2][HAM_ROWS][HAM_QW];   // [o][T, M][row][x]
  __shared__ int wsum[HAM_THREADS / 32][NCOUNT];
  __shared__ int part[HAM_CLUSTER][NCOUNT];           // rank 0's: every CTA's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, k = blockIdx.x / HAM_CLUSTER;
  // every CTA has started before any stores into rank 0's shared memory
  // (the wait before those stores)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  // ---- loads
  // this thread's candidate chunk, and the query words to stage
  const int g = rank * HAM_CHUNKS + tid;
  const bool live = tid < HAM_CHUNKS;
  const size_t crow = (size_t)__ldg(cand + k) * (WORDS * ROW_CHUNKS);
  int4 ct = make_int4(0, 0, 0, 0), cm = ct;
  if (live) {
    ct = __ldg(dbT + crow + g);
    cm = __ldg(dbM + crow + g);
  }
  const int s0 = __ldg(shifts + 2 * k), s1 = __ldg(shifts + 2 * k + 1);
  const int w0 = rank * HAM_CHUNKS / ROW_CHUNKS;
  const int* qT = reinterpret_cast<const int*>(dbT) + ((size_t)qidx * WORDS + w0) * COLS;
  const int* qM = reinterpret_cast<const int*>(dbM) + ((size_t)qidx * WORDS + w0) * COLS;
  int qv[HAM_STAGE_PER];
#pragma unroll
  for (int i = 0; i < HAM_STAGE_PER; ++i) {
    const int e = tid + i * HAM_THREADS, rc = e % (HAM_ROWS * COLS);
    qv[i] = (e < HAM_STAGE && w0 + rc / COLS < WORDS)
                ? __ldg((e < HAM_ROWS * COLS ? qT : qM) + rc) : 0;
  }
  // ---- stage
  // qs[o][.][r][x] = the query word at column x + base_o (mod 360)
  const int base0 = pmod(-pmod(s0) - 2), base1 = pmod(180 - pmod(s1) - 2);
#pragma unroll
  for (int i = 0; i < HAM_STAGE_PER; ++i) {
    const int e = tid + i * HAM_THREADS;
    if (e >= HAM_STAGE) break;
    const int tm = e / (HAM_ROWS * COLS), r = (e / COLS) % HAM_ROWS, c = e % COLS;
    int x0 = c - base0, x1 = c - base1;
    x0 += x0 < 0 ? COLS : 0;
    x1 += x1 < 0 ? COLS : 0;
    qs[0][tm][r][x0] = (unsigned)qv[i];
    qs[1][tm][r][x1] = (unsigned)qv[i];
    if (x0 < HAM_QW - COLS) qs[0][tm][r][x0 + COLS] = (unsigned)qv[i];
    if (x1 < HAM_QW - COLS) qs[1][tm][r][x1 + COLS] = (unsigned)qv[i];
  }
  __syncthreads();
  // ---- counts
  // pair p = 5 o + off + 2: chunk column j + cc meets staged word j + cc + 4 - (off + 2)
  int cnt[NCOUNT];
#pragma unroll
  for (int i = 0; i < NCOUNT; ++i) cnt[i] = 0;
  if (live) {
    const int r = g / ROW_CHUNKS - w0, j = (g % ROW_CHUNKS) * 4;
    const unsigned dt[4] = {(unsigned)ct.x, (unsigned)ct.y, (unsigned)ct.z, (unsigned)ct.w};
    const unsigned dm[4] = {(unsigned)cm.x, (unsigned)cm.y, (unsigned)cm.z, (unsigned)cm.w};
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const uint4 t0 = *reinterpret_cast<const uint4*>(&qs[o][0][r][j]);
      const uint4 t1 = *reinterpret_cast<const uint4*>(&qs[o][0][r][j + 4]);
      const uint4 m0 = *reinterpret_cast<const uint4*>(&qs[o][1][r][j]);
      const uint4 m1 = *reinterpret_cast<const uint4*>(&qs[o][1][r][j + 4]);
      const unsigned qt[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      const unsigned qm[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
      for (int p = 0; p < 5; ++p)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const unsigned mk = qm[cc + 4 - p] | dm[cc];
          cnt[2 * (5 * o + p)] += __popc(mk);
          cnt[2 * (5 * o + p) + 1] += __popc((qt[cc + 4 - p] ^ dt[cc]) & ~mk);
        }
    }
  }
  // ---- sums
  // the warps' by redux, the CTA's in threads tid < 20, stored into rank 0
#pragma unroll
  for (int i = 0; i < NCOUNT; ++i) {
    const int s = __reduce_add_sync(0xffffffffu, cnt[i]);
    if (lane == 0) wsum[warp][i] = s;
  }
  __syncthreads();
  int tot = 0;
  if (tid < NCOUNT)
#pragma unroll
    for (int w = 0; w < HAM_THREADS / 32; ++w) tot += wsum[w][tid];
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid < NCOUNT) cluster.map_shared_rank(&part[0][0], 0)[rank * NCOUNT + tid] = tot;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank != 0 || warp != 0) return;
  // ---- pick
  // lane p < 10: pair p's distance = diff / max(total, 1) (+inf where total
  // is 0). lo::fast_div is IEEE's division here: diff <= total < 2^18, so
  // the quotient lies at least 2^-19 ulp from any rounding midpoint, well
  // past the error of its one correction step.
  float dis = INFINITY;
  if (lane < NPAIR) {
    int masked = 0, diff = 0;
#pragma unroll
    for (int q = 0; q < HAM_CLUSTER; ++q) {
      masked += part[q][2 * lane];
      diff += part[q][2 * lane + 1];
    }
    const int total = ROWS * 2 * NSCALE * COLS - masked;
    if (total != 0) dis = lo::fast_div((float)diff, (float)total);
  }
  // the first minimum over each orientation's shifts, then forward only
  // where strictly better
  float best_d[2];
  int best_s[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int s = o == 0 ? s0 : s1;
    best_d[o] = INFINITY;
    best_s[o] = s - 2;
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const float d = __shfl_sync(0xffffffffu, dis, 5 * o + p);
      if (d < best_d[o]) {
        best_d[o] = d;
        best_s[o] = s + p - 2;
      }
    }
  }
  if (lane != 0) return;
  const bool use1 = best_d[0] < best_d[1];
  out[2 * k] = valid[k] ? (use1 ? best_d[0] : best_d[1]) : INFINITY;
  out[2 * k + 1] = (float)(use1 ? best_s[0] : pmod(best_s[1] + 180));
}

inline int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

LO_EXPORT int lo_iris_image(const float* pts, const bool* mask, int b, int n, float deg,
                            int* img, void* stream) {
  iris_image_kernel<<<max(1, blocks((long long)b * n)), THREADS, 0, (cudaStream_t)stream>>>(
      pts, mask, b, n, deg, img);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_gabor_product(const float* spec, const float* filt, int b, float* out,
                               void* stream) {
  if (b <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;   // gridDim.y
  if ((((uintptr_t)spec | (uintptr_t)out) & 15) || ((uintptr_t)filt & 7))
    return (int)cudaErrorMisalignedAddress;           // 16-byte pairs, 8-byte filter pairs
  gabor_product_kernel<<<dim3(ROWS / GABOR_ROWS, b), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)spec, filt, (float4*)out);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_iris_encode(const float* resp, int b, float scale, float x0, int* T, int* M,
                             void* stream) {
  if (b <= 0) return 0;
  if ((((uintptr_t)resp) & 15) || (((uintptr_t)T | (uintptr_t)M) & 7))
    return (int)cudaErrorMisalignedAddress;           // 16-byte column pairs, 8-byte word pairs
  iris_encode_kernel<<<(int)(((long long)b * ENC_PER_KF + ENC_THREADS - 1) / ENC_THREADS),
                       ENC_THREADS, 0, (cudaStream_t)stream>>>((const float4*)resp, b, scale, x0,
                                                               (int2*)T, (int2*)M);
  return (int)cudaGetLastError();
}

// K8c's launch shape: CTAs a cluster, threads a CTA, CTAs a candidate
// (a launch of K candidates takes K clusters).
LO_EXPORT void lo_iris_hamming_shape(int* out) {
  out[0] = HAM_CLUSTER;
  out[1] = HAM_THREADS;
  out[2] = HAM_CLUSTER;
}

LO_EXPORT int lo_iris_hamming(const int* dbT, const int* dbM, int qidx, const int* cand,
                              const int* shifts, const bool* valid, int k, float* out,
                              void* stream) {
  if (k <= 0) return 0;
  if (k > (1 << 24)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)dbT | (uintptr_t)dbM) & 15)
    return (int)cudaErrorMisalignedAddress;           // 16-byte chunks
  return (int)lo::launch_clusters(iris_hamming_kernel, HAM_CLUSTER * k, HAM_THREADS,
                                  HAM_CLUSTER, (cudaStream_t)stream, (const int4*)dbT,
                                  (const int4*)dbM, qidx, cand, shifts, valid, out);
}
