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
//  * iris_hamming: per candidate, 2 orientations x 5 shifts of an XOR,
//    AND-NOT and two popcounts over 7200 words of T and M: K <= 32
//    candidates read ~1.9 MB of DB rows (L2 serves the repeats) and do
//    ~14 M integer ops: far below the card's rates; latency-bound.
//    Design: one block per candidate reads the query and candidate rows
//    straight from the device DB by index (no gathered copy), rolls the
//    query by the column shift in the index arithmetic, reduces the
//    popcounts over the block, and thread 0 picks the first minimum over
//    the shifts and the better orientation: one (distance, bias) row per
//    candidate is all that is written.
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

__device__ __forceinline__ int wrap(int c) { return ((c % COLS) + COLS) % COLS; }

__device__ __forceinline__ int block_sum(int v, int* buf) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int k = 0; k < THREADS / 32; ++k) s += buf[k];
  return s;   // valid in thread 0
}

__global__ void __launch_bounds__(THREADS)
iris_hamming_kernel(const int* __restrict__ qT, const int* __restrict__ qM,
                    const int* __restrict__ dbT, const int* __restrict__ dbM,
                    const int* __restrict__ cand, const int* __restrict__ shifts,
                    const bool* __restrict__ valid, float* __restrict__ out) {
  __shared__ int buf[THREADS / 32];
  const int k = blockIdx.x;
  const size_t row = (size_t)cand[k] * WORDS * COLS;
  const int* dT = dbT + row;
  const int* dM = dbM + row;
  float best_d[2];
  int best_s[2];
  for (int o = 0; o < 2; ++o) {             // forward, then flipped by 180 columns
    const int flip = o == 0 ? 0 : 180;
    const int s0 = shifts[2 * k + o];
    best_d[o] = INFINITY;
    best_s[o] = s0 - 2;
    for (int off = -2; off <= 2; ++off) {
      const int s = s0 + off;
      int masked = 0, diff = 0;
      for (int i = threadIdx.x; i < WORDS * COLS; i += THREADS) {
        const int w = i / COLS, c = i % COLS;
        const int qi = w * COLS + wrap(c - s);
        const int di = w * COLS + wrap(c - flip);
        const unsigned int mk = (unsigned int)(qM[qi] | dM[di]);
        masked += __popc(mk);
        diff += __popc((unsigned int)(qT[qi] ^ dT[di]) & ~mk);
      }
      masked = block_sum(masked, buf);
      diff = block_sum(diff, buf);
      if (threadIdx.x == 0) {
        const int total = ROWS * 2 * NSCALE * COLS - masked;
        const float dis = total == 0 ? INFINITY : (float)diff / (float)max(total, 1);
        if (dis < best_d[o]) {   // the first minimum, as argmin
          best_d[o] = dis;
          best_s[o] = s;
        }
      }
    }
  }
  if (threadIdx.x != 0) return;
  const bool use1 = best_d[0] < best_d[1];
  out[2 * k] = valid[k] ? (use1 ? best_d[0] : best_d[1]) : INFINITY;
  out[2 * k + 1] = (float)(use1 ? best_s[0] : wrap(best_s[1] + 180));
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

LO_EXPORT int lo_iris_hamming(const int* qT, const int* qM, const int* dbT, const int* dbM,
                              const int* cand, const int* shifts, const bool* valid, int k,
                              float* out, void* stream) {
  iris_hamming_kernel<<<max(1, k), THREADS, 0, (cudaStream_t)stream>>>(qT, qM, dbT, dbM, cand,
                                                                       shifts, valid, out);
  return (int)cudaGetLastError();
}
