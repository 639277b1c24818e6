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
//    bound it. Design: one thread per output word column reads the 32
//    stacked rows it packs (neighbouring threads, neighbouring columns:
//    coalesced), thresholds re > 0, im > 0 and |z| < 1e-4 after the 1/N
//    scale is undone, and writes T and M words: the (640, 360) bool
//    stacks never reach memory.
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
// word w at column c = stacked row 32 w + j.
__global__ void __launch_bounds__(THREADS)
iris_encode_kernel(const float2* __restrict__ resp, int b, float scale, int* __restrict__ T,
                   int* __restrict__ M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b * WORDS * COLS) return;
  const int k = i / (WORDS * COLS), w = (i / COLS) % WORDS, c = i % COLS;
  const float2* base = resp + (size_t)k * NSCALE * ROWS * COLS;
  unsigned int t = 0, m = 0;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const int r = 32 * w + j;                 // stacked row, 0..639
    const int rr = r % (NSCALE * ROWS);       // the response row it reads
    const float2 z = base[(size_t)(rr / ROWS) * ROWS * COLS + (rr % ROWS) * COLS + c];
    const float re = __fmul_rn(z.x, scale), im = __fmul_rn(z.y, scale);
    const bool tb = r < NSCALE * ROWS ? re > 0.f : im > 0.f;
    const float mag = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
    t |= (unsigned int)tb << j;
    m |= (unsigned int)(mag < 1e-4f) << j;
  }
  T[i] = (int)t;
  M[i] = (int)m;
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

LO_EXPORT int lo_iris_encode(const float* resp, int b, float scale, int* T, int* M,
                             void* stream) {
  iris_encode_kernel<<<max(1, blocks((long long)b * WORDS * COLS)), THREADS, 0,
                       (cudaStream_t)stream>>>((const float2*)resp, b, scale, T, M);
  return (int)cudaGetLastError();
}

LO_EXPORT int lo_iris_hamming(const int* qT, const int* qM, const int* dbT, const int* dbM,
                              const int* cand, const int* shifts, const bool* valid, int k,
                              float* out, void* stream) {
  iris_hamming_kernel<<<max(1, k), THREADS, 0, (cudaStream_t)stream>>>(qT, qM, dbT, dbM, cand,
                                                                       shifts, valid, out);
  return (int)cudaGetLastError();
}
