// K3 pko_alpha: PKO's adaptive kernel scale, one single-block launch.
//
// Replaces: the JAX package's ops/pko.py:257 pko_scale_factor
// (stratified_sample, _fit_gmm, pko_alpha_index_from_samples), plus the
// iteration-0 normalisation scale of ops/icp.py:81 _norm_scale_from.
//
// Bound on the H100: only the first step touches N-sized data (14336
// residuals + flags, ~72 KB, ~0.02 us at 3.35 TB/s). Everything after it is
// a few thousand serial-dependent flops on 100 samples: k-means and EM each
// run up to 100 dependent iterations. So the kernel is bound by the latency
// of those dependent steps, not by bytes or by the flop rate.
//
// Input is the signed point-to-plane residual; the kernel takes |r|.
//
// Lanes: B independent residual sets (the blocked multi-sequence runner,
// JAX pko_scale_factor under vmap, whose fixed PRNGKey(42) gives every
// lane the same draws) take one block each (gridDim.x = B), with shared
// constants. Block b offsets its pointers to lane b and runs the one-lane
// body unchanged, so lane b is bit-identical to a one-lane launch on its
// inputs. A lane whose solve is done writes its scale through and a zero
// count and index, and returns.
//
// Design: one block of 1024 threads per lane. The block scans the valid
// flags to rank the valid residuals in feature order (and, at iteration 0, takes
// mean and variance in two passes over the same chunks), resolves the 100
// stratified ranks to indices, and gathers the normalised samples into
// shared memory. One warp then runs k-means and EM with its 32 lanes over
// the 100 samples and shuffle reductions, so an iteration costs a few
// shuffles and no block barrier. The whole block evaluates P on the grid
// and the 101 x 100 Jensen-Shannon table (one warp per alpha row), and
// thread 0 takes the argmin with index 0 skipped. The alpha index stays
// on the device, where the ICP normal-equation kernel reads it.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int M = 100;       // samples
constexpr int KC = 3;        // GMM components
constexpr int MAX_A = 128;   // alpha rows held in shared memory
constexpr int MAX_G = 128;   // grid points held in shared memory
constexpr float TWO_PI = 6.28318548f;

__device__ __forceinline__ float block_sum(float v, float* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (t < off) buf[t] += buf[t + off];
    __syncthreads();
  }
  const float out = buf[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gaussian_pdf(float x, float mean, float var) {
  var = fmaxf(var, 1e-12f);
  const float d = x - mean;
  return expf(((-0.5f * d) * d) / var) / sqrtf(TWO_PI * var);
}

__device__ __forceinline__ int nearest(float x, const float* mu) {
  const float d0 = fabsf(x - mu[0]), d1 = fabsf(x - mu[1]), d2 = fabsf(x - mu[2]);
  int a = 0;
  float b = d0;
  if (d1 < b) { a = 1; b = d1; }
  if (d2 < b) a = 2;
  return a;
}

__global__ void __launch_bounds__(THREADS)
pko_kernel(const float* __restrict__ resid, const bool* __restrict__ valid, int n,
           const int* __restrict__ flags, const float* __restrict__ scale_in, int compute_scale,
           const float* __restrict__ u, const int* __restrict__ pick,
           const float* __restrict__ alphas, const float* __restrict__ r_grid,
           const float* __restrict__ Q, int n_alpha, int n_grid,
           float* __restrict__ scale_out, int* __restrict__ aux) {
  __shared__ int scan[THREADS];
  __shared__ float fbuf[THREADS];
  __shared__ int ranks[M];
  __shared__ int sidx[M];
  __shared__ int first_idx;
  __shared__ float samp[M];
  __shared__ float gw[KC], gmu[KC], gvar[KC];
  __shared__ float P[MAX_G];
  __shared__ float cost[MAX_A];

  const int t = threadIdx.x;
  const size_t lane_ix = blockIdx.x;
  resid += lane_ix * n;
  valid += lane_ix * n;
  flags += 3 * lane_ix;
  scale_in += lane_ix;
  scale_out += lane_ix;
  aux += 2 * lane_ix;
  if (flags[0]) {  // the solve is done: nothing to choose
    if (t == 0) {
      scale_out[0] = scale_in[0];
      aux[0] = 0;
      aux[1] = 0;
    }
    return;
  }
  const int chunk = (n + THREADS - 1) / THREADS;
  const int b0 = min(n, t * chunk);
  const int b1 = min(n, b0 + chunk);

  // ---- rank the valid entries (and the iteration-0 scale) ----
  int c = 0;
  float s = 0.f;
  for (int i = b0; i < b1; ++i)
    if (valid[i]) { ++c; s += fabsf(resid[i]); }
  const int incl = lo::block_inclusive_scan(c, scan);
  const int nv = scan[THREADS - 1];
  const int base = incl - c;
  float scale;
  if (compute_scale) {
    const float nf = fmaxf((float)nv, 1.0f);
    const float mean = block_sum(s, fbuf) / nf;
    float s2 = 0.f;
    for (int i = b0; i < b1; ++i)
      if (valid[i]) { const float d = fabsf(resid[i]) - mean; s2 += d * d; }
    scale = sqrtf(block_sum(s2, fbuf) / nf) / 6.0f;
  } else {
    scale = scale_in[0];
  }
  const float denom = fmaxf(scale, 1e-6f);

  // ---- stratified ranks -> indices ----
  if (t < M) {
    int k = (int)floorf(__fdiv_rn(__fmul_rn(__fadd_rn((float)t, u[t]), (float)nv), (float)M));
    ranks[t] = min(max(k, 0), max(nv - 1, 0));
  }
  if (t == 0) first_idx = 0;
  __syncthreads();
  if (c > 0) {
    for (int j = 0; j < M; ++j) {
      const int want = ranks[j] - base;
      if (want < 0 || want >= c) continue;
      int seen = 0;
      for (int i = b0; i < b1; ++i) {
        if (!valid[i]) continue;
        if (seen == want) { sidx[j] = i; break; }
        ++seen;
      }
    }
    if (base == 0) {
      for (int i = b0; i < b1; ++i)
        if (valid[i]) { first_idx = i; break; }
    }
  }
  __syncthreads();
  if (t < M) samp[t] = fabsf(resid[t < nv ? sidx[t] : first_idx]) / denom;
  __syncthreads();

  // ---- GMM: k-means then EM, on warp 0 ----
  if (t < 32) {
    const int lane = t;
    float x[4];
    int nx = 0;
    for (int i = lane; i < M; i += 32) x[nx++] = samp[i];
    float mu[KC] = {0.f, samp[pick[1]], samp[pick[2]]};
    bool changed = true;
    for (int it = 0; changed && it < 100; ++it) {
      float cnt[KC] = {0.f, 0.f, 0.f}, sx[KC] = {0.f, 0.f, 0.f};
      for (int q = 0; q < nx; ++q) {
        const int a = nearest(x[q], mu);
        cnt[a] += 1.f;
        sx[a] += x[q];
      }
      float nm[KC];
      changed = false;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float ck = warp_sum(cnt[k]);
        const float sk = warp_sum(sx[k]);
        nm[k] = ck > 0.f ? sk / fmaxf(ck, 1.f) : mu[k];
      }
      nm[0] = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        changed |= (nm[k] != mu[k]);
        mu[k] = nm[k];
      }
    }
    float sum = 0.f;
    for (int q = 0; q < nx; ++q) sum += x[q];
    const float dmean = warp_sum(sum) / (float)M;
    float sv = 0.f;
    float cnt[KC] = {0.f, 0.f, 0.f};
    for (int q = 0; q < nx; ++q) {
      const float d = x[q] - dmean;
      sv += d * d;
      cnt[nearest(x[q], mu)] += 1.f;
    }
    const float init_var = warp_sum(sv) / (float)M;
    float w[KC], var[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      w[k] = warp_sum(cnt[k]) / (float)M;
      var[k] = init_var;
    }
    float change = INFINITY;
    for (int it = 0; change >= 1e-6f && it < 100; ++it) {
      float resp[4][KC];
      float nk[KC] = {0.f, 0.f, 0.f}, sx[KC] = {0.f, 0.f, 0.f};
      for (int q = 0; q < nx; ++q) {
        float tot = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          resp[q][k] = w[k] * gaussian_pdf(x[q], mu[k], var[k]);
          tot += resp[q][k];
        }
        tot = tot > 0.f ? tot : (tot != tot ? tot : 0.f);  // max(., 0), NaN kept
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          resp[q][k] = resp[q][k] / tot;
          nk[k] += resp[q][k];
          sx[k] += resp[q][k] * x[q];
        }
      }
      float nmu[KC], Nk[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float a = warp_sum(nk[k]);
        Nk[k] = (a > 1e-12f || a != a) ? a : 1e-12f;
        nmu[k] = warp_sum(sx[k]) / Nk[k];
      }
      nmu[0] = 0.f;
      float sv2[KC] = {0.f, 0.f, 0.f};
      for (int q = 0; q < nx; ++q)
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const float d = x[q] - nmu[k];
          sv2[k] += (resp[q][k] * d) * d;
        }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float v = warp_sum(sv2[k]) / Nk[k];
        var[k] = (v > 1e-6f || v != v) ? v : 1e-6f;
        w[k] = Nk[k] / (float)M;
      }
      change = fabsf(nmu[1] - mu[1]) + fabsf(nmu[2] - mu[2]);
#pragma unroll
      for (int k = 0; k < KC; ++k) mu[k] = nmu[k];
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < KC; ++k) { gw[k] = w[k]; gmu[k] = mu[k]; gvar[k] = var[k]; }
    }
  }
  __syncthreads();

  // ---- P on the grid, JS cost per alpha, argmin ----
  if (t < n_grid) {
    float p = 0.f;
#pragma unroll
    for (int k = 0; k < KC; ++k) p += gw[k] * gaussian_pdf(r_grid[t], gmu[k], gvar[k]);
    P[t] = p + 1e-10f;
  }
  __syncthreads();
  const int warp = t / 32, lane = t % 32;
  for (int a = warp; a < n_alpha; a += THREADS / 32) {
    float acc = 0.f;
    for (int g = lane; g < n_grid; g += 32) {
      const float p = P[g], q = Q[a * n_grid + g];
      const float m = 0.5f * (p + q);
      acc += 0.5f * (p * logf(p / m) + q * logf(q / m));
    }
    acc = warp_sum(acc);
    if (lane == 0) cost[a] = acc / (float)n_grid;
  }
  __syncthreads();
  if (t == 0) {
    int best = 0;
    float bv = INFINITY;  // cost[0] is replaced by +inf
    for (int a = 1; a < n_alpha; ++a) {
      const float v = cost[a];
      if (v != v) { best = a; break; }  // argmin returns the first NaN
      if (v < bv) { bv = v; best = a; }
    }
    aux[0] = nv;
    aux[1] = best;
    scale_out[0] = scale;
  }
}

}  // namespace

LO_EXPORT int lo_pko_alpha(const float* resid, const bool* valid, int n, int lanes,
                           const int* flags, const float* scale_in, int compute_scale,
                           const float* u, const int* pick, const float* alphas,
                           const float* r_grid, const float* Q, int n_alpha, int n_grid,
                           float* scale_out, int* aux, void* stream) {
  if (n_alpha > MAX_A || n_grid > MAX_G) return (int)cudaErrorInvalidValue;
  pko_kernel<<<lanes, THREADS, 0, (cudaStream_t)stream>>>(resid, valid, n, flags, scale_in,
                                                          compute_scale, u, pick, alphas,
                                                          r_grid, Q, n_alpha, n_grid, scale_out,
                                                          aux);
  return (int)cudaGetLastError();
}
