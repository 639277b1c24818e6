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
// thread 0 takes the argmin with index 0 skipped (both in gmm.cuh, which
// the sharded ICP's K11d shares). The alpha index stays on the device,
// where the ICP normal-equation kernel reads it.
#include "gmm.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int M = 100;       // samples
constexpr int KC = lo::GMM_KC;
constexpr int MAX_A = 128;   // alpha rows held in shared memory
constexpr int MAX_G = 128;   // grid points held in shared memory

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

  // ---- GMM: k-means then EM, on warp 0 (gmm.cuh) ----
  if (t < 32) lo::gmm_fit_warp(samp, M, pick, gw, gmu, gvar);
  __syncthreads();

  // ---- P on the grid, JS cost per alpha, argmin (gmm.cuh) ----
  const int best = lo::js_argmin_block(gw, gmu, gvar, r_grid, Q, n_alpha, n_grid, P, cost);
  if (t == 0) {
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
