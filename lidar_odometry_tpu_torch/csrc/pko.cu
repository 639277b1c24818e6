// K3 pko_alpha: PKO's adaptive kernel scale, one block a lane.
//
// Replaces: the JAX package's ops/pko.py:257 pko_scale_factor
// (stratified_sample, _fit_gmm, pko_alpha_index_from_samples), plus the
// iteration-0 normalisation scale of ops/icp.py:81 _norm_scale_from.
//
// Bound on the H100: only the first step touches N-sized data (14336
// residuals + flags, ~72 KB, ~0.02 us at 3.35 TB/s). Everything after it is
// a few thousand serial-dependent flops on 100 samples: k-means and EM each
// run up to 100 dependent rounds. So the kernel is bound by the latency of
// those rounds, not by bytes or by the flop rate.
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
// Design: one block of 512 threads a lane.
//  * Front end, one coalesced pass: warp w takes a contiguous run of
//    32-entry tiles of the valid flags, loads them BATCH tiles at a time,
//    counts each tile with a ballot and popc, and keeps the tile's mask
//    and its running count in shared memory. The per-warp totals (16
//    values) give each warp's base rank. At iteration 0 the mean and then
//    the variance of the valid |r| are warp shuffle sums plus one 16-entry
//    step (norm_scale_from's two passes). Each of the 100 strata resolves
//    its rank to an index by a search over the warp bases and the warp's
//    tile counts, then the rank's bit in the tile's mask.
//  * GMM fit (gmm.cuh): warp 0, samples in registers, each EM round
//    branch-free. Meanwhile the other warps copy Q into shared memory.
//  * P on the grid, the 101 x 100 Jensen-Shannon table (four threads an
//    alpha row, Q from shared memory) and the argmin (warp 0), in gmm.cuh,
//    which the sharded ICP's K11d shares. The alpha index stays on the
//    device, where the ICP normal-equation kernel reads it.
// Divisions and square roots take gmm.cuh's branch-free helpers, so the
// kernel makes no slow-path call and keeps no stack frame. The "// ---- "
// comments mark its phases for tools/k3_phase_stamps.py.
#include "gmm.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 16;    // tiles a warp loads at once
constexpr int M = 100;       // samples
constexpr int KC = lo::GMM_KC;
constexpr int MAX_A = 128;   // alpha rows
constexpr int MAX_G = 128;   // grid points
constexpr size_t STATIC_SMEM = 2048;   // at least the kernel's static shared memory

// Position of the r-th (from 0) set bit of m; m has more than r set bits.
__device__ __forceinline__ int nth_set_bit(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// Dynamic shared memory: Q (n_alpha x n_grid floats), then each tile's
// ballot mask and its inclusive valid count within its warp's run.
// One block a lane and SM: the fit's warp may take up to 128 registers.
__global__ void __launch_bounds__(THREADS, 1)
pko_kernel(const float* __restrict__ resid, const bool* __restrict__ valid, int n,
           const int* __restrict__ flags, const float* __restrict__ scale_in, int compute_scale,
           const float* __restrict__ u, const int* __restrict__ pick,
           const float* __restrict__ alphas, const float* __restrict__ r_grid,
           const float* __restrict__ Q, int n_alpha, int n_grid,
           float* __restrict__ scale_out, int* __restrict__ aux) {
  extern __shared__ float dyn[];
  __shared__ int wcnt[WARPS];
  __shared__ float wsum[WARPS];
  __shared__ float samp[M];
  __shared__ float gw[KC], gmu[KC], gvar[KC];
  __shared__ float P[MAX_G];
  __shared__ float cost[MAX_A];

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
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
  const int n_q = n_alpha * n_grid;
  float* Qs = dyn;
  unsigned* tmask = reinterpret_cast<unsigned*>(dyn + n_q);
  const int n_tiles = (n + 31) / 32;
  int* tcount = reinterpret_cast<int*>(tmask + n_tiles);
  const int per_warp = (n_tiles + WARPS - 1) / WARPS;
  const int tile0 = min(n_tiles, warp * per_warp), tile1 = min(n_tiles, tile0 + per_warp);

  // ---- rank the valid entries (and the iteration-0 mean) ----
  int c = 0;       // the warp's running count
  float s = 0.f;   // this lane's sum of valid |r|
  for (int b0 = tile0; b0 < tile1; b0 += BATCH) {
    bool v[BATCH];   // a batch of tiles' loads, all in flight together
    float a[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = (b0 + j) * 32 + lane;
      const bool in = b0 + j < tile1 && i < n;
      v[j] = in && valid[i];
      a[j] = in ? resid[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (b0 + j >= tile1) break;
      const unsigned mask = __ballot_sync(0xffffffffu, v[j]);
      c += __popc(mask);
      s += v[j] ? fabsf(a[j]) : 0.f;
      if (lane == 0) {
        tmask[b0 + j] = mask;
        tcount[b0 + j] = c;
      }
    }
  }
  if (lane == 0) wcnt[warp] = c;
  s = lo::warp_sum(s);
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  int nv = 0;
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    nv += wcnt[w];
    tot += wsum[w];
  }
  float scale;
  if (compute_scale) {
    const float nf = fmaxf((float)nv, 1.0f);
    const float mean = lo::fast_div(tot, nf);
    float s2 = 0.f;
    for (int b0 = tile0; b0 < tile1; b0 += BATCH) {
      bool v[BATCH];
      float a[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = (b0 + j) * 32 + lane;
        const bool in = b0 + j < tile1 && i < n;
        v[j] = in && valid[i];
        a[j] = in ? resid[i] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const float d = fabsf(a[j]) - mean;
        s2 += v[j] ? d * d : 0.f;
      }
    }
    s2 = lo::warp_sum(s2);
    __syncthreads();   // every thread has read wsum
    if (lane == 0) wsum[warp] = s2;
    __syncthreads();
    float var = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) var += wsum[w];
    scale = lo::fast_div(lo::fast_sqrt(lo::fast_div(var, nf)), 6.0f);
  } else {
    scale = scale_in[0];
  }
  const float denom = fmaxf(scale, 1e-6f);

  // ---- stratified ranks -> indices ----
  if (t < M) {
    const int k = (int)floorf(
        lo::fast_div(__fmul_rn(__fadd_rn((float)t, u[t]), (float)nv), (float)M));
    // strata past the valid count take rank 0's entry (index 0 if none)
    const int rank = t < nv ? min(max(k, 0), nv - 1) : 0;
    int idx = 0;
    if (nv > 0) {
      int w = 0, wb = 0, acc = 0;   // the last warp whose base is <= rank
#pragma unroll
      for (int x = 0; x < WARPS; ++x) {
        if (acc <= rank && wcnt[x] > 0) { w = x; wb = acc; }
        acc += wcnt[x];
      }
      const int r = rank - wb;
      int lo_t = min(n_tiles, w * per_warp), hi_t = min(n_tiles, lo_t + per_warp) - 1;
      while (lo_t < hi_t) {   // the first tile of the run whose count exceeds r
        const int mid = (lo_t + hi_t) / 2;
        if (tcount[mid] > r) hi_t = mid; else lo_t = mid + 1;
      }
      const unsigned mask = tmask[lo_t];
      idx = lo_t * 32 + nth_set_bit(mask, r - (tcount[lo_t] - __popc(mask)));
    }
    samp[t] = lo::fast_div(fabsf(resid[idx]), denom);
  }
  __syncthreads();

  // ---- GMM: k-means then EM, on warp 0 (gmm.cuh); Q to shared memory ----
  if (warp == 0) {
    lo::gmm_fit_warp(samp, M, pick, gw, gmu, gvar);
  } else {
    for (int i = t - 32; i < n_q; i += THREADS - 32) Qs[i] = Q[i];
  }
  __syncthreads();

  // ---- P on the grid, JS cost per alpha, argmin (gmm.cuh) ----
  const int best = lo::js_argmin_block(gw, gmu, gvar, r_grid, Qs, n_alpha, n_grid, P, cost);
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
  const size_t n_tiles = ((size_t)n + 31) / 32;
  const size_t smem = ((size_t)n_alpha * n_grid + 2 * n_tiles) * 4;
  if (smem + STATIC_SMEM > 48 * 1024) {   // past the default limit of a block
    const cudaError_t e =
        cudaFuncSetAttribute(pko_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pko_kernel<<<lanes, THREADS, smem, (cudaStream_t)stream>>>(resid, valid, n, flags, scale_in,
                                                            compute_scale, u, pick, alphas,
                                                            r_grid, Q, n_alpha, n_grid,
                                                            scale_out, aux);
  return (int)cudaGetLastError();
}
