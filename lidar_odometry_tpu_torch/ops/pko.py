"""PKO adaptive M-estimator scale (counterpart of
the JAX package's ops/pko.py, the parts the odometry path uses).

Per ICP iteration: normalise the valid residual magnitudes (at iteration
0 the scale std/6 is taken here too), draw 100 stratified samples by rank
in feature order, fit a 3-component 1-D GMM (k-means with component 0
pinned at 0, then EM), evaluate it on the residual grid, and return the
index of the alpha whose kernel distribution Q is nearest in
Jensen-Shannon divergence (index 0 skipped).

Kernel K3 (csrc/pko.cu) does all of that in one launch, one block a lane,
and leaves the alpha index on the device for the ICP normal-equation
kernel.
Lanes (the blocked multi-sequence runner) add a leading B to the
residuals, flags, scale and results: one launch, one block per lane, and
every lane takes the same draws, as JAX's fixed key does under vmap.

The JAX program draws its randomness from a fixed PRNGKey(42): 100
uniforms for the strata and 3 sample indices for the k-means start. With
100 samples and 3 components both are constants, committed below as
float32 bit patterns and held equal to JAX's draws by a test. Other sample
sizes or component counts are refused. The sharded ICP's per-shard draws
(shard_draws) are committed the same way for 1, 2, 4 and 8 shards; the
GMM fit and JS argmin of K3 serve its K11d too (csrc/gmm.cuh).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels

__all__ = ["PKOConstants", "make_pko_constants", "pko_alpha_index",
           "pko_alpha_index_plain", "pko_scale_factor", "pko_alpha_from_samples",
           "kernel_weight", "stratified_sample", "fit_gmm",
           "alpha_index_from_samples", "norm_scale_from", "STRATA_U",
           "KMEANS_PICK", "SHARD_COUNTS", "shard_quota", "shard_draws"]

GMM_SAMPLES = 100
GMM_COMPONENTS = 3
_EM_TOL = float(np.float32(1e-6))   # JAX compares in float32

# jax.random.uniform(jax.random.PRNGKey(42), (100,)), float32 bit patterns
_U_BITS = [
    0x3efa3824, 0x3f2e0730, 0x3f1dc3f8, 0x3f0f9ec0, 0x3ee6bae4, 0x3f15fb4e,
    0x3d9935b0, 0x3f466f24, 0x3f32eefe, 0x3f5191fa, 0x3eb35b34, 0x3f5f7122,
    0x3f6d0690, 0x3f5c3186, 0x3ef481f8, 0x3f518806, 0x3f361b54, 0x3f1631ca,
    0x3d9703a0, 0x3f471240, 0x3ecf2338, 0x3df3f6e0, 0x3cd71600, 0x3f23a138,
    0x3ecf38ec, 0x3f634990, 0x3da6dc10, 0x3e97c260, 0x3f1b4f5c, 0x3f70302a,
    0x3f4189bc, 0x3eead204, 0x3e9d8e3c, 0x3f40380c, 0x3f0b4c42, 0x3eba6010,
    0x3f2ce7b2, 0x3f1711b6, 0x3e93d6d0, 0x3e412450, 0x3ed4b840, 0x3f1ef770,
    0x3ed9fb2c, 0x3f098c88, 0x3f25501c, 0x3e14b138, 0x3f2c2544, 0x3f631348,
    0x3f2af5d6, 0x3e769140, 0x3f11ec00, 0x3ed7adb8, 0x3ed3ccf4, 0x3f6690da,
    0x3f2573f2, 0x3edbd14c, 0x3ecf7c6c, 0x3eae93b8, 0x3f24ab02, 0x3f61efa4,
    0x3e191be0, 0x3e5aa1f0, 0x3f5ae7cc, 0x3eb79d1c, 0x3ef4bf54, 0x3ca44d40,
    0x3f6eee52, 0x3d930c30, 0x3f083a32, 0x3e5172b8, 0x3ee7f05c, 0x3e3bd528,
    0x3f36ac6c, 0x3e17ac48, 0x3db9e640, 0x3f72fca6, 0x3f045652, 0x3ddc70f0,
    0x3eda1734, 0x3f3ac584, 0x3ecc8034, 0x3f689186, 0x3f5a9860, 0x3f56f052,
    0x3cc87780, 0x3e992688, 0x3c26f380, 0x3f5d0506, 0x3f7dee16, 0x3f44c462,
    0x3f44681a, 0x3e3bd500, 0x3e94b2d4, 0x3f2b92a6, 0x3ea90620, 0x3f6451a6,
    0x3edc8288, 0x3f1182aa, 0x3f1c7526, 0x3e223360,
]
STRATA_U = np.asarray(_U_BITS, np.uint32).view(np.float32)
# jax.random.randint(jax.random.PRNGKey(42), (3,), 0, 100)
KMEANS_PICK = np.asarray([44, 14, 71], np.int32)

# The sharded ICP (parallel/sharded_map.py) draws each shard's stratified
# sample of ceil(100 / S) residuals with the uniforms
# jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(42), shard),
# (ceil(100 / S),)), and fits its GMM to the S * ceil(100 / S) merged
# samples with the k-means start jax.random.randint(jax.random.PRNGKey(42),
# (3,), 0, S * ceil(100 / S)). Both are committed below for S in
# SHARD_COUNTS, as float32 bit patterns and indices, and held equal to
# JAX's draws by a test.
SHARD_COUNTS = (1, 2, 4, 8)
_SHARD_U_BITS = {
    1: [
        [0x3f07bf2c, 0x3ea07100, 0x3f66cab0, 0x3f32c5f2, 0x3f1e398c, 0x3f1f31b2,
         0x3f37be40, 0x3e56bba0, 0x3cbf9840, 0x3f3d1f6c, 0x3f160d66, 0x3f0040b0,
         0x3f73b652, 0x3f149ab0, 0x3efba200, 0x3e7c0390, 0x3f01f698, 0x3f2e6f96,
         0x3e4d08b0, 0x3f58a78a, 0x3c923cc0, 0x3f2ab0e4, 0x3e7abcf0, 0x3f5c4f64,
         0x3f13ef58, 0x3f4d7434, 0x3f7727fa, 0x3f4325a2, 0x3f67b0d4, 0x3d691800,
         0x3f00261c, 0x3ecb9648, 0x3f54e1de, 0x3f2a111a, 0x3e83bde0, 0x3f52a896,
         0x3ebf5394, 0x3ea6c45c, 0x3db47560, 0x3f2e5c88, 0x3f1e3056, 0x3e056a48,
         0x3eecdbf8, 0x3f7c06ce, 0x3f1e2fac, 0x3eff6428, 0x3ec87ed4, 0x3e9f40b0,
         0x3f0e6418, 0x3f1f5010, 0x3f01f70a, 0x3f79d370, 0x3eccbf30, 0x3f771948,
         0x3f4eabac, 0x3f420ede, 0x3ee5cfb0, 0x3f004a62, 0x3eff7e48, 0x3e9858c8,
         0x3f734d40, 0x3f7a8f46, 0x3eff4708, 0x3e6cbc70, 0x3f6932f0, 0x3ed97cf0,
         0x3c360680, 0x3f4ed806, 0x3f22602a, 0x3f7db976, 0x3f54ada4, 0x3f2dc3cc,
         0x3eedb718, 0x3d97d140, 0x3f44b96c, 0x3f06eebe, 0x3f01d608, 0x3e579db8,
         0x3ecbb3ac, 0x3ecea890, 0x3eaab9a0, 0x3f7efe8a, 0x3e536c68, 0x3f2ec234,
         0x3e0e4078, 0x3e6168e0, 0x3efda424, 0x3f760632, 0x3f287d28, 0x3ec981a4,
         0x3f4f1cb4, 0x3ea85510, 0x3f47af9c, 0x3eb353a4, 0x3f14de42, 0x3efd6748,
         0x3e42cfd0, 0x3f482be2, 0x3e8b084c, 0x3f281bba],
    ],
    2: [
        [0x3f07bf2c, 0x3ea07100, 0x3f66cab0, 0x3f32c5f2, 0x3f1e398c, 0x3f1f31b2,
         0x3f37be40, 0x3e56bba0, 0x3cbf9840, 0x3f3d1f6c, 0x3f160d66, 0x3f0040b0,
         0x3f73b652, 0x3f149ab0, 0x3efba200, 0x3e7c0390, 0x3f01f698, 0x3f2e6f96,
         0x3e4d08b0, 0x3f58a78a, 0x3c923cc0, 0x3f2ab0e4, 0x3e7abcf0, 0x3f5c4f64,
         0x3f13ef58, 0x3f4d7434, 0x3f7727fa, 0x3f4325a2, 0x3f67b0d4, 0x3d691800,
         0x3f00261c, 0x3ecb9648, 0x3f54e1de, 0x3f2a111a, 0x3e83bde0, 0x3f52a896,
         0x3ebf5394, 0x3ea6c45c, 0x3db47560, 0x3f2e5c88, 0x3f1e3056, 0x3e056a48,
         0x3eecdbf8, 0x3f7c06ce, 0x3f1e2fac, 0x3eff6428, 0x3ec87ed4, 0x3e9f40b0,
         0x3f0e6418, 0x3f1f5010],
        [0x3f3a4834, 0x3f49b1b0, 0x3e3a0e10, 0x3e867778, 0x3de2c610, 0x3e4f7e70,
         0x3ea2a810, 0x3dd83540, 0x3edc13f0, 0x3ef5f5a8, 0x3eae3584, 0x3eb1a06c,
         0x3f67b9bc, 0x3f15d860, 0x3f28e21e, 0x3ec5ac4c, 0x3e2b3e58, 0x3f2c62d2,
         0x3ea8dd54, 0x3e34f388, 0x3ec92f1c, 0x3f408e22, 0x3ea0a8d0, 0x3f31bcbe,
         0x3ee2e8d8, 0x3f087b66, 0x3f450a5a, 0x3f651662, 0x3f4a2778, 0x3e08a3b0,
         0x3e7e2860, 0x3d708220, 0x3ec2db48, 0x3f2737e8, 0x3e421f30, 0x3be60400,
         0x3f530512, 0x3e316cd8, 0x3f2e562e, 0x3e91e26c, 0x3ef8b66c, 0x3f3e6a76,
         0x3e7f2238, 0x3ed29040, 0x3e265c68, 0x3c97a200, 0x3f77682c, 0x3f25c21a,
         0x3f4fb612, 0x3ec712ac],
    ],
    4: [
        [0x3f07bf2c, 0x3ea07100, 0x3f66cab0, 0x3f32c5f2, 0x3f1e398c, 0x3f1f31b2,
         0x3f37be40, 0x3e56bba0, 0x3cbf9840, 0x3f3d1f6c, 0x3f160d66, 0x3f0040b0,
         0x3f73b652, 0x3f149ab0, 0x3efba200, 0x3e7c0390, 0x3f01f698, 0x3f2e6f96,
         0x3e4d08b0, 0x3f58a78a, 0x3c923cc0, 0x3f2ab0e4, 0x3e7abcf0, 0x3f5c4f64,
         0x3f13ef58],
        [0x3f3a4834, 0x3f49b1b0, 0x3e3a0e10, 0x3e867778, 0x3de2c610, 0x3e4f7e70,
         0x3ea2a810, 0x3dd83540, 0x3edc13f0, 0x3ef5f5a8, 0x3eae3584, 0x3eb1a06c,
         0x3f67b9bc, 0x3f15d860, 0x3f28e21e, 0x3ec5ac4c, 0x3e2b3e58, 0x3f2c62d2,
         0x3ea8dd54, 0x3e34f388, 0x3ec92f1c, 0x3f408e22, 0x3ea0a8d0, 0x3f31bcbe,
         0x3ee2e8d8],
        [0x3f2ad048, 0x3f38b35a, 0x3e01d678, 0x3eb563c8, 0x3ed79950, 0x3d2c55c0,
         0x3d08cda0, 0x3ea4f160, 0x3ef97958, 0x3d1aa1e0, 0x3f6be9b6, 0x3f102030,
         0x3f58c246, 0x3ec79c44, 0x3e44db28, 0x3e31a5e0, 0x3f5287ce, 0x3d9a3a00,
         0x3e78e508, 0x3f2d8f04, 0x3e8a84dc, 0x3f31aa42, 0x3f01abd4, 0x3f3178e4,
         0x3f73f6cc],
        [0x3ec72c98, 0x3daf9660, 0x3d50fae0, 0x3f1f28fa, 0x3eb35b50, 0x3f149806,
         0x3f10ff90, 0x3e4364c0, 0x3f0624c2, 0x3e9e1400, 0x3f46a426, 0x3d5fa040,
         0x3f1b76a2, 0x3e10aa00, 0x3f61d4c4, 0x3f3633a0, 0x3f4d12be, 0x3e3a2258,
         0x3f56b726, 0x3ec1add8, 0x3e861f70, 0x3f2b6b92, 0x3efd0c08, 0x3f4aafb2,
         0x3e019a60],
    ],
    8: [
        [0x3f07bf2c, 0x3ea07100, 0x3f66cab0, 0x3f32c5f2, 0x3f1e398c, 0x3f1f31b2,
         0x3f37be40, 0x3e56bba0, 0x3cbf9840, 0x3f3d1f6c, 0x3f160d66, 0x3f0040b0,
         0x3f73b652],
        [0x3f3a4834, 0x3f49b1b0, 0x3e3a0e10, 0x3e867778, 0x3de2c610, 0x3e4f7e70,
         0x3ea2a810, 0x3dd83540, 0x3edc13f0, 0x3ef5f5a8, 0x3eae3584, 0x3eb1a06c,
         0x3f67b9bc],
        [0x3f2ad048, 0x3f38b35a, 0x3e01d678, 0x3eb563c8, 0x3ed79950, 0x3d2c55c0,
         0x3d08cda0, 0x3ea4f160, 0x3ef97958, 0x3d1aa1e0, 0x3f6be9b6, 0x3f102030,
         0x3f58c246],
        [0x3ec72c98, 0x3daf9660, 0x3d50fae0, 0x3f1f28fa, 0x3eb35b50, 0x3f149806,
         0x3f10ff90, 0x3e4364c0, 0x3f0624c2, 0x3e9e1400, 0x3f46a426, 0x3d5fa040,
         0x3f1b76a2],
        [0x3f3e65b8, 0x3f11a048, 0x3f720608, 0x3f47bf10, 0x3f4623e2, 0x3f1b42c0,
         0x3f22defe, 0x3ee6a50c, 0x3f7dd018, 0x3e82c8bc, 0x3f603434, 0x3f54b5f4,
         0x3f0e8048],
        [0x3ed419d4, 0x3cbfd480, 0x3e8a9d50, 0x3e3a64f8, 0x3f6f38de, 0x3eeb6ea0,
         0x3e871cc4, 0x3f09bb6e, 0x3ee49d68, 0x3f010918, 0x3ea855ec, 0x3f62a288,
         0x3f1b4df6],
        [0x3ecc974c, 0x3e85e90c, 0x3e7c8580, 0x3f05bb44, 0x3f1c0af0, 0x3f6c0002,
         0x3f278dca, 0x3f6f8fae, 0x3e826224, 0x3b62a800, 0x3e883c88, 0x3f3dfce2,
         0x3ed8961c],
        [0x3f1d1304, 0x3efe084c, 0x3f0f889e, 0x3f1e9306, 0x3f04d828, 0x3f0474bc,
         0x3d8f5740, 0x3f585572, 0x3dcd1190, 0x3e9d7c70, 0x3f0016c2, 0x3cf55b00,
         0x3f7fefc8],
    ],
}
_PICK_BY_SAMPLES = {100: KMEANS_PICK, 104: np.asarray([76, 90, 103], np.int32)}


def shard_quota(n_shards: int) -> int:
    """Samples each of n_shards shards draws: ceil(100 / n_shards)."""
    return -(-GMM_SAMPLES // n_shards)


def shard_draws(n_shards: int):
    """The sharded ICP's draws for n_shards shards: (u (S, quota) float32,
    the k-means start (3,) int32 over S * quota samples). Raises for a
    shard count that has no committed draws."""
    if n_shards not in SHARD_COUNTS:
        raise ValueError(f"the port carries the sharded ICP's draws for {SHARD_COUNTS} shards "
                         f"only, not {n_shards}")
    u = np.asarray(_SHARD_U_BITS[n_shards], np.uint32).view(np.float32)
    return u, _PICK_BY_SAMPLES[n_shards * shard_quota(n_shards)].copy()


def _kernel_weight_np(r, delta, kernel_type):
    r = np.abs(r)
    if kernel_type == "huber":
        return np.where(r <= delta, 1.0, delta / np.maximum(r, 1e-30))
    if kernel_type == "cauchy":
        return delta**2 / (delta**2 + r**2)
    if kernel_type == "tukey":
        x = r / delta
        return np.where(x < 1.0, (1 - x**2) ** 2, 0.0)
    if kernel_type == "welsch":
        return np.exp(-(r**2) / (delta**2) / 2.0)
    if kernel_type == "gemanMcClure":
        return r * delta**2 / (delta**2 + r**2) ** 2
    if kernel_type == "pseudoHuber":
        return delta**2 / (delta**2 + r**2) ** 1.5
    return delta**2 / (delta**2 + r**2)  # default: cauchy


def kernel_weight(r: torch.Tensor, delta, kernel_type: str) -> torch.Tensor:
    """Robust kernel weights of residuals r at scale delta (the table of
    _kernel_weight_np, in torch)."""
    r = torch.abs(r)
    if kernel_type == "huber":
        return torch.where(r <= delta, 1.0, delta / torch.clamp(r, min=1e-30))
    if kernel_type == "tukey":
        x = r / delta
        return torch.where(x < 1.0, (1 - x**2) ** 2, 0.0)
    if kernel_type == "welsch":
        return torch.exp(-(r**2) / (delta**2) / 2.0)
    if kernel_type == "gemanMcClure":
        return r * delta**2 / (delta**2 + r**2) ** 2
    if kernel_type == "pseudoHuber":
        return delta**2 / (delta**2 + r**2) ** 1.5
    return delta**2 / (delta**2 + r**2)  # cauchy, and the default


@dataclass(frozen=True)
class PKOConstants:
    alphas: torch.Tensor     # (A,) candidate scales (index 0 = min, skipped)
    Z: torch.Tensor          # (A,) partition functions
    r_grid: torch.Tensor     # (G,) residual grid
    Q: torch.Tensor          # (A, G) normalised kernel distribution + eps
    u: torch.Tensor          # (100,) the strata uniforms
    pick: torch.Tensor       # (3,) int32 k-means start indices
    kernel_type: str = "huber"
    gmm_components: int = GMM_COMPONENTS
    gmm_sample_size: int = GMM_SAMPLES


def make_pko_constants(min_scale: float, max_scale: float, num_segments: int,
                       truncated_threshold: float, kernel_type: str,
                       gmm_components: int, gmm_sample_size: int,
                       device="cuda") -> PKOConstants:
    """Alpha grid, Z(alpha) and Q(r|alpha), computed in float64 numpy as
    the JAX package does, stored as float32 on `device`."""
    if (gmm_sample_size, gmm_components) != (GMM_SAMPLES, GMM_COMPONENTS):
        raise ValueError(
            "the port carries the JAX PRNGKey(42) draws for 100 samples and "
            f"3 components only, not ({gmm_sample_size}, {gmm_components})")
    alphas = np.empty(num_segments + 1)
    alphas[0] = min_scale
    t = np.arange(1, num_segments + 1) / num_segments
    alphas[1:] = min_scale + (max_scale - min_scale) * (np.power(100.0, t) - 1.0) / 99.0
    xs = np.arange(0.0, truncated_threshold + 1e-9, 0.01)
    kv = _kernel_weight_np(xs[None, :], alphas[:, None], kernel_type)
    Z = np.maximum(kv.sum(axis=1) * 0.01, 1e-10)
    g = 100
    dr = truncated_threshold / g
    r_grid = dr * (1.0 + np.arange(g))
    q = _kernel_weight_np(r_grid[None, :], alphas[:, None], kernel_type)
    Q = q / (Z[:, None] + 1e-10) + 1e-10
    return from_arrays(dict(alphas=alphas, Z=Z, r_grid=r_grid, Q=Q),
                       kernel_type, device)


def from_arrays(arrays: dict, kernel_type: str, device) -> PKOConstants:
    f = lambda k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
    return PKOConstants(
        alphas=f("alphas"), Z=f("Z"), r_grid=f("r_grid"), Q=f("Q").contiguous(),
        u=torch.as_tensor(STRATA_U.copy(), device=device),
        pick=torch.as_tensor(KMEANS_PICK.copy(), device=device),
        kernel_type=kernel_type)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def norm_scale_from(abs_resid: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Iteration-0 normalisation scale: population std / 6 of the valid
    residual magnitudes, over the last axis."""
    w = valid.to(abs_resid.dtype)
    n = torch.clamp(torch.sum(w, -1), min=1.0)
    mean = torch.sum(torch.where(valid, abs_resid, 0.0), -1) / n
    var = torch.sum(torch.where(valid, (abs_resid - mean[..., None]) ** 2, 0.0), -1) / n
    return torch.sqrt(var) / 6.0


def stratified_sample(residuals: torch.Tensor, valid: torch.Tensor,
                      u: torch.Tensor, m: int = GMM_SAMPLES) -> torch.Tensor:
    """One residual per stratum of the valid entries' ranks (feature order)."""
    n = residuals.shape[0]
    n_valid = torch.sum(valid.to(torch.int32))
    rank = torch.cumsum(valid.to(torch.int32), 0) - 1
    idx_of_rank = torch.zeros((n + 1,), dtype=torch.int64, device=residuals.device)
    idx_of_rank[torch.where(valid, rank, n).to(torch.int64)] = torch.arange(
        n, device=residuals.device)
    j = torch.arange(m, dtype=torch.float32, device=residuals.device)
    # divided by a tensor: CUDA multiplies by a Python scalar divisor's
    # reciprocal, which rounds differently from the kernels' division
    k = torch.floor((j + u) * n_valid.to(torch.float32)
                    / torch.full((), float(m), device=residuals.device)).to(torch.int64)
    k = torch.minimum(torch.clamp(k, min=0), torch.clamp(n_valid - 1, min=0))
    samples = residuals[idx_of_rank[k]]
    ok = torch.arange(m, device=residuals.device) < n_valid
    return torch.where(ok, samples, residuals[idx_of_rank[0]])


def _gaussian_pdf(x, mean, var):
    var = torch.clamp(var, min=1e-12)
    d = x - mean
    return torch.exp(-0.5 * d * d / var) / torch.sqrt(2.0 * math.pi * var)


def fit_gmm(samples: torch.Tensor, pick: torch.Tensor, kk: int = GMM_COMPONENTS,
            rounds: bool = False):
    """k-means start (component 0 pinned at 0), then EM. Python loops with
    the JAX stop rules: k-means while changed and it < 100, EM while
    change >= 1e-6 and it < 100. Returns (weights, means, variances), and
    with rounds=True also the (k-means, EM) round counts."""
    n = samples.shape[0]
    means = samples[pick.to(torch.int64)].clone()
    means[0] = 0.0
    changed, it = True, 0
    while changed and it < 100:
        assign = torch.argmin(torch.abs(samples[:, None] - means[None, :]), dim=1)
        one_hot = torch.nn.functional.one_hot(assign, kk).to(samples.dtype)
        cnt = one_hot.sum(0)
        new = (one_hot * samples[:, None]).sum(0) / torch.clamp(cnt, min=1.0)
        new = torch.where(cnt > 0, new, means)
        new[0] = 0.0
        changed = bool(torch.any(new != means))
        means, it = new, it + 1
    km_rounds = it
    data_mean = samples.mean()
    variances = torch.full((kk,), float(torch.mean((samples - data_mean) ** 2)),
                           dtype=samples.dtype, device=samples.device)
    assign = torch.argmin(torch.abs(samples[:, None] - means[None, :]), dim=1)
    weights = torch.nn.functional.one_hot(assign, kk).to(samples.dtype).sum(0) / n
    change, it = math.inf, 0
    while change >= _EM_TOL and it < 100:
        resp = weights[None, :] * _gaussian_pdf(samples[:, None], means[None, :],
                                                variances[None, :])
        # JAX's max(., 1e-300) is max(., 0) in float32
        resp = resp / torch.clamp(resp.sum(1, keepdim=True), min=0.0)
        Nk = torch.clamp(resp.sum(0), min=1e-12)
        new_w = Nk / n
        new_mu = (resp * samples[:, None]).sum(0) / Nk
        new_mu[0] = 0.0
        diff = samples[:, None] - new_mu[None, :]
        new_var = torch.clamp((resp * diff * diff).sum(0) / Nk, min=1e-6)
        change = float(torch.sum(torch.abs(new_mu[1:] - means[1:])))
        weights, means, variances, it = new_w, new_mu, new_var, it + 1
    if rounds:
        return weights, means, variances, (km_rounds, it)
    return weights, means, variances


def _first_argmin(cost: torch.Tensor) -> torch.Tensor:
    """jnp.argmin: the first NaN if there is one, else the first minimum."""
    nan = torch.isnan(cost)
    idx = torch.arange(cost.shape[0], device=cost.device)
    first_nan = torch.min(torch.where(nan, idx, cost.shape[0]))
    m = torch.min(torch.where(nan, math.inf, cost))
    first_min = torch.min(torch.where(cost == m, idx, cost.shape[0]))
    return torch.where(torch.any(nan), first_nan, first_min).to(torch.int32)


def alpha_index_from_samples(samples: torch.Tensor, consts: PKOConstants,
                             pick: torch.Tensor = None) -> torch.Tensor:
    """The JS-argmin alpha index of the GMM fitted to `samples`, from the
    k-means start `pick` (consts.pick, the draw for 100 samples, unless
    given)."""
    w, mu, var = fit_gmm(samples, consts.pick if pick is None else pick, consts.gmm_components)
    r = consts.r_grid
    P = (w[None, :] * _gaussian_pdf(r[:, None], mu[None, :], var[None, :])).sum(1) + 1e-10
    Q = consts.Q
    M = 0.5 * (P[None, :] + Q)
    jsd = 0.5 * (P[None, :] * torch.log(P[None, :] / M) + Q * torch.log(Q / M))
    cost = torch.mean(jsd, dim=1)
    cost[0] = math.inf
    return _first_argmin(cost)


def pko_alpha_from_samples(samples: torch.Tensor, consts: PKOConstants,
                           pick: torch.Tensor = None) -> torch.Tensor:
    """The JS-argmin kernel scale alpha (a () tensor) of the GMM fitted to
    an already drawn sample of normalised residuals."""
    return consts.alphas[alpha_index_from_samples(samples, consts, pick).to(torch.int64)]


def pko_scale_factor(residuals: torch.Tensor, valid: torch.Tensor,
                     consts: PKOConstants) -> torch.Tensor:
    """The kernel scale alpha (a () tensor) of normalised residual
    magnitudes |r| / scale (N,) f32 under the (N,) bool mask: the
    stratified sample, the GMM fit and the JS argmin of one K3 launch
    (scale 1, so the kernel's normalisation leaves the values as they
    are)."""
    dev = residuals.device
    aux, _ = pko_alpha_index(
        residuals.to(torch.float32).contiguous(), valid.to(torch.bool).contiguous(),
        torch.zeros((3,), dtype=torch.int32, device=dev),
        torch.ones((1,), dtype=torch.float32, device=dev), False, consts)
    return consts.alphas[aux[1].to(torch.int64)]


def pko_alpha_index_plain(resid, valid, scale, compute_scale: bool,
                          consts: PKOConstants):
    """Plain twin of K3, on the signed residuals. Returns (alpha_index ()
    int32, count () int32, scale () float32)."""
    r_abs = torch.abs(resid)
    if compute_scale:
        scale = norm_scale_from(r_abs, valid)
    norm = r_abs / torch.clamp(scale, min=1e-6)
    samples = stratified_sample(norm, valid, consts.u)
    count = torch.sum(valid.to(torch.int32))
    return alpha_index_from_samples(samples, consts), count, scale.reshape(())


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def pko_alpha_index(resid, valid, flags, scale, compute_scale: bool,
                    consts: PKOConstants):
    """K3's wrapper. resid (N,) f32 signed residuals, valid (N,) bool, flags (3,) int32
    [done, failed, n_corr] (a done solve skips the work), scale (1,) f32;
    for B lanes each with a leading B. Returns (aux (2,) int32 [count,
    alpha_index], zero when done, scale_out (1,) f32), with the leading B
    for lanes. CPU tensors take the plain version, lane by lane."""
    if not resid.is_cuda:
        if resid.dim() == 2:
            outs = [pko_alpha_index(resid[b], valid[b], flags[b], scale[b], compute_scale,
                                    consts) for b in range(resid.shape[0])]
            return tuple(torch.stack(c) for c in zip(*outs))
        if bool(flags[0]):    # done: the kernel returns at once too
            return torch.zeros((2,), dtype=torch.int32), scale
        a, c, s = pko_alpha_index_plain(resid, valid, scale.reshape(()),
                                        compute_scale, consts)
        return torch.stack([c, a]).to(torch.int32), s.reshape(1)
    lead = tuple(resid.shape[:-1])
    if len(lead) > 1:
        raise kernels.KernelInputError("pko_alpha_index: expected (N,) or (B, N) residuals")
    n = resid.shape[-1]
    kernels.check(resid, "resid", torch.float32, lead + (n,))
    kernels.check(valid, "valid", torch.bool, lead + (n,))
    kernels.check(flags, "flags", torch.int32, lead + (3,))
    kernels.check(scale, "scale", torch.float32, lead + (1,))
    n_alpha, n_grid = consts.Q.shape
    aux = torch.empty(lead + (2,), dtype=torch.int32, device=resid.device)
    scale_out = torch.empty(lead + (1,), dtype=torch.float32, device=resid.device)
    kernels.KERNELS["pko_alpha"].launch(
        resid.data_ptr(), valid.data_ptr(), n, lead[0] if lead else 1, flags.data_ptr(),
        scale.data_ptr(), int(compute_scale), consts.u.data_ptr(), consts.pick.data_ptr(),
        consts.alphas.data_ptr(), consts.r_grid.data_ptr(), consts.Q.data_ptr(),
        n_alpha, n_grid, scale_out.data_ptr(), aux.data_ptr())
    return aux, scale_out
