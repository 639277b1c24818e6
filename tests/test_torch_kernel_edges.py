"""The plain twins of K1 and K10c on the edge cases their card tests
(tests/test_torch_kernels.py) hold the kernels to, on the CPU.

K1: scans made of voxel runs of known lengths (synthetic.voxel_runs) that
cross the kernel's 512-entry tiles, one run longer than a tile, n not a
multiple of the tile, all keys invalid, more voxels than the output
capacity. The port's filter against the JAX filter (below the capacity:
the JAX filter folds the segments past it into the last kept one, a fault
the port does not copy) at the 2e-4 of tests/test_torch_voxel_filter.py,
and against a numpy float64 per-voxel mean at 2e-5 (a run of 1500 points
adds 1500 float32 terms).

K10c: synthetic separator systems (synthetic.separator_system) at D = 1,
D not a multiple of the kernel's 4-separator panel, and D = 200, with a
loop block given twice and an invalid loop: the twin's xs against a numpy
float64 assembly of the same blocks (scatter-adds, then (H + H^T) / 2)
solved by numpy at 1e-10 of max|xs|, its backward error at most 1e-13, and
NaN everywhere for a system that is not positive definite.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import voxel_filter as jvf
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import voxel_filter as tvf
from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo

# the card tests' K1 cases: (run lengths, invalid rows, cap)
K1_CASES = {
    "runs_cross_tile_boundaries": ([3] * 700, 0, 8192),
    "run_longer_than_a_tile": ([2] * 300 + [1500] + [1] * 200, 0, 8192),
    "n_not_a_multiple_of_the_tile": ([1, 2, 5] * 333, 7, 8192),
    "all_keys_invalid": ([], 1000, 256),
    "more_voxels_than_cap": ([2] * 900 + [1] * 900, 0, 1000),
}


def _numpy_means(raw, voxel=0.5):
    """Per-voxel float64 means in the compact key's x-major order."""
    pts = raw[np.all(np.isfinite(raw), axis=1)].astype(np.float64)
    keys = np.floor(pts / voxel).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv.reshape(-1), pts)
    return sums / np.bincount(inv.reshape(-1), minlength=len(uniq))[:, None]


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_voxel_filter_twin_on_kernel_edges(case):
    counts, n_invalid, cap = K1_CASES[case]
    raw = synthetic.voxel_runs(counts, n_invalid, seed=len(counts))
    n = raw.shape[0]
    tc, tm, tn = tvf.voxel_filter(torch.as_tensor(raw), n, voxel_size=0.5, stride=1,
                                  out_capacity=cap, compact_keys=True)
    assert int(tn) == len(counts)
    live = min(len(counts), cap)
    assert tm.numpy().tolist() == [True] * live + [False] * (cap - live)
    assert np.all(tc.numpy()[live:] == 0.0)
    mean = _numpy_means(raw)
    np.testing.assert_allclose(tc.numpy()[:live], mean[:live], atol=2e-5)
    if len(counts) < cap:
        jc, jm, jn = jvf.voxel_filter(jnp.asarray(raw), jnp.int32(n), voxel_size=0.5, stride=1,
                                      out_capacity=cap, compact_keys=True)
        assert int(jn) == len(counts)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)


def _numpy_separator_solve(c):
    """xs of the separator system assembled block by block in float64
    numpy, in the order of the JAX scatter-adds, symmetrised and solved."""
    D = len(c["seps"])
    H = np.zeros((D, D, 6, 6))
    bs = np.zeros((D, 6))
    S = c["S"]
    for k in range(D):
        H[k, k] += c["diag"][c["seps"][k]] + S[k, 3]
        bs[k] += c["b"][c["seps"][k]] + c["r"][k, 1]
        if k > 0:
            H[k - 1, k - 1] += S[k, 0]
            H[k - 1, k] += S[k, 1]
            H[k, k - 1] += S[k, 2]
            bs[k - 1] += c["r"][k, 0]
        if c["adj_mask"][k]:
            H[k, k + 1] += c["off"][c["adj_off"][k]]
            H[k + 1, k] += c["off"][c["adj_off"][k]].T
    for l in range(len(c["loop_a"])):
        if c["loop_valid"][l]:
            H[c["loop_a"][l], c["loop_b"][l]] += c["lb"][l]
            H[c["loop_b"][l], c["loop_a"][l]] += c["lb"][l].T
    Hs = H.transpose(0, 2, 1, 3).reshape(6 * D, 6 * D)
    return np.linalg.solve((Hs + Hs.T) / 2, bs.reshape(-1)).reshape(D, 6)


def _twin(c):
    t = {k: torch.as_tensor(v) for k, v in c.items()}
    return dpgo.reduced_solve_plain(*[t[k] for k in ("diag", "off", "b", "lb", "S", "r")],
                                    *[t[k] for k in dpgo.RED_KEYS])


@pytest.mark.parametrize("D", [1, 5, 7, 200])
def test_separator_solve_twin_on_kernel_edges(D):
    c = synthetic.separator_system(D, 6, seed=D)
    assert D < 3 or len(c["loop_a"]) == 7   # 6 loops, the first pair twice, the last invalid
    xs, Hs, bs = _twin(c)
    ref = _numpy_separator_solve(c)
    np.testing.assert_allclose(xs.numpy(), ref, atol=1e-10 * np.abs(ref).max(), rtol=0)
    x = xs.reshape(-1)
    backward = float((Hs @ x - bs).abs().max() / (Hs.abs().sum(1).max() * x.abs().max()))
    assert backward <= 1e-13


def test_separator_solve_twin_not_positive_definite():
    xs = _twin(synthetic.separator_system(9, 3, seed=3, spd=False))[0]
    assert bool(torch.isnan(xs).all())
