"""The port's voxel filter (kernel K1's plain path) against the JAX filter
and a numpy per-voxel mean, on the same scans (CPU).

Scans stay below the output capacity: the JAX filter folds the segments
past its capacity into the last kept one, a fault of the reference that
the port does not copy. The JAX centroids carry its f32 prefix-sum error,
hence 2e-4 against JAX (tests/test_voxel_filter.py) and 1.5e-5 against the
direct numpy mean."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import voxel_filter as jvf
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import voxel_filter as tvf


def _scan(seed, n_points=6000, max_range=50.0):
    world = synthetic.make_world(seed=seed, extent=60.0, n_buildings=14)
    pose = synthetic.straight_trajectory(1)[0]
    rng = np.random.default_rng(seed)
    s = synthetic.sample_scan(world, pose, n_points, rng, max_range=max_range, noise=0.01)
    raw = np.full((15000, 3), np.nan, np.float32)
    raw[:len(s)] = s
    return raw


def _numpy_mean(pts, voxel):
    keys = np.floor(pts.astype(np.float64) / voxel).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, pts.astype(np.float64))
    cnt = np.bincount(inv, minlength=len(uniq))
    return uniq, sums / cnt[:, None]


@pytest.mark.parametrize("seed,stride,compact", [
    (0, 1, True), (1, 2, True), (2, 1, False), (3, 3, False)])
def test_filter_matches_jax_and_numpy(seed, stride, compact):
    raw = _scan(seed)
    cap, vox = 8192, 0.5
    jc, jm, jn = jvf.voxel_filter(jnp.asarray(raw), jnp.int32(raw.shape[0]),
                                  voxel_size=vox, stride=stride, out_capacity=cap,
                                  compact_keys=compact)
    tc, tm, tn = tvf.voxel_filter(torch.as_tensor(raw), raw.shape[0], voxel_size=vox,
                                  stride=stride, out_capacity=cap, compact_keys=compact)
    assert int(tn) == int(jn) < cap
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    n = int(tn)
    tcn, jcn = tc.numpy()[:n], np.asarray(jc)[:n]
    # same order: centroids of distinct voxels differ by far more than 2e-4
    np.testing.assert_allclose(tcn, jcn, atol=2e-4)
    assert np.all(tc.numpy()[n:] == 0.0)

    pts = raw[::stride]
    pts = pts[np.all(np.isfinite(pts), axis=1)]
    uniq, mean = _numpy_mean(pts, vox)
    # the port's order: x-major for the compact key, z-major for the map key
    order = (np.arange(len(uniq)) if compact
             else np.lexsort((uniq[:, 1], uniq[:, 0], uniq[:, 2])))
    np.testing.assert_allclose(tcn, mean[order], atol=1.5e-5)


def test_compact_order_is_x_major():
    """Features come out in the compact key's x-major order, which is what
    PKO's rank-stratified sample walks."""
    raw = _scan(4)
    tc, _, tn = tvf.voxel_filter(torch.as_tensor(raw), raw.shape[0], voxel_size=0.5,
                                 stride=1, out_capacity=8192, compact_keys=True)
    c = np.floor(tc.numpy()[:int(tn)] / 0.5).astype(np.int64) + 512
    key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    assert np.all(np.diff(key) > 0)


def test_envelope_nonfinite_and_padding():
    pts = np.array([[0.1, 0.1, 0.1], [300.0, 0.0, 0.0], [np.nan, 0, 0],
                    [0.2, 0.1, 0.1], [-255.9, 0.0, 0.0], [np.inf, 1, 1],
                    [5.0, 5.0, 5.0], [7.0, 7.0, 7.0]], np.float32)
    for compact in (True, False):
        jc, jm, jn = jvf.voxel_filter(jnp.asarray(pts), jnp.int32(7), voxel_size=0.5,
                                      stride=1, out_capacity=16, compact_keys=compact)
        tc, tm, tn = tvf.voxel_filter(torch.as_tensor(pts), 7, voxel_size=0.5, stride=1,
                                      out_capacity=16, compact_keys=compact)
        assert int(tn) == int(jn) == (3 if compact else 4)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


@pytest.mark.parametrize("compact", [True, False])
def test_lanes_equal_one_lane_each_and_jax_vmap(compact):
    """A (B, N, 3) stack filters each lane exactly as the one-scan filter
    does (same order, so PKO's rank sample sees the same features), and
    as jax.vmap of the JAX filter does at the 2e-4 above."""
    raws = np.stack([_scan(s) for s in (5, 6, 7)])
    cap, vox, n = 8192, 0.5, raws.shape[1]
    kw = dict(voxel_size=vox, stride=1, out_capacity=cap, compact_keys=compact)
    tc, tm, tn = tvf.voxel_filter(torch.as_tensor(raws), n, **kw)
    assert tc.shape == (3, cap, 3) and tm.shape == (3, cap) and tn.shape == (3,)
    for b in range(3):
        c1, m1, n1 = tvf.voxel_filter(torch.as_tensor(raws[b]), n, **kw)
        assert torch.equal(tc[b], c1) and torch.equal(tm[b], m1) and torch.equal(tn[b], n1)
    jc, jm, jn = jax.vmap(lambda r: jvf.voxel_filter(r, jnp.int32(n), **kw))(jnp.asarray(raws))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)
