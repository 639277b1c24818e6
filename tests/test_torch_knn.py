"""The port's point-table k-NN (ops/knn.py: K6a's and K6b's plain twins on
the CPU) against the JAX package's ops/knn.py on the same numpy clouds.

Tolerances: the table (sorted keys, permuted points, dense grid, origin,
fits, count) is exact. The k-NN picks the same candidates, in the same
order, with the same validity flags, and the same points (exact); the
distances agree to 1e-6 m (float32 rounding of the sum of squares).
Cases: k = 5 and 1, radius 1 and 2, bucket widths 4 and 8, on a cloud
whose 2 m bins hold up to ~40 points (fuller than either width, so which
points a probe sees depends on the stable sort), and on a cloud wider
than the 128 x 128 x 32 dense window at 0.5 m bins (the binary-search
path)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidar_odometry_tpu.ops import knn as jknn
from lidar_odometry_tpu.utils import keys as JK
from lidar_odometry_tpu_torch.ops import knn
from lidar_odometry_tpu_torch.utils import keys as K


def _dense_cloud(seed=0, n=3000):
    """Clustered points: 2 m bins far fuller than the probe width."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-12, -12, -2], [12, 12, 4], (n, 3)).astype(np.float32)
    pts[: n // 3] = rng.normal([2.0, -3.0, 0.5], 0.8, (n // 3, 3)).astype(np.float32)
    mask = rng.random(n) > 0.1
    return pts, mask


def _wide_cloud(seed=1, n=2000):
    """A cloud 150 m wide: outside the dense window at 0.5 m bins."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-75, -20, -2], [75, 20, 3], (n, 3)).astype(np.float32)
    return pts, np.ones(n, bool)


def _queries(pts, seed=2, n=600):
    """Points near the cloud's, and 40 far from it (no candidate)."""
    rng = np.random.default_rng(seed)
    q = pts[rng.integers(0, len(pts), n)] + rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    far = rng.uniform(-5, 5, (40, 3)) + np.array([0.0, 0.0, 60.0])
    return np.concatenate([q, far]).astype(np.float32)


def _tables(pts, mask, bin_size):
    jt = jknn.build_point_table(jnp.asarray(pts), jnp.asarray(mask), bin_size=bin_size)
    pt = knn.build_point_table(torch.as_tensor(pts), torch.as_tensor(mask), bin_size=bin_size)
    return jt, pt


@pytest.mark.parametrize("cloud,bin_size,fits", [("dense", 2.0, True), ("wide", 0.5, False)])
def test_point_table_matches_jax(cloud, bin_size, fits):
    pts, mask = _dense_cloud() if cloud == "dense" else _wide_cloud()
    jt, pt = _tables(pts, mask, bin_size)
    jkey = K.sort_key(torch.as_tensor(np.asarray(jt.hi).astype(np.int64)),
                      torch.as_tensor(np.asarray(jt.lo).astype(np.int64)))
    np.testing.assert_array_equal(pt.key.numpy(), jkey.numpy())
    np.testing.assert_array_equal(pt.pts.numpy(), np.asarray(jt.pts))
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(jt.valid))
    assert bool(pt.fits) == bool(jt.fits) == fits
    assert int(pt.n) == int(jt.n) == int(mask.sum())
    if fits:
        np.testing.assert_array_equal(pt.origin.numpy(), np.asarray(jt.origin))
        np.testing.assert_array_equal(pt.grid.numpy(), np.asarray(jt.grid))
    # bins fuller than the widest probe, so the stable order matters
    _, counts = np.unique(pt.key.numpy()[pt.valid.numpy()], return_counts=True)
    assert counts.max() > (8 if cloud == "dense" else 1)


def _check_knn(jt, pt, q, k, radius, width):
    jn, jo, jd = jknn.knn_query(jt, jnp.asarray(q), bin_size=float(1.0 / pt.inv), k=k,
                                radius=radius, bucket_width=width)
    pn, po, pd = knn.knn_query(pt, torch.as_tensor(q), k=k, radius=radius, bucket_width=width)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    jd, pd = np.asarray(jd), pd.numpy()
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(pd[fin], jd[fin], atol=1e-6, rtol=0)
    assert po.numpy().any() and not po.numpy().all()


@pytest.mark.parametrize("k", [5, 1])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("width", [4, 8])
def test_knn_matches_jax_dense_window(k, radius, width):
    pts, mask = _dense_cloud()
    jt, pt = _tables(pts, mask, 2.0)
    _check_knn(jt, pt, _queries(pts), k, radius, width)


@pytest.mark.parametrize("k", [5, 1])
def test_knn_matches_jax_binary_search(k):
    pts, mask = _wide_cloud()
    jt, pt = _tables(pts, mask, 0.5)
    assert not bool(pt.fits)
    _check_knn(jt, pt, _queries(pts, n=400), k, 1, 4)


def test_nn1_distance_matches_jax():
    pts, mask = _dense_cloud(seed=5)
    jt, pt = _tables(pts, mask, 2.0)
    q = _queries(pts, seed=6)
    jd = np.asarray(jknn.nn1_distance(jt, jnp.asarray(q), bin_size=2.0, radius=1,
                                      bucket_width=8))
    pd = knn.nn1_distance(pt, torch.as_tensor(q), radius=1, bucket_width=8).numpy()
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd))
    np.testing.assert_allclose(pd[np.isfinite(jd)], jd[np.isfinite(jd)], atol=1e-6, rtol=0)


def test_sort_key_round_trip():
    c = torch.tensor([[-5, 7, -3], [32767, -32768, 123456], [0, 0, -(1 << 31)]],
                     dtype=torch.int32)
    hi, lo = K.pack_key(c)
    h2, l2 = K.split_sort_key(K.sort_key(hi, lo))
    assert torch.equal(h2, hi) and torch.equal(l2, lo)
    jhi, jlo = JK.pack_key(jnp.asarray(c.numpy()))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
