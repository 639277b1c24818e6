"""KD-tree mode's kernels through their plain path — K5a grid_knn_neighbors
and K5b plane_fit_5nn — and plane_from_points, against the JAX package on
the same inputs (CPU).

A plane fit's float32 normal is only as good as the gap between the two
smallest eigenvalues of its covariance allows: its error grows like
eps * lambda_max / (lambda_1 - lambda_0), and on a line (gap 0) the
normal is not fixed by the data at all. Rows whose gap is within 1e-2 of
the largest eigenvalue are counted, and the normal and the distance are
compared on the rest; there the two agree to 5e-6 m."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import icp as jicp
from lidar_odometry_tpu.ops import voxel_map as jvm
from lidar_odometry_tpu.utils import eigh3 as jeigh
from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import icp as ticp
from lidar_odometry_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_tpu_torch.utils import eigh3 as teigh

C1, VOX = 4096, 0.5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's many small CPU ops: with the
    suite's parallel workers on one host, torch's default of one thread a
    core oversubscribes the cores and its threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """A JAX map of two keyframes (no surfels, as KD-tree mode builds it),
    carried across by convert.py, and queries around a third pose plus a
    few far from any voxel."""
    world = synthetic.make_world(seed=17, extent=40.0, n_buildings=8)
    poses = synthetic.straight_trajectory(3, step=1.0)
    rng = np.random.default_rng(17)
    js = jvm.empty_map(0, C1)
    for i in range(2):
        s = synthetic.sample_scan(world, poses[i], 5000, rng, max_range=35.0, noise=0.01)
        pts = np.zeros((6144, 3), np.float32)
        mask = np.zeros(6144, bool)
        pts[:len(s)] = s + poses[i][:3, 3]
        mask[:len(s)] = True
        js = jvm.update_map(js, jnp.asarray(pts), jnp.asarray(mask),
                            jnp.asarray(poses[i][:3, 3]), 120.0, voxel_size=VOX,
                            planarity_threshold=0.1, compute_surfels=False)
    q = synthetic.sample_scan(world, poses[2], 1500, rng, max_range=35.0, noise=0.05)
    q = np.concatenate([q + poses[2][:3, 3], rng.uniform(200.0, 300.0, (20, 3))])
    ts = convert.map_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                      device="cpu")
    return js, ts, q.astype(np.float32)


@pytest.mark.parametrize("radius", [1, 2])
def test_grid_knn_matches_jax(scene, radius):
    js, ts, q = scene
    jc, jok = jvm.grid_knn_neighbors(js, jnp.asarray(q), voxel_size=VOX, radius=radius)
    tc, tok = tvm.grid_knn_neighbors(ts, torch.as_tensor(q), voxel_size=VOX, radius=radius)
    jc, jok = np.asarray(jc), np.asarray(jok)
    assert tc.shape == ((len(q), (2 * radius + 1) ** 3, 3)) and tok.dtype == torch.bool
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6, rtol=0)
    n_ok = jok.sum(1)
    assert n_ok[-20:].max() == 0                       # far queries: nothing
    assert (n_ok >= 5).mean() > 0.5                    # most have a plane's worth


@pytest.mark.parametrize("radius", [1, 2])
def test_kd_correspondences_with_the_row_mask_in_grid_knn_match_jax(scene, radius):
    """K5a's wrapper with the row mask: the twin's flags ANDed with it,
    the centroids as without it; the KD-tree correspondences that pass the
    mask to it against JAX's _grid_plane_correspondences (which ANDs it
    after grid_knn_neighbors), at test_plane_fit_5nn_matches_jax's
    tolerances: validity, nearest point and selection exactly, centroid
    1e-5, distance and normal on the well-conditioned rows."""
    js, ts, q = scene
    mask = np.random.default_rng(radius).random(len(q)) < 0.7
    tq, tm = torch.as_tensor(q), torch.as_tensor(mask)
    tc, tok = tvm.grid_knn_neighbors(ts, tq, voxel_size=VOX, radius=radius, mask=tm)
    pc, pok = tvm.grid_knn_neighbors_plain(ts, tq, voxel_size=VOX, radius=radius)
    assert torch.equal(tc, pc) and torch.equal(tok, pok & tm[:, None])
    assert bool(tok.any()) and not bool(tok[~tm].any())
    jcfg = jicp.ICPConfig(voxel_size=VOX, grid_knn_radius=radius, max_correspondence_distance=0.1,
                          plane_fit_planarity=0.1)
    tcfg = ticp.ICPConfig(voxel_size=VOX, grid_knn_radius=radius, max_correspondence_distance=0.1,
                          plane_fit_planarity=0.1, use_surfel_correspondence=False)
    fit = jax.jit(jicp._grid_plane_correspondences, static_argnames=("cfg",))
    jn, jc, jnn, jv, jd = (np.asarray(x) for x in fit(js, jnp.asarray(q), jnp.asarray(mask),
                                                      jnp.eye(4, dtype=jnp.float32), cfg=jcfg))
    t = ticp._grid_plane_correspondences(ts, tq, tm, torch.eye(4), None, tcfg)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_array_equal(t.nearest.numpy(), jnn)
    np.testing.assert_allclose(t.centroid.numpy(), jc, atol=1e-5)
    jcand, jok = jvm.grid_knn_neighbors(js, jnp.asarray(q), voxel_size=VOX, radius=radius)
    jok = np.asarray(jok) & mask[:, None]
    d2 = np.where(jok, ((np.asarray(jcand) - q[:, None]) ** 2).sum(-1), np.inf)
    jsel = np.asarray(jax.lax.top_k(-jnp.asarray(d2), 5)[1])
    np.testing.assert_array_equal(t.sel.numpy(), jsel)
    nb = np.take_along_axis(np.asarray(jcand), jsel[..., None], 1).astype(np.float64)
    well = ~_degenerate(nb, np.take_along_axis(jok, jsel, 1))
    assert jv.sum() > 0 and well.sum() > 0
    np.testing.assert_allclose(t.dist.numpy()[well], jd[well], atol=1e-5)
    assert np.abs(np.sum(t.normal.numpy() * jn, -1))[well].min() > 1 - 1e-5


def _candidates(seed=3, n=600, k=27):
    """Candidate sets with exact ties (repeated points), rows with fewer
    than 5 ok entries, rows whose nearest three lie on a line, and rows
    with no ok entry."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    cand = p[:, None, :] + rng.normal(0.0, 0.4, (n, k, 3)).astype(np.float32)
    cand[: n // 2, :, 2] = p[: n // 2, None, 2] + rng.normal(0.0, 0.01, (n // 2, k))
    ok = rng.random((n, k)) < 0.7
    cand[:100, 1:k:2] = cand[:100, 0:k - 1:2]          # ties
    ok[:100, 1:k:2] = ok[:100, 0:k - 1:2]
    ok[100:200] = False                                # fewer than 5 ok
    ok[100:200, rng.integers(0, k, 3)] = True
    d = rng.normal(size=(100, 1, 3))                   # a line through the nearest
    t = np.linspace(0.05, 0.3, k)[None, :, None] * rng.choice([-1.0, 1.0], (100, k, 1))
    cand[200:300] = p[200:300, None, :] + (d / np.linalg.norm(d, axis=-1, keepdims=True)) * t
    ok[200:300, :8] = True
    ok[300:320] = False                                # nothing ok
    mask = rng.random(n) < 0.9
    return p, cand.astype(np.float32), ok, mask


def _degenerate(nb, nb_ok):
    """Rows whose masked covariance has its two smallest eigenvalues within
    1e-2 of the largest (float64)."""
    m = nb_ok[..., None].astype(np.float64)
    cnt = np.maximum(m.sum(1), 1.0)
    mean = (nb * m).sum(1) / cnt
    d = (nb - mean[:, None]) * m
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", d, d) / cnt[..., None])
    return (lam[:, 1] - lam[:, 0]) <= 1e-2 * (lam[:, 2] + 1e-6)


@pytest.mark.parametrize("gate", [True, False])
def test_plane_fit_5nn_matches_jax(gate):
    p, cand, ok, mask = _candidates()
    jcfg = jicp.ICPConfig(max_correspondence_distance=0.1, plane_fit_planarity=0.1)
    tcfg = ticp.ICPConfig(max_correspondence_distance=0.1, plane_fit_planarity=0.1)
    fit = jax.jit(jicp._plane_fit_5nn, static_argnames=("cfg", "gate"))
    jn, jc, jnn, jv, jd = (np.asarray(x) for x in fit(
        jnp.asarray(p), jnp.asarray(cand), jnp.asarray(ok), jnp.asarray(mask), cfg=jcfg,
        gate=gate))
    d2 = jnp.where(jnp.asarray(ok), jnp.sum((jnp.asarray(cand) - p[:, None, :]) ** 2, -1),
                   jnp.inf)
    jsel = np.asarray(jax.lax.top_k(-d2, 5)[1])
    t = ticp.plane_fit_5nn(torch.as_tensor(p), torch.as_tensor(cand), torch.as_tensor(ok),
                           torch.as_tensor(mask), tcfg, gate)
    np.testing.assert_array_equal(t.sel.numpy(), jsel)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_allclose(t.nearest.numpy(), jnn, atol=0)
    np.testing.assert_allclose(t.centroid.numpy(), jc, atol=1e-5)
    nb = np.take_along_axis(cand, jsel[..., None], 1).astype(np.float64)
    deg = _degenerate(nb, np.take_along_axis(ok, jsel, 1))
    assert 120 <= deg.sum() <= 180, deg.sum()          # the line and empty rows, and some
    assert deg[200:320].all()
    np.testing.assert_allclose(t.dist.numpy()[~deg], jd[~deg], atol=1e-5)
    dots = np.abs(np.sum(t.normal.numpy() * jn, -1))[~deg]
    assert dots.min() > 1 - 1e-5
    signed = np.sum(jn * (p - jc), -1)
    np.testing.assert_allclose(np.abs(t.resid.numpy()[~deg]), np.abs(signed[~deg]), atol=1e-5)
    assert 0 < jv.sum() < mask.sum()                   # the gates took some away


def test_plane_from_points_matches_jax():
    rng = np.random.default_rng(8)
    pts = rng.normal(0.0, 1.0, (400, 5, 3)).astype(np.float32)
    pts[:200, :, 2] *= 0.02
    m = rng.random((400, 5)) < 0.8
    m[:10] = False
    jn, jc, jp = (np.asarray(x) for x in jeigh.plane_from_points(jnp.asarray(pts),
                                                                 jnp.asarray(m)))
    tn, tc, tp = (x.numpy() for x in teigh.plane_from_points(torch.as_tensor(pts),
                                                             torch.as_tensor(m)))
    deg = _degenerate(pts.astype(np.float64), m)
    assert 10 <= deg.sum() <= 60, deg.sum()            # empty rows, 1-2 points, near-lines
    np.testing.assert_allclose(tc, jc, atol=1e-6)
    # two points: lambda_0 = lambda_1 = 0, known to eps * lambda_max only
    np.testing.assert_allclose(tp[~deg], jp[~deg], atol=1e-5)
    assert np.abs(np.sum(tn * jn, -1))[~deg].min() > 1 - 1e-5
