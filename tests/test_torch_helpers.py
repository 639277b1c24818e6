"""The port's public helpers outside the odometry path against the JAX
package, on the same numpy inputs (CPU): the PKO kernel weights, scale
factor and alpha-from-samples; the Lie-group vee, logs, exps, SVD
projection and SE(3) accessors (and the pose graph's GTSAM-ordered
wrappers of them); eigh3's smallest eigenvector; the keys' parent
coords, sorted-table search and Morton code; and the point-cloud filters
of ops/legacy_filters.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.models import pose_graph as jpg
from lidar_odometry_tpu.ops import legacy_filters as jlf
from lidar_odometry_tpu.ops import pko as jpko
from lidar_odometry_tpu.utils import eigh3 as jeigh
from lidar_odometry_tpu.utils import keys as jkeys
from lidar_odometry_tpu.utils import lie as jlie
from lidar_odometry_tpu_torch.models import pose_graph as tpg
from lidar_odometry_tpu_torch.ops import legacy_filters as tlf
from lidar_odometry_tpu_torch.ops import pko as tpko
from lidar_odometry_tpu_torch.utils import eigh3 as teigh
from lidar_odometry_tpu_torch.utils import keys as tkeys
from lidar_odometry_tpu_torch.utils import lie as tlie

PKO_ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)
# the JAX side jitted whole: one compile a function, not one a primitive
J_SO3_LOG, J_SE3_EXP, J_SE3_LOG, J_PROJECT_SVD = (
    jax.jit(f) for f in (jlie.so3_log, jlie.se3_exp, jlie.se3_log, jlie.so3_project_svd))
KERNELS = ("huber", "cauchy", "tukey", "welsch", "gemanMcClure", "pseudoHuber", "other")


@pytest.fixture(scope="module")
def consts():
    jc = jpko.make_pko_constants(*PKO_ARGS)
    key = jax.random.PRNGKey(42)
    alpha_of = jax.jit(lambda s: jpko.pko_alpha_from_samples(s, jc, key=key))
    return jc, tpko.make_pko_constants(*PKO_ARGS, device="cpu"), alpha_of


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_weight_matches_jax(kernel):
    r = np.random.default_rng(0).normal(0.0, 2.0, 2000).astype(np.float32)
    for delta in (0.3, 1.7):
        np.testing.assert_allclose(
            tpko.kernel_weight(torch.as_tensor(r), delta, kernel).numpy(),
            np.asarray(jpko.kernel_weight(jnp.asarray(r), delta, kernel)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pko_scale_factor_matches_jax(consts, seed):
    """The scale of normalised residual magnitudes through K3's wrapper
    (its plain version here), and the alpha of a drawn sample: both the
    alpha JAX picks."""
    jc, tc, alpha_of = consts
    rng = np.random.default_rng(seed)
    r = np.abs(np.concatenate([rng.standard_normal(2000) * (0.5 + seed),
                               3.0 + rng.standard_normal(600)])).astype(np.float32)
    valid = rng.random(len(r)) > 0.2
    want = float(jpko.pko_scale_factor(jnp.asarray(r), jnp.asarray(valid), jc))
    got = tpko.pko_scale_factor(torch.as_tensor(r), torch.as_tensor(valid), tc)
    assert got.shape == () and float(got) == want
    key = jax.random.PRNGKey(42)
    samples, _ = jpko.stratified_sample(jnp.asarray(r), jnp.asarray(valid), 100, key)
    want = float(alpha_of(samples))
    assert float(tpko.pko_alpha_from_samples(torch.tensor(np.asarray(samples)), tc)) == want


def _rotations(seed, n=256):
    """Rotations of every size of angle: tiny, generic, and within 1e-4 of
    pi and at pi."""
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.concatenate([rng.uniform(0.0, 1e-7, n // 8), rng.uniform(1e-3, 3.0, n // 2),
                            np.pi - rng.uniform(0.0, 1e-4, n // 8)])
    theta = np.concatenate([theta, np.full(n - len(theta), np.pi)])
    w = (axis * theta[:, None]).astype(np.float32)
    return w, np.asarray(jax.jit(jlie.so3_exp)(w))


@pytest.mark.parametrize("seed", [3, 4])
def test_lie_helpers_match_jax(seed):
    w, R = _rotations(seed)
    Rt = torch.tensor(R)
    np.testing.assert_array_equal(tlie.vee(tlie.hat(torch.as_tensor(w))).numpy(), w)
    np.testing.assert_allclose(tlie.so3_log(Rt).numpy(), np.asarray(J_SO3_LOG(R)),
                               atol=2e-4)
    rng = np.random.default_rng(seed)
    noisy = (R + 1e-2 * rng.standard_normal(R.shape)).astype(np.float32)
    noisy[:4] = -noisy[:4]                       # reflections
    got = tlie.so3_project_svd(torch.as_tensor(noisy)).numpy()
    want = np.asarray(J_PROJECT_SVD(noisy))
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    # a reflection's projection flips its least singular direction, which
    # two float32 SVDs fix to ~eps / (singular value gap)
    np.testing.assert_allclose(got[:4], want[:4], atol=1e-3)
    np.testing.assert_allclose(got[4:], want[4:], atol=1e-5)
    xi = np.concatenate([rng.standard_normal((len(w), 3)) * 5.0, w], 1).astype(np.float32)
    T = np.array(J_SE3_EXP(xi))
    np.testing.assert_allclose(tlie.se3_exp(torch.as_tensor(xi)).numpy(), T, atol=2e-5)
    gen = slice(len(w) // 8, len(w) // 8 + len(w) // 2)       # log's rho is ill-posed at pi
    np.testing.assert_allclose(tlie.se3_log(torch.as_tensor(T[gen])).numpy(),
                               np.asarray(J_SE3_LOG(T[gen])), atol=2e-4)
    Rj, tj = jlie.se3_rt(jnp.asarray(T))
    Rp, tp = tlie.se3_rt(torch.as_tensor(T))
    np.testing.assert_array_equal(Rp.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(tlie.se3_identity().numpy(), np.asarray(jlie.se3_identity()))
    np.testing.assert_allclose(tlie.se3_mul(torch.as_tensor(T[:8]), torch.as_tensor(T[8:16])).numpy(),
                               np.asarray(jlie.se3_mul(jnp.asarray(T[:8]), jnp.asarray(T[8:16]))),
                               atol=1e-4)


def test_pose_graph_wrappers_match_jax():
    """The pose graph's GTSAM-ordered so3_log, se3_log and se3_exp (now on
    utils/lie in float64) against the JAX pose graph's numpy copies."""
    rng = np.random.default_rng(11)
    for theta in (1e-12, 1e-6, 0.3, 2.0, 3.1):
        axis = rng.standard_normal(3)
        xi = np.concatenate([axis / np.linalg.norm(axis) * theta, rng.standard_normal(3)])
        R, t = tpg.se3_exp(xi)
        Rj, tj = jpg.se3_exp(xi)
        np.testing.assert_allclose(tpg.so3_exp(xi[:3]), jpg.so3_exp(xi[:3]), atol=1e-13)
        np.testing.assert_allclose(R, Rj, atol=1e-13)
        np.testing.assert_allclose(t, tj, atol=1e-12)
        np.testing.assert_allclose(tpg.so3_log(Rj), jpg.so3_log(Rj), atol=1e-9)
        np.testing.assert_allclose(tpg.se3_log(Rj, tj), jpg.se3_log(Rj, tj), atol=1e-9)
        np.testing.assert_allclose(tpg.se3_log(R, t), xi, atol=1e-9)


def test_smallest_eigenvector_matches_jax():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((512, 6, 3)).astype(np.float32)
    X[:, :, 2] *= 0.05
    A = (np.einsum("nki,nkj->nij", X, X) / 6.0).astype(np.float32)
    lam = np.linalg.eigvalsh(A.astype(np.float64))
    iso = (lam[:, 1] - lam[:, 0]) > 1e-3
    v_j = np.asarray(jax.jit(jeigh.smallest_eigenvector)(A))
    v_t = teigh.smallest_eigenvector(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(np.abs(np.sum(v_t * v_j, -1))[iso], 1.0, atol=1e-5)
    np.testing.assert_allclose(v_t, teigh.eigh3(torch.as_tensor(A))[1].numpy())


def test_keys_helpers_match_jax():
    rng = np.random.default_rng(5)
    c = rng.integers(-40000, 40000, size=(4096, 3)).astype(np.int32)
    c[:, :2] = np.clip(c[:, :2], -32768, 32767)
    np.testing.assert_array_equal(tkeys.parent_coords(torch.as_tensor(c), 3).numpy(),
                                  np.asarray(jkeys.parent_coords(jnp.asarray(c), 3)))
    np.testing.assert_array_equal(tkeys.morton_np(c), jkeys.morton_np(c))
    # a sorted table of 1000 keys padded with invalid slots; queries hit,
    # miss, and fall before, between and past the keys
    hi, lo = jkeys.pack_key(jnp.asarray(c[:1000]))
    hi_s, lo_s, perm = jkeys.sort_by_key(hi, lo, jnp.arange(1000))
    as_t = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64))
    got = tkeys.sort_by_key(as_t(hi), as_t(lo), torch.arange(1000))
    for g, w in zip(got, (hi_s, lo_s, perm)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a, b = (as_t(x) for x in jkeys.pack_key(jnp.asarray(c[1000:2000])))
    for fn in ("key_lt", "key_eq"):
        want = getattr(jkeys, fn)(hi, lo, jnp.roll(hi, 1).at[::7].set(hi[::7]), lo)
        np.testing.assert_array_equal(
            getattr(tkeys, fn)(as_t(hi), as_t(lo), as_t(jnp.roll(hi, 1).at[::7].set(hi[::7])),
                               as_t(lo)).numpy(), np.asarray(want))
    assert tkeys.key_lt(a, b, a, b + 1).all() and not tkeys.key_eq(a, b, a, b + 1).any()
    pad = jnp.full((24,), jkeys.INVALID_HI)
    table_hi, table_lo = jnp.concatenate([hi_s, pad]), jnp.concatenate([lo_s, pad])
    qhi, qlo = jkeys.pack_key(jnp.asarray(c[500:3000]))
    qhi = qhi.at[:3].set(jnp.asarray([0, 0xFFFFFFFF, 0x80000000], jnp.uint32))
    want = np.asarray(jax.jit(jkeys.searchsorted2)(table_hi, table_lo, qhi, qlo))
    got = tkeys.searchsorted2(as_t(table_hi), as_t(table_lo), as_t(qhi), as_t(qlo))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and want.min() == 0 and (want == 1000).any()


def test_voxel_occupied_matches_jax():
    """The diagnostic occupancy query on a map the port built, carried to
    JAX's layout: live voxels, empty children of live parents, and cells
    with no parent."""
    from lidar_odometry_tpu.ops import voxel_map as jvm
    from lidar_odometry_tpu_torch import convert
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.ops import voxel_map as tvm
    world = synthetic.make_world(seed=21, extent=60.0, n_buildings=14)
    rng = np.random.default_rng(21)
    pts = synthetic.sample_scan(world, np.eye(4), 6000, rng, max_range=45.0, noise=0.01)
    state = tvm.update_map(tvm.empty_map(0, 4096, device="cpu"), torch.as_tensor(pts),
                           torch.ones(len(pts), dtype=torch.bool), torch.zeros(3), 120.0,
                           voxel_size=0.5, planarity_threshold=0.1,
                           evict_enabled=torch.tensor(True))
    jstate = jvm.VoxelMapState(**{k: jnp.asarray(v) for k, v in
                                  convert.map_state_to_numpy(state).items()})
    q = np.concatenate([pts[::3], pts[::5] + 0.3, rng.uniform(-80, 80, (500, 3))]).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda s, p: jvm.voxel_occupied(s, p, voxel_size=0.5))(jstate, q))
    got = tvm.voxel_occupied(state, torch.as_tensor(q), voxel_size=0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(q)


@pytest.mark.parametrize("leaf,cap", [(1.0, None), (0.35, None), (1.0, 200)])
def test_voxel_grid_filter_matches_jax(leaf, cap):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    mask = np.ones(2000, bool)
    mask[::17] = False
    jc, jv = jlf.voxel_grid_filter(jnp.asarray(pts), jnp.asarray(mask), leaf_size=leaf,
                                   out_capacity=cap)
    tc, tv = tlf.voxel_grid_filter(torch.as_tensor(pts), torch.as_tensor(mask), leaf,
                                   out_capacity=cap)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    assert tv.sum() > 100


def test_crop_box_and_range_filter_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-70, 70, (3000, 3)).astype(np.float32)
    pts[:3] = [[1, 1, 1], [-1, 0.5, 0], [0.05, 0, 0]]          # on the box's faces, too near
    mask = rng.random(3000) > 0.1
    for negative in (False, True):
        want = jlf.crop_box(jnp.asarray(pts), jnp.asarray(mask), [-1, -1, -1], [1, 1, 1],
                            negative=negative)
        got = tlf.crop_box(torch.as_tensor(pts), torch.as_tensor(mask), [-1, -1, -1], [1, 1, 1],
                           negative=negative)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jlf.range_filter(jnp.asarray(pts), jnp.asarray(mask), 0.1, 50.0)
    got = tlf.range_filter(torch.as_tensor(pts), torch.as_tensor(mask), 0.1, 50.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < mask.sum()
