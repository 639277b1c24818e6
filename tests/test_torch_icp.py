"""The port's surfel ICP with PKO (kernels K2a, K3, K2b through their plain
path) against the JAX icp_optimize, on the same JAX-built map carried
across by convert.py and the same features (CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import icp as jicp
from lidar_odometry_tpu.ops import pko as jpko
from lidar_odometry_tpu.ops import voxel_filter as jvf
from lidar_odometry_tpu.ops import voxel_map as jvm
from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import icp as ticp
from lidar_odometry_tpu_torch.ops import pko as tpko
from lidar_odometry_tpu_torch.utils import lie as tlie

C1, CAP = 8192, 8192
ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)


def _features(world, pose, rng):
    s = synthetic.sample_scan(world, pose, 7000, rng, max_range=50.0, noise=0.01)
    raw = np.full((8000, 3), np.nan, np.float32)
    raw[:len(s)] = s
    c, m, _ = jvf.voxel_filter(jnp.asarray(raw), jnp.int32(8000), voxel_size=0.5, stride=1,
                               out_capacity=CAP, compact_keys=True)
    return np.asarray(c), np.asarray(m)


@pytest.fixture(scope="module")
def scene():
    world = synthetic.make_world(seed=13, extent=60.0, n_buildings=14)
    poses = synthetic.straight_trajectory(5, step=0.4)
    rng = np.random.default_rng(13)
    state = jvm.empty_map(0, C1)
    for i in range(3):
        c, m = _features(world, poses[i], rng)
        world_pts = c @ poses[i][:3, :3].T + poses[i][:3, 3]
        state = jvm.update_map(state, jnp.asarray(world_pts), jnp.asarray(m),
                               jnp.asarray(poses[i][:3, 3]), 120.0, voxel_size=0.5,
                               planarity_threshold=0.1)
    feat, mask = _features(world, poses[4], rng)
    return state, feat, mask, poses[4]


def _perturbed(pose, dt, dyaw):
    c, s = np.cos(dyaw), np.sin(dyaw)
    P = np.eye(4, dtype=np.float32)
    P[:2, :2] = [[c, -s], [s, c]]
    P[:3, 3] = dt
    return (pose @ P).astype(np.float32)


def _rot_err(A, B):
    """Angle of A^T B from its skew part (arccos of the trace is too coarse
    near 0 in float32)."""
    R = A[:3, :3].astype(np.float64).T @ B[:3, :3].astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    return float(np.arcsin(min(np.linalg.norm(w), 1.0)))


@pytest.mark.parametrize("dt,dyaw,adaptive", [
    ((0.15, -0.1, 0.05), 0.01, True),
    ((-0.3, 0.2, 0.0), -0.02, True),
    ((0.1, 0.1, 0.0), 0.005, False),
])
def test_icp_matches_jax_on_the_same_map(scene, dt, dyaw, adaptive):
    state, feat, mask, pose = scene
    T0 = _perturbed(pose, dt, dyaw)
    jcfg = jicp.ICPConfig(max_iterations=4, voxel_size=0.5, use_adaptive_m_estimator=adaptive)
    tcfg = ticp.ICPConfig(max_iterations=4, voxel_size=0.5, use_adaptive_m_estimator=adaptive)
    jT, jok, jn = jicp.icp_optimize(state, jnp.asarray(feat), jnp.asarray(mask),
                                    jnp.asarray(T0), jpko.make_pko_constants(*ARGS), jcfg)
    ts = convert.map_state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()},
                                      device="cpu")
    tT, tok, tn = ticp.icp_optimize(ts, torch.tensor(feat), torch.tensor(mask),
                                    torch.tensor(T0),
                                    tpko.make_pko_constants(*ARGS, device="cpu"), tcfg)
    jT, tT = np.asarray(jT), tT.numpy()
    assert bool(tok) == bool(jok) is True
    assert abs(int(tn) - int(jn)) <= 2
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=1e-4)
    assert _rot_err(tT, jT) < 1e-4
    # and the solve did its job: back near the true pose
    assert np.linalg.norm(tT[:3, 3] - pose[:3, 3]) < 0.05


@pytest.fixture(scope="module")
def kd_scene():
    """A JAX map without surfels (KD-tree mode's) of three keyframes."""
    world = synthetic.make_world(seed=13, extent=60.0, n_buildings=14)
    poses = synthetic.straight_trajectory(5, step=0.4)
    rng = np.random.default_rng(14)
    state = jvm.empty_map(0, C1)
    for i in range(3):
        c, m = _features(world, poses[i], rng)
        world_pts = c @ poses[i][:3, :3].T + poses[i][:3, 3]
        state = jvm.update_map(state, jnp.asarray(world_pts), jnp.asarray(m),
                               jnp.asarray(poses[i][:3, 3]), 120.0, voxel_size=0.5,
                               planarity_threshold=0.1, compute_surfels=False)
    feat, mask = _features(world, poses[4], rng)
    return state, feat, mask, poses[4]


@pytest.mark.parametrize("dt,dyaw,adaptive", [
    ((0.15, -0.1, 0.05), 0.01, True),
    ((0.1, 0.1, 0.0), -0.005, False),
])
def test_kd_tree_icp_matches_jax(kd_scene, dt, dyaw, adaptive):
    """KD-tree mode (K5a, K5b, K3, K2b through their plain path)."""
    state, feat, mask, pose = kd_scene
    T0 = _perturbed(pose, dt, dyaw)
    kw = dict(max_iterations=4, voxel_size=0.5, use_adaptive_m_estimator=adaptive,
              use_surfel_correspondence=False)
    jT, jok, jn = jicp.icp_optimize(state, jnp.asarray(feat), jnp.asarray(mask),
                                    jnp.asarray(T0), jpko.make_pko_constants(*ARGS),
                                    jicp.ICPConfig(**kw))
    ts = convert.map_state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()},
                                      device="cpu")
    tT, tok, tn = ticp.icp_optimize(ts, torch.tensor(feat), torch.tensor(mask),
                                    torch.tensor(T0),
                                    tpko.make_pko_constants(*ARGS, device="cpu"),
                                    ticp.ICPConfig(**kw))
    jT, tT = np.asarray(jT), tT.numpy()
    assert bool(tok) == bool(jok) is True
    assert abs(int(tn) - int(jn)) <= max(2, int(jn) // 200)
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=1e-3)
    assert _rot_err(tT, jT) < 1e-3
    assert np.linalg.norm(tT[:3, 3] - pose[:3, 3]) < 0.05


def test_icp_fails_without_correspondences(scene):
    """An empty map: fewer than 50 correspondences, so the solve fails and
    returns the initial guess, as the JAX solve does."""
    _, feat, mask, pose = scene
    T0 = _perturbed(pose, (0.1, 0.0, 0.0), 0.0)
    ts = convert.map_state_from_numpy(
        {k: np.asarray(v) for k, v in jvm.empty_map(0, 1024)._asdict().items()}, device="cpu")
    tT, tok, tn = ticp.icp_optimize(ts, torch.tensor(feat), torch.tensor(mask),
                                    torch.tensor(T0),
                                    tpko.make_pko_constants(*ARGS, device="cpu"),
                                    ticp.ICPConfig())
    assert not bool(tok) and int(tn) == 0
    np.testing.assert_array_equal(tT.numpy(), T0)


def test_normal_equations_match_autodiff_jacobian(scene):
    """K2b's plain twin: H and g are J^T W J and J^T W r of the residual
    r(xi) = n . (T Exp(xi) p - q) under the right perturbation."""
    state, feat, mask, pose = scene
    ts = convert.map_state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()},
                                      device="cpu")
    cfg = ticp.ICPConfig(use_robust_loss=False, use_adaptive_m_estimator=False)
    T = torch.as_tensor(_perturbed(pose, (0.05, 0.0, 0.0), 0.0)).reshape(16)
    pts, m = torch.tensor(feat), torch.tensor(mask)
    flags = torch.zeros((3,), dtype=torch.int32)
    nrm, r, valid = ticp.icp_correspond(pts, m, T, flags, ts, cfg)
    aux = torch.stack([valid.sum(), torch.tensor(0)]).to(torch.int32)
    _, _, hg = ticp.icp_normal_eq(pts, nrm, r, valid, T, torch.ones(1), flags, aux,
                                  tpko.make_pko_constants(*ARGS, device="cpu"), cfg)
    q = tlie.transform_points(T.view(4, 4).double(), pts.double()) \
        - r.double()[:, None] * nrm.double()

    def resid(xi):
        Tx = T.view(4, 4).double() @ tlie.se3_from_exp_rt(xi[:3], xi[3:])
        return torch.sum(nrm.double() * (tlie.transform_points(Tx, pts.double()) - q), -1)

    J = torch.autograd.functional.jacobian(resid, torch.zeros(6, dtype=torch.float64))
    J = J[valid]
    H = J.T @ J
    g = J.T @ resid(torch.zeros(6, dtype=torch.float64))[valid]
    ref = torch.cat([torch.stack([H[i, j] for i in range(6) for j in range(i, 6)]), g])
    np.testing.assert_allclose(hg.numpy(), ref.numpy(), rtol=2e-3, atol=2e-2)
