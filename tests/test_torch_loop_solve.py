"""The port's loop-closure solve (ops/icp.py loop_closure_solve: BEV + yaw
prealign, coarse and polish loop ICP, the 1-NN inlier ratio; every kernel
on its plain twin on the CPU) against the JAX package's on the same
revisit pair: tests/test_loop_trel.py's _keyframe_pair at 4000 points.

Tolerances: success equal; T_rel within 1e-4 m in translation and 1e-4
rad in rotation; the inlier ratio within one point in N (1/N); the
polish phase's residual RMS within 1e-4 m. Cases: prealign on and off,
polish 0 and 8 iterations. Also K2b's weight residual: with rw = |r| it
is the odometry step bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidar_odometry_tpu.ops import icp as jicp
from lidar_odometry_tpu.ops import pko as jpko
from lidar_odometry_tpu_torch.ops import icp, pko
from test_loop_trel import _keyframe_pair


@pytest.fixture(scope="module")
def pair():
    return _keyframe_pair(drift_t=(1.5, -0.8, 0.0), drift_yaw_deg=4.0, n_pts=4000)


def _rot_err(A, B):
    R = A[:3, :3].T.astype(np.float64) @ B[:3, :3].astype(np.float64)
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


@pytest.mark.parametrize("prealign", [True, False])
@pytest.mark.parametrize("polish", [0, 8])
def test_loop_solve_matches_jax(pair, prealign, polish):
    (q_pts, q_mask, est_pose), (m_pts, m_mask, m_pose), _ = pair
    iters = 30 if prealign else 100
    jcfg = jicp.ICPConfig(max_iterations=4, voxel_size=0.5)
    jconsts = jpko.make_pko_constants(0.1, 10.0, 100, 10.0, "huber", 3, 100)
    jp = np.asarray(jicp.loop_closure_solve(
        jnp.asarray(q_pts[::2]), jnp.asarray(q_mask[::2]), jnp.asarray(est_pose),
        jnp.asarray(m_pts), jnp.asarray(m_mask), jnp.asarray(m_pose), jnp.float32(0.0),
        jconsts, jcfg, prealign=prealign, bucket_width=8, max_loop_iterations=iters,
        polish_iterations=polish))
    cfg = icp.ICPConfig(max_iterations=4, voxel_size=0.5)
    consts = pko.make_pko_constants(0.1, 10.0, 100, 10.0, "huber", 3, 100, device="cpu")
    t = lambda a: torch.as_tensor(np.array(a))
    pp = icp.loop_closure_solve(
        t(q_pts[::2]), t(q_mask[::2]), t(est_pose), t(m_pts), t(m_mask), t(m_pose),
        torch.tensor(0.0), consts, cfg, prealign=prealign, bucket_width=8,
        max_loop_iterations=iters, polish_iterations=polish).numpy()
    assert pp.shape == (19,)
    assert (pp[16] > 0.5) == (jp[16] > 0.5)
    assert jp[16] > 0.5, "the JAX solve must succeed on this pair"
    Tp, Tj = pp[:16].reshape(4, 4), jp[:16].reshape(4, 4)
    assert np.linalg.norm(Tp[:3, 3] - Tj[:3, 3]) < 1e-4, (Tp, Tj)
    assert _rot_err(Tp, Tj) < 1e-4
    n = int(q_mask[::2].sum())
    assert abs(pp[17] - jp[17]) <= 1.0 / n + 1e-7
    assert abs(pp[18] - jp[18]) < 1e-4
    if polish:
        assert pp[18] > 0.0


def test_weight_residual_is_the_odometry_step_when_equal():
    rng = np.random.default_rng(3)
    n = 500
    pts = torch.as_tensor(rng.normal(0, 5, (n, 3)).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.as_tensor(rng.normal(0, 1, (n, 3)).astype(
        np.float32)), dim=1)
    r = torch.as_tensor(rng.normal(0, 0.05, n).astype(np.float32))
    valid = torch.as_tensor(rng.random(n) > 0.2)
    T = torch.eye(4).reshape(16)
    consts = pko.make_pko_constants(0.1, 10.0, 100, 10.0, "huber", 3, 100, device="cpu")
    flags = torch.zeros(3, dtype=torch.int32)
    aux = torch.tensor([int(valid.sum()), 7], dtype=torch.int32)
    scale = torch.tensor([0.01])
    cfg = icp.ICPConfig()
    a = icp.icp_normal_eq(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg)
    b = icp.icp_normal_eq(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg, rw=r.abs())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = icp.icp_normal_eq(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg, rw=r * 3)
    assert not torch.equal(a[2], c[2])
