"""The port's pose graph (models/pose_graph.py, a copy of the JAX host
solver, "manual" backend) against the JAX package's on the same factors,
built directly and carried across by convert.py.

Tolerance: optimised poses within 1e-9 (the same float64 numpy and scipy
code on the same inputs)."""
import numpy as np
import pytest

from lidar_odometry_tpu.models.pose_graph import PoseGraphOptimizer as JaxGraph
from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.models.pose_graph import PoseGraphOptimizer, se3_exp


def _pose(xi):
    R, t = se3_exp(np.asarray(xi, np.float64))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _chain(n=30, seed=0):
    """A circle of keyframes with noisy odometry, and a loop back to 0."""
    rng = np.random.default_rng(seed)
    step = _pose([0, 0, 2 * np.pi / n, 1.0, 0, 0])
    true = [np.eye(4)]
    for _ in range(n - 1):
        true.append(true[-1] @ step)
    rels = [np.linalg.inv(true[i - 1]) @ true[i] @ _pose(rng.normal(0, [0.01] * 3 + [0.03] * 3))
            for i in range(1, n)]
    est = [np.eye(4)]
    for r in rels:
        est.append(est[-1] @ r)
    loop = np.linalg.inv(true[0]) @ true[n - 1]
    return est, rels, loop


def _build(cls, est, rels):
    g = cls(backend="manual")
    g.add_first_keyframe(0, est[0].astype(np.float32))
    for i, r in enumerate(rels, start=1):
        g.add_keyframe_with_odom(i - 1, i, est[i].astype(np.float32), r.astype(np.float32),
                                 0.1, 0.05)
    return g


def test_loop_optimisation_matches_jax():
    est, rels, loop = _chain()
    jg, pg = _build(JaxGraph, est, rels), _build(PoseGraphOptimizer, est, rels)
    n = len(est)
    assert jg.add_loop_and_optimize(0, n - 1, loop, 0.05, 0.02)
    assert pg.add_loop_and_optimize(0, n - 1, loop, 0.05, 0.02)
    jp, pp = jg.get_all_optimized_poses(), pg.get_all_optimized_poses()
    assert jp.keys() == pp.keys()
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=1e-9, rtol=0)
    # the loop closed the drift
    assert np.linalg.norm(pp[n - 1][:3, 3] - (np.eye(4) @ loop)[:3, 3]) < 0.2
    assert pg.loop_closure_count == 1 and pg.odometry_count == n - 1


def test_graph_carried_across_then_optimised_matches_jax():
    est, rels, loop = _chain(n=20, seed=3)
    jg = _build(JaxGraph, est, rels)
    arrays = dict(
        keyframe_ids=np.asarray(jg._keyframe_ids),
        poses=np.stack([jg._poses[k] for k in jg._keyframe_ids]),
        prior_keys=np.asarray([p.key for p in jg._priors]),
        prior_measured=np.stack([p.measured for p in jg._priors]),
        prior_sqrt_info=np.stack([p.sqrt_info for p in jg._priors]),
        between_keys=np.asarray([(b.key_from, b.key_to) for b in jg._betweens]),
        between_measured=np.stack([b.measured for b in jg._betweens]),
        between_sqrt_info=np.stack([b.sqrt_info for b in jg._betweens]),
        counts=np.asarray([jg.odometry_count, jg.loop_closure_count]))
    pg = convert.pose_graph_from_numpy(arrays)
    for k, v in pg.export_factors().items():
        np.testing.assert_array_equal(v, np.asarray(arrays[k]).reshape(v.shape), err_msg=k)
    assert jg.add_loop_and_optimize(0, 19, loop, 0.05, 0.02)
    assert pg.add_loop_and_optimize(0, 19, loop, 0.05, 0.02)
    jp, pp = jg.get_all_optimized_poses(), pg.get_all_optimized_poses()
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=1e-9, rtol=0)


def test_distributed_backend_raises_with_a_roadmap_pointer():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PoseGraphOptimizer(backend="distributed")
