"""The port's pose graph (models/pose_graph.py) against the JAX package's
on the same factors, built directly and carried across by convert.py:
the "manual" backend (a copy of the JAX host solver) and the "distributed"
one (the float64 device solve, here on the CPU through its plain twins).

Tolerances: optimised poses within 1e-9 of JAX's same backend (the same
float64 math on the same inputs); the distributed backend within 1e-4 of
the manual one, the JAX tests' bound between the two backends."""
import jax
import numpy as np
import pytest

from lidar_odometry_tpu.models.pose_graph import PoseGraphOptimizer as JaxGraph
from lidar_odometry_tpu.parallel import distributed_pgo as jax_dpgo
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


def _build(cls, est, rels, backend="manual", **kw):
    g = cls(backend=backend, **kw)
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
    pd = convert.pose_graph_from_numpy(arrays, backend="distributed", n_blocks=4, device="cpu")
    assert (pg.backend, pd.backend, pd.n_blocks, pd.device) == ("manual", "distributed", 4, "cpu")
    for graph in (pg, pd):
        for k, v in graph.export_factors().items():
            np.testing.assert_array_equal(v, np.asarray(arrays[k]).reshape(v.shape), err_msg=k)
    jd = _build(JaxGraph, est, rels, backend="distributed", n_blocks=4)
    for graph in (jg, pg, jd, pd):
        assert graph.add_loop_and_optimize(0, 19, loop, 0.05, 0.02)
    jp, pp = jg.get_all_optimized_poses(), pg.get_all_optimized_poses()
    jdp, pdp = jd.get_all_optimized_poses(), pd.get_all_optimized_poses()
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=1e-9, rtol=0)
        np.testing.assert_allclose(pdp[k], jdp[k], atol=1e-9, rtol=0)
        np.testing.assert_allclose(pdp[k], pp[k], atol=1e-4, rtol=0)


def _line(opt, n, drift, loop_from, loop_to):
    """The JAX backend tests' graph (tests/test_pose_graph.py:102,126) in
    `opt`: a straight line of n keyframes 1 m apart whose odometry drifts
    `drift` m sideways a step, closed by a loop with the true relative
    pose. Returns the drifted and the true poses."""
    true = [np.eye(4) for _ in range(n)]
    for i, T in enumerate(true):
        T[0, 3] = float(i)
    noisy = [np.eye(4)]
    opt.add_first_keyframe(0, noisy[0])
    for i in range(1, n):
        rel = np.linalg.inv(true[i - 1]) @ true[i]
        rel[1, 3] += drift
        noisy.append(noisy[-1] @ rel)
        opt.add_keyframe_with_odom(i - 1, i, noisy[i], rel, 1.0, 1.0)
    assert opt.add_loop_and_optimize(loop_from, loop_to,
                                     np.linalg.inv(true[loop_from]) @ true[loop_to], 1.0, 1.0)
    return noisy, true


@pytest.mark.parametrize("case", ["matches_manual", "loop_to_keyframe_zero", "device_path_taken"])
def test_distributed_backend_matches_manual_and_jax(case):
    """The "distributed" backend (once refused with a ROADMAP pointer) in the
    JAX backend tests' three cases: it matches the port's manual backend
    within 1e-4 and JAX's distributed backend within 1e-9; a loop to
    keyframe 0 corrects the drift; and it takes the device path, whose
    result the graph keeps."""
    graph = {"matches_manual": (24, 0.03, 3, 20),
             "loop_to_keyframe_zero": (20, 0.04, 0, 19),
             "device_path_taken": (12, 0.0, 1, 11)}[case]
    dist = PoseGraphOptimizer(backend="distributed", n_blocks=4, device="cpu")
    called = {}
    orig = dist._optimize_distributed_device

    def spy(*a, **k):
        called["result"] = orig(*a, **k)
        return called["result"]

    dist._optimize_distributed_device = spy
    noisy, true = _line(dist, *graph)
    manual = PoseGraphOptimizer(backend="manual")
    jax_dist = JaxGraph(backend="distributed", n_blocks=4)
    _line(manual, *graph)
    _line(jax_dist, *graph)
    got, want = dist.get_all_optimized_poses(), manual.get_all_optimized_poses()
    want_jax = jax_dist.get_all_optimized_poses()
    assert called.get("result") is True and dist.loop_closure_count == 1
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[k], want_jax[k], atol=1e-9, rtol=0)
    if case == "loop_to_keyframe_zero":
        n = graph[0]
        before = np.linalg.norm(noisy[n - 1][:3, 3] - true[n - 1][:3, 3])
        after = np.linalg.norm(got[n - 1][:3, 3] - true[n - 1][:3, 3])
        assert after < before * 0.2, (before, after)


LINES = {"matches_manual": (24, 0.03, 3, 20), "loop_to_keyframe_zero": (20, 0.04, 0, 19),
         "device_path_taken": (12, 0.0, 1, 11)}


@pytest.mark.parametrize("case", sorted(LINES))
def test_distributed_host_iteration_matches_jax(case, monkeypatch):
    """_optimize_distributed_host, the JAX distributed backend's host
    Gauss-Newton loop with the partitioned Schur solve, against that loop
    in JAX (reached there by making its device program raise), under x64,
    on the backend tests' line graphs: poses within 1e-9."""
    def device_fails(*a, **k):
        raise RuntimeError("device program unavailable")

    monkeypatch.setattr(jax_dpgo, "gn_optimize_device", device_fails)
    port = PoseGraphOptimizer(backend="distributed", n_blocks=4, device="cpu")
    jg = JaxGraph(backend="distributed", n_blocks=4)
    calls = {}
    for name, g in (("port", port), ("jax", jg)):
        def spy(n_vars, _orig=g._solve_distributed, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(n_vars)
        g._solve_distributed = spy
    port._optimize = port._optimize_distributed_host
    with jax.enable_x64():
        _line(jg, *LINES[case])
    _line(port, *LINES[case])
    assert calls["port"] == calls["jax"] >= 1 and port.loop_closure_count == 1
    got, want = port.get_all_optimized_poses(), jg.get_all_optimized_poses()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, rtol=0)


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="distributed"):
        PoseGraphOptimizer(backend="sharded")
