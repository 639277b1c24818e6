"""The port's Estimator front door against the JAX Estimator (CPU).

Loops off, KD-tree mode: 12 frames of 8k points, once through
process_frame and once through process_chunk (two chunks of 4, the first
with its sampled per-frame first frame, then a per-frame tail of 4).

Loops on, surfel mode, sync_loop: the JAX loop test's circuit (seed 9,
1.07 laps of a 30 m x 10 m stadium at 0.6 m a frame, 6000-point scans)
through process_frame on both sides: the same accepted loops between the
same keyframe ids, and trajectories within 5 cm and 5e-3 in rotation
entries of each other, the ATE scale of either run (each ICP agrees to
~1e-4 m and the differences add up along 220 frames; the largest gaps
seen were 3.9 cm and 3.6e-3, each on one frame). The port
alone also runs the circuit through process_chunk (the same loop, a map
rehash) and a short run with the loop worker thread that ends cleanly
through finalize_loops and reset().

The JAX estimator runs in a fresh subprocess that writes its outputs to an
.npz, so that its large compiles never land late in a long-lived test
worker (see the note in tests/conftest.py)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_odometry_tpu_torch.config import SystemConfig
from lidar_odometry_tpu_torch.eval import ate_rmse
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.models.estimator import Estimator

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(scan_capacity=8192, map_l0_capacity=8192, map_l1_capacity=8192,
           keyframe_capacity=64, point_stride=1, voxel_size=0.5, map_voxel_size=0.5,
           max_range=50.0, use_surfel_correspondence=False, enable_loop_detection=False,
           enable_console_statistics=False)

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's many small CPU ops: with the
    suite's parallel workers on one host, torch's default of one thread a
    core oversubscribes the cores and its threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.models.estimator import Estimator
    scans = np.load(sys.argv[1])["scans"]
    cfg = SystemConfig(**json.loads(sys.argv[3]))
    est = Estimator(cfg, sync_loop=True)
    for s in scans:
        est.process_frame(s)
    out = dict(frame_traj=est.trajectory(),
               frame_kf=np.array([f.is_keyframe for f in est.frames]),
               frame_map=est.map_points())
    est = Estimator(cfg, sync_loop=True)
    est.process_chunk(scans[0:4], sample_stages=True)
    est.process_chunk(scans[4:8])
    for s in scans[8:]:
        est.process_frame(s)
    out.update(chunk_traj=est.trajectory(),
               chunk_kf=np.array([f.is_keyframe for f in est.frames]))
    np.savez(sys.argv[2], **out)
""")


def _scans(n_frames=12, seed=9):
    world = synthetic.make_world(seed=seed, extent=60.0, n_buildings=14)
    poses = synthetic.straight_trajectory(n_frames, step=0.4)
    rng = np.random.default_rng(seed)
    scans = np.full((n_frames, 8192, 3), np.nan, np.float32)
    for i in range(n_frames):
        s = synthetic.sample_scan(world, poses[i], 8000, rng, max_range=50.0, noise=0.01)
        scans[i, :len(s)] = s
    return scans, poses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scans, poses = _scans()
    tmp = tmp_path_factory.mktemp("estimator")
    inp, outp = tmp / "in.npz", tmp / "jax.npz"
    np.savez(inp, scans=scans)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(inp), str(outp),
                           json.dumps(CFG)], env=env, cwd=str(ROOT), timeout=600,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jax_out = dict(np.load(outp))

    cfg = SystemConfig(**CFG)
    est = Estimator(cfg, device="cpu")
    for s in scans:
        assert est.process_frame(s)
    port = dict(frame_traj=est.trajectory(),
                frame_kf=np.array([f.is_keyframe for f in est.frames]),
                frame_map=est.map_points(), frame_count=est.frame_count)
    est = Estimator(cfg, device="cpu")
    est.process_chunk(scans[0:4], sample_stages=True)
    est.process_chunk(scans[4:8], defer_host=True)
    for s in scans[8:]:
        est.process_frame(s)
    port.update(chunk_traj=est.trajectory(),
                chunk_kf=np.array([f.is_keyframe for f in est.frames]),
                chunk_count=est.frame_count, staged=len([t for t in est.timing_history
                                                         if t.preprocessing_ms > 0]))
    return poses, jax_out, port


@pytest.mark.parametrize("path", ["frame", "chunk"])
def test_estimator_matches_jax(runs, path):
    gt, jo, po = runs
    np.testing.assert_array_equal(po[f"{path}_kf"], jo[f"{path}_kf"])
    assert po[f"{path}_kf"].sum() >= 4
    a, b = po[f"{path}_traj"], jo[f"{path}_traj"]
    assert a.shape == b.shape == (12, 4, 4)
    np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=2e-3)
    assert ate_rmse(a, gt) < 0.05
    assert po[f"{path}_count"] == 12


def test_estimator_map_matches_jax(runs):
    _, jo, po = runs
    a, b = po["frame_map"], jo["frame_map"]
    assert abs(len(a) - len(b)) <= max(2, len(b) // 500)
    assert len(a) > 1000


def test_chunk_path_records_a_sampled_stage_breakdown(runs):
    """sample_stages ran the first frame per-frame; the tail's 4 frames
    are per-frame too."""
    assert runs[2]["staged"] == 5


def test_estimator_refuses_loop_closure():
    """What the estimator refuses with loops on: process_chunk(defer_host=
    True) raises, as in JAX. The distributed pose-graph backend, refused
    before it was ported, is built with the configuration's backend on the
    caller's device (and kept across reset()); an unknown backend is
    refused."""
    cfg = SystemConfig(**{**CFG, "enable_loop_detection": True})
    est = Estimator(cfg, sync_loop=True, device="cpu")
    with pytest.raises(ValueError, match="loop detection off"):
        est.process_chunk(np.zeros((2, 16, 3), np.float32), defer_host=True)
    assert est.pose_graph.backend == "manual"
    dist = Estimator(dataclasses.replace(cfg, pgo_backend="distributed"), sync_loop=True,
                     device="cpu")
    dist.reset()
    assert (dist.pose_graph.backend, dist.pose_graph.device) == ("distributed", "cpu")
    with pytest.raises(ValueError, match="pgo_backend"):
        Estimator(dataclasses.replace(cfg, pgo_backend="sharded"), device="cpu")


def test_reset_and_accessors():
    scans, _ = _scans(n_frames=3, seed=4)
    est = Estimator(SystemConfig(**CFG), device="cpu")
    for s in scans:
        est.process_frame(s)
    assert est.get_keyframe_count() >= 1 and est.get_keyframe(0).kf_id == 0
    assert est.get_keyframe(99) is None and est.get_loop_closure_count() == 0
    assert est.get_current_pose().shape == (4, 4)
    acc = est.accumulated_map(voxel_size=0.5)
    assert acc.ndim == 2 and acc.shape[1] == 3 and len(acc) > 100
    assert not est.process_frame(np.zeros((0, 3), np.float32))
    est.reset()
    assert est.frame_count == 0 and len(est.trajectory()) == 0
    assert len(est.map_points()) == 0
    assert dataclasses.is_dataclass(est.cfg)


# ---------------------------------------------------------------------------
# loops on
# ---------------------------------------------------------------------------

LOOP_CFG = dict(scan_capacity=8192, map_l0_capacity=131072, map_l1_capacity=32768,
                keyframe_capacity=256, point_stride=1, max_iterations=4,
                enable_loop_detection=True, min_keyframe_gap=25, max_search_distance=8.0,
                similarity_threshold=0.4, enable_console_statistics=False)

_JAX_LOOPS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.models.estimator import Estimator
    d = np.load(sys.argv[1])
    est = Estimator(SystemConfig(**json.loads(sys.argv[3])), sync_loop=True)
    for i in range(int(d["n"])):
        est.process_frame(d["scans"][i, :d["lens"][i]])
    est.finalize_loops()
    loops = [(b.key_from, b.key_to) for b in est.pose_graph._betweens
             if b.key_to - b.key_from != 1]
    np.savez(sys.argv[2], traj=est.trajectory(), loops=np.asarray(loops).reshape(-1, 2),
             count=est.get_loop_closure_count(), kfs=len(est.keyframes))
""")


def _loop_pairs(est):
    keys = est.pose_graph.export_factors()["between_keys"]
    return keys[keys[:, 1] - keys[:, 0] != 1]


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(220, length=30.0, radius=10.0, step=0.6)
    rng = np.random.default_rng(9)
    scans = [synthetic.sample_scan(world, p, 6000, rng, max_range=45.0, noise=0.02)
             for p in poses]
    padded = np.full((len(scans), 6000, 3), np.nan, np.float32)
    for i, s in enumerate(scans):
        padded[i, :len(s)] = s
    tmp = tmp_path_factory.mktemp("loops")
    inp, outp = tmp / "in.npz", tmp / "jax.npz"
    np.savez(inp, scans=padded, lens=np.array([len(s) for s in scans]), n=len(scans))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_LOOPS, str(inp), str(outp),
                             json.dumps(LOOP_CFG)], env=env, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the port's runs while the JAX side runs in its own process
        cfg = SystemConfig(**LOOP_CFG)
        est = Estimator(cfg, sync_loop=True, device="cpu")
        for s in scans:
            assert est.process_frame(s)
        est.finalize_loops()
        port = dict(traj=est.trajectory(), loops=_loop_pairs(est),
                    count=est.get_loop_closure_count(), kfs=len(est.keyframes),
                    rehash=est.rehash_count, errors=est.loop_errors,
                    stages=est.loop_stage_snapshot())
        est = Estimator(cfg, sync_loop=True, device="cpu")
        for c in range(0, 200, 20):
            est.process_chunk(padded[c:c + 20])
        for s in scans[200:]:
            est.process_frame(s)
        est.finalize_loops()
        chunk = dict(traj=est.trajectory(), loops=_loop_pairs(est), rehash=est.rehash_count,
                     errors=est.loop_errors)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return poses, dict(np.load(outp)), port, chunk


def test_loops_match_jax(loop_runs):
    gt, jo, po, _ = loop_runs
    assert int(jo["count"]) >= 1, "the workload must close a loop on the JAX side"
    assert po["count"] == int(jo["count"]) and po["kfs"] == int(jo["kfs"])
    np.testing.assert_array_equal(po["loops"], jo["loops"])
    assert po["rehash"] >= 1 and po["errors"] == 0
    assert set(po["stages"]) == {"loop_icp", "pgo_solve", "pgo_apply"}
    a, b = po["traj"], jo["traj"]
    assert a.shape == b.shape == (220, 4, 4)
    np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=5e-2)
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=5e-3)
    assert ate_rmse(a, gt) < 0.1


def test_loops_through_the_chunk_path(loop_runs):
    gt, _, po, co = loop_runs
    np.testing.assert_array_equal(co["loops"], po["loops"])
    assert co["rehash"] >= 1 and co["errors"] == 0
    np.testing.assert_allclose(co["traj"][:, :3, 3], po["traj"][:, :3, 3], atol=5e-2)
    assert ate_rmse(co["traj"], gt) < 0.1


def test_loop_worker_thread_ends_cleanly():
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(70, length=30.0, radius=10.0, step=0.6)
    rng = np.random.default_rng(9)
    cfg = SystemConfig(**{**LOOP_CFG, "min_keyframe_gap": 5})
    est = Estimator(cfg, sync_loop=False, device="cpu")
    assert est._thread is not None and est._thread.is_alive()
    for p in poses:
        est.process_frame(synthetic.sample_scan(world, p, 6000, rng, max_range=45.0,
                                                noise=0.02))
    est.finalize_loops()
    assert est._thread is None and est.loop_errors == 0
    assert est.loop_detector.total_queries >= 1
    assert len(est.trajectory()) == 70
    est.reset()
    assert est.frame_count == 0 and len(est.keyframes) == 0
    assert est.loop_detector._db_n == 0 and est.get_loop_closure_count() == 0
    est.enable_loop_closure(True)
    assert est._thread is not None and est._thread.is_alive()
    est.shutdown()
    assert est._thread is None
