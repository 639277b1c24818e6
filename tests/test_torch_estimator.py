"""The port's Estimator front door against the JAX Estimator in KD-tree
mode with loop closure off (CPU): 12 frames of 8k points, once through
process_frame and once through process_chunk (two chunks of 4, the first
with its sampled per-frame first frame, then a per-frame tail of 4).

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
    cfg = SystemConfig(**{**CFG, "enable_loop_detection": True})
    with pytest.raises(ValueError, match="loop closure"):
        Estimator(cfg, device="cpu")


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
