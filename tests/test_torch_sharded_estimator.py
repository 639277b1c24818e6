"""The Estimator front door over the sharded map (models/map_backend.py
ShardedMapBackend, 4 shards in one process, the kernels' plain twins on
the CPU) against the port's single-device backend and the JAX package's
sharded Estimator (tests/test_sharded_estimator.py), on that test's
straight drive cut to 14 frames (CPU).

  * each run's ATE below 0.05 m; sharded and single-device trajectories
    within 0.02 m of each other with equal keyframe counts
    (tests/test_sharded_estimator.py:65-73); the port's sharded poses
    within 1e-3 m of JAX's (each ICP agrees to ~1e-7 m), the same
    keyframes, and every shard's voxel count within 0.2 % (a keyframe
    point within float32 rounding of a voxel edge may land in its
    neighbour);
  * sharded_update_batch = 4: finalize_loops flushes the pending inserts,
    ATE below 0.08 m (tests/test_sharded_estimator.py:76-89), and the
    JAX comparison above holds for the batched run too;
  * warm_loop_programs leaves pending inserts pending (its rehash result
    is dropped, so a flush there would lose them);
  * process_chunk refuses the sharded backend.

The JAX estimator runs in a fresh subprocess, as in
tests/test_torch_estimator.py."""
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
from lidar_odometry_tpu_torch.models.map_backend import ShardedMapBackend
from lidar_odometry_tpu_torch.parallel import mesh

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 14
CFG = dict(scan_capacity=4096, map_l0_capacity=131072, map_l1_capacity=32768,
           keyframe_capacity=256, point_stride=1, enable_loop_detection=False,
           enable_console_statistics=False)

_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.models.estimator import Estimator
    from lidar_odometry_tpu.models.map_backend import ShardedMapBackend
    scans = np.load(sys.argv[1])["scans"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("map",))
    out = {}
    for name, batch in (("b1", 1), ("b4", 4)):
        cfg = SystemConfig(**json.loads(sys.argv[3]), sharded_update_batch=batch)
        est = Estimator(cfg, sync_loop=True, map_backend=ShardedMapBackend(cfg, mesh))
        for s in scans:
            est.process_frame(s)
        est.finalize_loops()
        out[name + "_traj"] = est.trajectory()
        out[name + "_kf"] = np.array([f.is_keyframe for f in est.frames])
        out[name + "_n_l0"] = np.asarray(est.map_state.n_l0)
    np.savez(sys.argv[2], **out)
""")


def _straight_scans(n_frames=FRAMES, n_pts=4000, seed=5):
    world = synthetic.make_world(seed=seed, extent=50.0, n_buildings=12)
    poses = synthetic.straight_trajectory(n_frames, step=0.4)
    rng = np.random.default_rng(seed)
    scans = np.full((n_frames, n_pts, 3), np.nan, np.float32)
    for i in range(n_frames):
        s = synthetic.sample_scan(world, poses[i], n_pts, rng, max_range=45.0, noise=0.01)
        scans[i, :len(s)] = s
    return poses, scans


def _sharded(cfg, **kw):
    return Estimator(cfg, sync_loop=True, device="cpu",
                     map_backend=ShardedMapBackend(cfg, mesh.make_group(4, device="cpu"), **kw))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    poses, scans = _straight_scans()
    tmp = tmp_path_factory.mktemp("sharded_estimator")
    np.savez(tmp / "in.npz", scans=scans)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"),
                           str(tmp / "jax.npz"), json.dumps(CFG)], env=env, cwd=str(ROOT),
                          timeout=900, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    cfg = SystemConfig(**CFG)
    out = {}
    for name, est in (("single", Estimator(cfg, sync_loop=True, device="cpu")),
                      ("b1", _sharded(cfg)),
                      ("b4", _sharded(cfg.replace(sharded_update_batch=4)))):
        for s in scans:
            assert est.process_frame(s)
        est.finalize_loops()
        out[name] = est
    return poses, dict(np.load(tmp / "jax.npz")), out


def test_sharded_front_door_matches_single_device(runs):
    gt, _, est = runs
    single, sharded = est["single"].trajectory(), est["b1"].trajectory()
    assert ate_rmse(single, gt) < 0.05
    assert ate_rmse(sharded, gt) < 0.05
    assert ate_rmse(sharded, single) < 0.02
    assert est["b1"].get_keyframe_count() == est["single"].get_keyframe_count()
    counts = est["b1"].map_counts()
    assert counts["n_l0"] > 1000 and counts["n_dropped"] == 0
    assert int(est["b1"].backend.owned_overflow) == 0


@pytest.mark.parametrize("name", ["b1", "b4"])
def test_sharded_front_door_matches_jax(runs, name):
    gt, jo, est = runs
    traj = est[name].trajectory()
    assert traj.shape == jo[name + "_traj"].shape == (FRAMES, 4, 4)
    np.testing.assert_array_equal([f.is_keyframe for f in est[name].frames], jo[name + "_kf"])
    np.testing.assert_allclose(traj[:, :3, 3], jo[name + "_traj"][:, :3, 3], atol=1e-3)
    assert ate_rmse(jo[name + "_traj"], gt) < (0.05 if name == "b1" else 0.08)
    # the keyframes' world points are rounded differently on the two sides,
    # so a point within rounding of a voxel edge may land in its neighbour
    np.testing.assert_allclose(est[name].map_state.n_l0.numpy(), jo[name + "_n_l0"], rtol=2e-3)


def test_update_batching_flushes(runs):
    gt, _, est = runs
    b4 = est["b4"]
    assert not b4.backend._pend
    assert ate_rmse(b4.trajectory(), gt) < 0.08
    assert b4.map_counts()["n_l0"] > 1000


def test_warm_up_keeps_pending_inserts():
    poses, scans = _straight_scans(n_frames=7)
    # every frame a keyframe: four updates run at once, three stay pending
    cfg = SystemConfig(**CFG).replace(sharded_update_batch=4, scan_capacity=1024,
                                      keyframe_distance_threshold=0.3)
    est = _sharded(cfg)
    for s in scans:
        est.process_frame(s[:1024])
    pend = len(est.backend._pend)
    assert pend == 3
    before = est.map_counts()
    est.warm_loop_programs()
    assert len(est.backend._pend) == pend
    assert est.map_counts() == before
    est.finalize_loops()
    assert not est.backend._pend and est.map_counts()["n_l0"] > before["n_l0"]


def test_process_chunk_refuses_sharded_backend():
    cfg = SystemConfig(**CFG)
    est = _sharded(cfg)
    with pytest.raises(NotImplementedError, match="process_frame"):
        est.process_chunk(np.zeros((2, 64, 3), np.float32))


def test_sharded_backend_checks():
    g = mesh.make_group(4, device="cpu")
    with pytest.raises(ValueError, match="use_surfel_correspondence"):
        ShardedMapBackend(SystemConfig(**CFG).replace(use_surfel_correspondence=False), g)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedMapBackend(SystemConfig(**CFG).replace(map_l1_capacity=32770), g)
