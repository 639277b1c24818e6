"""The port's viewer (render_snapshot, ConsoleViewer, export_state,
LiveViewer), Estimator.save_map_to_ply and the players' live_viewer
argument, against the JAX package where the two can be compared (CPU).

The JAX side runs in one fresh subprocess: the JAX live-viewer test's
drive (seed 3, 6 frames of 6000 points, loops off, through process_frame),
then export_state, save_map_to_ply and one LiveViewer update, whose JSON
it writes out. The port runs the same scans. Its export_state files agree
with JAX's: the trajectory and keyframe positions within 2e-3; the map
points and the debug clouds as sets (counts within 0.2 %, 99 % of JAX's
points with a port point within 2e-3); the surfels matched by centroid
(within 2e-3), their planarity within 2e-3 and, on cells of at least 5
children, their normals parallel within 1e-3 (a cell of fewer children may
have a normal its points do not fix: ROADMAP queue 3). The LiveViewer's
JSON carries JAX's keys."""
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from lidar_odometry_tpu_torch import viewer
from lidar_odometry_tpu_torch.config import SystemConfig
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.io.kitti import KittiPlayer
from lidar_odometry_tpu_torch.io.ply import PLYPlayer, load_ply, save_ply
from lidar_odometry_tpu_torch.models.estimator import Estimator, TimingStats
from lidar_odometry_tpu_torch.ops import voxel_map as vm

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(scan_capacity=4096, map_l0_capacity=32768, map_l1_capacity=8192,
           keyframe_capacity=64, point_stride=2, enable_loop_detection=False,
           enable_console_statistics=False)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_JAX_SIDE = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lidar_odometry_tpu import viewer
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.models.estimator import Estimator
    scans = np.load(sys.argv[1])["scans"]
    out = Path(sys.argv[2])
    est = Estimator(SystemConfig(**json.loads(sys.argv[3])), sync_loop=True)
    for s in scans:
        est.process_frame(s)
    viewer.export_state(str(out / "export"), est)
    est.save_map_to_ply(str(out / "map_acc.ply"))
    lv = viewer.LiveViewer(port=0)
    lv.update(est)
    (out / "state.json").write_bytes(lv._state_bytes)
    lv.close()
    est.shutdown()
""")


def _scans():
    world = synthetic.make_world(seed=3, extent=40.0, n_buildings=8)
    rng = np.random.default_rng(3)
    return [synthetic.sample_scan(world, p, 6000, rng, max_range=30.0, noise=0.01)
            for p in synthetic.straight_trajectory(6, step=0.5)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scans = _scans()
    tmp = tmp_path_factory.mktemp("viewer")
    padded = np.full((len(scans), max(map(len, scans)), 3), np.nan, np.float32)
    for i, s in enumerate(scans):
        padded[i, :len(s)] = s
    np.savez(tmp / "in.npz", scans=padded)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    log = open(tmp / "jax.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"), str(tmp),
                             json.dumps(CFG)], env=env, cwd=str(ROOT), stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        est = Estimator(SystemConfig(**CFG), sync_loop=True, device="cpu")
        for s in scans:
            assert est.process_frame(s)
        proc.wait(timeout=600)
    finally:
        proc.kill()
        log.close()
    assert proc.returncode == 0, (tmp / "jax.log").read_text()[-4000:]
    yield est, tmp
    est.shutdown()


def _csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _same_set(a, b, tol=2e-3):
    """b's points as a set against a's: counts within 0.2 % (2 at least),
    99 % of a's points with a point of b within tol."""
    assert abs(len(a) - len(b)) <= max(2, len(a) // 500), (len(a), len(b))
    d, _ = cKDTree(b).query(a)
    assert np.mean(d <= tol) >= 0.99, np.mean(d <= tol)


def _children(state) -> np.ndarray:
    """Live L0 children of each valid L1 surfel, in _surfel_rows' order."""
    c1 = state.c1
    live = (state.l0_data[:c1 * vm.NCH, 0] > 0.0).reshape(c1, vm.NCH).sum(1).numpy()
    return live[vm.l1_surfels(state)[3].numpy()]


def test_render_snapshot(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((500, 3)).astype(np.float32) * 10
    traj = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    traj[:, 0, 3] = np.arange(20)
    out = str(tmp_path / "snap.png")
    ok = viewer.render_snapshot(out, map_points=pts, trajectory=traj,
                                keyframe_positions=traj[::5, :3, 3])
    try:
        import matplotlib  # noqa: F401
        assert ok and os.path.getsize(out) > 1000
    except ImportError:
        assert ok is False and not os.path.exists(out)


def test_console_viewer_autoplay():
    cv = viewer.ConsoleViewer(step_mode=False, print_every=5)
    pose = np.eye(4, dtype=np.float32)
    for _ in range(12):
        assert cv.on_frame(pose, n_points=100, n_keyframes=2)
    cv.finish()


def test_timing_statistics_smoke():
    est = Estimator(SystemConfig(enable_loop_detection=False, scan_capacity=1024,
                                 map_l0_capacity=4096, map_l1_capacity=1024), sync_loop=True,
                    device="cpu")
    for _ in range(5):
        est.timing_history.append(TimingStats(1.0, 2.0, 3.0, 6.0))
    est.print_timing_statistics()
    est.shutdown()


def test_export_state_matches_jax(runs):
    est, tmp = runs
    out = tmp / "port_export"
    viewer.export_state(str(out), est)
    jout = tmp / "export"
    names = {"map.ply", "trajectory_xyz.csv", "keyframes_xyz.csv", "surfels.csv",
             "debug_pre_icp.ply", "debug_post_icp.ply"}
    assert names <= set(os.listdir(out)) and names <= set(os.listdir(jout))
    for name in ("trajectory_xyz.csv", "keyframes_xyz.csv"):
        a, b = _csv(out / name), _csv(jout / name)
        assert a.shape == b.shape and len(a) >= 3
        np.testing.assert_allclose(a, b, atol=2e-3)
    for name in ("map.ply", "debug_pre_icp.ply", "debug_post_icp.ply"):
        _same_set(load_ply(str(jout / name)), load_ply(str(out / name)))
    assert len(load_ply(str(out / "map.ply"))) == len(est.map_points()) > 1000

    surf, jsurf = _csv(out / "surfels.csv"), _csv(jout / "surfels.csv")
    assert surf.shape[1] == 7 and len(surf) > 100
    np.testing.assert_allclose(np.linalg.norm(surf[:, 3:6], axis=1), 1.0, atol=1e-3)
    assert np.all(surf[:, 6] >= 0.0)
    d, j = cKDTree(jsurf[:, :3]).query(surf[:, :3])
    hit = d <= 2e-3
    assert hit.mean() >= 0.99
    np.testing.assert_allclose(surf[hit, 6], jsurf[j[hit], 6], atol=2e-3)
    full = hit & (_children(est.map_state) >= 5)
    assert full.sum() >= 0.5 * len(surf)
    dots = np.abs(np.sum(surf[full, 3:6] * jsurf[j[full], 3:6], axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)


def test_save_map_to_ply_matches_jax(runs, tmp_path):
    est, tmp = runs
    path = str(tmp_path / "map_acc.ply")
    assert est.save_map_to_ply(path)
    np.testing.assert_array_equal(load_ply(path), est.accumulated_map(est.cfg.voxel_size))
    _same_set(load_ply(str(tmp / "map_acc.ply")), load_ply(path))
    empty = Estimator(SystemConfig(**CFG), device="cpu")
    assert not empty.save_map_to_ply(str(tmp_path / "none.ply"))


def test_live_viewer_serves_state_and_controls(runs):
    """The page, state.json with JAX's keys and counts, the finish and step
    controls; the debug state the viewer reads is cleared by reset()."""
    est, tmp = runs
    lv = viewer.LiveViewer(port=0)
    try:
        lv.update(est)
        base = f"http://127.0.0.1:{lv.port}"
        page = urllib.request.urlopen(f"{base}/").read().decode()
        assert "live</title>" in page
        state = json.loads(urllib.request.urlopen(f"{base}/state.json").read())
        jstate = json.loads((tmp / "state.json").read_text())
        assert set(state) == set(jstate)
        assert state["frame"] == jstate["frame"] == 6 and len(state["traj"]) == 6
        assert state["n_map"] == len(est.map_points()) == len(state["map"]) > 1000
        assert abs(state["n_map"] - jstate["n_map"]) <= max(2, jstate["n_map"] // 500)
        assert state["n_kf"] == jstate["n_kf"] and state["mode"] == "auto"
        np.testing.assert_allclose(state["traj"], jstate["traj"], atol=2e-3)

        urllib.request.urlopen(urllib.request.Request(f"{base}/control?mode=finish",
                                                      method="POST"))
        assert lv.mode == "finish" and lv.wait_if_stepping() is False
        urllib.request.urlopen(urllib.request.Request(f"{base}/control?mode=step",
                                                      method="POST"))
        granted = []
        t = threading.Thread(target=lambda: granted.append(lv.wait_if_stepping()))
        t.start()
        t.join(timeout=5.0)
        assert granted == [True] and lv.mode == "step"
    finally:
        lv.close()
    fresh = Estimator(SystemConfig(**CFG), device="cpu")
    fresh.process_frame(_scans()[0])
    assert fresh._last_feat is not None and fresh._last_icp_guess is None
    fresh.reset()
    assert fresh._last_feat is None and fresh._last_mask is None


class StubViewer:
    """A viewer that finishes after `allow` gates, in auto or step mode,
    and records the frame count, and the chunks whose host bookkeeping is
    still deferred, at each update."""

    def __init__(self, allow: int, mode: str = "auto"):
        self.allow, self.mode, self.updates, self.deferred = allow, mode, [], []

    def wait_if_stepping(self) -> bool:
        self.allow -= 1
        if self.allow < 0:
            self.mode = "finish"
        return self.allow >= 0

    def update(self, est) -> None:
        self.updates.append(est.frame_count)
        self.deferred.append(len(est._deferred_chunks))


@pytest.fixture(scope="module")
def ply_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ply")
    for i, s in enumerate(_scans() * 2):
        save_ply(str(d / f"frame_{i:06d}.ply"), s)
    return d


@pytest.mark.parametrize("chunk,mode,allow,frames,updates", [
    (0, "auto", 8, 8, [1, 6]),                 # frame by frame: every 5th frame
    (0, "step", 3, 3, [1, 2, 3]),              # step mode: every frame
    (4, "auto", 2, 8, [4, 8]),                 # chunks of 4: every chunk
])
def test_players_honour_the_viewer(ply_dir, chunk, mode, allow, frames, updates):
    cfg = SystemConfig(**CFG).replace(data_directory=str(ply_dir), save_trajectory=False)
    lv = StubViewer(allow, mode)
    res = PLYPlayer(cfg, device="cpu").run(chunk_frames=chunk, sync_loop=True, live_viewer=lv)
    assert res.frames_processed == frames and res.frames_failed == 0
    assert lv.updates == updates and lv.mode == "finish"


@pytest.fixture(scope="module")
def bin_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti")
    for i, s in enumerate(_scans() * 2):
        xyzi = np.concatenate([s, np.zeros((len(s), 1), np.float32)], axis=1)
        xyzi.astype(np.float32).tofile(d / f"{i:06d}.bin")
    return d


@pytest.mark.parametrize("chunk,mode,allow,frames,updates", [
    (0, "step", 3, 3, [1, 2, 3]),              # frame by frame, step mode: every frame
    (3, "auto", 3, 9, [3, 6, 9]),              # chunks of 3, loops off: every chunk
    (5, "auto", 3, 11, [5, 10, 11]),           # chunks of 5, then the tail's gate
])
def test_kitti_player_honours_the_viewer(bin_dir, chunk, mode, allow, frames, updates):
    """Chunked with loops off, the player would defer the host bookkeeping
    of chunks 2 on; with a viewer attached it does not, so each update
    sees every frame run so far."""
    cfg = SystemConfig(**CFG).replace(data_directory=str(bin_dir), save_trajectory=False,
                                      enable_statistics=False)
    lv = StubViewer(allow, mode)
    res = KittiPlayer(cfg, device="cpu").run(chunk_frames=chunk, sync_loop=True,
                                             live_viewer=lv)
    assert res.frames_processed == frames and res.frames_failed == 0
    assert lv.updates == updates and lv.mode == "finish"
    assert lv.deferred == [0] * len(updates)
