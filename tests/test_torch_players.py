"""The port's host side of the PLY player path against the JAX package
(CPU): PLY files, the config loader, the trajectory writers, the feeder,
and the PLY player and its CLI over a short indoor-corridor sequence at
the mid360 configuration."""
import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_odometry_tpu import config as jconfig
from lidar_odometry_tpu.io import kitti as jkitti
from lidar_odometry_tpu.io import ply as jply
from lidar_odometry_tpu_torch import config as tconfig
from lidar_odometry_tpu_torch.apps import lidar_odometry as cli
from lidar_odometry_tpu_torch.eval import ate_rmse
from lidar_odometry_tpu_torch.io import feeder, kitti, ply, synthetic

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's many small CPU ops: with the
    suite's parallel workers on one host, torch's default of one thread a
    core oversubscribes the cores and its threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["mid360.yaml", "kitti.yaml"])
def test_load_config_matches_jax(name):
    path = str(ROOT / "config" / name)
    assert (dataclasses.asdict(tconfig.load_config(path))
            == dataclasses.asdict(jconfig.load_config(path)))


def test_ply_round_trip(tmp_path):
    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    ply.save_ply(str(tmp_path / "a" / "frame_000012.ply"), pts)
    np.testing.assert_array_equal(ply.load_ply(str(tmp_path / "a" / "frame_000012.ply")), pts)
    np.testing.assert_array_equal(jply.load_ply(str(tmp_path / "a" / "frame_000012.ply")), pts)
    jply.save_ply(str(tmp_path / "b.ply"), pts)
    np.testing.assert_array_equal(ply.load_ply(str(tmp_path / "b.ply")), pts)
    (tmp_path / "c.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float y\nproperty float x\n"
        "property float z\nproperty uchar intensity\nend_header\n1 2 3 9\n4 5 6 9\n")
    np.testing.assert_array_equal(ply.load_ply(str(tmp_path / "c.ply")),
                                  [[2, 1, 3], [5, 4, 6]])
    assert ply.frame_number("/x/scan_7/frame_000012.ply") == 12


def test_trajectory_writers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(5, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    poses[2, :2, :2] = [[c, -s], [s, c]]
    for fmt in ("kitti", "tum"):
        getattr(kitti, f"save_trajectory_{fmt}")(str(tmp_path / f"p_{fmt}.txt"), poses)
        getattr(jkitti, f"save_trajectory_{fmt}")(str(tmp_path / f"j_{fmt}.txt"), poses)
        assert (tmp_path / f"p_{fmt}.txt").read_text() == (tmp_path / f"j_{fmt}.txt").read_text()


def test_read_ahead_closes_when_the_consumer_leaves_early():
    def slow(p):
        time.sleep(0.01)
        return np.zeros((3, 3), np.float32) + p

    ra = feeder.ReadAhead(list(range(200)), slow, lookahead=2)
    got = [x for _, x in zip(range(3), ra)]
    assert [int(g[0, 0]) for g in got] == [0, 1, 2]
    ra.close()
    assert not ra._thread.is_alive()
    assert threading.active_count() < 50


def _corridor(n_frames, rings=24):
    """MID360-style ring scans along the indoor corridor loop."""
    poses = synthetic.circuit_trajectory(n_frames, length=24.0, radius=7.0, step=0.12,
                                         height=1.2)
    center = synthetic.circuit_trajectory(64, length=24.0, radius=7.0,
                                          step=(2 * 24.0 + 2 * np.pi * 7.0) / 64, height=1.2)
    world = synthetic.make_corridor_world(center[:, :2, 3], width=5.0, height=3.0, extent=25.0)
    rng = np.random.default_rng(33)
    scans = [synthetic.sample_scan_rings(world, p, rng, n_rings=rings, azimuth_steps=720,
                                         max_range=25.0, noise=0.008,
                                         elevation_range=(-7.0, 52.0)) for p in poses]
    return scans, poses


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("mid360")
    scans, poses = _corridor(10)
    for i, s in enumerate(scans):
        ply.save_ply(str(d / "slam" / f"{i:06d}.ply"), s)
    return d, scans, poses


def test_chunk_feeder_on_the_cpu(dataset):
    d, scans, _ = dataset
    files = sorted(str(p) for p in (d / "slam").glob("*.ply"))
    fd = feeder.ChunkFeeder(files, 4, loader=ply.load_ply, device="cpu", point_stride=4)
    chunks = list(fd)
    fd.close()
    assert fd.tail == files[8:] and len(chunks) == 2
    assert chunks[0].shape == (4, fd.capacity, 3) and fd.capacity % 2048 == 0
    s = scans[5][::4]
    np.testing.assert_array_equal(chunks[1][1, :len(s)], s)
    assert np.isnan(chunks[1][1, len(s):]).all()


def test_ply_player_cli_at_the_mid360_configuration(dataset):
    """config/mid360.yaml through the CLI on the CPU: two chunks of 4 (the
    first with its sampled per-frame frame) and a per-frame tail of 2; an
    8-column TUM trajectory that follows the synthetic poses."""
    d, _, poses = dataset
    text = (ROOT / "config" / "mid360.yaml").read_text()
    text = text.replace('data_directory: "/data/mid360"', f'data_directory: "{d}"')
    text = text.replace("  map_l1_capacity: 65536", "  map_l1_capacity: 8192")
    text = text.replace("  scan_capacity: 16384", "  scan_capacity: 8192")
    cfg_path = d / "mid360_small.yaml"
    cfg_path.write_text(text)
    args = [str(cfg_path), "--device", "cpu", "--chunk", "4", "--format", "tum",
            "--output", str(d / "out")]
    with pytest.raises(ValueError, match="loop closure"):
        cli.main(args)
    assert cli.main(args + ["--no-loop-closure"]) == 0
    rows = np.loadtxt(d / "out" / "slam" / "slam_lo_tpu.txt")
    assert rows.shape == (10, 8)
    est = np.tile(np.eye(4), (10, 1, 1))
    est[:, :3, 3] = rows[:, 1:4]
    from scipy.spatial.transform import Rotation
    est[:, :3, :3] = Rotation.from_quat(rows[:, 4:8]).as_matrix()
    assert ate_rmse(est, poses) < 0.05


def test_ply_player_on_the_cpu(dataset):
    d, _, poses = dataset
    cfg = tconfig.load_config(str(ROOT / "config" / "mid360.yaml")).replace(
        data_directory=str(d), output_directory="", enable_loop_detection=False,
        map_l1_capacity=8192, scan_capacity=8192, enable_console_statistics=False)
    player = ply.PLYPlayer(cfg, device="cpu")
    res = player.run(chunk_frames=0, end=6)
    assert res.frames_processed == 6 and res.trajectory_path == ""
    assert player.estimator.get_keyframe_count() >= 1
    assert ate_rmse(player.estimator.trajectory(), poses[:6]) < 0.05
