"""The port's KITTI front door (runtime/native_io.py, eval.py's segment
evaluator, io/kitti.py's player and apps/kitti_lidar_odometry.py) against
the JAX package's, on the CPU, over a written sequence of 7 KITTI .bin
scans of ~4000 points and its camera-frame ground truth.

Tolerances: the loaders, the prefetcher, the pose parser, the velocity
statistics and the statistics file are exact; the evaluator's fields
agree to 1e-12 (the same float64 numpy in the same order), but for
translation_rmse and rotation_rmse, which the port computes as root mean
squares and the JAX package sets to the means; the player's poses agree
with the JAX player's to 2e-3, the estimator tests' tolerance
(tests/test_torch_estimator.py), frame by frame and in chunks of 2 (three
chunks and a tail frame) alike; the chunked run also agrees with the
per-frame run to 0.02 m. The JAX player runs in a fresh subprocess, as
in tests/test_torch_estimator.py."""
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

from lidar_odometry_tpu import eval as jeval
from lidar_odometry_tpu.io import kitti as jkitti
from lidar_odometry_tpu.runtime import native_io as jnative
from lidar_odometry_tpu_torch import eval as teval
from lidar_odometry_tpu_torch import kernels
from lidar_odometry_tpu_torch.apps import kitti_lidar_odometry as cli
from lidar_odometry_tpu_torch.config import SystemConfig
from lidar_odometry_tpu_torch.eval import ate_rmse, lidar_pose_to_cam
from lidar_odometry_tpu_torch.io import kitti, synthetic
from lidar_odometry_tpu_torch.runtime import native_io

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 7
CHUNK = 2         # the chunked runs: three chunks of 2, then a tail frame
CFG = dict(seq="07", scan_capacity=4096, map_l0_capacity=32768, map_l1_capacity=8192,
           keyframe_capacity=64, point_stride=1, voxel_size=0.5, map_voxel_size=0.5,
           max_range=50.0, use_surfel_correspondence=False, enable_loop_detection=False,
           enable_console_statistics=False)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads (see tests/test_torch_players.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_bin(path, pts):
    data = np.zeros((len(pts), 4), np.float32)
    data[:, :3] = pts
    data[:, 3] = np.linspace(0.0, 1.0, len(pts), dtype=np.float32)
    data.astype("<f4").tofile(path)


def _write_gt(path, poses):
    with open(path, "w") as f:
        for p in poses:
            cam = lidar_pose_to_cam(p.astype(np.float64))
            f.write(" ".join(f"{cam[r, c]:.9f}" for r in range(3) for c in range(4)) + "\n")


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A straight drive of FRAMES scans as sequences/07/velodyne/*.bin and
    its ground truth gt/07.txt."""
    root = tmp_path_factory.mktemp("kitti")
    world = synthetic.make_world(seed=21, extent=60.0, n_buildings=12)
    poses = synthetic.straight_trajectory(FRAMES, step=0.4)
    rng = np.random.default_rng(21)
    velo = root / "sequences" / "07" / "velodyne"
    velo.mkdir(parents=True)
    (root / "gt").mkdir()
    for i, p in enumerate(poses):
        s = synthetic.sample_scan(world, p, 4000, rng, max_range=50.0, noise=0.01)
        _write_bin(str(velo / f"{i:06d}.bin"), s)
    _write_gt(str(root / "gt" / "07.txt"), poses)
    files = sorted(str(f) for f in velo.glob("*.bin"))
    return root, files, poses


def _numpy_loader(monkeypatch):
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_lib_tried", True)


def test_native_library_is_built_outside_the_sources():
    assert native_io.loader_name() == "native"
    lib = native_io.library_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "native"
    assert not list(native_io.SOURCE.parent.glob("*.so"))


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Four threads building the library into one directory at once: one
    compiles under the lock, the others wait and find it built; no
    temporary file is left and the library loads."""
    import ctypes
    import threading
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path)
    lib = tmp_path / "libio_native_test.so"
    runs, errors = [], []
    real_run = native_io.subprocess.run

    def counted(*a, **kw):
        runs.append(a[0])
        return real_run(*a, **kw)

    monkeypatch.setattr(native_io.subprocess, "run", counted)

    def build():
        try:
            native_io._build(lib)
        except Exception as e:   # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(runs) == 1 and lib.exists()
    assert [f.name for f in tmp_path.iterdir() if ".tmp" in f.name] == []
    assert ctypes.CDLL(str(lib)).lo_load_kitti_bin is not None


@pytest.mark.parametrize("loader", ["native", "numpy"])
def test_load_kitti_binary_matches_jax(sequence, monkeypatch, loader):
    _, files, _ = sequence
    want = [jkitti.load_kitti_binary(f) for f in files]
    if loader == "numpy":
        _numpy_loader(monkeypatch)
    assert native_io.loader_name() == loader
    for f, w in zip(files, want):
        got = kitti.load_kitti_binary(f)
        assert got.dtype == np.float32 and got.shape == w.shape
        assert np.array_equal(got.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("loader", ["native", "numpy"])
def test_both_loaders_cap_the_points_alike(sequence, monkeypatch, loader):
    """A file of more than MAX_POINTS points gives its first MAX_POINTS,
    through the library and through numpy alike."""
    _, files, _ = sequence
    full = np.fromfile(files[0], dtype=np.float32).reshape(-1, 4)[:, :3]
    monkeypatch.setattr(native_io, "MAX_POINTS", len(full) - 7)
    if loader == "numpy":
        _numpy_loader(monkeypatch)
    assert native_io.loader_name() == loader
    got = kitti.load_kitti_binary(files[0])
    assert np.array_equal(got, full[:len(full) - 7])
    pf = native_io.Prefetcher(files[:1])
    assert np.array_equal(pf.next(), full[:len(full) - 7])
    pf.close()


@pytest.mark.parametrize("loader", ["native", "numpy"])
def test_prefetcher_yields_jax_clouds_in_order(sequence, monkeypatch, loader):
    _, files, _ = sequence
    paths = files + [files[0] + ".missing"] + files[:2]
    jp = jnative.Prefetcher(paths, lookahead=2)
    want = [jp.next() for _ in range(len(paths))]
    jp.close()
    if loader == "numpy":
        _numpy_loader(monkeypatch)
    pf = native_io.Prefetcher(paths, lookahead=2)
    got = [pf.next() for _ in range(len(paths))]
    assert pf.next() is None
    pf.close()
    assert got[len(files)] is None and want[len(files)] is None
    del got[len(files)], want[len(files)]
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_pose_files_match_jax(sequence):
    root, _, poses = sequence
    path = str(root / "gt" / "07.txt")
    got, want = kitti.load_kitti_gt(path), jkitti.load_kitti_gt(path)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    line = open(path).readline()
    assert np.array_equal(kitti.parse_kitti_pose_line(line), jkitti.parse_kitti_pose_line(line))
    np.testing.assert_allclose(got, [lidar_pose_to_cam(p.astype(np.float64)) for p in poses],
                               atol=1e-8)
    assert kitti.load_kitti_gt(str(root / "gt" / "07.txt")).shape == (FRAMES, 4, 4)


def _long_drive(n=1200, seed=3):
    """A 1.2 km drive with curves (~1 m a frame) and a noisy estimate of it,
    both (n, 4, 4) float64: enough path for every segment of 100-800 m."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(np.where(np.arange(n) % 300 < 50, 0.02, 0.0) + rng.normal(0, 2e-3, n))
    step = 1.0 + 0.1 * np.sin(np.arange(n) / 40.0)
    xy = np.cumsum(np.stack([step * np.cos(yaw), step * np.sin(yaw)], 1), 0)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = (np.cos(yaw), -np.sin(yaw),
                                                          np.sin(yaw), np.cos(yaw))
    gt[:, :2, 3] = xy
    gt[:, 2, 3] = 0.01 * np.arange(n)
    est = gt.copy()
    drift = np.cumsum(rng.normal(0, 0.02, (n, 3)), 0)
    est[:, :3, 3] = 1.01 * gt[:, :3, 3] + drift
    a = np.cumsum(rng.normal(0, 1e-3, n))
    R = np.tile(np.eye(3), (n, 1, 1))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = np.cos(a), -np.sin(a), np.sin(a), np.cos(a)
    est[:, :3, :3] = R @ gt[:, :3, :3]
    return est, gt


@pytest.mark.parametrize("apply_scale", [True, False])
def test_evaluate_trajectory_matches_jax(apply_scale):
    est, gt = _long_drive()
    got = teval.evaluate_trajectory(est, gt, apply_scale=apply_scale)
    want = jeval.evaluate_trajectory(est, gt, apply_scale=apply_scale)
    assert got.available and got.total_segments > 500
    for name, value in dataclasses.asdict(want).items():
        if name.endswith("_rmse") and name != "ate_rmse":
            continue
        assert abs(getattr(got, name) - value) <= 1e-12 * max(1.0, abs(value)), name
    # the JAX package sets the segment RMSEs to the means; the port's are
    # root mean squares, which a spread of segment errors puts above them
    assert (want.translation_rmse, want.rotation_rmse) == (want.translation_mean,
                                                           want.rotation_mean)
    assert got.translation_rmse > got.translation_mean > 0
    assert got.rotation_rmse > got.rotation_mean > 0
    assert teval.SEGMENT_LENGTHS == jeval.SEGMENT_LENGTHS and teval.STEP_SIZE == jeval.STEP_SIZE


def test_evaluate_short_and_empty_runs_match_jax():
    est, gt = _long_drive(n=40)
    for n in (0, 1, 40):
        got, want = teval.evaluate_trajectory(est[:n], gt[:n]), jeval.evaluate_trajectory(est[:n],
                                                                                         gt[:n])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_velocity_statistics_and_statistics_file_match_jax(tmp_path):
    est, gt = _long_drive(n=50)
    v, jv = kitti.velocity_statistics(est), jkitti.velocity_statistics(est)
    assert dataclasses.asdict(v) == dataclasses.asdict(jv)
    assert not kitti.velocity_statistics(est[:1]).available
    common = dict(frames_processed=50, total_time_s=2.5, fps=20.0, steady_fps=21.5,
                  per_frame_ms=[40.0, 50.0, 60.0])
    res = kitti.KittiPlayerResult(**common, error_stats=teval.evaluate_trajectory(est, gt),
                                  velocity_stats=v)
    jres = jkitti.KittiPlayerResult(**common, error_stats=jeval.evaluate_trajectory(est, gt),
                                    velocity_stats=jv)
    kitti.save_statistics(str(tmp_path / "p.txt"), res, "07")
    jkitti.save_statistics(str(tmp_path / "j.txt"), jres, "07")
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    res.frames_failed = 2
    kitti.save_statistics(str(tmp_path / "p.txt"), res, "07")
    assert " Frames failed: 2\n" in (tmp_path / "p.txt").read_text()


_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.io.kitti import KittiPlayer
    for out, kw in ((sys.argv[1], dict(sync_loop=True, chunk_frames=0)),
                    (sys.argv[2], dict(chunk_frames=int(sys.argv[4]), prestage=True))):
        player = KittiPlayer(SystemConfig(**json.loads(sys.argv[3])))
        res = player.run(**kw)
        np.savez(out, traj=player.estimator.trajectory(),
                 kf=np.array([f.is_keyframe for f in player.estimator.frames]),
                 frames=res.frames_processed, ate=res.error_stats.ate_rmse,
                 traj_file=open(res.trajectory_path).read())
""")


def _cfg(root, out, **kw):
    return dict(CFG, data_directory=str(root), ground_truth_directory=str(root / "gt"),
                output_directory=str(out), **kw)


@pytest.fixture(scope="module")
def jax_runs(sequence, tmp_path_factory):
    """The JAX player frame by frame and in chunks of CHUNK (prestaged)."""
    root, _, _ = sequence
    out = tmp_path_factory.mktemp("jax_out")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(out / "frames.npz"),
                           str(out / "chunked.npz"), json.dumps(_cfg(root, out)), str(CHUNK)],
                          env=env, cwd=str(ROOT), timeout=600, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {k: dict(np.load(out / f"{k}.npz")) for k in ("frames", "chunked")}


@pytest.fixture(scope="module")
def jax_run(jax_runs):
    return jax_runs["frames"]


@pytest.fixture(scope="module")
def frame_run(sequence, tmp_path_factory):
    root, _, _ = sequence
    out = tmp_path_factory.mktemp("port_out")
    player = kitti.KittiPlayer(SystemConfig(**_cfg(root, out)), device="cpu")
    res = player.run(sync_loop=True, chunk_frames=0)
    return player, res


def test_player_matches_jax_frame_by_frame(sequence, jax_run, frame_run):
    _, _, poses = sequence
    player, res = frame_run
    a, b = player.estimator.trajectory(), jax_run["traj"]
    assert res.frames_processed == int(jax_run["frames"]) == FRAMES and res.frames_failed == 0
    assert a.shape == b.shape == (FRAMES, 4, 4)
    np.testing.assert_array_equal([f.is_keyframe for f in player.estimator.frames],
                                  jax_run["kf"])
    np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=2e-3)
    assert ate_rmse(a, poses) < 0.05
    assert abs(res.error_stats.ate_rmse - float(jax_run["ate"])) < 2e-3
    rows = np.loadtxt(res.trajectory_path)
    assert rows.shape == (FRAMES, 12)
    np.testing.assert_allclose(rows, np.loadtxt(str(jax_run["traj_file"]).splitlines()),
                               atol=2e-3)
    assert os.path.isfile(res.statistics_path) and res.velocity_stats.available


@pytest.fixture(scope="module")
def chunked_run(sequence, tmp_path_factory):
    root, _, _ = sequence
    out = tmp_path_factory.mktemp("port_chunked")
    player = kitti.KittiPlayer(SystemConfig(**_cfg(root, out)), device="cpu")
    res = player.run(chunk_frames=CHUNK, prestage=True)
    return player, res


def test_chunked_run_matches_jax(sequence, jax_runs, chunked_run):
    """The chunked player (the feeder, prestage, deferred drains, the tail
    frame by frame) against the JAX player's chunked run."""
    _, _, poses = sequence
    player, res = chunked_run
    want = jax_runs["chunked"]
    a, b = player.estimator.trajectory(), want["traj"]
    tail = FRAMES % CHUNK
    assert tail == 1
    assert res.frames_processed == int(want["frames"]) == FRAMES and res.frames_failed == 0
    assert len(res.per_frame_ms) == FRAMES and res.steady_fps > 0
    assert a.shape == b.shape == (FRAMES, 4, 4)
    np.testing.assert_array_equal([f.is_keyframe for f in player.estimator.frames], want["kf"])
    np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=2e-3)
    # the tail frame, run frame by frame after the chunks
    np.testing.assert_allclose(a[-tail:], b[-tail:], atol=2e-3)
    assert abs(res.error_stats.ate_rmse - float(want["ate"])) < 2e-3
    np.testing.assert_allclose(np.loadtxt(res.trajectory_path),
                               np.loadtxt(str(want["traj_file"]).splitlines()), atol=2e-3)
    assert ate_rmse(a, poses) < 0.05


def test_chunked_run_matches_the_frame_run(frame_run, chunked_run):
    player, res = chunked_run
    assert res.frames_processed == FRAMES and res.frames_failed == 0
    np.testing.assert_allclose(player.estimator.trajectory()[:, :3, 3],
                               frame_run[0].estimator.trajectory()[:, :3, 3], atol=0.02)


def test_player_on_the_sharded_backend(sequence, tmp_path):
    root, _, poses = sequence
    cfg = SystemConfig(**_cfg(root, tmp_path, use_surfel_correspondence=True))
    player = kitti.KittiPlayer(cfg, device="cpu")
    res = player.run(sync_loop=True, shards=4, end=4)
    assert player.estimator.backend.name == "sharded"
    assert player.estimator.backend.group.n_shards == 4
    assert player.estimator.cfg.pgo_backend == "distributed" and cfg.pgo_backend == "manual"
    assert res.frames_processed == 4 and res.frames_failed == 0
    assert ate_rmse(player.estimator.trajectory(), poses[:4]) < 0.05


class _FailingEstimator:
    """Stands in for the Estimator: process_frame raises `error` on frame
    `bad` and records the others."""
    error, bad = None, 2

    def __init__(self, cfg, sync_loop=False, device=None, map_backend=None):
        self.frames = []

    def process_frame(self, cloud):
        if len(self.frames) == self.bad and self.error is not None:
            self.frames.append(None)
            raise self.error
        self.frames.append(len(cloud))
        return True

    def finalize_loops(self):
        pass

    def trajectory(self):
        return np.tile(np.eye(4), (len(self.frames), 1, 1))

    def shutdown(self):
        pass


def test_a_failing_frame_is_logged_and_counted(sequence, monkeypatch, capsys, tmp_path):
    root, _, _ = sequence
    monkeypatch.setattr(_FailingEstimator, "error", ValueError("bad frame"))
    monkeypatch.setattr(kitti, "Estimator", _FailingEstimator)
    res = kitti.KittiPlayer(SystemConfig(**_cfg(root, tmp_path)), device="cpu").run(
        chunk_frames=0)
    assert res.frames_processed == FRAMES and res.frames_failed == 1
    assert "[KittiPlayer] frame 2 failed: ValueError('bad frame')" in capsys.readouterr().err
    assert " Frames failed: 1\n" in open(res.statistics_path).read()


@pytest.mark.parametrize("fault", ["kernel", "cuda"])
def test_a_kernel_or_cuda_fault_is_raised(sequence, monkeypatch, tmp_path, fault):
    root, _, _ = sequence
    err = {"kernel": kernels.KernelError("CUDA kernel bev_raster failed to launch "
                                         "(cudaError 9)"),
           "cuda": torch.AcceleratorError("CUDA error: an illegal memory access")}[fault]
    monkeypatch.setattr(_FailingEstimator, "error", err)
    monkeypatch.setattr(kitti, "Estimator", _FailingEstimator)
    with pytest.raises(type(err)) as raised:
        kitti.KittiPlayer(SystemConfig(**_cfg(root, tmp_path)), device="cpu").run(chunk_frames=0)
    assert raised.value is err


def test_cli_writes_its_trajectory(sequence, tmp_path):
    root, _, poses = sequence
    text = (ROOT / "config" / "kitti.yaml").read_text()
    for a, b in (('data_directory: "/data/KITTI"', f'data_directory: "{root}"'),
                 ('ground_truth_directory: "/data/KITTI/GroundTruth"',
                  f'ground_truth_directory: "{root / "gt"}"'),
                 ('output_directory: "/data/KITTI/Result"', f'output_directory: "{tmp_path}"'),
                 ("  point_stride: 8", "  point_stride: 1"),
                 ("  scan_capacity: 16384", "  scan_capacity: 4096"),
                 ("  map_l0_capacity: 262144", "  map_l0_capacity: 32768"),
                 ("  map_l1_capacity: 65536", "  map_l1_capacity: 8192"),
                 ("  keyframe_capacity: 4096", "  keyframe_capacity: 64"),
                 ("  enable_console_statistics: true", "  enable_console_statistics: false")):
        assert a in text
        text = text.replace(a, b)
    cfg_path = tmp_path / "kitti_small.yaml"
    cfg_path.write_text(text)
    assert cli.main([str(cfg_path), "--device", "cpu", "--sync-loop", "--chunk", "0",
                     "--end", "4", "--save-map", str(tmp_path / "map.ply")]) == 0
    rows = np.loadtxt(tmp_path / "07" / "07_lo_tpu.txt")
    assert rows.shape == (4, 12)
    est = np.tile(np.eye(4), (4, 1, 1))
    est[:, :3, :] = rows.reshape(4, 3, 4)
    cam = np.stack([lidar_pose_to_cam(p.astype(np.float64)) for p in poses[:4]])
    assert ate_rmse(est, cam) < 0.05
    assert (tmp_path / "07" / "07_statistics.txt").is_file()
    assert (tmp_path / "map.ply").stat().st_size > 1000
    assert cli.main([str(cfg_path), "--device", "cpu", "--start", "100"]) == 1
