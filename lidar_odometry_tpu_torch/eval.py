"""Trajectory accuracy and frames (copies of the JAX package's eval.py:
ate_rmse, T_LIDAR_TO_CAM, lidar_pose_to_cam, and the KITTI segment
evaluator SEGMENT_LENGTHS, STEP_SIZE, ErrorStats, evaluate_trajectory,
which the port cannot import without importing jax).

The evaluator:
  * first-frame alignment of both trajectories;
  * a scale fit of the estimated step lengths onto the ground truth's;
  * segment-based relative errors over lengths 100..800 m, a segment
    starting every STEP_SIZE frames: translation % and rotation deg/100m
    against the ground truth's path length of each segment;
  * ATE (mean, RMSE, median, min, max) of the aligned positions.
translation_rmse and rotation_rmse are the segment errors' root mean
squares; the JAX package sets them to the means.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = ["ate_rmse", "T_LIDAR_TO_CAM", "lidar_pose_to_cam", "SEGMENT_LENGTHS", "STEP_SIZE",
           "ErrorStats", "evaluate_trajectory"]

SEGMENT_LENGTHS = [100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0]
STEP_SIZE = 10

# KITTI's LiDAR -> camera axis permutation
T_LIDAR_TO_CAM = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)


def lidar_pose_to_cam(pose: np.ndarray) -> np.ndarray:
    """T_cam = T_l2c * T * T_l2c^-1."""
    return T_LIDAR_TO_CAM @ pose @ np.linalg.inv(T_LIDAR_TO_CAM)


@dataclass
class ErrorStats:
    available: bool = False
    translation_mean: float = 0.0        # percent
    rotation_mean: float = 0.0           # deg / 100 m
    translation_rmse: float = 0.0
    rotation_rmse: float = 0.0
    ate_mean: float = 0.0
    ate_rmse: float = 0.0
    ate_median: float = 0.0
    ate_min: float = 0.0
    ate_max: float = 0.0
    total_segments: int = 0
    scale_factor: float = 1.0


def evaluate_trajectory(est_poses: np.ndarray, gt_poses: np.ndarray,
                        segment_lengths: Optional[List[float]] = None,
                        apply_scale: bool = True) -> ErrorStats:
    """Both inputs (F, 4, 4) in the same frame convention."""
    stats = ErrorStats()
    n = min(len(est_poses), len(gt_poses))
    if n < 2:
        return stats
    lengths = segment_lengths or SEGMENT_LENGTHS

    gt = np.linalg.inv(gt_poses[0])[None] @ gt_poses[:n].astype(np.float64)
    est = np.linalg.inv(est_poses[0])[None] @ est_poses[:n].astype(np.float64)

    # the scale of the estimated steps fitted onto the ground truth's
    gt_steps = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)
    est_steps = np.linalg.norm(np.diff(est[:, :3, 3], axis=0), axis=-1)
    scale = 1.0
    if apply_scale and np.sum(est_steps**2) > 1e-10:
        scale = float(np.sum(gt_steps * est_steps) / np.sum(est_steps**2))
    est = est.copy()
    est[:, :3, 3] *= scale
    stats.scale_factor = scale

    dist = np.concatenate([[0.0], np.cumsum(gt_steps)])   # the ground truth's path length

    trans_errors, rot_errors = [], []
    for first in range(0, n, STEP_SIZE):
        for seg_len in lengths:
            last = np.searchsorted(dist, dist[first] + seg_len, side="right")
            if last >= n:
                continue
            delta_gt = np.linalg.inv(gt[first]) @ gt[last]
            delta_est = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(delta_est) @ delta_gt
            path_len = dist[last] - dist[first]
            if path_len <= 0:
                continue
            d = np.clip(0.5 * (np.trace(err[:3, :3]) - 1.0), -1.0, 1.0)
            rot_errors.append(np.degrees(np.arccos(d) / path_len) * 100.0)
            trans_errors.append(np.linalg.norm(err[:3, 3]) / path_len * 100.0)

    ate = np.linalg.norm(gt[:, :3, 3] - est[:, :3, 3], axis=-1)
    stats.ate_mean = float(ate.mean())
    stats.ate_rmse = float(np.sqrt((ate**2).mean()))
    stats.ate_median = float(np.sort(ate)[len(ate) // 2])
    stats.ate_min = float(ate.min())
    stats.ate_max = float(ate.max())

    # ATE alone where the run is shorter than the shortest segment
    stats.available = True
    if trans_errors:
        t, r = np.asarray(trans_errors), np.asarray(rot_errors)
        stats.total_segments = len(t)
        stats.translation_mean = float(t.mean())
        stats.rotation_mean = float(r.mean())
        stats.translation_rmse = float(np.sqrt((t**2).mean()))
        stats.rotation_rmse = float(np.sqrt((r**2).mean()))
    return stats


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """First-frame-aligned ATE RMSE without scale fitting — the headline
    accuracy number for short synthetic runs."""
    n = min(len(est_poses), len(gt_poses))
    gt = np.linalg.inv(gt_poses[0])[None] @ gt_poses[:n].astype(np.float64)
    est = np.linalg.inv(est_poses[0])[None] @ est_poses[:n].astype(np.float64)
    ate = np.linalg.norm(gt[:, :3, 3] - est[:, :3, 3], axis=-1)
    return float(np.sqrt((ate**2).mean()))
