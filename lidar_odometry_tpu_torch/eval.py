"""Trajectory accuracy and frames (copies of the JAX package's
eval.ate_rmse, T_LIDAR_TO_CAM and lidar_pose_to_cam, which the port
cannot import without importing jax)."""
from __future__ import annotations

import numpy as np

__all__ = ["ate_rmse", "T_LIDAR_TO_CAM", "lidar_pose_to_cam"]

# KITTI's LiDAR -> camera axis permutation
T_LIDAR_TO_CAM = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)


def lidar_pose_to_cam(pose: np.ndarray) -> np.ndarray:
    """T_cam = T_l2c * T * T_l2c^-1."""
    return T_LIDAR_TO_CAM @ pose @ np.linalg.inv(T_LIDAR_TO_CAM)


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """First-frame-aligned ATE RMSE without scale fitting — the headline
    accuracy number for short synthetic runs."""
    n = min(len(est_poses), len(gt_poses))
    gt = np.linalg.inv(gt_poses[0])[None] @ gt_poses[:n].astype(np.float64)
    est = np.linalg.inv(est_poses[0])[None] @ est_poses[:n].astype(np.float64)
    ate = np.linalg.norm(gt[:, :3, 3] - est[:, :3, 3], axis=-1)
    return float(np.sqrt((ate**2).mean()))
