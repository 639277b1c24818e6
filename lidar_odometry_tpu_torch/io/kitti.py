"""Trajectory writers (the writer part of the JAX package's io/kitti.py):
KITTI 3x4 rows in the camera frame, and TUM lines. The KITTI player
itself comes later (ROADMAP queue 1, item 8)."""
from __future__ import annotations

import os

import numpy as np

from ..eval import lidar_pose_to_cam
from ..utils import logging_util as log

__all__ = ["pose_to_kitti_string", "save_trajectory_kitti", "save_trajectory_tum"]


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
