"""Trajectory accuracy (copy of the JAX package's eval.ate_rmse, which
the port cannot import without importing jax)."""
from __future__ import annotations

import numpy as np

__all__ = ["ate_rmse"]


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """First-frame-aligned ATE RMSE without scale fitting — the headline
    accuracy number for short synthetic runs."""
    n = min(len(est_poses), len(gt_poses))
    gt = np.linalg.inv(gt_poses[0])[None] @ gt_poses[:n].astype(np.float64)
    est = np.linalg.inv(est_poses[0])[None] @ est_poses[:n].astype(np.float64)
    ate = np.linalg.norm(gt[:, :3, 3] - est[:, :3, 3], axis=-1)
    return float(np.sqrt((ate**2).mean()))
