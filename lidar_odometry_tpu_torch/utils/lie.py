"""Batched SO(3)/SE(3) operations (counterpart of
the JAX package's utils/lie.py, the parts the odometry path uses).

Twist order [trans, rot]; Rodrigues exp with the small-angle branch;
so3_project is the 3-step Newton orthogonalisation R <- 1.5 R - 0.5 R R^T R;
the ICP retract is SE3(Exp(dw), dt) with no V matrix on the translation.
Functions take any leading batch shape and keep the input dtype.
"""
from __future__ import annotations

import torch

__all__ = ["hat", "so3_exp", "so3_project", "se3_matrix", "se3_inv",
           "se3_from_exp_rt", "transform_points"]


def _eps(dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-10


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]   # (...,1,1)
    small = theta < _eps(w.dtype)
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    K = hat(w / theta_safe[..., 0])
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    big = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(small, eye + hat(w), big)


def so3_project(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project a near-rotation onto SO(3) by Newton iteration."""
    for _ in range(iters):
        R = 1.5 * R - 0.5 * (R @ R.transpose(-1, -2) @ R)
    return R


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)   # fill_: no host-to-device copy of the scalar
    return T


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_from_exp_rt(dt: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """ICP retraction increment SE3(SO3::Exp(dw), dt)."""
    return se3_matrix(so3_exp(dw), dt)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
