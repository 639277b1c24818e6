"""Batched SO(3)/SE(3) operations (counterpart of the JAX package's
utils/lie.py).

Twist order [trans, rot]; Rodrigues exp with the small-angle branch; the
log with its small-angle and theta ~ pi branches, theta from atan2;
so3_project is the 3-step Newton orthogonalisation R <- 1.5 R - 0.5 R R^T R
and so3_project_svd the exact SVD projection; the ICP retract is
SE3(Exp(dw), dt) with no V matrix on the translation, where se3_exp
applies the left Jacobian V. Functions take any leading batch shape and
keep the input dtype (float32 on the odometry path, float64 for the pose
graph, whose GTSAM-ordered helpers wrap these).
"""
from __future__ import annotations

import torch

__all__ = ["hat", "vee", "so3_exp", "so3_log", "so3_project", "so3_project_svd", "se3_exp",
           "se3_log", "se3_matrix", "se3_rt", "se3_inv", "se3_mul", "se3_identity",
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


def vee(S: torch.Tensor) -> torch.Tensor:
    """Inverse of hat for (..., 3, 3) skew matrices."""
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]   # (...,1,1)
    small = theta < _eps(w.dtype)
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    K = hat(w / theta_safe[..., 0])
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    big = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(small, eye + hat(w), big)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) axis-angle. theta = atan2(|vee(R - R^T)| / 2,
    (tr - 1) / 2), well conditioned near 0 and pi; the small-angle branch
    returns vee(R - I), and near pi the axis comes from the largest
    diagonal entry, its sign fixed against the skew part."""
    eps = _eps(R.dtype)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    skew_part = vee(R - R.transpose(-1, -2))                  # 2 sin(theta) axis
    sin_theta = 0.5 * torch.linalg.norm(skew_part, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)
    sin_safe = torch.where(torch.abs(sin_theta) < eps, torch.ones_like(sin_theta), sin_theta)
    generic = (theta / (2.0 * sin_safe))[..., None] * skew_part

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    max_idx = torch.argmax(diag, dim=-1)
    d_max = torch.gather(diag, -1, max_idx[..., None])[..., 0]
    axis_pivot = torch.sqrt(torch.clamp((d_max + 1.0) * 0.5, min=0.0))
    axis_pivot_safe = torch.where(axis_pivot < eps, torch.ones_like(axis_pivot), axis_pivot)
    row = torch.gather(R, -2, max_idx[..., None, None].expand(max_idx.shape + (1, 3)))[..., 0, :]
    axis = row / (2.0 * axis_pivot_safe[..., None])
    one_hot = torch.nn.functional.one_hot(max_idx, 3).to(R.dtype)
    axis = axis * (1.0 - one_hot) + axis_pivot[..., None] * one_hot
    dot = torch.sum(axis * (skew_part * 0.5), dim=-1)
    axis = torch.where((dot < 0)[..., None], -axis, axis)
    near_pi = axis * theta[..., None]

    small = theta < eps
    at_pi = torch.abs(sin_theta) < eps
    out = torch.where(at_pi[..., None], near_pi, generic)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.where(small[..., None], vee(R - eye), out)


def so3_project(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project a near-rotation onto SO(3) by Newton iteration."""
    for _ in range(iters):
        R = 1.5 * R - 0.5 * (R @ R.transpose(-1, -2) @ R)
    return R


def so3_project_svd(R: torch.Tensor) -> torch.Tensor:
    """Exact SVD projection onto SO(3), a reflection turned by flipping
    U's last column."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    flip = torch.ones(R.shape[:-2] + (1, 3), dtype=R.dtype, device=R.device)
    flip[..., 0, 2] = torch.where(det < 0, -1.0, 1.0).to(R.dtype)
    return (U * flip) @ Vt


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V of SE(3) Exp: I + (1 - cos)/theta^2 [phi] + (theta - sin)/theta^3 [phi]^2."""
    theta = torch.linalg.norm(phi, dim=-1)
    small = theta < _eps(phi.dtype)
    th = torch.where(small, torch.ones_like(theta), theta)
    ph = hat(phi)
    t2 = th * th
    a = (1.0 - torch.cos(th)) / t2
    b = (th - torch.sin(th)) / (t2 * th)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(ph.shape)
    V = eye + a[..., None, None] * ph + b[..., None, None] * (ph @ ph)
    return torch.where(small[..., None, None], eye, V)


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """V^-1 of SE(3) Log."""
    eps = _eps(phi.dtype)
    theta = torch.linalg.norm(phi, dim=-1)
    small = theta < eps
    th = torch.where(small, torch.ones_like(theta), theta)
    ph = hat(phi)
    t2 = th * th
    st, ct = torch.sin(th), torch.cos(th)
    st = torch.where(torch.abs(st) < eps, torch.ones_like(st), st)
    coeff = (2.0 * st - th * (1.0 + ct)) / (2.0 * t2 * st)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(ph.shape)
    Vinv = eye - 0.5 * ph + coeff[..., None, None] * (ph @ ph)
    return torch.where(small[..., None, None], eye, Vinv)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential of (..., 6) twists [trans, rot] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return se3_matrix(so3_exp(phi), (_left_jacobian(phi) @ rho[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twists [trans, rot]."""
    R, t = se3_rt(T)
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)   # fill_: no host-to-device copy of the scalar
    return T


def se3_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def se3_identity(dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def se3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_from_exp_rt(dt: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """ICP retraction increment SE3(SO3::Exp(dw), dt)."""
    return se3_matrix(so3_exp(dw), dt)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
