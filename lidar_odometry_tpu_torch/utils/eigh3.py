"""Closed-form eigendecomposition of symmetric 3x3 matrices (counterpart
of the JAX package's utils/eigh3.py): trigonometric eigenvalues and the
largest cross product of the rows of (A - lambda I) as the eigenvector.
The CUDA kernels carry a __device__ copy of the same arithmetic
(csrc/common.cuh, eigvals3 and eigvec_for): the map update's surfel
recompute and the KD-tree mode's 5-NN plane fit."""
from __future__ import annotations

import math

import torch

__all__ = ["eigh3", "smallest_eigenvector", "plane_from_points"]

_TWO_PI_3 = 2.0 * math.pi / 3.0


def _eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.where(p < 1e-20, torch.ones_like(p), p)
    b00, b11, b22 = (a00 - q) / p_safe, (a11 - q) / p_safe, (a22 - q) / p_safe
    b01, b02, b12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    l1 = 3.0 * q - l0 - l2
    near_diag = p < 1e-20
    d_sorted = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1).values
    lam = torch.stack([l0, l1, l2], dim=-1)
    return torch.where(near_diag[..., None], d_sorted, lam)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Null direction of (A - lam I): the largest cross product of its rows."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cand = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                        torch.linalg.cross(r1, r2)], dim=-2)   # (..., 3, 3)
    norms = torch.sum(cand * cand, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
    degenerate = nrm[..., 0] < 1e-20
    z = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(degenerate[..., None], z.expand(v.shape),
                       v / torch.where(nrm < 1e-20, torch.ones_like(nrm), nrm))


def eigh3(A: torch.Tensor):
    """(eigenvalues ascending (..., 3), smallest-eigenvalue eigenvector (..., 3))."""
    lam = _eigvals3(A)
    return lam, _eigvec_for(A, lam[..., 0])


def smallest_eigenvector(A: torch.Tensor) -> torch.Tensor:
    """The unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)."""
    return _eigvec_for(A, _eigvals3(A)[..., 0])


def plane_from_points(pts: torch.Tensor, mask: torch.Tensor):
    """Masked plane fit of (..., K, 3) points: (normal, centroid,
    planarity = lambda_min / (lambda_max + 1e-6)). The covariance is the
    mean outer product of the centred valid points."""
    m = mask[..., None].to(pts.dtype)
    cnt = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    centroid = torch.sum(pts * m, dim=-2) / cnt
    d = (pts - centroid[..., None, :]) * m
    cov = torch.einsum("...ki,...kj->...ij", d, d) / cnt[..., None]
    lam, normal = eigh3(cov)
    return normal, centroid, lam[..., 0] / (lam[..., 2] + 1e-6)
