"""Coarse loop-closure prealignment: yaw from the Iris bias, x-y translation
from bird's-eye-view phase correlation (counterpart of the JAX package's
ops/bev_align.py: bev_translation_offset, prealign_pose_jnp,
prealign_pose).

Both keyframe clouds are rasterised into (G, G) occupancy images around
the matched keyframe's position; the offset is the argmax of the
normalised cross-power spectrum (the first maximum in row-major order, as
jnp.argmax and torch.argmax both take it). The FFTs are torch.fft, the two
forward ones in one batched call.

Kernels (csrc/bev_align.cu), each with its plain twin below:
  K7 bev_raster — the query cloud's transform and both occupancy images,
      written as the complex64 pair that one batched FFT takes;
  K7c cross_power — the normalised cross-power spectrum between the FFTs
      (also the Iris shift estimate's, ops/iris.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..utils import keys as K
from ..utils import lie

__all__ = ["bev_raster", "bev_raster_plain", "cross_power", "cross_power_plain",
           "bev_translation_offset", "prealign_pose_t", "prealign_pose"]


# the kernel's bitmap of both images fits 48 KB of shared memory
MAX_RASTER_CELLS = 12288 * 32


def bev_raster(pts_a, mask_a, T_a, pts_b, mask_b, center, *, grid: int = 128,
               bin_size: float = 1.0):
    """K7's wrapper: the (2, G, G) complex64 occupancy images (real part 0
    or 1, imaginary part 0: what the FFTs take) of cloud A moved by T_a
    (16,) f32 row-major and of world cloud B, centred at center (3,). The
    kernel writes every cell: no fill before it, no cast after it."""
    if not pts_a.is_cuda:
        return bev_raster_plain(pts_a, mask_a, T_a, pts_b, mask_b, center, grid=grid,
                                bin_size=bin_size)
    na, nb = pts_a.shape[0], pts_b.shape[0]
    kernels.check(pts_a, "pts_a", torch.float32, (na, 3))
    kernels.check(mask_a, "mask_a", torch.bool, (na,))
    kernels.check(T_a, "T_a", torch.float32, (16,))
    kernels.check(pts_b, "pts_b", torch.float32, (nb, 3))
    kernels.check(mask_b, "mask_b", torch.bool, (nb,))
    kernels.check(center, "center", torch.float32, (3,))
    if 2 * grid * grid > MAX_RASTER_CELLS:
        raise kernels.KernelInputError(f"grid {grid}: the bitmap of two {grid} x {grid} "
                                       f"images does not fit the kernel's shared memory")
    img = torch.empty((2, grid, grid), dtype=torch.complex64, device=pts_a.device)
    kernels.KERNELS["bev_raster"].launch(
        pts_a.data_ptr(), mask_a.data_ptr(), na, T_a.data_ptr(), pts_b.data_ptr(),
        mask_b.data_ptr(), nb, center.data_ptr(), grid, K.f32(bin_size), img.data_ptr())
    return img


def _occupancy(x, y, m, center, grid: int, bin_size: float):
    """(G, G) f32 occupancy of points (x, y): the cell floor((x - c) / bin)
    + G / 2 by IEEE division (by a tensor: torch multiplies by the
    reciprocal of a Python float)."""
    half = grid // 2
    b = torch.full((), K.f32(bin_size), dtype=torch.float32, device=x.device)
    ij = torch.stack([torch.floor((x - center[0]) / b), torch.floor((y - center[1]) / b)], 1)
    ij = ij.to(torch.int32) + half
    ok = m & torch.all((ij >= 0) & (ij < grid), 1)
    flat = torch.where(ok, ij[:, 0] * grid + ij[:, 1], grid * grid).to(torch.int64)
    occ = torch.zeros((grid * grid + 1,), dtype=torch.float32, device=x.device)
    occ[flat] = 1.0
    return occ[:-1].view(grid, grid)


def bev_raster_plain(pts_a, mask_a, T_a, pts_b, mask_b, center, *, grid: int = 128,
                     bin_size: float = 1.0):
    """K7's twin: cloud A moved by T_a in the kernel's order (each product
    and sum rounded on its own, left to right), both occupancy images,
    complex64."""
    T = T_a.reshape(16)
    px, py, pz = pts_a.unbind(1)
    xa = ((T[0] * px + T[1] * py) + T[2] * pz) + T[3]
    ya = ((T[4] * px + T[5] * py) + T[6] * pz) + T[7]
    occ = torch.stack([_occupancy(xa, ya, mask_a, center, grid, bin_size),
                       _occupancy(pts_b[:, 0], pts_b[:, 1], mask_b, center, grid, bin_size)])
    return torch.complex(occ, torch.zeros_like(occ))


def cross_power(x, y, x2=None):
    """K7c's wrapper: x (B1, N) and y (N,) complex64 spectra, and where
    given x2 (B2, N) complex64, the batch's rows after x's (read where it
    lies: no concatenation). Returns (B1 + B2, N) complex64 x conj(y) /
    max(|x conj(y)|, 1e-12), y broadcast over the batch. The kernel reads
    a thread's two columns of every row as 16-byte vectors where N is even
    (the tensors then 16-byte aligned)."""
    if not x.is_cuda:
        return cross_power_plain(x, y, x2)
    b1, n = x.shape
    b2 = 0 if x2 is None else x2.shape[0]
    kernels.check(x, "x", torch.complex64, (b1, n))
    kernels.check(y, "y", torch.complex64, (n,))
    if x2 is not None:
        kernels.check(x2, "x2", torch.complex64, (b2, n))
    if n % 2 == 0:
        for t, name in ((x, "x"), (y, "y")) + (() if x2 is None else ((x2, "x2"),)):
            kernels.check_aligned(t, name)
    out = torch.empty((b1 + b2, n), dtype=torch.complex64, device=x.device)
    if b1 + b2:
        kernels.KERNELS["cross_power"].launch(
            x.data_ptr(), b1, 0 if x2 is None else x2.data_ptr(), b1 + b2, y.data_ptr(), n,
            out.data_ptr())
    return out


def cross_power_plain(x, y, x2=None):
    """K7c's twin, in the kernel's real arithmetic and order (products,
    hypot, the IEEE reciprocal of max(|.|, 1e-12), the scale), so that on
    the card it gives the kernel's bits."""
    if x2 is not None:
        x = torch.cat([x, x2])
    a, c = torch.view_as_real(x), torch.view_as_real(y)[None]
    re = a[..., 0] * c[..., 0] + a[..., 1] * c[..., 1]
    im = a[..., 1] * c[..., 0] - a[..., 0] * c[..., 1]
    s = torch.reciprocal(torch.fmax(torch.hypot(re, im), re.new_tensor(1e-12)))
    return torch.complex(re * s, im * s)


def _offset_from_images(img, grid: int, bin_size: float):
    """The offset from bev_raster's (2, G, G) complex64 images: one batched
    FFT of both, K7c, the inverse FFT and its first maximum."""
    f = torch.fft.fft2(img)
    cross = cross_power(f[1].reshape(1, -1), f[0].reshape(-1)).view(grid, grid)
    corr = torch.real(torch.fft.ifft2(cross))
    flat = torch.argmax(corr.reshape(-1))
    half = grid // 2
    d = torch.stack([flat // grid, flat % grid])
    d = torch.where(d >= half, d - grid, d)
    return d.to(torch.float32) * K.f32(bin_size)


def bev_translation_offset(pts_a, mask_a, pts_b, mask_b, center, *, grid: int = 128,
                           bin_size: float = 1.0, T_a=None):
    """x-y translation (2,) f32 that moves cloud A (moved by T_a, if given,
    else taken as world points) onto world cloud B."""
    if T_a is None:
        T_a = torch.eye(4, dtype=torch.float32, device=pts_a.device)
    img = bev_raster(pts_a, mask_a, T_a.reshape(16).contiguous(), pts_b, mask_b,
                     center.contiguous(), grid=grid, bin_size=bin_size)
    return _offset_from_images(img, grid, bin_size)


def _yaw_corrected(current_pose, matched_pose, bias_deg):
    delta = (torch.remainder(bias_deg + 180.0, 360.0) - 180.0) * K.f32(math.pi / 180.0)
    yaw_m = torch.atan2(matched_pose[1, 0], matched_pose[0, 0])
    yaw_c = torch.atan2(current_pose[1, 0], current_pose[0, 0])
    dyaw = yaw_m + delta - yaw_c
    dyaw = torch.remainder(dyaw + K.f32(math.pi), K.f32(2.0 * math.pi)) - K.f32(math.pi)
    c, s = torch.cos(dyaw), torch.sin(dyaw)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    Rz = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                      torch.stack([zero, zero, one])])
    return lie.se3_matrix(Rz @ current_pose[:3, :3], current_pose[:3, 3])


def prealign_pose_t(current_pose, matched_pose, bias_deg, query_cloud, query_mask,
                    matched_world, matched_mask, *, grid: int = 128, bin_size: float = 1.0):
    """Device prealignment (the JAX prealign_pose_jnp): poses (4, 4) f32
    tensors, bias_deg a 0-d f32 tensor. Returns the prealigned (4, 4) world
    pose of the query keyframe, with no host read."""
    T_init = _yaw_corrected(current_pose, matched_pose, bias_deg)
    off = bev_translation_offset(query_cloud, query_mask, matched_world, matched_mask,
                                 matched_pose[:3, 3], grid=grid, bin_size=bin_size,
                                 T_a=T_init)
    T_init[:2, 3] += off
    return T_init


def prealign_pose(current_pose: np.ndarray, matched_pose: np.ndarray, bias_deg: int,
                  query_cloud, query_mask, matched_world, matched_mask, *,
                  grid: int = 128, bin_size: float = 1.0, device="cuda") -> np.ndarray:
    """Host orchestration of the prealignment: numpy poses and clouds in,
    the corrected (4, 4) float32 world pose of the query out. The JAX
    package's host prealign_pose, kept for callers of that API; the loop
    solve calls prealign_pose_t on device tensors."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    return prealign_pose_t(
        t(current_pose.astype(np.float32)), t(matched_pose.astype(np.float32)),
        torch.tensor(float(bias_deg), dtype=torch.float32, device=device),
        t(np.asarray(query_cloud, np.float32)), t(np.asarray(query_mask, bool)),
        t(np.asarray(matched_world, np.float32)), t(np.asarray(matched_mask, bool)),
        grid=grid, bin_size=bin_size).cpu().numpy()
