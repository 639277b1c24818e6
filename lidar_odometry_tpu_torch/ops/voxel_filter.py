"""Scan downsampling: stride skip + voxel-grid centroid, fixed shapes
(counterpart of the JAX package's ops/voxel_filter.py).

Points are keyed, sorted by key (torch.sort, stable, on int64) and reduced
per voxel. The reduction is kernel K1 (csrc/voxel_filter.cu): one block
marks segment starts, numbers them by a block scan, and walks each
segment's run to its exact count and its sum of voxel-corner-relative
coordinates, then writes the padded centroids, the mask and the count.
The JAX program took the per-voxel sums as prefix-sum differences; the
port sums each voxel directly, so its centroids carry no prefix-sum error
and segments past `out_capacity` are dropped instead of folded into the
last kept one.

With `compact_keys` the key is the 10-bit-per-axis compact key (x-major;
points outside +-512 voxels are dropped like non-finite ones), which fixes
the feature order the rest of the pipeline sees. The generic path sorts
by the map key (z-major).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..utils import keys as K

__all__ = ["voxel_filter", "compact_keys_ok", "voxel_segments",
           "voxel_segments_plain"]


def compact_keys_ok(voxel_size: float, sensor_range: float) -> bool:
    """True when the compact key's +-512-voxel envelope covers every return
    of a sensor with the given range."""
    return float(voxel_size) * K.COMPACT_HALF >= float(sensor_range)


def voxel_filter(points: torch.Tensor, n_points: int, *, voxel_size: float,
                 stride: int, out_capacity: int, compact_keys: bool = False):
    """points (N, 3) float32 padded raw scan; n_points valid leading rows.
    Returns (centroids (out_capacity, 3), mask (out_capacity,) bool,
    n_voxels () int32), in key order."""
    pts = points[::stride].contiguous()
    n = pts.shape[0]
    idx = torch.arange(n, device=pts.device) * stride
    valid = (idx < n_points) & torch.all(torch.isfinite(pts), dim=-1)
    inv = K.f32(1.0 / K.f32(voxel_size))
    coords = torch.floor(torch.nan_to_num(pts, 0.0, 0.0, 0.0) * inv).to(torch.int32)
    if compact_keys:
        key, ok = K.compact_key(coords)
        valid = valid & ok
    else:
        key = K.sort_key(*K.pack_key(coords))
    key = torch.where(valid, key, torch.full_like(key, K.INVALID_SORT_KEY))
    key_s, perm = torch.sort(key, stable=True)
    return voxel_segments(key_s, perm, pts, out_capacity, inv,
                          K.f32(voxel_size))


def voxel_segments(key_s, perm, pts, cap: int, inv: float, voxel: float):
    """K1's wrapper: per-voxel centroids of the key-sorted points.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not key_s.is_cuda:
        return voxel_segments_plain(key_s, perm, pts, cap, inv, voxel)
    n = key_s.shape[0]
    kernels.check(key_s, "key_s", torch.int64, (n,))
    kernels.check(perm, "perm", torch.int64, (n,))
    kernels.check(pts, "pts", torch.float32, (n, 3))
    cent = torch.empty((cap, 3), dtype=torch.float32, device=pts.device)
    mask = torch.empty((cap,), dtype=torch.bool, device=pts.device)
    n_vox = torch.empty((), dtype=torch.int32, device=pts.device)
    kernels.KERNELS["voxel_filter"].launch(
        key_s.data_ptr(), perm.data_ptr(), pts.data_ptr(), n, cap, inv, voxel,
        cent.data_ptr(), mask.data_ptr(), n_vox.data_ptr())
    return cent, mask, n_vox


def voxel_segments_plain(key_s, perm, pts, cap: int, inv: float, voxel: float):
    """Plain PyTorch twin of K1."""
    dev = pts.device
    valid_s = key_s != K.INVALID_SORT_KEY
    is_start, seg = K.segment_starts(key_s, valid_s)
    n_vox = is_start.sum().to(torch.int32)
    pts_s = torch.where(valid_s[:, None], pts[perm], 0.0)
    corner = torch.floor(pts_s * inv) * voxel
    p_rel = torch.where(valid_s[:, None], pts_s - corner, 0.0)
    tgt = torch.where(valid_s & (seg < cap), seg, cap).to(torch.int64)
    sums = torch.zeros((cap + 1, 3), dtype=torch.float32, device=dev)
    sums.index_add_(0, tgt, p_rel)
    cnt = torch.zeros((cap + 1,), dtype=torch.float32, device=dev)
    cnt.index_add_(0, tgt, valid_s.to(torch.float32))
    corner_seg = torch.zeros((cap + 1, 3), dtype=torch.float32, device=dev)
    corner_seg[torch.where(is_start, tgt, cap)] = corner
    cent = corner_seg[:cap] + sums[:cap] / torch.clamp(cnt[:cap], min=1.0)[:, None]
    mask = torch.arange(cap, device=dev) < n_vox
    cent = torch.where(mask[:, None], cent, 0.0)
    return cent, mask, n_vox
