"""Point-cloud filters outside the odometry path (counterpart of the JAX
package's ops/legacy_filters.py): a weighted-centroid voxel grid, an
axis-aligned crop box and a range gate, on fixed-shape masked tensors.
The odometry path's downsampler is ops/voxel_filter.py (kernel K1).
"""
from __future__ import annotations

import torch

from ..utils import keys as K

__all__ = ["voxel_grid_filter", "crop_box", "range_filter"]


def voxel_grid_filter(points: torch.Tensor, mask: torch.Tensor, leaf_size: float,
                      out_capacity: int = None):
    """The mean of each voxel's masked points, one row per voxel in the
    map key's (z-major) order: torch.sort by the packed key, then
    index_add_ of [1 | xyz] into the voxel's row. Voxels past out_capacity
    (default N) are dropped. Returns (centroids (C, 3), valid (C,))."""
    n = points.shape[0]
    cap = out_capacity or n
    hi, lo = K.pack_key(K.voxel_coords(points, 1.0 / leaf_size))
    key = torch.where(mask, K.sort_key(hi, lo), K.INVALID_SORT_KEY)
    s_key, s_idx = torch.sort(key)
    s_ok = mask[s_idx]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=points.device),
                       s_key[1:] != s_key[:-1]]) & s_ok
    gix = torch.cumsum(first.to(torch.int64), 0) - 1
    keep = s_ok & (gix < cap)
    data = torch.cat([torch.ones((n, 1), dtype=points.dtype, device=points.device),
                      points[s_idx]], 1)[keep]
    seg = torch.zeros((cap, 4), dtype=points.dtype, device=points.device)
    seg.index_add_(0, gix[keep], data)
    cnt = seg[:, 0]
    return seg[:, 1:] / torch.clamp(cnt, min=1.0)[:, None], cnt > 0.0


def crop_box(points: torch.Tensor, mask: torch.Tensor, min_pt, max_pt,
             negative: bool = False) -> torch.Tensor:
    """The mask of the points inside [min_pt, max_pt] (outside with
    negative=True)."""
    lo = torch.as_tensor(min_pt, dtype=points.dtype, device=points.device)
    hi = torch.as_tensor(max_pt, dtype=points.dtype, device=points.device)
    inside = torch.all((points >= lo) & (points <= hi), dim=-1)
    return mask & (inside != negative)


def range_filter(points: torch.Tensor, mask: torch.Tensor, min_range,
                 max_range) -> torch.Tensor:
    """The mask of the points whose range lies in [min_range, max_range]."""
    r = torch.linalg.norm(points, dim=-1)
    return mask & (r >= min_range) & (r <= max_range)
