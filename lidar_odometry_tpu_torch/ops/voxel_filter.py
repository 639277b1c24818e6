"""Scan downsampling: stride skip + voxel-grid centroid, fixed shapes
(counterpart of the JAX package's ops/voxel_filter.py).

Points are keyed, sorted by key (torch.sort, stable, on int64) and reduced
per voxel. The reduction is kernel K1 (csrc/voxel_filter.cu): a grid of
CTAs over the sorted keys marks segment starts, numbers them by a
single-pass scan across the grid (decoupled look-back over tile
descriptors in a scratch buffer that each launch leaves zeroed), and walks
each segment's run to its exact count and its sum of
voxel-corner-relative coordinates, then writes the padded centroids, the
mask and the count.
The JAX program took the per-voxel sums as prefix-sum differences; the
port sums each voxel directly, so its centroids carry no prefix-sum error
and segments past `out_capacity` are dropped instead of folded into the
last kept one.

Lanes: a (B, N, 3) stack of B independent scans (the blocked
multi-sequence runner; the JAX filter under vmap) is keyed elementwise,
sorted along its last axis (stable, so each lane's order is its one-scan
order, which PKO's stratified sample depends on), and reduced by one K1
launch with a row of CTAs per lane.

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
    """points (N, 3) float32 padded raw scan, or (B, N, 3) for B lanes;
    n_points valid leading rows (of every lane). Returns (centroids
    (out_capacity, 3), mask (out_capacity,) bool, n_voxels () int32), in
    key order, each with a leading B for lanes."""
    pts = points[..., ::stride, :].contiguous()
    n = pts.shape[-2]
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
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    return voxel_segments(key_s, perm, pts, out_capacity, inv,
                          K.f32(voxel_size))


_TILE = 512   # csrc/voxel_filter.cu THREADS: sorted entries a CTA takes at once


def voxel_segments(key_s, perm, pts, cap: int, inv: float, voxel: float):
    """K1's wrapper: per-voxel centroids of the key-sorted points. key_s,
    perm (n,) or (B, n) with pts (n, 3) or (B, n, 3) (perm indexes each
    lane's own rows). CUDA tensors launch the kernel; CPU tensors take the
    plain version, lane by lane."""
    if not key_s.is_cuda:
        if key_s.dim() == 1:
            return voxel_segments_plain(key_s, perm, pts, cap, inv, voxel)
        outs = [voxel_segments_plain(key_s[b], perm[b], pts[b], cap, inv, voxel)
                for b in range(key_s.shape[0])]
        return tuple(torch.stack(c) for c in zip(*outs))
    lead = tuple(key_s.shape[:-1])
    if len(lead) > 1:
        raise kernels.KernelInputError("voxel_segments: expected (n,) or (B, n) keys")
    n = key_s.shape[-1]
    lanes = lead[0] if lead else 1
    kernels.check(key_s, "key_s", torch.int64, lead + (n,))
    kernels.check(perm, "perm", torch.int64, lead + (n,))
    kernels.check(pts, "pts", torch.float32, lead + (n, 3))
    cent = torch.empty(lead + (cap, 3), dtype=torch.float32, device=pts.device)
    mask = torch.empty(lead + (cap,), dtype=torch.bool, device=pts.device)
    n_vox = torch.empty(lead, dtype=torch.int32, device=pts.device)
    tiles = max(1, -(-n // _TILE))
    scratch = kernels.zeroed_scratch("voxel_filter", pts.device, lanes * tiles + lanes + 1)
    kernels.KERNELS["voxel_filter"].launch(
        key_s.data_ptr(), perm.data_ptr(), pts.data_ptr(), n, lanes, cap, inv, voxel,
        cent.data_ptr(), mask.data_ptr(), n_vox.data_ptr(), scratch.data_ptr())
    return cent, mask, n_vox


def voxel_segments_plain(key_s, perm, pts, cap: int, inv: float, voxel: float):
    """Plain PyTorch twin of K1, one lane."""
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
