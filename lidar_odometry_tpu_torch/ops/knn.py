"""Batched k-nearest-neighbour search over a voxel-binned point table
(counterpart of the JAX package's ops/knn.py: PointTable,
build_point_table, knn_query, nn1_distance), the loop-closure ICP's
correspondence search against a keyframe's world cloud.

The table sorts the cloud by its bin key (torch.sort, stable, so equal
keys keep their original order, as the JAX sort by (hi, lo, index) does)
and keeps a dense 128 x 128 x 32 bin -> first-index grid over the cloud's
bin window. A query probes the (2r+1)^3 bins around its own, takes up to
`bucket_width` consecutive entries of each, and keeps the k nearest (ties
to the lower candidate index, as jax.lax.top_k). A cloud wider than the
window falls back to a binary search of the sorted keys per bin.

Kernels (csrc/knn.cu), each with its plain twin below:
  K6a point_grid — the window origin, the fits flag and the dense grid;
  K6b point_knn (k = 5) and point_nn1 (k = 1) — the probe and the
      register top-k.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..utils import keys as K

__all__ = ["PointTable", "build_point_table", "knn_query", "nn1_distance",
           "knn_query_plain", "point_grid", "point_grid_plain", "GRID_DIMS", "POINT_GRID_SHAPE"]

GRID_DIMS = (128, 128, 32)
# K6a's launch: 16 clusters of 8 CTAs x 512 threads, each owning a
# sixteenth of the grid (csrc/knn.cu lo_point_grid_shape builds the same)
POINT_GRID_SHAPE = {"cluster": 8, "threads": 512, "grid": 128}
_G = GRID_DIMS[0] * GRID_DIMS[1] * GRID_DIMS[2]
_BIG = 1 << 20


class PointTable(NamedTuple):
    key: torch.Tensor    # (C,) int64 sort key of each point's bin, sorted
    pts: torch.Tensor    # (C, 3) f32 points in key order
    grid: torch.Tensor   # (GX*GY*GZ,) int32 bin -> first sorted index (C = none)
    meta: torch.Tensor   # (5,) int32 [origin xyz | fits | n_valid]
    inv: float           # 1 / bin size, rounded to float32

    @property
    def valid(self) -> torch.Tensor:
        return self.key != K.INVALID_SORT_KEY

    @property
    def n(self) -> torch.Tensor:
        return self.meta[4]

    @property
    def origin(self) -> torch.Tensor:
        return self.meta[:3]

    @property
    def fits(self) -> torch.Tensor:
        return self.meta[3] != 0


# ---------------------------------------------------------------------------
# K6a: the dense grid
# ---------------------------------------------------------------------------

def point_grid(key_s, pts_s, inv: float):
    """K6a's wrapper. key_s (C,) int64 sorted bin keys (INVALID_SORT_KEY for
    masked rows), pts_s (C, 3) f32 in the same order. Returns (grid
    (GX*GY*GZ,) int32, meta (5,) int32). One launch of POINT_GRID_SHAPE,
    which writes the whole grid."""
    if not key_s.is_cuda:
        return point_grid_plain(key_s, pts_s, inv)
    c = key_s.shape[0]
    kernels.check(key_s, "key_s", torch.int64, (c,))
    kernels.check(pts_s, "pts_s", torch.float32, (c, 3))
    grid = torch.empty((_G,), dtype=torch.int32, device=key_s.device)   # the kernel fills it
    meta = torch.empty((5,), dtype=torch.int32, device=key_s.device)
    kernels.KERNELS["point_grid"].launch(key_s.data_ptr(), pts_s.data_ptr(), c, inv,
                                         grid.data_ptr(), meta.data_ptr())
    return grid, meta


def point_grid_plain(key_s, pts_s, inv: float):
    c = key_s.shape[0]
    dev = key_s.device
    valid = key_s != K.INVALID_SORT_KEY
    coords = K.voxel_coords(pts_s, inv)
    origin = torch.where(valid[:, None], coords, _BIG).amin(0)
    maxc = torch.where(valid[:, None], coords, -_BIG).amax(0)
    dims = torch.tensor(GRID_DIMS, dtype=torch.int32, device=dev)
    n_valid = valid.sum()
    fits = torch.all(maxc - origin < dims) & (n_valid > 0)
    local = coords - origin[None, :]
    first = valid.clone()
    first[1:] &= key_s[1:] != key_s[:-1]
    inside = first & torch.all((local >= 0) & (local < dims[None, :]), 1)
    lin = ((local[:, 0] * GRID_DIMS[1] + local[:, 1]) * GRID_DIMS[2] + local[:, 2]).to(torch.int64)
    grid = torch.full((_G + 1,), c, dtype=torch.int32, device=dev)
    grid[torch.where(inside, lin, _G)] = torch.arange(c, dtype=torch.int32, device=dev)
    meta = torch.cat([origin, fits[None].to(torch.int32), n_valid[None].to(torch.int32)])
    return grid[:_G].contiguous(), meta.to(torch.int32)


def build_point_table(points, mask, *, bin_size: float) -> PointTable:
    """Sort (C, 3) points by bin key (masked rows last) and build the
    dense bin grid."""
    inv = K.f32(1.0 / K.f32(bin_size))
    key = torch.where(mask, K.sort_key(*K.pack_key(K.voxel_coords(points, inv))),
                      K.INVALID_SORT_KEY)
    key_s, idx = torch.sort(key, stable=True)
    pts_s = points[idx].contiguous()
    grid, meta = point_grid(key_s, pts_s, inv)
    return PointTable(key=key_s, pts=pts_s, grid=grid, meta=meta, inv=inv)


# ---------------------------------------------------------------------------
# K6b: the probe and top-k
# ---------------------------------------------------------------------------

def knn_query(table: PointTable, queries, *, k: int = 5, radius: int = 1,
              bucket_width: int = 3, flags=None):
    """K6b's wrapper (the kernel point_knn for k = 5, point_nn1 for k = 1):
    the k nearest table points of each query within its (2r+1)^3 bin
    neighbourhood, up to `bucket_width` entries a bin. queries (N, 3) f32.
    Returns (neighbours (N, k, 3), ok (N, k) bool, distances (N, k), +inf
    where not ok). `flags` (3,) int32 [done, failed, n_corr] of a solve, or
    None: once done, the kernel returns at once and leaves the outputs
    unwritten."""
    if not queries.is_cuda:
        return knn_query_plain(table, queries, k=k, radius=radius, bucket_width=bucket_width)
    if k not in (1, 5):
        raise kernels.KernelInputError(f"knn_query: the kernel takes k = 1 or 5, got {k}")
    n, c = queries.shape[0], table.key.shape[0]
    kernels.check(queries, "queries", torch.float32, (n, 3))
    kernels.check(table.key, "key", torch.int64, (c,))
    kernels.check(table.pts, "pts", torch.float32, (c, 3))
    kernels.check(table.grid, "grid", torch.int32, (_G,))
    kernels.check(table.meta, "meta", torch.int32, (5,))
    if flags is not None:
        kernels.check(flags, "flags", torch.int32, (3,))
    dev = queries.device
    nb = torch.empty((n, k, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((n, k), dtype=torch.bool, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    kernels.KERNELS["point_knn" if k == 5 else "point_nn1"].launch(
        queries.data_ptr(), n, None if flags is None else flags.data_ptr(),
        table.key.data_ptr(), table.pts.data_ptr(), c, table.grid.data_ptr(),
        table.meta.data_ptr(), table.inv, radius, bucket_width, nb.data_ptr(),
        ok.data_ptr(), dist.data_ptr())
    return nb, ok, dist


def _neighbor_offsets(radius: int) -> np.ndarray:
    r = np.arange(-radius, radius + 1)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3).astype(np.int32)


def knn_query_plain(table: PointTable, queries, *, k: int, radius: int, bucket_width: int):
    n, c = queries.shape[0], table.key.shape[0]
    dev = queries.device
    qc = K.voxel_coords(queries, table.inv)
    offs = torch.as_tensor(_neighbor_offsets(radius), device=dev)
    nb = qc[:, None, :] + offs[None, :, :]                                  # (N, M, 3)
    nkey = K.sort_key(*K.pack_key(nb))
    dims = torch.tensor(GRID_DIMS, dtype=torch.int32, device=dev)
    if bool(table.fits):
        local = nb - table.origin
        inside = torch.all((local >= 0) & (local < dims), -1)
        lin = ((local[..., 0] * GRID_DIMS[1] + local[..., 1]) * GRID_DIMS[2]
               + local[..., 2]).to(torch.int64)
        start = torch.where(inside, table.grid[torch.clamp(lin, 0, _G - 1)], c)
    else:
        start = torch.searchsorted(table.key, nkey.reshape(-1)).view(nkey.shape)
    w = torch.arange(bucket_width, device=dev)
    gidx = torch.clamp(start.to(torch.int64)[..., None] + w, max=c - 1)   # (N, M, W)
    gkey = table.key[gidx]
    cand_ok = ((gkey == nkey[..., None]) & (gkey != K.INVALID_SORT_KEY)).reshape(n, -1)
    cand = table.pts[gidx].reshape(n, -1, 3)
    d = cand - queries[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    d2 = torch.where(cand_ok, d2, torch.inf)
    top = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    nb_pts = torch.gather(cand, 1, top[..., None].expand(-1, -1, 3))
    nb_ok = torch.gather(cand_ok, 1, top)
    dist = torch.sqrt(torch.clamp(torch.gather(d2, 1, top), min=0.0))
    return nb_pts, nb_ok, torch.where(nb_ok, dist, torch.inf)


def nn1_distance(table: PointTable, queries, *, radius: int = 2, bucket_width: int = 3):
    """1-NN distance per query, +inf where no candidate is in reach."""
    _, ok, d = knn_query(table, queries, k=1, radius=radius, bucket_width=bucket_width)
    return torch.where(ok[:, 0], d[:, 0], torch.inf)
