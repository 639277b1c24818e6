"""Voxel keys (counterpart of the JAX package's utils/keys.py).

The JAX package holds a 64-bit key as a pair of uint32 lanes (hi, lo)
because the TPU has no native int64. The port keeps that pair wherever it
is stored (the map's bucket rows and meta rows keep the JAX layout, so a
JAX map state converts by copy), as int64 tensors that hold uint32
values, and sorts by one signed int64 `sort_key(hi, lo)` that orders
exactly like the lexicographic (hi, lo) pair.

`searchsorted2` is the lower-bound search of a sorted (hi, lo) table, and
`morton_np` the host-side 63-bit Morton code of the JAX package (its +2^20
bias and 21-bit clamp).

Two key layouts:
  * the map key `pack_key`: hi = iz + 2^31, lo = (ix+32768)<<16 | (iy+32768)
    (z-major order);
  * the voxel filter's compact key `compact_key`: 10 bits per axis,
    (ix+512)<<20 | (iy+512)<<10 | (iz+512), x-major, valid inside
    [-512, 512) voxels per axis. The filter's feature order is this key's
    order, and PKO samples residuals by their rank in that order, so the
    filter must sort by it and not by the map key.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["INVALID_U32", "INVALID_SORT_KEY", "COMPACT_BITS", "COMPACT_HALF",
           "voxel_coords", "f32", "pack_key", "unpack_key", "sort_key",
           "compact_key", "segment_starts", "to_i32", "from_i32", "split_sort_key",
           "parent_coords", "key_lt", "key_eq", "sort_by_key", "searchsorted2", "morton_np"]

INVALID_U32 = 0xFFFFFFFF
INVALID_SORT_KEY = (1 << 63) - 1          # sort_key(INVALID_U32, INVALID_U32)
COMPACT_BITS = 10
COMPACT_HALF = 1 << (COMPACT_BITS - 1)    # 512 voxels per half-axis

_BIAS32 = 1 << 31
_BIAS16 = 32768


def voxel_coords(points: torch.Tensor, inv_voxel_size: float) -> torch.Tensor:
    """(..., 3) float32 points -> (..., 3) int32 voxel coords, floor
    semantics. `inv_voxel_size` is rounded to float32 first, as the JAX
    program computes it."""
    return torch.floor(points * f32(inv_voxel_size)).to(torch.int32)


def f32(x: float) -> float:
    """A Python float rounded to float32, the way the JAX program rounds a
    weakly typed scalar before it meets a float32 array."""
    return float(np.float32(x))


def pack_key(coords: torch.Tensor):
    """(..., 3) int32 coords -> (hi, lo) int64 tensors holding uint32."""
    c = coords.to(torch.int64)
    hi = (c[..., 2] + _BIAS32) & 0xFFFFFFFF
    lx = (c[..., 0] + _BIAS16) & 0xFFFF
    ly = (c[..., 1] + _BIAS16) & 0xFFFF
    return hi, (lx << 16) | ly


def unpack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_key -> (..., 3) int32 coords."""
    iz = ((hi.to(torch.int64) - _BIAS32 + (1 << 32)) & 0xFFFFFFFF)
    iz = torch.where(iz >= _BIAS32, iz - (1 << 32), iz)
    lo = lo.to(torch.int64)
    ix = (lo >> 16) - _BIAS16
    iy = (lo & 0xFFFF) - _BIAS16
    return torch.stack([ix, iy, iz], dim=-1).to(torch.int32)


def sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One signed int64 that orders like the unsigned (hi, lo) pair:
    (hi - 2^31) << 32 | lo. (INVALID, INVALID) maps to INVALID_SORT_KEY."""
    return ((hi - _BIAS32) << 32) + lo


def split_sort_key(key: torch.Tensor):
    """Inverse of sort_key -> (hi, lo) int64 tensors holding uint32."""
    return ((key >> 32) + _BIAS32) & 0xFFFFFFFF, key & 0xFFFFFFFF


def compact_key(coords: torch.Tensor):
    """(..., 3) int32 coords -> (key int64, in_envelope bool) of the
    voxel filter's 10-bit-per-axis key (JAX voxel_filter.py:71-78)."""
    b = coords.to(torch.int64) + COMPACT_HALF
    ok = torch.all((b >= 0) & (b < 2 * COMPACT_HALF), dim=-1)
    key = (b[..., 0] << (2 * COMPACT_BITS)) | (b[..., 1] << COMPACT_BITS) | b[..., 2]
    return key, ok


def segment_starts(key_sorted: torch.Tensor, valid: torch.Tensor):
    """For sorted keys: (is_start, segment_id). is_start marks the first
    occurrence of each distinct valid key; segment ids count 0..S-1."""
    prev = torch.cat([key_sorted[:1] ^ 1, key_sorted[:-1]])
    is_start = (key_sorted != prev) & valid
    seg_id = torch.cumsum(is_start.to(torch.int32), 0) - 1
    return is_start, torch.clamp(seg_id, min=0)


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit pattern."""
    return torch.where(u >= _BIAS32, u - (1 << 32), u).to(torch.int32)


def from_i32(i: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> the uint32 value, held in int64."""
    return i.to(torch.int64) & 0xFFFFFFFF


def parent_coords(coords: torch.Tensor, factor: int) -> torch.Tensor:
    """Floor-division parent coords of (..., 3) int32 voxel coords."""
    return torch.div(coords, factor, rounding_mode="floor").to(coords.dtype)


def key_lt(ahi, alo, bhi, blo) -> torch.Tensor:
    """(ahi, alo) < (bhi, blo), lexicographically."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def key_eq(ahi, alo, bhi, blo) -> torch.Tensor:
    return (ahi == bhi) & (alo == blo)


def sort_by_key(hi: torch.Tensor, lo: torch.Tensor, *payload: torch.Tensor):
    """(hi, lo) sorted lexicographically (uint32 values held in int64), the
    payload tensors permuted along their first axis."""
    order = torch.sort(sort_key(hi.to(torch.int64), lo.to(torch.int64)), stable=True).indices
    return (hi[order], lo[order]) + tuple(p[order] for p in payload)


def searchsorted2(table_hi: torch.Tensor, table_lo: torch.Tensor,
                  qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """Lower-bound insertion indices in [0, C] of the (qhi, qlo) keys in a
    lexicographically sorted (hi, lo) table (uint32 values held in int64;
    padding slots hold (INVALID_U32, INVALID_U32) and sort last), int32."""
    table = sort_key(table_hi.to(torch.int64), table_lo.to(torch.int64))
    q = sort_key(qhi.to(torch.int64), qlo.to(torch.int64))
    return torch.searchsorted(table, q, right=False).to(torch.int32)


def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_np(coords: np.ndarray) -> np.ndarray:
    """63-bit Morton code (uint64) of (..., 3) int coords: each axis biased
    by 2^20 and clamped to 21 bits, x in bit 0 of each triple."""
    c = coords.astype(np.int64) + (1 << 20)
    c = np.clip(c, 0, (1 << 21) - 1).astype(np.uint64)
    return (_expand_bits_np(c[..., 0])
            | (_expand_bits_np(c[..., 1]) << np.uint64(1))
            | (_expand_bits_np(c[..., 2]) << np.uint64(2)))
