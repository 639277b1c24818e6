"""2-level voxel surfel map (counterpart of
the JAX package's ops/voxel_map.py, the odometry path's part).

The state keeps the JAX layout, so a JAX map converts by copy: L0 children
live at row parent_slot*27 + child_offset of l0_data [count | sum xyz];
the parent index is one (B, 32) int32 row per bucket of 8 cells,
[slot x8 | key_hi x8 | key_lo x8 | pad], with the key halves stored as
int32 bit patterns. Each table also carries one trailing SINK row: the
JAX program drops masked writes by aiming them one past the end
(mode="drop"); the port aims them at the sink row, so every masked write
is one unconditional index write and no host read. convert.py strips the
sink rows.

update_map follows the JAX program step by step, with the same sort-rank
bucket claim, so the integer state comes out identical. Its four size
tiers are picked on the device from the exact new-voxel and
unresolved-point counts; every list is allocated at the largest tier's
size and the picked tier's caps act as device-side limits in each
compaction, which reproduces the tiers' truncation semantics with no host
read. Buffers are updated in place: the state passed in is consumed, as
the JAX chunk runner donates it.

Kernels (csrc/voxel_map.cu), each with its plain twin below:
  K4a map_evict_scan — the divide-free radius test over every child row,
      any-reduced per parent;
  K4b map_scatter_add — per-voxel [count | sum xyz] totals of the
      key-sorted points, added at the target row that each voxel's leader
      computes from its point's parent slot and child offset;
  K4c map_surfel_recompute — per recomputed parent: its 27-row block,
      count, mean, covariance, eigh3, planarity and the non-planar verdict;
      a warp a parent, its sums over the children in a fixed butterfly
      order, which the twin repeats (_lane_sum).
  K5a grid_knn (csrc/grid_knn.cu) — the KD-tree mode's candidates: the L0
      centroids of each query's (2r+1)^3 voxel neighbourhood, found by
      probing the (2r//3 + 2)^3 distinct parents once each, with an
      optional row mask ANDed into the flags.

With compute_surfels=False (KD-tree mode) update_map keeps no surfels: it
skips K4c and the non-planar deletion, still frees the cells that
eviction emptied, and writes has = 0 on every affected cell.

transform_and_rehash (the map correction after a pose-graph optimisation)
rebuilds the map from its live L0 records moved by the correction:
  K9a map_bulk_index (csrc/rehash.cu) — gives the distinct parents, sorted
      by bucket, their bucket cells and slots and writes the fresh index
      and meta rows;
  K9b map_bulk_merge (csrc/rehash.cu) — merges the records of equal key in
      sorted order and scatters each merged voxel into its parent's block
      of the freshly built index;
then K4c recomputes every parent's statistics. A rebuilt cell keeps its
surfel row even when it is not planar (has = 0), where update_map deletes
such a cell.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..utils import eigh3 as E
from ..utils import keys as K

__all__ = ["VoxelMapState", "empty_map", "update_map", "lookup_surfels", "parent_inv",
           "l0_records", "l1_surfels", "hash_bucket", "bucket_find",
           "map_evict_scan", "map_evict_scan_plain", "map_scatter_add",
           "map_scatter_add_plain", "map_surfel_recompute",
           "map_surfel_recompute_plain", "grid_knn_neighbors",
           "grid_knn_neighbors_plain", "l0_points", "MIN_OCCUPIED_CHILDREN",
           "transform_and_rehash", "bulk_build", "bulk_plan", "bulk_parents", "rehash_records",
           "map_bulk_index", "map_bulk_index_plain", "map_bulk_merge", "map_bulk_merge_plain",
           "BULK_INDEX_SHAPE", "voxel_occupied"]

MIN_OCCUPIED_CHILDREN = 5
BUCKET = 8
ROW = 32
NCH = 27
EVICT_LIST = 2048
CH_CAP = 8192
SMALL_CAP = 4096
INVALID_I32 = -1

def _cube(lo: int, hi: int) -> np.ndarray:
    """Every integer offset of [lo, hi]^3 in meshgrid "ij" order."""
    r = np.arange(lo, hi + 1)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3).astype(np.int32)


_CHILD_OFFS = _cube(0, 2)


def _scaled_caps(c1: int, p: int):
    evict_cap = max(256, min(EVICT_LIST, c1 // 32))
    zero_cap = max(1024, min(CH_CAP, c1 // 8))
    small_cap = max(256, min(max(SMALL_CAP, p // 8), max(c1 // 16, p // 4)))
    return evict_cap, zero_cap, small_cap


def _n_buckets(capacity: int) -> int:
    n = max(capacity // 4, 8)
    p = 1
    while p < n:
        p *= 2
    return p


class VoxelMapState(NamedTuple):
    l0_data: torch.Tensor     # (C1*27 + 1, 4) f32 [count | sum xyz], sink last
    l1_index: torch.Tensor    # (B1 + 1, 32) i32 bucket rows, sink last
    l1_meta: torch.Tensor     # (C1 + 1, 4) i32 [key_hi | key_lo | children | cellpos]
    l1_last: torch.Tensor     # (C1 + 1,) i32 child count at last surfel compute
    l1_surfel: torch.Tensor   # (C1 + 1, 8) f32 [normal | centroid | planarity | has]
    l1_free: torch.Tensor     # (C1 + 1,) i32 free-slot stack
    l1_free_top: torch.Tensor  # () i32
    n_l0: torch.Tensor        # () i32
    n_l1: torch.Tensor        # () i32
    n_dropped: torch.Tensor   # () i32

    @property
    def c1(self) -> int:
        return self.l1_meta.shape[0] - 1

    @property
    def n_buckets(self) -> int:
        return self.l1_index.shape[0] - 1


def empty_map(c0: int, c1: int, device="cuda") -> VoxelMapState:
    """c1 parent cells (27*c1 child rows). c0 is accepted for the JAX
    signature and unused."""
    del c0
    i32 = dict(dtype=torch.int32, device=device)
    free = torch.arange(c1 + 1, **i32)
    return VoxelMapState(
        l0_data=torch.zeros((c1 * NCH + 1, 4), dtype=torch.float32, device=device),
        l1_index=torch.full((_n_buckets(c1) + 1, ROW), -1, **i32),
        l1_meta=torch.full((c1 + 1, 4), INVALID_I32, **i32),
        l1_last=torch.zeros((c1 + 1,), **i32),
        l1_surfel=torch.zeros((c1 + 1, 8), dtype=torch.float32, device=device),
        l1_free=free,
        l1_free_top=torch.tensor(c1, **i32),
        n_l0=torch.tensor(0, **i32),
        n_l1=torch.tensor(0, **i32),
        n_dropped=torch.tensor(0, **i32),
    )


# ---------------------------------------------------------------------------
# index primitives
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values held in int64, in 16-bit halves so
    that no product leaves the int64 range."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    mid = (ah * bl + al * bh) & 0xFFFF
    return (al * bl + (mid << 16)) & 0xFFFFFFFF


def hash_bucket(hi: torch.Tensor, lo: torch.Tensor, mask: int) -> torch.Tensor:
    """The JAX _hash_bucket on uint32 values held in int64."""
    h = _mul32(hi, 0x9E3779B1) ^ _mul32(lo, 0x85EBCA77)
    h = _mul32(h ^ (h >> 15), 0xC2B2AE35)
    h = h ^ (h >> 13)
    return h & mask


def bucket_find(index: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor):
    """One-row bucket probe. Returns (slot (N,), hit (N,), bucket (N,),
    empty (N, 8))."""
    nb = index.shape[0] - 1
    b = hash_bucket(qhi, qlo, nb - 1)
    row = index[b]
    slots = row[:, 0:BUCKET]
    occ = slots >= 0
    hit_c = (occ & (row[:, BUCKET:2 * BUCKET] == K.to_i32(qhi)[:, None])
             & (row[:, 2 * BUCKET:3 * BUCKET] == K.to_i32(qlo)[:, None]))
    hit = torch.any(hit_c, dim=1)
    slot = torch.where(hit, torch.sum(torch.where(hit_c, slots, 0), dim=1), -1)
    return slot.to(torch.int64), hit, b, ~occ


def _compact(mask: torch.Tensor, size: int, cap=None):
    """Positions of the True entries in order, in (size,) int64 padded with
    -1, and truncated at `cap` (an int or a 0-d device tensor) if given;
    and the count of True entries (0-d int64 on the device), which exceeds
    the kept ones by what the truncation dropped."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (rank < size)
    if cap is not None:
        keep = keep & (rank < cap)
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    out[torch.where(keep, rank, size)] = torch.arange(n, device=mask.device)
    return out[:size], mask.sum()


def _pick(branch: torch.Tensor, values) -> torch.Tensor:
    """values[branch] for a 0-d device branch, with no host read."""
    out = torch.full_like(branch, values[-1])
    for i in range(len(values) - 2, -1, -1):
        out = torch.where(branch == i, values[i], out)
    return out


def _claim_round(index, meta, free, top, qhi, qlo, want, col2_init: int):
    """Allocate slots and index cells for the wanted keys: dedupe by sort,
    rank leaders within their bucket, claim the rank-th empty cell, pop
    free slots. Returns (top, slot, claimed, allocated); index and meta
    are written in place."""
    m = qhi.shape[0]
    c = meta.shape[0] - 1
    nb = index.shape[0] - 1
    dev = qhi.device
    slot0, hit, b, empty = bucket_find(index, qhi, qlo)
    resolved = hit & want
    slot = torch.where(resolved, slot0, -1)
    cand = want & ~resolved

    skey = torch.where(cand, K.sort_key(qhi, qlo), K.INVALID_SORT_KEY)
    s_k, s_idx = torch.sort(skey, stable=True)
    first = torch.ones((m,), dtype=torch.bool, device=dev)
    first[1:] = s_k[1:] != s_k[:-1]
    leader = torch.zeros((m,), dtype=torch.bool, device=dev)
    leader[s_idx] = first & cand[s_idx]

    bkey = torch.where(leader, b, nb)
    b_s, bidx = torch.sort(bkey, stable=True)
    bfirst = torch.ones((m,), dtype=torch.bool, device=dev)
    bfirst[1:] = b_s[1:] != b_s[:-1]
    pos = torch.arange(m, device=dev)
    start = torch.cummax(torch.where(bfirst, pos, 0), 0).values
    brank = torch.zeros((m,), dtype=torch.int64, device=dev)
    brank[bidx] = pos - start

    ecnt = torch.cumsum(empty.to(torch.int64), 1)
    sel = empty & (ecnt == (brank + 1)[:, None])
    has_cell = leader & torch.any(sel, 1)
    cell = torch.argmax(sel.to(torch.int32), 1)

    arank = torch.cumsum(has_cell.to(torch.int64), 0) - 1
    can = has_cell & (arank < top)
    new_slot = free[torch.clamp(top - 1 - arank, 0, c - 1)].to(torch.int64)
    new_slot = torch.where(can, new_slot, -1)

    qh_i, ql_i = K.to_i32(qhi), K.to_i32(qlo)
    flat = index.view(-1)
    base = torch.where(can, b * ROW + cell, nb * ROW)
    flat[base] = new_slot.to(torch.int32)
    flat[torch.where(can, base + BUCKET, nb * ROW)] = qh_i
    flat[torch.where(can, base + 2 * BUCKET, nb * ROW)] = ql_i
    mrow = torch.stack([qh_i, ql_i, torch.full_like(qh_i, col2_init),
                        (b * BUCKET + cell).to(torch.int32)], dim=1)
    meta[torch.where(can, new_slot, c)] = mrow

    top = top - torch.sum(can.to(torch.int32))
    return top, torch.where(can, new_slot, slot), resolved | can, can


def _resolve_parents(index, meta, free, top, qhi, qlo, want, size, cap, find0):
    """Resolve-or-allocate parent slots for (N,) keys: keys found by the
    initial probe resolve directly; the rest compact (to `cap`) into one
    claim round, and duplicate losers re-find their winner."""
    n = qhi.shape[0]
    slot0, hit = find0[0], find0[1]
    slot = torch.full((n + 1,), -1, dtype=torch.int64, device=qhi.device)
    slot[:n] = torch.where(hit & want, slot0, -1)
    rem_idx, _ = _compact(want & ~hit, size, cap)
    rem_ok = rem_idx >= 0
    ri = torch.clamp(rem_idx, 0, n - 1)
    r_hi = torch.where(rem_ok, qhi[ri], K.INVALID_U32)
    r_lo = torch.where(rem_ok, qlo[ri], K.INVALID_U32)
    top, slot2, claimed2, _ = _claim_round(index, meta, free, top, r_hi, r_lo,
                                           rem_ok, col2_init=0)
    slot3, hit3, _, _ = bucket_find(index, r_hi, r_lo)
    slot2 = torch.where(claimed2, slot2, torch.where(hit3, slot3, -1))
    slot[torch.where(rem_ok & (slot2 >= 0), ri, n)] = slot2
    return top, slot[:n]


def _child_offset_of(coords: torch.Tensor) -> torch.Tensor:
    m = coords - 3 * torch.div(coords, 3, rounding_mode="floor")
    return ((m[..., 0] * 3 + m[..., 1]) * 3 + m[..., 2]).to(torch.int64)


# ---------------------------------------------------------------------------
# kernels and their plain twins
# ---------------------------------------------------------------------------

def map_evict_scan(l0_data, c1: int, sensors, maxd2: float, enabled):
    """K4a's wrapper: (c1,) bool, True where a parent has a live child whose
    centroid lies beyond sqrt(maxd2) of every sensor. `enabled` is a 0-d
    bool tensor; False gives all-False (the stage is gated off)."""
    if not l0_data.is_cuda:
        return map_evict_scan_plain(l0_data, c1, sensors, maxd2, enabled)
    kernels.check(l0_data, "l0_data", torch.float32, (c1 * NCH + 1, 4))
    kernels.check(sensors, "sensors", torch.float32)
    kernels.check(enabled, "enabled", torch.bool, ())
    cand = torch.empty((c1,), dtype=torch.bool, device=l0_data.device)
    kernels.KERNELS["map_evict_scan"].launch(
        l0_data.data_ptr(), c1, sensors.data_ptr(), sensors.shape[0], maxd2,
        enabled.data_ptr(), cand.data_ptr())
    return cand


def map_evict_scan_plain(l0_data, c1: int, sensors, maxd2: float, enabled):
    rows = l0_data[:c1 * NCH]
    cnt = rows[:, 0]
    d2 = None
    for si in range(sensors.shape[0]):
        rv = rows[:, 1:4] - cnt[:, None] * sensors[si]
        di = rv[:, 0] * rv[:, 0] + rv[:, 1] * rv[:, 1] + rv[:, 2] * rv[:, 2]
        d2 = di if d2 is None else torch.minimum(d2, di)
    ev = (cnt > 0.0) & (d2 > maxd2 * cnt * cnt)
    return torch.any(ev.view(c1, NCH), dim=1) & enabled


def map_scatter_add(l0_data, pts, s_idx, firstk, valid_s, placed, pslot, ch_off):
    """K4b's wrapper: for each run of equal keys in the sorted order (runs
    start where `firstk`), add the run's [count | sum xyz] of valid points
    to its target row, computed in the kernel from the run leader's point
    as the JAX program computes it: pslot * 27 + ch_off where `placed`, else
    the sink row, which is never written (`placed`, `pslot` and `ch_off`
    are indexed by point, as `pts`). In place."""
    if not l0_data.is_cuda:
        return map_scatter_add_plain(l0_data, pts, s_idx, firstk, valid_s, placed, pslot,
                                     ch_off)
    p = pts.shape[0]
    kernels.check(l0_data, "l0_data", torch.float32)
    kernels.check(pts, "pts", torch.float32, (p, 3))
    kernels.check(s_idx, "s_idx", torch.int64, (p,))
    kernels.check(firstk, "firstk", torch.bool, (p,))
    kernels.check(valid_s, "valid_s", torch.bool, (p,))
    kernels.check(placed, "placed", torch.bool, (p,))
    kernels.check(pslot, "pslot", torch.int64, (p,))
    kernels.check(ch_off, "ch_off", torch.int64, (p,))
    kernels.check_aligned(l0_data, "l0_data")
    kernels.KERNELS["map_scatter_add"].launch(
        pts.data_ptr(), s_idx.data_ptr(), firstk.data_ptr(), valid_s.data_ptr(),
        placed.data_ptr(), pslot.data_ptr(), ch_off.data_ptr(), p, l0_data.shape[0] - 1,
        l0_data.data_ptr())
    return l0_data


def map_scatter_add_plain(l0_data, pts, s_idx, firstk, valid_s, placed, pslot, ch_off):
    p = pts.shape[0]
    nrows = l0_data.shape[0] - 1
    tgt = torch.where(firstk & placed[s_idx], pslot[s_idx] * NCH + ch_off[s_idx], nrows)
    data4 = torch.cat([valid_s.to(torch.float32)[:, None],
                       torch.where(valid_s[:, None], pts[s_idx], 0.0)], dim=1)
    gix = torch.cumsum(firstk.to(torch.int64), 0) - 1
    seg4 = torch.zeros((p, 4), dtype=torch.float32, device=pts.device)
    seg4.index_add_(0, gix, data4)
    t = torch.where((tgt >= 0) & (tgt < nrows), tgt, nrows)
    l0_data.index_add_(0, t, seg4[gix])
    l0_data[nrows:].fill_(0.0)
    return l0_data


def map_surfel_recompute(l0_data, r_slot, c1: int, planarity_threshold: float):
    """K4c's wrapper. r_slot (R,) int64 parent slots (-1 = none). Returns
    (srows (R, 8) [normal | mean | planarity | 1], non_planar (R,) bool,
    kidmask (R,) int32 bit k = child k is live)."""
    if not l0_data.is_cuda:
        return map_surfel_recompute_plain(l0_data, r_slot, c1, planarity_threshold)
    r = r_slot.shape[0]
    kernels.check(l0_data, "l0_data", torch.float32, (c1 * NCH + 1, 4))
    kernels.check(r_slot, "r_slot", torch.int64, (r,))
    srows = torch.empty((r, 8), dtype=torch.float32, device=l0_data.device)
    non_planar = torch.empty((r,), dtype=torch.bool, device=l0_data.device)
    kidmask = torch.empty((r,), dtype=torch.int32, device=l0_data.device)
    kernels.KERNELS["map_surfel_recompute"].launch(
        l0_data.data_ptr(), r_slot.data_ptr(), r, c1, planarity_threshold,
        srows.data_ptr(), non_planar.data_ptr(), kidmask.data_ptr())
    return srows, non_planar, kidmask


def _lane_sum(x):
    """Sum over dim 1 (the 27 children) in K4c's order: the children on 27
    of a warp's 32 lanes, zeros on the rest, and a butterfly over the
    lanes (halves of 16, 8, 4, 2, 1), whose sum every lane holds."""
    x = torch.cat([x, x.new_zeros((x.shape[0], 32 - NCH) + x.shape[2:])], 1)
    for h in (16, 8, 4, 2, 1):
        x = x[:, :h] + x[:, h:2 * h]
    return x[:, 0]


def _block_stats(blk):
    ok = blk[..., 0] > 0.0
    cnt = torch.sum(ok.to(torch.int32), dim=1)
    cen = blk[..., 1:4] / torch.clamp(blk[..., 0:1], min=1.0)
    w = ok.to(torch.float32)[..., None]
    denom = torch.clamp(cnt, min=1)[:, None].to(torch.float32)
    mean = _lane_sum(cen * w) / denom
    d = (cen - mean[:, None, :]) * w
    cov = _lane_sum(d[:, :, :, None] * d[:, :, None, :])
    return cnt, mean, cov / denom[..., None], ok


def map_surfel_recompute_plain(l0_data, r_slot, c1: int, planarity_threshold: float):
    r_ok = r_slot >= 0
    rows = (torch.clamp(r_slot, 0, c1 - 1)[:, None] * NCH
            + torch.arange(NCH, device=r_slot.device)[None, :])
    blk = torch.where(r_ok[:, None, None], l0_data[rows.reshape(-1)].view(-1, NCH, 4), 0.0)
    _cnt, mean, cov, ok = _block_stats(blk)
    lam, normal = E.eigh3(cov)
    plan = lam[:, 0] / (lam[:, 2] + 1e-6)
    srows = torch.cat([normal, mean, plan[:, None], torch.ones_like(plan)[:, None]], 1)
    bits = (ok.to(torch.int32) << torch.arange(NCH, device=ok.device, dtype=torch.int32))
    return srows, r_ok & (plan > planarity_threshold), torch.sum(bits, 1).to(torch.int32)


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------

def update_map(state: VoxelMapState, new_pts, new_mask, sensor_pos,
               max_distance: float, *, voxel_size: float,
               planarity_threshold: float, hierarchy_factor: int = 3,
               compute_surfels: bool = True, evict_enabled=None) -> VoxelMapState:
    """Per-keyframe map update: radius eviction, insertion, surfel
    recompute (with compute_surfels; without it, no surfels are kept).
    new_pts (P, 3) world points with new_mask (P,); sensor_pos (3,) or
    (S, 3); evict_enabled a 0-d bool tensor (None = on). Updates the
    state's buffers in place and returns the new state."""
    c1 = state.c1
    nrows = c1 * NCH
    p = new_pts.shape[0]
    dev = new_pts.device
    evict_list, ch_cap, small_cap = _scaled_caps(c1, p)
    sensors = sensor_pos.reshape(-1, 3).contiguous()
    l0_data, l1_index, l1_meta = state.l0_data, state.l1_index, state.l1_meta
    l1_last, l1_surfel, l1_free = state.l1_last, state.l1_surfel, state.l1_free
    l1_top, n_l0, n_dropped = state.l1_free_top, state.n_l0, state.n_dropped
    if evict_enabled is None:
        evict_enabled = torch.ones((), dtype=torch.bool, device=dev)

    # ---- Step 1: radius eviction (bounded, deferred beyond the caps) ----
    maxd2 = K.f32(K.f32(max_distance) * K.f32(max_distance))
    cand_evict = map_evict_scan(l0_data, c1, sensors, maxd2, evict_enabled)
    ev_list, _ = _compact(cand_evict, evict_list)
    ev_ok = ev_list >= 0
    evp = torch.clamp(ev_list, 0, c1 - 1)
    ev_rows = (evp[:, None] * NCH + torch.arange(NCH, device=dev)[None, :]).reshape(-1)
    blk = l0_data[ev_rows].view(evict_list, NCH, 4)
    bcnt = blk[..., 0]
    bd2 = None
    for si in range(sensors.shape[0]):
        rv = blk[..., 1:4] - bcnt[..., None] * sensors[si]
        di = rv[..., 0] * rv[..., 0] + rv[..., 1] * rv[..., 1] + rv[..., 2] * rv[..., 2]
        bd2 = di if bd2 is None else torch.minimum(bd2, di)
    bev = ev_ok[:, None] & (bcnt > 0.0) & (bd2 > maxd2 * bcnt * bcnt)
    bev_flat = bev.reshape(-1)
    kept_flat = bev_flat & (torch.cumsum(bev_flat.to(torch.int64), 0) <= ch_cap)
    l0_data.index_fill_(0, torch.where(kept_flat, ev_rows, nrows), 0.0)
    n_per_par = kept_flat.view(evict_list, NCH).sum(1).to(torch.int32)
    # index_add_ (atomics) rather than index_put_(accumulate=True), whose
    # CUDA path sorts and serialises the thousands of masked entries that
    # all aim at the sink row
    l1_meta[:, 2].index_add_(0, torch.where(ev_ok, evp, c1), -n_per_par)
    n_l0 = n_l0 - kept_flat.sum().to(torch.int32)
    evpar = torch.where(ev_ok & (n_per_par > 0), evp, -1)

    # ---- Step 2: keys of the incoming points ----
    inv = K.f32(1.0 / K.f32(voxel_size))
    pcoords = K.voxel_coords(new_pts, inv)
    par_c = torch.div(pcoords, hierarchy_factor, rounding_mode="floor")
    ch_off = _child_offset_of(pcoords)
    phi, plo = K.pack_key(par_c)
    phi = torch.where(new_mask, phi, K.INVALID_U32)
    plo = torch.where(new_mask, plo, K.INVALID_U32)
    khi, klo = K.pack_key(pcoords)
    kkey = torch.where(new_mask, K.sort_key(khi, klo), K.INVALID_SORT_KEY)
    find0 = bucket_find(l1_index, phi, plo)

    s_k, s_idx = torch.sort(kkey, stable=True)
    firstk = torch.ones((p,), dtype=torch.bool, device=dev)
    firstk[1:] = s_k[1:] != s_k[:-1]
    valid_s = new_mask[s_idx]
    leader = torch.zeros((p,), dtype=torch.bool, device=dev)
    leader[s_idx] = firstk & valid_s

    slot0, hit0 = find0[0], find0[1]
    addr0 = torch.clamp(slot0, 0, c1 - 1) * NCH + ch_off
    pre_cnt = torch.where(hit0 & new_mask, l0_data[addr0, 0], 0.0)
    is_new_voxel = leader & (pre_cnt == 0.0)
    n_new = is_new_voxel.sum()
    n_unres = (new_mask & ~hit0).sum()

    # ---- tier caps, picked on the device ----
    sc = min(small_cap, p)
    resolve_mid = min(2 * small_cap, p)
    r_small = max(min(small_cap * 3 // 8, p), 8)
    t_cap = min(64, sc)
    tiers = [(t_cap, min(t_cap + evict_list, c1), t_cap, t_cap),
             (sc, sc, r_small, sc),
             (sc, sc, r_small, resolve_mid),
             (p, min(p + evict_list, c1), min(p, c1), p)]
    new_sz, aff_sz, r_sz, res_sz = (max(col) for col in zip(*tiers))
    branch = torch.where(
        (n_new <= t_cap) & (n_unres <= t_cap), 0,
        torch.where((n_new <= sc) & (n_unres <= sc), 1,
                    torch.where((n_new <= sc) & (n_unres <= resolve_mid), 2, 3)))
    new_cap, aff_cap, r_cap, res_cap = (_pick(branch, [t[i] for t in tiers])
                                        for i in range(4))

    # ---- Step 3: resolve-or-allocate parent slots ----
    l1_top, pslot = _resolve_parents(l1_index, l1_meta, l1_free, l1_top,
                                     phi, plo, new_mask, res_sz, res_cap, find0)
    placed = new_mask & (pslot >= 0)

    # ---- Step 4: accumulate the per-voxel totals at leader rows (K4b
    # computes each leader's target from placed, pslot and ch_off) ----
    map_scatter_add(l0_data, new_pts, s_idx, firstk, valid_s, placed, pslot, ch_off)

    # ---- Step 5: new children ----
    new_child = is_new_voxel & placed
    n_l0 = n_l0 + new_child.sum().to(torch.int32)
    n_dropped = n_dropped + (is_new_voxel & ~placed).sum().to(torch.int32)

    # ---- Step 6: affected parents = new-child parents + evicted parents ----
    new_idx, n_live = _compact(new_child, new_sz, new_cap)
    n_dropped = n_dropped + torch.clamp(n_live - new_cap, min=0).to(torch.int32)
    new_ok = new_idx >= 0
    ni = torch.clamp(new_idx, 0, p - 1)
    new_par = torch.where(new_ok, pslot[ni], c1)
    l1_meta[:, 2].index_add_(0, new_par, torch.ones_like(new_par, dtype=torch.int32))
    cand_slot = torch.cat([new_par, torch.where(evpar >= 0, evpar, c1)])
    cand_old = torch.cat([torch.zeros((new_sz,), dtype=torch.int64, device=dev),
                          torch.ones((evict_list,), dtype=torch.int64, device=dev)])
    m2 = cand_slot.shape[0]
    s2, _ = torch.sort(cand_slot * 2 + cand_old, stable=True)
    s_slot = s2 >> 1
    lead2 = torch.ones((m2,), dtype=torch.bool, device=dev)
    lead2[1:] = s_slot[1:] != s_slot[:-1]
    lead2 = lead2 & (s_slot < c1)
    lead_pos, n_live = _compact(lead2, aff_sz, aff_cap)
    n_dropped = n_dropped + torch.clamp(n_live - aff_cap, min=0).to(torch.int32)
    aff_ok = lead_pos >= 0
    lp = torch.clamp(lead_pos, 0, m2 - 1)
    aff_slot = torch.where(aff_ok, s_slot[lp], -1)
    aff_new = aff_ok & ((s2[lp] & 1) == 0)

    # ---- Step 7: surfel decisions from the incremental child counter ----
    aff_c = torch.clamp(aff_slot, 0, c1 - 1)
    cnt = torch.where(aff_ok, l1_meta[aff_c, 2], 0)
    wslot = torch.where(aff_ok, aff_slot, c1)
    if not compute_surfels:
        # no surfels: free the cells that eviction emptied, clear has
        l1_top = _free_cells(l1_index, l1_meta, l1_free, l1_top, aff_ok & (cnt == 0),
                             aff_slot)
        # index_fill_ takes its value as a kernel argument: assigning a
        # Python scalar through indexing would copy it from the host
        l1_surfel[:, 7].index_fill_(0, wslot, 0.0)
        return _finish(l0_data, l1_index, l1_meta, l1_last, l1_surfel, l1_free, l1_top,
                       n_l0, n_dropped)
    prev_has = aff_ok & (l1_surfel[aff_c, 7] > 0.5)
    prev_last = l1_last[aff_c]
    enough = cnt >= MIN_OCCUPIED_CHILDREN
    skip = prev_has & (prev_last == cnt)
    recompute = aff_new & enough & ~skip

    r_pos, n_live = _compact(recompute, r_sz, r_cap)
    n_dropped = n_dropped + torch.clamp(n_live - r_cap, min=0).to(torch.int32)
    r_ok = r_pos >= 0
    rp = torch.clamp(r_pos, 0, aff_sz - 1)
    r_slot = torch.where(r_ok, aff_slot[rp], -1)
    srows, r_non_planar, kidmask = map_surfel_recompute(
        l0_data, r_slot, c1, K.f32(planarity_threshold))
    # bound deletions so every freed child is fully processed
    npr = torch.cumsum(r_non_planar.to(torch.int64), 0) - 1
    r_defer = r_non_planar & (npr >= torch.div(r_cap, 8, rounding_mode="floor"))
    r_non_planar = r_non_planar & ~r_defer
    r_use = r_ok & ~r_non_planar & ~r_defer

    r_rank = torch.cumsum(recompute.to(torch.int64), 0) - 1
    in_r = recompute & (r_rank < r_cap)
    rr = torch.clamp(r_rank, 0, r_sz - 1)
    non_planar = in_r & r_non_planar[rr]
    use_new = in_r & r_use[rr]
    has_out = torch.where(aff_new, enough & (skip | use_new), prev_has & enough)
    cnt_post = torch.where(non_planar, 0, cnt)
    freed = aff_ok & (cnt_post == 0)

    # non-planar deletion: zero every live child of a deleted cell
    kid_bits = torch.arange(NCH, device=dev, dtype=torch.int32)
    delk = (((kidmask[:, None] >> kid_bits) & 1) > 0) & r_non_planar[:, None]
    del_rows = torch.clamp(r_slot, 0, c1 - 1)[:, None] * NCH + kid_bits[None, :]
    l0_data.index_fill_(0, torch.where(delk, del_rows, nrows).reshape(-1), 0.0)
    n_l0 = n_l0 - delk.sum().to(torch.int32)
    dtgt = torch.where(r_non_planar, r_slot, c1)
    l1_meta[:, 2].index_fill_(0, dtgt, 0)

    # free emptied cells (deletion or eviction)
    l1_top = _free_cells(l1_index, l1_meta, l1_free, l1_top, freed, aff_slot)
    cnt = cnt_post
    has_out = has_out & ~non_planar

    # ---- write back surfels, has flags and last counts ----
    l1_surfel[torch.where(r_use, torch.clamp(r_slot, 0, c1 - 1), c1)] = srows
    l1_surfel[wslot, torch.full_like(wslot, 7)] = has_out.to(torch.float32)
    l1_last[torch.where(use_new, wslot, c1)] = cnt.to(torch.int32)
    return _finish(l0_data, l1_index, l1_meta, l1_last, l1_surfel, l1_free, l1_top,
                   n_l0, n_dropped)


def _free_cells(l1_index, l1_meta, l1_free, l1_top, freed, aff_slot):
    """Erase the freed cells from the index and meta rows and push their
    slots on the free stack. Returns the new stack top."""
    c1 = l1_meta.shape[0] - 1
    nb = l1_index.shape[0] - 1
    fslot = torch.where(freed, aff_slot, c1)
    cellpos = l1_meta[torch.clamp(fslot, 0, c1 - 1), 3].to(torch.int64)
    l1_index.view(-1).index_fill_(
        0, torch.where(freed, (cellpos >> 3) * ROW + (cellpos & 7), nb * ROW), -1)
    l1_meta[:, 0].index_fill_(0, fslot, INVALID_I32)
    l1_meta[:, 1].index_fill_(0, fslot, INVALID_I32)
    frank = torch.cumsum(freed.to(torch.int64), 0) - 1
    l1_free[torch.where(freed, l1_top + frank, c1)] = torch.where(
        freed, aff_slot, -1).to(torch.int32)
    return l1_top + freed.sum().to(torch.int32)


def _finish(l0_data, l1_index, l1_meta, l1_last, l1_surfel, l1_free, l1_top, n_l0,
            n_dropped) -> VoxelMapState:
    _clear_sinks(l0_data, l1_index, l1_meta, l1_last, l1_surfel, l1_free)
    return VoxelMapState(
        l0_data=l0_data, l1_index=l1_index, l1_meta=l1_meta, l1_last=l1_last,
        l1_surfel=l1_surfel, l1_free=l1_free, l1_free_top=l1_top.to(torch.int32), n_l0=n_l0,
        n_l1=(l1_meta.shape[0] - 1 - l1_top).to(torch.int32), n_dropped=n_dropped)


def _clear_sinks(l0_data, l1_index, l1_meta, l1_last, l1_surfel, l1_free):
    """Reset the sink rows to their empty-map values, so that the map's
    contents never depend on which masked writes landed there. (fill_ on a
    view: assigning a Python scalar through indexing would copy it from
    the host and synchronise.)"""
    l0_data[-1:].fill_(0.0)
    l1_index[-1:].fill_(-1)
    l1_meta[-1:].fill_(INVALID_I32)
    l1_last[-1:].fill_(0)
    l1_surfel[-1:].fill_(0.0)
    l1_free[-1:].fill_(l1_free.shape[0] - 1)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def parent_inv(voxel_size: float, hierarchy_factor: int) -> float:
    """1 / parent-cell size, rounded as the JAX program rounds it (float32)."""
    return K.f32(1.0 / K.f32(K.f32(voxel_size) * hierarchy_factor))


def lookup_surfels(state: VoxelMapState, pts: torch.Tensor, *, voxel_size: float,
                   hierarchy_factor: int = 3):
    """Batched surfel query: one bucket-row probe and one surfel-row gather
    per point. Returns (normal (N, 3), centroid (N, 3), valid (N,)). The
    ICP correspondence kernel runs the same probe on the device."""
    qhi, qlo = K.pack_key(K.voxel_coords(pts, parent_inv(voxel_size, hierarchy_factor)))
    slot, hit, _, _ = bucket_find(state.l1_index, qhi, qlo)
    row = state.l1_surfel[torch.clamp(slot, 0, state.c1 - 1)]
    return row[:, 0:3], row[:, 3:6], hit & (row[:, 7] > 0.5)


def voxel_occupied(state: VoxelMapState, pts: torch.Tensor, *, voxel_size: float,
                   hierarchy_factor: int = 3) -> torch.Tensor:
    """Whether each point's L0 voxel is live (a diagnostic query)."""
    coords = K.voxel_coords(pts, 1.0 / voxel_size)
    slot, hit, _, _ = bucket_find(state.l1_index, *K.pack_key(
        torch.div(coords, hierarchy_factor, rounding_mode="floor")))
    addr = torch.clamp(slot, 0, state.c1 - 1) * NCH + _child_offset_of(coords)
    return hit & (state.l0_data[addr, 0] > 0.0)


def grid_knn_neighbors(state: VoxelMapState, pts: torch.Tensor, *, voxel_size: float,
                       hierarchy_factor: int = 3, radius: int = 1, flags=None, mask=None):
    """K5a's wrapper: the L0 centroids of each query's (2r+1)^3 voxel
    neighbourhood, in meshgrid "ij" offset order. pts (N, 3) f32. Returns
    (centroids (N, M, 3), ok (N, M) bool), M = (2r+1)^3; a neighbour that
    is not live has ok False and the centroid of the row it was read from.
    `flags` (3,) int32 [done, failed, n_corr] of an ICP solve, or None:
    once done, the kernel returns at once and leaves the outputs
    unwritten, as the JAX while_loop stops. `mask` (N,) bool, or None: ok
    is also False on the rows it masks out (ok & mask[:, None], in the
    kernel). The kernel takes radius 1 or 2 with hierarchy factor 3."""
    if not pts.is_cuda:
        cen, ok = grid_knn_neighbors_plain(state, pts, voxel_size=voxel_size,
                                           hierarchy_factor=hierarchy_factor, radius=radius)
        return cen, ok if mask is None else ok & mask[:, None]
    if hierarchy_factor != 3 or radius not in (1, 2):
        raise kernels.KernelInputError(
            "grid_knn: the kernel takes radius 1 or 2 with hierarchy factor 3")
    n = pts.shape[0]
    m = (2 * radius + 1) ** 3
    kernels.check(pts, "pts", torch.float32, (n, 3))
    kernels.check(state.l1_index, "l1_index", torch.int32)
    kernels.check_aligned(state.l1_index, "l1_index")
    kernels.check(state.l0_data, "l0_data", torch.float32)
    if flags is not None:
        kernels.check(flags, "flags", torch.int32, (3,))
    if mask is not None:
        kernels.check(mask, "mask", torch.bool, (n,))
    # the kernel's 16-byte stores need 16-byte aligned outputs (torch.empty's are)
    cen = torch.empty((n, m, 3), dtype=torch.float32, device=pts.device)
    ok = torch.empty((n, m), dtype=torch.bool, device=pts.device)
    kernels.KERNELS["grid_knn"].launch(
        pts.data_ptr(), n, None if flags is None else flags.data_ptr(),
        None if mask is None else mask.data_ptr(), state.l1_index.data_ptr(), state.n_buckets,
        state.l0_data.data_ptr(), state.c1, K.f32(1.0 / K.f32(voxel_size)), radius,
        cen.data_ptr(), ok.data_ptr())
    return cen, ok


def grid_knn_neighbors_plain(state: VoxelMapState, pts: torch.Tensor, *, voxel_size: float,
                             hierarchy_factor: int = 3, radius: int = 1):
    """Plain twin of K5a. The (2r+1)^3 neighbours share at most span^3
    parents, span = 2r//h + 2, each probed once; a neighbour's parent and
    child offset come from comparisons on (qc mod h) + offset, and its
    parent's probe is read by index."""
    h = hierarchy_factor
    dev = pts.device
    qc = K.voxel_coords(pts, K.f32(1.0 / K.f32(voxel_size)))
    n = qc.shape[0]
    offs = torch.as_tensor(_cube(-radius, radius), device=dev)
    m = offs.shape[0]
    span = (2 * radius) // h + 2
    pq = torch.div(qc, h, rounding_mode="floor")
    lo_par = torch.div(qc - radius, h, rounding_mode="floor")
    poffs = torch.as_tensor(_cube(0, span - 1), device=dev)
    phi, plo = K.pack_key(lo_par[:, None, :] + poffs[None, :, :])
    pslot = bucket_find(state.l1_index, phi.reshape(-1), plo.reshape(-1))[0].view(n, -1)

    v = (qc - pq * h)[:, None, :] + offs[None, :, :]
    d = torch.where(v < 0, -1, torch.where(v >= h, 1, 0))
    cloc = v - d * h
    rel = (pq - lo_par)[:, None, :] + d
    pidx = (rel[..., 0] * span + rel[..., 1]) * span + rel[..., 2]
    slot = torch.gather(pslot, 1, pidx.to(torch.int64))
    off_c = (cloc[..., 0] * h + cloc[..., 1]) * h + cloc[..., 2]
    addr = torch.clamp(slot, 0, state.c1 - 1) * NCH + off_c
    data = state.l0_data[addr.reshape(-1)]
    ok = (slot >= 0) & (data[:, 0].view(n, m) > 0.0)
    cen = (data[:, 1:4] / torch.clamp(data[:, 0:1], min=1.0)).view(n, m, 3)
    return cen, ok


def l0_points(state: VoxelMapState):
    """Every L0 centroid and its validity: ((C1*27, 3), (C1*27,) bool)."""
    data = state.l0_data[:-1]
    return data[:, 1:4] / torch.clamp(data[:, 0], min=1.0)[:, None], data[:, 0] > 0.0


def l0_records(state: VoxelMapState):
    """Every L0 voxel as records (key_hi, key_lo, count, centroid, live),
    each (C1*27,)-shaped."""
    c1 = state.c1
    meta = state.l1_meta[:c1]
    pc = K.unpack_key(K.from_i32(meta[:, 0]), K.from_i32(meta[:, 1]))
    offs = torch.as_tensor(_CHILD_OFFS, device=meta.device)
    coords = pc[:, None, :] * 3 + offs[None, :, :]
    hi, lo = K.pack_key(coords.reshape(-1, 3))
    data = state.l0_data[:c1 * NCH]
    cnt = data[:, 0]
    live = (cnt > 0.0) & torch.repeat_interleave(meta[:, 0] != INVALID_I32, NCH)
    centroid = data[:, 1:4] / torch.clamp(cnt, min=1.0)[:, None]
    return hi, lo, cnt, centroid, live


def l1_surfels(state: VoxelMapState):
    """All cached surfels: (normals, centroids, planarity, valid)."""
    s = state.l1_surfel[:state.c1]
    return s[:, 0:3], s[:, 3:6], s[:, 6], s[:, 7] > 0.0


# ---------------------------------------------------------------------------
# rehash (the pose-graph correction)
# ---------------------------------------------------------------------------

def map_bulk_merge(l0_data, s_key, s_idx, first, counts, centroids, l1_index):
    """K9b's wrapper. The records in sorted order: s_key (M,) int64 sorted
    keys (INVALID_SORT_KEY for dead records, which sort last), s_idx (M,)
    int64 the permutation, first (M,) bool run leaders of live keys; counts
    (M,) f32 and centroids (M, 3) f32 by record. Sums each run's [count |
    count * centroid] in the sorted order and writes it to its parent's
    child row of l0_data (in place; the parent found in l1_index). Returns
    (2,) int32 [merged voxels placed, merged voxels whose parent is not in
    the index]. The kernel adds the counts into a zeroed scratch that it
    leaves zeroed (kernels.zeroed_scratch), so a call launches nothing
    else."""
    if not s_key.is_cuda:
        return map_bulk_merge_plain(l0_data, s_key, s_idx, first, counts, centroids, l1_index)
    m = s_key.shape[0]
    kernels.check(l0_data, "l0_data", torch.float32)
    kernels.check(s_key, "s_key", torch.int64, (m,))
    kernels.check(s_idx, "s_idx", torch.int64, (m,))
    kernels.check(first, "first", torch.bool, (m,))
    kernels.check(counts, "counts", torch.float32, (m,))
    kernels.check(centroids, "centroids", torch.float32, (m, 3))
    kernels.check(l1_index, "l1_index", torch.int32)
    kernels.check_aligned(l1_index, "l1_index")
    out = torch.empty((2,), dtype=torch.int32, device=s_key.device)
    scratch = kernels.zeroed_scratch("map_bulk_merge", s_key.device, 2)
    kernels.KERNELS["map_bulk_merge"].launch(
        s_key.data_ptr(), s_idx.data_ptr(), first.data_ptr(), counts.data_ptr(),
        centroids.data_ptr(), m, l1_index.data_ptr(), l1_index.shape[0] - 1,
        l0_data.data_ptr(), scratch.data_ptr(), out.data_ptr())
    return out


def map_bulk_merge_plain(l0_data, s_key, s_idx, first, counts, centroids, l1_index):
    """K9b's twin. Step k adds the k-th record of every run to its total,
    so each total is summed in its run's order on any device (the
    kernel's order, and the JAX segment sum's)."""
    m = s_key.shape[0]
    nrows = l0_data.shape[0] - 1
    dev = s_key.device
    live = s_key != K.INVALID_SORT_KEY
    w = torch.where(live, counts[s_idx], 0.0)
    data4 = torch.cat([w[:, None], centroids[s_idx] * w[:, None]], 1)
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    pos = torch.arange(m, device=dev)
    step = torch.where(live, pos - torch.cummax(torch.where(first, pos, 0), 0).values, -1)
    tot = torch.zeros((m, 4), dtype=torch.float32, device=dev)
    for k in range(int(step.max()) + 1 if m else 0):
        at = step == k
        tot[seg[at]] += data4[at]
    coords = K.unpack_key(*K.split_sort_key(s_key))
    par = torch.div(coords, 3, rounding_mode="floor")
    pslot, phit, _, _ = bucket_find(l1_index, *K.pack_key(par))
    ok = first & phit
    addr = torch.where(ok, torch.clamp(pslot, 0) * NCH + _child_offset_of(coords), nrows)
    l0_data[addr] = torch.where(ok[:, None], tot[seg.clamp(min=0)], 0.0)
    l0_data[nrows:].fill_(0.0)
    return torch.stack([ok.sum(), (first & ~phit).sum()]).to(torch.int32)


# K9a's launch: one cluster of 16 CTAs x 1024 threads (csrc/rehash.cu
# INDEX_CLUSTER, INDEX_THREADS; a non-portable size), as
# kernels.KERNELS["map_bulk_index"].launch_shape() reads it from the build
BULK_INDEX_SHAPE = {"cluster": 16, "threads": 1024}


def map_bulk_index(b_s, i_s, hi, lo, l1_index, l1_meta, slot_from_top: int):
    """K9a's wrapper: the slots and bucket cells of DISTINCT keys in a fresh
    map, by sort. b_s (N,) int64 the keys' buckets in stable sorted order
    (n_buckets where the key is dead), i_s (N,) int64 the sort permutation,
    hi, lo (N,) int32 the keys' bits. A key's cell is its rank within its
    bucket (cells past 8 are not placed); the placed keys take slots
    counting down from slot_from_top - 1 in key order. Writes each placed
    key's index cell (slot, hi, lo) into l1_index and its meta row (hi, lo,
    -1, cell position) into l1_meta, in place. Returns the number placed,
    () int32."""
    if not b_s.is_cuda:
        return map_bulk_index_plain(b_s, i_s, hi, lo, l1_index, l1_meta, slot_from_top)
    n = b_s.shape[0]
    kernels.check(b_s, "b_s", torch.int64, (n,))
    kernels.check(i_s, "i_s", torch.int64, (n,))
    kernels.check(hi, "hi", torch.int32, (n,))
    kernels.check(lo, "lo", torch.int32, (n,))
    kernels.check(l1_index, "l1_index", torch.int32)
    kernels.check(l1_meta, "l1_meta", torch.int32)
    for t, name in ((hi, "hi"), (lo, "lo"), (l1_meta, "l1_meta")):
        kernels.check_aligned(t, name)
    if slot_from_top > l1_meta.shape[0] - 1:
        raise kernels.KernelInputError(
            f"map_bulk_index: {slot_from_top} slots but {l1_meta.shape[0] - 1} meta rows")
    cp = torch.empty((n,), dtype=torch.int32, device=b_s.device)
    out = torch.empty((), dtype=torch.int32, device=b_s.device)
    kernels.KERNELS["map_bulk_index"].launch(
        b_s.data_ptr(), i_s.data_ptr(), hi.data_ptr(), lo.data_ptr(), n, l1_index.shape[0] - 1,
        slot_from_top, cp.data_ptr(), l1_index.data_ptr(), l1_meta.data_ptr(), out.data_ptr())
    return out


def map_bulk_index_plain(b_s, i_s, hi, lo, l1_index, l1_meta, slot_from_top: int):
    n = b_s.shape[0]
    dev = b_s.device
    nb = l1_index.shape[0] - 1
    bfirst = torch.ones((n,), dtype=torch.bool, device=dev)
    bfirst[1:] = b_s[1:] != b_s[:-1]
    pos = torch.arange(n, device=dev)
    cell = torch.zeros((n,), dtype=torch.int64, device=dev)
    cell[i_s] = pos - torch.cummax(torch.where(bfirst, pos, 0), 0).values
    b = torch.zeros((n,), dtype=torch.int64, device=dev)
    b[i_s] = b_s
    placed = (b < nb) & (cell < BUCKET)
    rank = torch.cumsum(placed.to(torch.int64), 0) - 1
    slot = torch.where(placed & (rank < slot_from_top), slot_from_top - 1 - rank, -1)
    placed = slot >= 0
    cellpos = torch.where(placed, b * BUCKET + cell, -1)
    base = torch.where(placed, (cellpos >> 3) * ROW + (cellpos & 7), nb * ROW)
    flat = l1_index.view(-1)
    flat[base] = slot.to(torch.int32)
    flat[torch.where(placed, base + BUCKET, nb * ROW)] = hi
    flat[torch.where(placed, base + 2 * BUCKET, nb * ROW)] = lo
    sink = l1_meta.shape[0] - 1
    l1_meta[torch.where(placed, slot, sink)] = torch.stack(
        [hi, lo, torch.full_like(hi, INVALID_I32), cellpos.to(torch.int32)], 1)
    l1_index[-1:].fill_(-1)
    l1_meta[-1:].fill_(INVALID_I32)
    return placed.sum().to(torch.int32)


class BulkPlan(NamedTuple):
    """A bulk build up to its merge: the fresh state with its index and meta
    rows written, and the records in key order for K9b."""
    fresh: VoxelMapState
    s_key: torch.Tensor      # (M,) int64 sorted record keys
    s_idx: torch.Tensor      # (M,) int64 the sort permutation
    first: torch.Tensor      # (M,) bool run leaders of live keys
    counts: torch.Tensor     # (M,) f32 by record, 0 where dead
    centroids: torch.Tensor  # (M, 3) f32 by record
    n1: torch.Tensor         # () i32 distinct parents that got a slot


def bulk_parents(s_key, first, c0: int, c1: int, n_buckets: int, hierarchy_factor: int = 3):
    """The distinct parents of the merged voxels (the run leaders `first` of
    the sorted record keys s_key, at most c0), in key order and at most c1,
    as K9a takes them: (b_s, i_s) their buckets (n_buckets past the last
    parent) in stable sorted order and the permutation, (hi, lo) their key
    bits, each (c1,)."""
    seg_pos, _ = _compact(first, c0)
    m_live = seg_pos >= 0
    m_key = torch.where(m_live, s_key[torch.clamp(seg_pos, 0)], K.INVALID_SORT_KEY)
    par = torch.div(K.unpack_key(*K.split_sort_key(m_key)), hierarchy_factor,
                    rounding_mode="floor")
    p_key = torch.where(m_live, K.sort_key(*K.pack_key(par)), K.INVALID_SORT_KEY)
    ps_key, _ = torch.sort(p_key, stable=True)
    pfirst = ps_key != K.INVALID_SORT_KEY
    pfirst[1:] &= ps_key[1:] != ps_key[:-1]
    u_pos, _ = _compact(pfirst, c1)
    u_live = u_pos >= 0
    u_hi, u_lo = K.split_sort_key(torch.where(u_live, ps_key[torch.clamp(u_pos, 0)],
                                              K.INVALID_SORT_KEY))
    b_s, i_s = torch.sort(torch.where(u_live, hash_bucket(u_hi, u_lo, n_buckets - 1), n_buckets),
                          stable=True)
    return b_s, i_s, K.to_i32(u_hi), K.to_i32(u_lo)


def bulk_plan(centroids, counts, live, c0: int, c1: int, *, voxel_size: float,
              hierarchy_factor: int = 3) -> BulkPlan:
    """Key the records, sort them, find the distinct parents of the merged
    voxels and give them slots and bucket cells in a fresh map (c0 is the
    merge capacity)."""
    if hierarchy_factor != 3:
        raise ValueError("bulk_build: the port takes hierarchy factor 3")
    dev = centroids.device
    cnt = torch.where(live, counts, 0.0)
    key = torch.where(live, K.sort_key(*K.pack_key(K.voxel_coords(
        centroids, K.f32(1.0 / K.f32(voxel_size))))), K.INVALID_SORT_KEY)
    s_key, s_idx = torch.sort(key, stable=True)
    first = s_key != K.INVALID_SORT_KEY
    first[1:] &= s_key[1:] != s_key[:-1]

    fresh = empty_map(0, c1, device=dev)
    n1 = map_bulk_index(*bulk_parents(s_key, first, c0, c1, fresh.n_buckets, hierarchy_factor),
                        fresh.l1_index, fresh.l1_meta, c1)
    return BulkPlan(fresh, s_key, s_idx, first, cnt, centroids.contiguous(), n1)


def bulk_build(centroids, counts, live, c0: int, c1: int, *, voxel_size: float,
               planarity_threshold: float, hierarchy_factor: int = 3,
               n_dropped=None) -> VoxelMapState:
    """A fresh map from (M,) weighted-centroid records: records of equal
    key merge by weighted centroid, distinct parents get slots and cells
    by sort (K9a), each merged voxel lands in its parent's block (K9b), and every
    parent's statistics are recomputed (K4c). c0 is the merge capacity."""
    plan = bulk_plan(centroids, counts, live, c0, c1, voxel_size=voxel_size,
                     hierarchy_factor=hierarchy_factor)
    fresh, dev = plan.fresh, centroids.device
    if n_dropped is None:
        n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    placed = map_bulk_merge(fresh.l0_data, plan.s_key, plan.s_idx, plan.first, plan.counts,
                            plan.centroids, fresh.l1_index)
    n_dropped = n_dropped + placed[1] + torch.clamp(plan.first.sum() - c0, min=0).to(torch.int32)

    # every parent's statistics (K4c), has without the non-planar deletion
    l1_meta = fresh.l1_meta
    occ = l1_meta[:c1, 0] != INVALID_I32
    srows, _np, kidmask = map_surfel_recompute(
        fresh.l0_data, torch.arange(c1, device=dev), c1, K.f32(planarity_threshold))
    ccnt = ((kidmask[:, None] >> torch.arange(NCH, dtype=torch.int32, device=dev)) & 1).sum(1)
    has = occ & (ccnt >= MIN_OCCUPIED_CHILDREN) & (srows[:, 6] <= K.f32(planarity_threshold))
    fresh.l1_surfel[:c1] = torch.cat([srows[:, :7], has.to(torch.float32)[:, None]], 1)
    l1_meta[:c1, 2] = torch.where(occ, ccnt.to(torch.int32), l1_meta[:c1, 2])
    fresh.l1_last[:c1] = torch.where(occ, ccnt, 0).to(torch.int32)
    n1 = plan.n1
    return fresh._replace(l1_free_top=(c1 - n1).to(torch.int32), n_l0=placed[0].clone(),
                          n_l1=n1, n_dropped=n_dropped.to(torch.int32))


def rehash_records(state: VoxelMapState, T):
    """The live L0 records of a map, compacted to 4 a parent slot and moved
    by T (4, 4). Returns (centroids (cap, 3), counts (cap,), live (cap,),
    cap, n_dropped with the compaction's overflow)."""
    c1 = state.c1
    m = c1 * NCH
    cap = min(4 * c1, m)
    live = state.l0_data[:m, 0] > 0.0
    live_idx, n_live = _compact(live, cap)
    ok = live_idx >= 0
    rows = state.l0_data[torch.clamp(live_idx, 0, m - 1)]
    c_cnt = torch.where(ok, rows[:, 0], 0.0)
    c_cen = rows[:, 1:4] / torch.clamp(c_cnt, min=1.0)[:, None]
    T = T.to(torch.float32)
    new_centroid = c_cen @ T[:3, :3].T + T[:3, 3][None, :]
    n_dropped = state.n_dropped + torch.clamp(n_live - cap, min=0).to(torch.int32)
    return new_centroid, c_cnt, ok, cap, n_dropped


def transform_and_rehash(state: VoxelMapState, T, *, voxel_size: float,
                         planarity_threshold: float, hierarchy_factor: int = 3) -> VoxelMapState:
    """The map correction after a pose-graph optimisation: move every live
    L0 centroid by T (4, 4), re-key, merge collisions by weighted centroid
    and recompute every surfel, into a fresh map. The live records are
    compacted to 4 per parent slot first; a map denser than that drops the
    excess into n_dropped."""
    centroids, counts, live, cap, n_dropped = rehash_records(state, T)
    return bulk_build(centroids, counts, live, cap, state.c1, voxel_size=voxel_size,
                      planarity_threshold=planarity_threshold,
                      hierarchy_factor=hierarchy_factor, n_dropped=n_dropped)
