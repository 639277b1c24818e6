"""The spatially sharded voxel surfel map (counterpart of the JAX package's
parallel/sharded_map.py).

Ownership is by parent cell: shard s owns every L1 cell whose key hashes
to s (mod S) and every L0 voxel of such a cell, so each shard is a whole
single-device map (ops/voxel_map.py) with its own bucket index (sized by
its own c1 = c1_total / S), slot tables, free stack, scalars and sink
rows. A rank holds n_local shards (parallel/mesh.py ShardGroup) in the
JAX global layout: every table is the n_local shards' tables one after
another, each with its sink row ((n_local * (rows + 1), ...)), and the
four scalars are (n_local,) vectors. `local_view` gives shard k's tables
as views, so the single-device update writes them in place.

  * update: each shard compacts its owned subset of the replicated scan
    (K11a) and runs the single-device update on it (K4a-c); no
    collective.
  * lookup: replicated queries, each shard answers the keys it owns and
    misses the rest; a psum combines.
  * ICP (robust_icp_loop): owned points compacted once at the guess
    (K11a); each iteration one K2a launch over every lane and shard, one
    launch of K11b's per-alpha systems with K11c's sample into one row per
    shard, an all_gather of the rows (the JAX program's one fused psum),
    and K11d's replicated select, solve and retract. Iteration 0 gathers
    the raw moments first (K11b) for the std / 6 scale.
  * rehash (a loop correction): every shard's live (centroid, count)
    records moved by T and all_gathered in shard order; each shard
    bulk-builds the ones it owns (K11a's owner mode, K9a/K9b, K4c) and
    keeps its own n_dropped.

Everything stays on the device: no host read on any of these paths. The
local shards are a Python loop for the map update (K4a-c, K9a/b).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..ops import icp as icp_ops
from ..ops import pko
from ..ops import voxel_map as vm
from . import shard_ops as so
from .mesh import ShardGroup

__all__ = ["SCALARS", "sharded_empty_map", "local_view", "set_local", "owned_cap",
           "sharded_update_map", "sharded_lookup_surfels", "sharded_icp_step",
           "robust_icp_loop", "sharded_icp_optimize", "sharded_transform_and_rehash",
           "gather_state", "local_views", "shard_counts"]

SCALARS = ("l1_free_top", "n_l0", "n_l1", "n_dropped")
owned_cap = so.owned_cap

_draws: dict = {}


def _shard_draws(n_shards: int, device):
    """The committed per-shard uniforms (S, quota) and k-means start, on
    `device` (kept, so that a frame makes no host-to-device copy)."""
    key = (n_shards, str(device))
    if key not in _draws:
        u, pick = pko.shard_draws(n_shards)
        _draws[key] = (torch.as_tensor(u, device=device), torch.as_tensor(pick, device=device))
    return _draws[key]


def sharded_empty_map(c0_total: int, c1_total: int, group: ShardGroup,
                      batch: int = None) -> vm.VoxelMapState:
    """An empty map of c1_total parents split over the group's S shards,
    this rank's n_local of them; with `batch`, B such maps with a leading
    B (the data x map step's lanes)."""
    s = group.n_shards
    if c1_total % s:
        raise ValueError(f"map capacity {c1_total} is not divisible by {s} shards")
    local = vm.empty_map(c0_total // s, c1_total // s, device=group.device)
    n = group.n_local
    lead = () if batch is None else (batch,)
    out = {}
    for name, a in local._asdict().items():
        if name in SCALARS:
            out[name] = a.expand(lead + (n,)).clone()
        else:
            t = a.repeat((n,) + (1,) * (a.dim() - 1))
            out[name] = t.expand(lead + t.shape).clone() if lead else t
    return vm.VoxelMapState(**out)


def _n_local(state: vm.VoxelMapState) -> int:
    return state.n_l0.shape[-1]


def local_view(state: vm.VoxelMapState, k: int, lane: int = None) -> vm.VoxelMapState:
    """Shard k's map (of lane `lane` in a batched state) as views: tables
    are row ranges of the rank's tables, scalars 0-d elements."""
    n = _n_local(state)
    out = {}
    for name, a in state._asdict().items():
        if lane is not None:
            a = a[lane]
        if name in SCALARS:
            out[name] = a[k]
        else:
            rows = a.shape[0] // n
            out[name] = a[k * rows:(k + 1) * rows]
    return vm.VoxelMapState(**out)


def local_views(state: vm.VoxelMapState, lanes: int = None):
    """[lane][k] local views of every shard of every lane (one lane when
    `lanes` is None)."""
    n = _n_local(state)
    if lanes is None:
        return [[local_view(state, k) for k in range(n)]]
    return [[local_view(state, k, b) for k in range(n)] for b in range(lanes)]


def set_local(state: vm.VoxelMapState, k: int, new: vm.VoxelMapState, lane: int = None):
    """Write shard k's scalars after update_map, which wrote its tables in
    place through the views."""
    view = local_view(state, k, lane)
    for name in SCALARS:
        getattr(view, name).copy_(getattr(new, name))


def shard_counts(state: vm.VoxelMapState) -> dict:
    """n_l0, n_l1 and n_dropped summed over this rank's shards (host ints)."""
    return {k: int(getattr(state, k).sum()) for k in ("n_l0", "n_l1", "n_dropped")}


# ---------------------------------------------------------------------------
# update and lookup
# ---------------------------------------------------------------------------

def sharded_update_map(state: vm.VoxelMapState, pts, mask, sensor_pos, max_distance,
                       group: ShardGroup, *, voxel_size: float, planarity_threshold: float,
                       hierarchy_factor: int = 3, compute_surfels: bool = True,
                       overflow=None) -> vm.VoxelMapState:
    """The keyframe update: each local shard compacts its owned subset of
    the replicated (P, 3) world points with mask (P,) (K11a) and runs the
    single-device update on it; no collective. In place; returns the
    state. `overflow`, a 0-d int tensor, gathers the owned points past
    the per-shard capacity (dropped)."""
    n = pts.shape[0]
    cap = owned_cap(n, group.n_shards)
    p_own, ok, _, over = so.shard_own(
        pts.reshape(1, n, 3).contiguous(), mask.reshape(1, n).contiguous(), None,
        group.n_shards, group.first, group.n_local, cap,
        so.owner_inv(voxel_size, hierarchy_factor))
    if overflow is not None:
        overflow += over.sum()
    for k in range(group.n_local):
        out = vm.update_map(local_view(state, k), p_own[k], ok[k], sensor_pos, max_distance,
                            voxel_size=voxel_size, planarity_threshold=planarity_threshold,
                            hierarchy_factor=hierarchy_factor, compute_surfels=compute_surfels)
        set_local(state, k, out)
    return state


def sharded_lookup_surfels(state: vm.VoxelMapState, pts, group: ShardGroup, *,
                           voxel_size: float, hierarchy_factor: int = 3):
    """The surfel query: replicated (N, 3) queries, the owning shard answers
    (the others miss their index), psum over shards. Returns (normal,
    centroid, valid)."""
    rows = []
    for k in range(group.n_local):
        n, c, v = vm.lookup_surfels(local_view(state, k), pts, voxel_size=voxel_size,
                                    hierarchy_factor=hierarchy_factor)
        vf = v.to(torch.float32)[:, None]
        rows.append(torch.cat([n * vf, c * vf, vf], 1))
    tot = group.psum(torch.stack(rows))
    return tot[:, 0:3], tot[:, 3:6], tot[:, 6] > 0


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

def robust_icp_loop(views, group: ShardGroup, pts, mask, T0, cfg: icp_ops.ICPConfig,
                    pko_consts=None):
    """The distributed scan-to-map ICP of L lanes with the single-device
    engine's semantics: the std / 6 scale from the psum'd raw moments at
    the guess, PKO's alpha from the merged per-shard samples (or the fixed
    delta, or unit weights without the robust loss), the early exit and
    the fall-back to the guess on failure. views [L][n_local] the local
    shard maps; pts (L, N, 3) body points, mask (L, N), T0 (L, 4, 4).
    Returns (T (L, 4, 4), success (L,), n_corr (L,) int32, over (L *
    n_local,) int32 the owned points past cap). Every iteration issues
    the same launches and collectives (a done lane's kernels return at
    once), max_iterations of them."""
    lanes, n = pts.shape[0], pts.shape[1]
    s, n_local = group.n_shards, group.n_local
    dev = pts.device
    cap = owned_cap(n, s)
    T0f = T0.reshape(lanes, 16).contiguous()
    p_own, ok, _, over = so.shard_own(pts.contiguous(), mask.contiguous(), T0f, s,
                                      group.first, n_local, cap,
                                      so.owner_inv(cfg.voxel_size, cfg.hierarchy_factor))
    # PKO picks the robust kernel's scale: without the robust loss the
    # weights are unit whatever the m-estimator flag says
    use_pko = cfg.use_robust_loss and cfg.use_adaptive_m_estimator and pko_consts is not None
    if use_pko:
        alphas = pko_consts.alphas
        u, pick = _shard_draws(s, dev)
        quota = u.shape[1]
    else:
        alphas = torch.full((1,), cfg.robust_loss_delta, dtype=torch.float32, device=dev)
        u = pick = None
        quota = 0
    n_alpha = alphas.shape[0]
    ld = so.buffer_width(n_alpha, s, quota)
    g = lanes * n_local
    bufs = (torch.empty((g, cap, 3), dtype=torch.float32, device=dev),
            torch.empty((g, cap), dtype=torch.float32, device=dev),
            torch.empty((g, cap), dtype=torch.bool, device=dev))
    row = torch.empty((g, ld), dtype=torch.float32, device=dev)
    T, flags = T0f, torch.zeros((lanes, 3), dtype=torch.int32, device=dev)
    mom = None
    for i in range(cfg.max_iterations):
        icp_ops.icp_correspond_instances(p_own, ok, T, flags, views, cfg, out=bufs)
        nrm, r, valid = bufs
        if i == 0:
            m = so.shard_alpha_normal_eq(p_own, nrm, r, valid, T, flags, None, None, cfg,
                                         n_local=n_local, moments=True)
            mom = group.all_gather(m.view(lanes, n_local, 3), dim=1).contiguous()
        if use_pko:   # K11b's systems and K11c's sample, one launch
            so.shard_alpha_normal_eq_sample(p_own, nrm, r, valid, T, flags, mom, alphas, u, cfg,
                                            first=group.first, n_local=n_local,
                                            off=n_alpha * 42, out=row)
        else:
            so.shard_alpha_normal_eq(p_own, nrm, r, valid, T, flags, mom, alphas, cfg,
                                     n_local=n_local, out=row)
        rows = group.all_gather(row.view(lanes, n_local, ld), dim=1).contiguous()
        T, flags, _ = so.shard_gn_select(rows, T, flags, pko_consts, pick, cfg,
                                         n_alpha=n_alpha, quota=quota, use_pko=use_pko)
    success = flags[:, 1] == 0
    T_final = torch.where(success[:, None, None], T.view(lanes, 4, 4), T0.reshape(lanes, 4, 4))
    return T_final, success, flags[:, 2], over


def sharded_icp_optimize(state: vm.VoxelMapState, pts, mask, T_init, group: ShardGroup,
                         cfg: icp_ops.ICPConfig, pko_consts=None, overflow=None):
    """The distributed scan-to-map ICP (robust_icp_loop) of one scan: pts
    (N, 3) local features, mask (N,), T_init (4, 4). Returns (T_opt (4,
    4), success () bool, n_correspondences () int32); on failure T_opt is
    T_init. `overflow` as in sharded_update_map."""
    n = pts.shape[0]
    T, ok, nc, over = robust_icp_loop(local_views(state), group, pts.reshape(1, n, 3),
                                      mask.reshape(1, n), T_init.reshape(1, 4, 4), cfg,
                                      pko_consts)
    if overflow is not None:
        overflow += over.sum()
    return T[0], ok[0], nc[0]


def sharded_icp_step(state: vm.VoxelMapState, pts, mask, T, group: ShardGroup,
                     cfg: icp_ops.ICPConfig):
    """One unweighted distributed GN step: owned points compacted at T
    (K11a), per-shard correspondences (K2a) and normal equations (K11b),
    all_gather, solve and retract (K11d). Returns (T_new (4, 4), n
    correspondences () int32)."""
    n = pts.shape[0]
    dev = pts.device
    ucfg = replace(cfg, use_robust_loss=False, min_correspondence_points=0)
    T16 = T.reshape(1, 16).contiguous().to(torch.float32)
    cap = owned_cap(n, group.n_shards)
    p_own, ok, _, _ = so.shard_own(pts.reshape(1, n, 3).contiguous(), mask.reshape(1, n),
                                   T16, group.n_shards, group.first, group.n_local, cap,
                                   so.owner_inv(cfg.voxel_size, cfg.hierarchy_factor))
    flags = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    bufs = (torch.empty((group.n_local, cap, 3), dtype=torch.float32, device=dev),
            torch.empty((group.n_local, cap), dtype=torch.float32, device=dev),
            torch.empty((group.n_local, cap), dtype=torch.bool, device=dev))
    icp_ops.icp_correspond_instances(p_own, ok, T16, flags, local_views(state), ucfg,
                                     out=bufs)
    ld = so.buffer_width(1, group.n_shards, 0)
    row = torch.empty((group.n_local, ld), dtype=torch.float32, device=dev)
    mom = torch.zeros((1, group.n_shards, 3), dtype=torch.float32, device=dev)
    so.shard_alpha_normal_eq(p_own, *bufs, T16, flags, mom,
                             torch.ones((1,), dtype=torch.float32, device=dev), ucfg,
                             n_local=group.n_local, out=row)
    rows = group.all_gather(row.view(1, group.n_local, ld), dim=1).contiguous()
    T_new, _, info = so.shard_gn_select(rows, T16, flags, None, None, ucfg, n_alpha=1,
                                        quota=0, use_pko=False)
    return T_new.view(4, 4), info[0, 1]


# ---------------------------------------------------------------------------
# rehash and gather
# ---------------------------------------------------------------------------

def sharded_transform_and_rehash(state: vm.VoxelMapState, T, group: ShardGroup, *,
                                 voxel_size: float, planarity_threshold: float,
                                 hierarchy_factor: int = 3) -> vm.VoxelMapState:
    """The map correction after a pose-graph optimisation: every shard's
    live L0 records moved by T (4, 4) and all_gathered in shard order;
    each shard bulk-builds the records it owns after the move into a
    fresh map (K11a owner mode, K9a, K9b, K4c), carrying its n_dropped.
    Returns a new state."""
    T = T.to(torch.float32)
    views = local_views(state)[0]
    c1 = views[0].c1
    rows = c1 * vm.NCH
    moved, cnts = [], []
    for v in views:
        data = v.l0_data[:rows]
        cnt = data[:, 0]
        cen = data[:, 1:4] / torch.clamp(cnt, min=1.0)[:, None]
        moved.append(cen @ T[:3, :3].T + T[:3, 3][None, :])
        cnts.append(cnt)
    all_moved = group.all_gather(torch.stack(moved)).reshape(-1, 3).contiguous()
    all_cnt = group.all_gather(torch.stack(cnts)).reshape(-1)
    owner = so.shard_owner(all_moved, group.n_shards,
                           so.owner_inv(voxel_size, hierarchy_factor))
    fresh = []
    for k, v in enumerate(views):
        mine = (all_cnt > 0.0) & (owner == group.first + k)
        fresh.append(vm.bulk_build(all_moved, all_cnt, mine, rows, c1, voxel_size=voxel_size,
                                   planarity_threshold=planarity_threshold,
                                   hierarchy_factor=hierarchy_factor, n_dropped=v.n_dropped))
    return vm.VoxelMapState(**{
        name: (torch.stack if name in SCALARS else torch.cat)([getattr(f, name) for f in fresh])
        for name in vm.VoxelMapState._fields})


def gather_state(state: vm.VoxelMapState, group: ShardGroup) -> vm.VoxelMapState:
    """Every rank's shards of an unbatched state, in global shard order, on
    this rank (a debug or checkpoint read; one rank: the state itself)."""
    if group.world_size == 1:
        return state
    out = {}
    for name, a in state._asdict().items():
        if name in SCALARS:
            out[name] = group.all_gather(a)
        else:
            per = a.view((group.n_local, a.shape[0] // group.n_local) + tuple(a.shape[1:]))
            out[name] = group.all_gather(per).reshape((-1,) + tuple(a.shape[1:]))
    return vm.VoxelMapState(**out)
