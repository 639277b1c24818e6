"""The data x map odometry step (counterpart of the JAX package's
parallel/pipeline.py): B independent sequences (lanes, the data axis),
each against its own map sharded over the group's S shards (the map
axis).

One step = the distributed robust ICP of every lane (sharded_map
robust_icp_loop: K11a once, then one K2a launch over every lane and
shard, K11b, K11c and one all_gather of the rows, K11d per iteration) -> the pose's rotation
projected onto SO(3) -> a masked shard-local keyframe update of every
lane's map on its owned subset of the scan (K11a, then K4a-c per lane and
shard). A lane that is not a keyframe inserts nothing and evicts nothing
(its mask is empty and its eviction gated off, which the JAX step writes
as max_distance 1e30), so the flags need no host read.
"""
from __future__ import annotations

import torch

from ..ops import icp as icp_ops
from ..ops import voxel_map as vm
from ..utils import lie
from . import shard_ops as so
from .mesh import ShardGroup
from .sharded_map import local_views, owned_cap, robust_icp_loop, set_local, \
    sharded_empty_map

__all__ = ["multichip_odometry_step", "batched_sharded_map_state"]


def batched_sharded_map_state(batch: int, c0_total: int, c1_total: int,
                              group: ShardGroup) -> vm.VoxelMapState:
    """B empty sharded maps: tables (B, n_local * (rows + 1), ...), scalars
    (B, n_local)."""
    return sharded_empty_map(c0_total, c1_total, group, batch=batch)


def multichip_odometry_step(group: ShardGroup, cfg: icp_ops.ICPConfig, *,
                            update_max_distance: float = 120.0,
                            planarity_threshold: float = 0.1, pko_consts=None):
    """Returns step(state, pts, mask, T, is_keyframe) -> (T_new, state):
    state per batched_sharded_map_state, pts (B, N, 3) body features with
    mask (B, N), T (B, 4, 4) the pose guesses, is_keyframe (B,) bool (a
    tensor on the group's device). The state is updated in place and
    returned."""

    def step(state, pts, mask, T, is_keyframe):
        lanes, n = pts.shape[0], pts.shape[1]
        views = local_views(state, lanes)
        T_new, _success, _n, _over = robust_icp_loop(views, group, pts, mask, T, cfg,
                                                     pko_consts)
        T_new = lie.se3_matrix(lie.so3_project(T_new[:, :3, :3]), T_new[:, :3, 3])
        world = lie.transform_points(T_new, pts).contiguous()
        kf = is_keyframe.to(device=pts.device, dtype=torch.bool)
        cap = owned_cap(n, group.n_shards)
        w_own, ok, _, _ = so.shard_own(world, (mask & kf[:, None]).contiguous(), None,
                                       group.n_shards, group.first, group.n_local, cap,
                                       so.owner_inv(cfg.voxel_size, cfg.hierarchy_factor))
        for b in range(lanes):
            for k in range(group.n_local):
                i = b * group.n_local + k
                out = vm.update_map(views[b][k], w_own[i], ok[i], T_new[b, :3, 3],
                                    update_max_distance, voxel_size=cfg.voxel_size,
                                    planarity_threshold=planarity_threshold,
                                    hierarchy_factor=cfg.hierarchy_factor,
                                    evict_enabled=kf[b])
                set_local(state, k, out, lane=b)
        return T_new, state

    return step
