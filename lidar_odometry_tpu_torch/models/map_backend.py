"""The map backends behind the Estimator front door (counterpart of the JAX
package's models/map_backend.py).

A backend gives the Estimator the device-side map operations it needs:
the empty map, the odometry ICP, the keyframe update and the rehash after
a loop correction. Everything else in the Estimator is backend-agnostic,
and the loop-closure ICP stays on one device in both: it aligns keyframe
clouds, never the map.

  * SingleChipMapBackend: one device holds the whole map.
  * ShardedMapBackend: the map sharded by parent cell over a ShardGroup
    (parallel/sharded_map.py): the distributed robust ICP, shard-local
    keyframe updates (optionally batched K at a time) and the all_gather
    rebuild on a loop correction. Surfel mode only: a query routes to its
    parent cell's owner, which KD-tree mode's neighbourhoods would cross.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import icp as icp_ops
from ..ops import voxel_map as vm
from ..parallel import sharded_map as sm

__all__ = ["SingleChipMapBackend", "ShardedMapBackend"]


class SingleChipMapBackend:
    """The default backend: one device holds the whole map."""

    name = "single"

    def __init__(self, config, device="cuda"):
        self.cfg = config
        self.device = device

    def empty(self) -> vm.VoxelMapState:
        return vm.empty_map(self.cfg.map_l0_capacity, self.cfg.map_l1_capacity,
                            device=self.device)

    def icp_optimize(self, state, pts, mask, T_init, pko_consts, icp_cfg):
        return icp_ops.icp_optimize(state, pts, mask, T_init, pko_consts, icp_cfg)

    def update(self, state, world_pts, mask, sensor_pos, max_distance, evict_enabled=None):
        return vm.update_map(
            state, world_pts, mask, sensor_pos, max_distance,
            voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor(),
            compute_surfels=self.cfg.use_surfel_correspondence,
            evict_enabled=evict_enabled)

    def counts(self, state) -> dict:
        return {k: int(getattr(state, k)) for k in ("n_l0", "n_l1", "n_dropped")}

    def rehash(self, state, correction, flush: bool = True):
        """The map moved by a pose-graph correction (4, 4), rebuilt into a
        fresh state (ops/voxel_map.py transform_and_rehash). `flush` is
        accepted for the sharded backend's signature."""
        del flush
        T = torch.as_tensor(np.asarray(correction, np.float32), device=self.device)
        return vm.transform_and_rehash(
            state, T, voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor())


class ShardedMapBackend:
    """The map sharded over `group` (parallel/mesh.py ShardGroup): the
    configured capacities are totals over the group's S shards, and
    map_l1_capacity must divide by S.

    config.sharded_update_batch K > 1 holds keyframe inserts and runs K
    of them in one update: the first K updates run at once (the first
    keyframes must reach the map), then a batch runs when K are pending,
    padded with zero-mask copies by flush();
    its eviction radius is taken around the newest keyframe. Lookups lag
    the map by at most K - 1 keyframes. `owned_overflow` counts, on the
    device, the owned points that ICP and updates dropped past the
    per-shard capacity (the JAX program drops them silently)."""

    name = "sharded"

    def __init__(self, config, group):
        if not config.use_surfel_correspondence:
            raise ValueError("ShardedMapBackend requires use_surfel_correspondence=True")
        if config.map_l1_capacity % group.n_shards:
            raise ValueError(f"map_l1_capacity {config.map_l1_capacity} is not divisible by "
                             f"{group.n_shards} shards")
        self.cfg = config
        self.group = group
        self.device = group.device
        self.update_batch = config.sharded_update_batch
        self._pend = []        # [(world_pts, mask, sensor)] device tensors
        self._n_updates = 0
        self.owned_overflow = torch.zeros((), dtype=torch.int64, device=self.device)

    def empty(self) -> vm.VoxelMapState:
        """A fresh sharded map; the batching and overflow counts start over
        with it."""
        self._pend, self._n_updates = [], 0
        self.owned_overflow.zero_()
        return sm.sharded_empty_map(self.cfg.map_l0_capacity, self.cfg.map_l1_capacity,
                                    self.group)

    def icp_optimize(self, state, pts, mask, T_init, pko_consts, icp_cfg):
        return sm.sharded_icp_optimize(state, pts, mask, T_init, self.group, icp_cfg,
                                       pko_consts, overflow=self.owned_overflow)

    def _dispatch_update(self, state, world_pts, mask, sensor_pos, max_distance):
        return sm.sharded_update_map(
            state, world_pts, mask, sensor_pos, max_distance, self.group,
            voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor(),
            compute_surfels=self.cfg.use_surfel_correspondence,
            overflow=self.owned_overflow)

    def update(self, state, world_pts, mask, sensor_pos, max_distance, evict_enabled=None):
        """The keyframe update. `evict_enabled` is accepted for the front
        door's signature: the sharded update evicts on every update it
        runs (a batch of K already spaces them K keyframes apart)."""
        del evict_enabled
        self._n_updates += 1
        if self.update_batch <= 1 or self._n_updates <= self.update_batch:
            return self._dispatch_update(state, world_pts, mask, sensor_pos, max_distance)
        self._pend.append((world_pts, mask, sensor_pos))
        if len(self._pend) < self.update_batch:
            return state
        return self._flush_pending(state, max_distance)

    def _flush_pending(self, state, max_distance):
        k = self.update_batch
        pend = self._pend + [(self._pend[0][0], torch.zeros_like(self._pend[0][1]),
                              self._pend[-1][2])] * (k - len(self._pend))
        self._pend = []
        pts = torch.cat([p for p, _, _ in pend])
        msk = torch.cat([m for _, m, _ in pend])
        return self._dispatch_update(state, pts, msk, pend[-1][2], max_distance)

    def flush(self, state):
        """Insert the pending keyframes now (before reading the map's
        content or applying a correction)."""
        if not self._pend:
            return state
        return self._flush_pending(state, self.cfg.max_range * 1.2)

    def counts(self, state) -> dict:
        return sm.shard_counts(state)

    def rehash(self, state, correction, flush: bool = True):
        """The sharded map moved by a pose-graph correction (4, 4): pending
        inserts, in the frame before the correction, land first (with
        `flush`), then the all_gather rebuild into a fresh state."""
        if flush:
            state = self.flush(state)
        T = torch.as_tensor(np.asarray(correction, np.float32), device=self.device)
        return sm.sharded_transform_and_rehash(
            state, T, self.group, voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor())
