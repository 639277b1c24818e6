"""The map backend behind the Estimator front door (counterpart of the JAX
package's models/map_backend.py, SingleChipMapBackend).

One device holds the whole map: the backend owns the map's device and
gives the Estimator the device-side map operations it needs (empty map,
ICP, keyframe update, rehash after a loop correction). The sharded backend
comes with the multi-GPU slice (ROADMAP queue 1, slice 6b).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import icp as icp_ops
from ..ops import voxel_map as vm

__all__ = ["SingleChipMapBackend"]


class SingleChipMapBackend:
    """The default backend: one device holds the whole map."""

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

    def rehash(self, state, correction):
        """The map moved by a pose-graph correction (4, 4), rebuilt into a
        fresh state (ops/voxel_map.py transform_and_rehash)."""
        T = torch.as_tensor(np.asarray(correction, np.float32), device=self.device)
        return vm.transform_and_rehash(
            state, T, voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor())
