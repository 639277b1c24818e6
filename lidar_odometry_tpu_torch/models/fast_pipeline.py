"""Single-stream odometry over chunks of scans (counterpart of
the JAX package's models/fast_pipeline.py: OdomCarry, init_carry,
make_chunk_runner and its frame step).

Per frame: voxel filter (K1), ICP with PKO (surfel mode: K2a, K3, K2b per
iteration; KD-tree mode: K5a, K5b, K3, K2b), re-orthonormalisation, the constant-velocity model and the
keyframe decision (small torch ops on the device), and on keyframes the
map update (K4a-c; K4a-b without surfels). The JAX runner is one lax.scan with the keyframe
branch as a lax.cond; here the chunk is a Python loop over frames that
reads the keyframe flag to the host once per frame to take the branch.
That read is the slice's one host sync per frame; everything else stays
on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import icp as icp_ops
from ..ops import pko as pko_ops
from ..ops import voxel_filter as vf
from ..ops import voxel_map as vm
from ..utils import keys as K
from ..utils import lie

__all__ = ["OdomCarry", "init_carry", "make_chunk_runner"]


class OdomCarry(NamedTuple):
    map_state: vm.VoxelMapState
    T_prev: torch.Tensor        # (4, 4) previous frame pose
    velocity: torch.Tensor      # (4, 4) constant-velocity model
    last_kf_pose: torch.Tensor  # (4, 4)
    initialized: torch.Tensor   # () bool
    kf_count: torch.Tensor      # () int32


def init_carry(c0: int, c1: int, device="cuda") -> OdomCarry:
    eye = lambda: torch.eye(4, dtype=torch.float32, device=device)
    return OdomCarry(
        map_state=vm.empty_map(c0, c1, device=device), T_prev=eye(),
        velocity=eye(), last_kf_pose=eye(),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        kf_count=torch.zeros((), dtype=torch.int32, device=device))


def make_chunk_runner(icp_cfg: icp_ops.ICPConfig, pko_consts: pko_ops.PKOConstants,
                      *, scan_voxel_size: float, point_stride: int,
                      scan_capacity: int, keyframe_distance: float,
                      keyframe_rotation: float, max_distance: float,
                      planarity_threshold: float, compute_surfels: bool = True,
                      return_features: bool = False):
    """Build chunk(carry, scans (F, N, 3)) -> (carry, (poses (F, 4, 4),
    is_kf (F,), n_corr (F,))) — plus (feats (F, cap, 3), masks (F, cap))
    with return_features=True. Scans are raw padded clouds whose pad rows
    are non-finite. compute_surfels=False keeps no surfels in the map, as
    KD-tree-mode ICP (icp_cfg.use_surfel_correspondence=False) needs none.
    The carry's buffers are updated in place: treat the carry passed in
    as consumed."""
    # the compact filter key whenever its +-512-voxel envelope covers a
    # 200 m return, as the JAX runner decides
    compact = vf.compact_keys_ok(scan_voxel_size, 200.0)
    kf_dist = K.f32(keyframe_distance)
    kf_rot = K.f32(keyframe_rotation)

    def frame_step(carry: OdomCarry, raw_scan: torch.Tensor):
        dev = raw_scan.device
        feat, mask, _ = vf.voxel_filter(
            raw_scan, raw_scan.shape[0], voxel_size=scan_voxel_size,
            stride=point_stride, out_capacity=scan_capacity, compact_keys=compact)
        guess = carry.T_prev @ carry.velocity
        T_icp, _success, n_corr = icp_ops.icp_optimize(
            carry.map_state, feat, mask, guess, pko_consts, icp_cfg)
        # re-orthonormalise once per frame: the velocity recursion would
        # otherwise square any shear in R
        T_icp = lie.se3_matrix(lie.so3_project(T_icp[:3, :3]), T_icp[:3, 3])
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        T = torch.where(carry.initialized, T_icp, eye)
        velocity = torch.where(carry.initialized, lie.se3_inv(carry.T_prev) @ T, eye)

        diff = T[:3, 3] - carry.last_kf_pose[:3, 3]
        dist = torch.linalg.norm(diff)
        R_rel = carry.last_kf_pose[:3, :3].T @ T[:3, :3]
        cos_t = torch.clamp((torch.trace(R_rel) - 1.0) * 0.5, -1.0, 1.0)
        angle = torch.arccos(cos_t)
        is_kf = (~carry.initialized) | (dist > kf_dist) | (angle > kf_rot)

        map_state = carry.map_state
        if bool(is_kf):   # the slice's one host read per frame
            world = lie.transform_points(T, feat)
            map_state = vm.update_map(
                map_state, world, mask, T[:3, 3], max_distance,
                voxel_size=icp_cfg.voxel_size,
                planarity_threshold=planarity_threshold,
                hierarchy_factor=icp_cfg.hierarchy_factor,
                compute_surfels=compute_surfels,
                evict_enabled=(carry.kf_count % 4 == 0))
        new_carry = OdomCarry(
            map_state=map_state, T_prev=T, velocity=velocity,
            last_kf_pose=torch.where(is_kf, T, carry.last_kf_pose),
            initialized=torch.ones((), dtype=torch.bool, device=dev),
            kf_count=carry.kf_count + is_kf.to(torch.int32))
        return new_carry, (T, is_kf, n_corr, feat, mask)

    def chunk(carry: OdomCarry, scans: torch.Tensor):
        outs = []
        for f in range(scans.shape[0]):
            carry, out = frame_step(carry, scans[f])
            outs.append(out)
        cols = [torch.stack(c) for c in zip(*outs)]
        return carry, tuple(cols if return_features else cols[:3])

    return chunk
