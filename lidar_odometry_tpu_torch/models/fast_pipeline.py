"""Odometry over chunks of scans (counterpart of the JAX package's
models/fast_pipeline.py: OdomCarry, init_carry, make_chunk_runner and its
frame step; init_blocked_carry and make_blocked_runner).

Per frame: voxel filter (K1), ICP with PKO (surfel mode: K2a, K3, K2b per
iteration; KD-tree mode: K5a, K5b, K3, K2b), re-orthonormalisation, the constant-velocity model and the
keyframe decision (small torch ops on the device), and the map update
(K4a-c; K4a-b without surfels). The JAX runner is one lax.scan with the
keyframe branch as a lax.cond; here the branch is predicated on the
device: the update runs every frame, its inserts masked by the keyframe
flag and its eviction scan enabled on every 4th keyframe only, so a
non-keyframe's update leaves the map bit-equal to no update and the
frame step reads nothing on the host.

The blocked runner (multi-sequence serving) runs B independent sequences
over ONE shared map, lane b's world shifted by b * lane_spacing_m in x.
The per-frame part (`_make_pre`, shared with the single-stream frame
step) runs all lanes at once: one K1 launch, one K2a, K3 and K2b per ICP
iteration, each with one block row per lane. Frames go in blocks of
`block`; each block ends in ONE unconditional map update that inserts
every lane's keyframe features (masked per lane-frame, compacted to 1.5
keyframes per lane) with the B lane sensors for the eviction.

On the card both runners run a chunk as one captured CUDA graph, the
counterpart of the jitted lax.scan with its carry donated
(`GraphedChunk`): the first call of a shape runs the chunk eagerly as
the warm-up, the second captures it, and every later call of that shape
copies the scans in and replays. CPU tensors run the chunk eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..ops import icp as icp_ops
from ..ops import pko as pko_ops
from ..ops import voxel_filter as vf
from ..ops import voxel_map as vm
from ..utils import keys as K
from ..utils import lie

__all__ = ["OdomCarry", "init_carry", "make_chunk_runner", "init_blocked_carry",
           "make_blocked_runner", "GraphedChunk"]


class OdomCarry(NamedTuple):
    """The runners' state; the blocked runner's adds a leading B (lanes) to
    every field but the one shared map."""
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


def _make_pre(icp_cfg: icp_ops.ICPConfig, pko_consts: pko_ops.PKOConstants, *,
              scan_voxel_size: float, point_stride: int, scan_capacity: int,
              keyframe_distance: float, keyframe_rotation: float):
    """The per-frame pipeline with the map read-only: filter, ICP,
    re-orthonormalisation, velocity model and keyframe decision. pre(carry,
    raw (N, 3) or (B, N, 3), home=None or (B, 4, 4)) -> (T, velocity,
    is_kf, n_corr, feat, mask), with a leading B for lanes. `home` is the
    pose of a sequence's first frame: a lane's offset, or (None) the
    identity."""
    # the compact filter key whenever its +-512-voxel envelope covers a
    # 200 m return, as the JAX runner decides
    compact = vf.compact_keys_ok(scan_voxel_size, 200.0)
    kf_dist = K.f32(keyframe_distance)
    kf_rot = K.f32(keyframe_rotation)

    def pre(carry: OdomCarry, raw_scan: torch.Tensor, home=None):
        feat, mask, _ = vf.voxel_filter(
            raw_scan, raw_scan.shape[-2], voxel_size=scan_voxel_size,
            stride=point_stride, out_capacity=scan_capacity, compact_keys=compact)
        guess = carry.T_prev @ carry.velocity
        T_icp, _success, n_corr = icp_ops.icp_optimize(
            carry.map_state, feat, mask, guess, pko_consts, icp_cfg)
        # re-orthonormalise once per frame: the velocity recursion would
        # otherwise square any shear in R
        T_icp = lie.se3_matrix(lie.so3_project(T_icp[..., :3, :3]), T_icp[..., :3, 3])
        init = carry.initialized[..., None, None]
        eye = torch.eye(4, dtype=torch.float32, device=raw_scan.device)
        T = torch.where(init, T_icp, eye if home is None else home)
        velocity = torch.where(init, lie.se3_inv(carry.T_prev) @ T, eye)

        diff = T[..., :3, 3] - carry.last_kf_pose[..., :3, 3]
        dist = torch.linalg.norm(diff, dim=-1)
        R_rel = carry.last_kf_pose[..., :3, :3].transpose(-1, -2) @ T[..., :3, :3]
        cos_t = torch.clamp((_trace3(R_rel) - 1.0) * 0.5, -1.0, 1.0)
        angle = torch.arccos(cos_t)
        is_kf = (~carry.initialized) | (dist > kf_dist) | (angle > kf_rot)
        return T, velocity, is_kf, n_corr, feat, mask

    return pre


def _trace3(R: torch.Tensor) -> torch.Tensor:
    """Trace of (3, 3) or (B, 3, 3) matrices (torch.trace takes one matrix
    only, and sums in double on the CPU, so lanes round their own way)."""
    if R.dim() == 2:
        return torch.trace(R)
    return torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)


def make_chunk_runner(icp_cfg: icp_ops.ICPConfig, pko_consts: pko_ops.PKOConstants,
                      *, scan_voxel_size: float, point_stride: int,
                      scan_capacity: int, keyframe_distance: float,
                      keyframe_rotation: float, max_distance: float,
                      planarity_threshold: float, compute_surfels: bool = True,
                      return_features: bool = False, graph: bool = True):
    """Build chunk(carry, scans (F, N, 3)) -> (carry, (poses (F, 4, 4),
    is_kf (F,), n_corr (F,))) — plus (feats (F, cap, 3), masks (F, cap))
    with return_features=True. Scans are raw padded clouds whose pad rows
    are non-finite. compute_surfels=False keeps no surfels in the map, as
    KD-tree-mode ICP (icp_cfg.use_surfel_correspondence=False) needs none.
    The carry's buffers are updated in place: treat the carry passed in
    as consumed. graph=True runs CUDA chunks through `GraphedChunk`;
    graph=False runs them eagerly (to compare against)."""
    pre = _make_pre(icp_cfg, pko_consts, scan_voxel_size=scan_voxel_size,
                    point_stride=point_stride, scan_capacity=scan_capacity,
                    keyframe_distance=keyframe_distance, keyframe_rotation=keyframe_rotation)

    def frame_step(carry: OdomCarry, raw_scan: torch.Tensor):
        dev = raw_scan.device
        T, velocity, is_kf, n_corr, feat, mask = pre(carry, raw_scan)
        # the JAX runner's keyframe cond, predicated: a non-keyframe inserts
        # nothing and scans nothing for eviction, which leaves every map
        # tensor as it was; the radius-eviction scan runs on every 4th
        # keyframe
        map_state = vm.update_map(
            carry.map_state, lie.transform_points(T, feat), mask & is_kf, T[:3, 3],
            max_distance, voxel_size=icp_cfg.voxel_size,
            planarity_threshold=planarity_threshold,
            hierarchy_factor=icp_cfg.hierarchy_factor, compute_surfels=compute_surfels,
            evict_enabled=is_kf & (carry.kf_count % 4 == 0))
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

    return GraphedChunk(chunk) if graph else chunk


# ---------------------------------------------------------------------------
# blocked multi-sequence serving
# ---------------------------------------------------------------------------

def _lane_homes(batch: int, lane_spacing_m: float, device) -> torch.Tensor:
    """(B, 4, 4) identity poses shifted by b * lane_spacing_m in x, made on
    the device (no host-to-device copy)."""
    homes = torch.eye(4, dtype=torch.float32, device=device).repeat(batch, 1, 1)
    homes[:, 0, 3] = torch.arange(batch, dtype=torch.float32, device=device) * K.f32(
        lane_spacing_m)
    return homes


def init_blocked_carry(batch: int, c0: int, c1: int, lane_spacing_m: float = 1024.0,
                       device="cuda") -> OdomCarry:
    """Carry for the blocked shared-map runner: ONE map (size it B times the
    single-sequence capacity), per-lane pose state starting at each lane's
    coordinate offset."""
    homes = _lane_homes(batch, lane_spacing_m, device)
    return OdomCarry(
        map_state=vm.empty_map(c0, c1, device=device), T_prev=homes,
        velocity=torch.eye(4, dtype=torch.float32, device=device).repeat(batch, 1, 1),
        last_kf_pose=homes.clone(),
        initialized=torch.zeros((batch,), dtype=torch.bool, device=device),
        kf_count=torch.zeros((batch,), dtype=torch.int32, device=device))


def make_blocked_runner(icp_cfg: icp_ops.ICPConfig, pko_consts: pko_ops.PKOConstants, *,
                        batch: int, block: int = 4, lane_spacing_m: float = 1024.0,
                        scan_voxel_size: float, point_stride: int, scan_capacity: int,
                        keyframe_distance: float, keyframe_rotation: float,
                        max_distance: float, planarity_threshold: float,
                        graph: bool = True):
    """B independent sequences over ONE shared map at disjoint x offsets
    (lane b at b * lane_spacing_m, far beyond the eviction radius, so lanes
    never interact; eviction takes the min distance over the B lane
    sensors). Frames go in blocks of `block`, and each block ends in ONE
    unconditional update that inserts every lane's keyframe features:
    lookups lag keyframes by at most block - 1 frames. Lanes work in the
    offset frame, as the JAX runner does; only the reported poses have the
    offsets removed.

    chunk(carry, scans (B, F, N, 3)) -> (carry, (poses (B, F, 4, 4),
    is_kf (B, F), n_corr (B, F))). F must be a multiple of `block`. The
    eviction scan runs on the blocks whose index, counted from 0 in each
    chunk call, is a multiple of 4. The carry's buffers are updated in
    place: treat the carry passed in as consumed. graph=True runs CUDA
    chunks through `GraphedChunk`; graph=False runs them eagerly."""
    pre = _make_pre(icp_cfg, pko_consts, scan_voxel_size=scan_voxel_size,
                    point_stride=point_stride, scan_capacity=scan_capacity,
                    keyframe_distance=keyframe_distance, keyframe_rotation=keyframe_rotation)
    ins_cap = (batch * scan_capacity * 3) // 2

    def chunk(carry: OdomCarry, scans: torch.Tensor):
        b, f, dev = scans.shape[0], scans.shape[1], scans.device
        if b != batch or f % block:
            raise ValueError(f"blocked runner: scans of shape {tuple(scans.shape)}, expected "
                             f"({batch}, a multiple of {block}, N, 3)")
        # made on the device once a call: no host-to-device copy in the loop
        homes = _lane_homes(batch, lane_spacing_m, dev)
        offs = homes - torch.eye(4, dtype=torch.float32, device=dev)   # reported-pose offsets
        evict_on = torch.ones((), dtype=torch.bool, device=dev)
        evict_off = torch.zeros((), dtype=torch.bool, device=dev)
        poses, kfs, ncs = [], [], []
        for blk_i in range(f // block):
            ins_pts, ins_msk = [], []
            for j in range(block):
                T, velocity, is_kf, n_corr, feat, mask = pre(
                    carry, scans[:, blk_i * block + j], homes)
                carry = OdomCarry(
                    map_state=carry.map_state, T_prev=T, velocity=velocity,
                    last_kf_pose=torch.where(is_kf[:, None, None], T, carry.last_kf_pose),
                    initialized=torch.ones_like(carry.initialized),
                    kf_count=carry.kf_count + is_kf.to(torch.int32))
                # keyframe features in the (offset) world frame, masked per lane
                ins_pts.append(lie.transform_points(T, feat))
                ins_msk.append(mask & is_kf[:, None])
                poses.append(T - offs)
                kfs.append(is_kf)
                ncs.append(n_corr)
            pts_all = torch.cat(ins_pts).reshape(-1, 3)
            msk_all = torch.cat(ins_msk).reshape(-1)
            # compact the live inserts to 1.5 keyframes per lane; what
            # does not fit is dropped and counted in n_dropped
            overflow = None
            p_raw = pts_all.shape[0]
            if ins_cap < p_raw:
                keep_idx, n_live = vm._compact(msk_all, ins_cap)
                msk_all = keep_idx >= 0
                pts_all = torch.where(msk_all[:, None],
                                      pts_all[torch.clamp(keep_idx, 0, p_raw - 1)], 0.0)
                overflow = torch.clamp(n_live - ins_cap, min=0).to(torch.int32)
            map_state = vm.update_map(
                carry.map_state, pts_all, msk_all, carry.T_prev[:, :3, 3], max_distance,
                voxel_size=icp_cfg.voxel_size, planarity_threshold=planarity_threshold,
                hierarchy_factor=icp_cfg.hierarchy_factor,
                evict_enabled=evict_on if blk_i % 4 == 0 else evict_off)
            if overflow is not None:
                map_state = map_state._replace(n_dropped=map_state.n_dropped + overflow)
            carry = carry._replace(map_state=map_state)
        return carry, (torch.stack(poses, 1), torch.stack(kfs, 1), torch.stack(ncs, 1))

    return GraphedChunk(chunk) if graph else chunk


# ---------------------------------------------------------------------------
# a chunk as one captured CUDA graph
# ---------------------------------------------------------------------------

def _leaves(carry: OdomCarry) -> list:
    return list(carry.map_state) + list(carry[1:])


def _from_leaves(leaves: list) -> OdomCarry:
    n = len(vm.VoxelMapState._fields)
    return OdomCarry(vm.VoxelMapState(*leaves[:n]), *leaves[n:])


class CapturedChunk(NamedTuple):
    """One captured chunk: the graph, its static scans and outputs, and
    what its capture launched (`kernels.Capture`)."""
    graph: torch.cuda.CUDAGraph
    scans: torch.Tensor
    outs: tuple
    capture: kernels.Capture


class GraphedChunk:
    """chunk(carry, scans) run as one CUDA graph per shape on the card.

    Keyed by the carry's and the scans' shapes (a map of another capacity
    is another key), the first call of a key runs the chunk eagerly on the
    runner's capture stream: the warm-up that builds the kernels, makes
    the libraries' state and allocates the kept scratch (never a frame run
    twice: the carry is updated in place). The second call captures the
    chunk on that stream, in thread_local mode so that the loop worker's
    thread neither breaks the capture nor lands in it, with the carry in
    static buffers shared by every graph of that carry shape. Each call
    from then on copies in any carry tensor that is not already its buffer
    (the first call, a restored or rehashed map, a carry rebuilt from
    host state), copies the scans in, replays, adds the captured kernel
    launches to `kernels.counts()` (and one to `replays`), and returns the
    carry buffers and clones of the outputs, which outlive the next
    replay. A failed capture
    or replay raises; nothing falls back to the eager chunk. CPU tensors
    run the chunk eagerly."""

    def __init__(self, chunk):
        self.eager = chunk
        self.graphs: dict = {}      # key -> CapturedChunk
        self.replays = 0
        self._warm: set = set()
        self._carries: dict = {}    # carry shapes -> static carry leaves
        self._stream = None

    def __call__(self, carry: OdomCarry, scans: torch.Tensor):
        if not scans.is_cuda:
            return self.eager(carry, scans)
        leaves = _leaves(carry)
        ckey = tuple((tuple(t.shape), t.dtype) for t in leaves)
        key = (ckey, tuple(scans.shape))
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=scans.device)
        cap = self.graphs.get(key)
        if cap is None:
            if key not in self._warm:
                self._warm.add(key)
                return self._warm_up(carry, scans)
            cap = self.graphs[key] = self._capture(ckey, leaves, scans)
        static = self._carries[ckey]
        for dst, src in zip(static, leaves):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        cap.scans.copy_(scans)
        cap.graph.replay()
        self.replays += 1
        kernels.add_replay(cap.capture)
        return _from_leaves(static), tuple(o.clone() for o in cap.outs)

    def _warm_up(self, carry, scans):
        cur = torch.cuda.current_stream(scans.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self.eager(carry, scans)
        cur.wait_stream(self._stream)
        return out

    def _capture(self, ckey, leaves, scans) -> CapturedChunk:
        static = self._carries.get(ckey)
        if static is None:
            static = self._carries[ckey] = [torch.empty_like(t) for t in leaves]
        static_scans = torch.empty_like(scans)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with kernels.capturing() as capture:
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                carry, outs = self.eager(_from_leaves(static), static_scans)
                for dst, src in zip(static, _leaves(carry)):
                    if (src.shape, src.dtype) != (dst.shape, dst.dtype):
                        raise ValueError(f"the chunk turned a carry tensor of {dst.dtype} "
                                         f"{tuple(dst.shape)} into {src.dtype} "
                                         f"{tuple(src.shape)}: it cannot be captured")
                    if src.data_ptr() != dst.data_ptr():
                        dst.copy_(src)
        graph.instantiate()
        return CapturedChunk(graph, static_scans, outs, capture)
