"""The SLAM front door (counterpart of the JAX package's
models/estimator.py).

`process_frame` runs one scan: preprocess (voxel filter) -> ICP against
the map with a constant-velocity guess -> velocity update -> keyframe
decision -> keyframe record, pose-graph odometry factor, map update and
loop query. `process_chunk` runs a chunk of scans through the fused chunk
runner (models/fast_pipeline.py; on the card one captured CUDA graph a
chunk length, GraphedChunk) and does the same host bookkeeping
afterwards, optionally deferred (loops off) so that consecutive chunks run
with no host round trip. The runner copies in a carry that is not its
graph's buffers (the first chunk, a restore, the map rehashed after a
pose-graph optimisation, a carry rebuilt after process_frame) and hands
back clones of the outputs, so deferred feature clouds outlive the next
replay; a player's sampled chunks (one frame shorter) get a graph of
their own. Poses, keyframe records and the pose graph live
on the host; the map, the chunk carry and the Iris DB stay on the device.

Loop closure: a keyframe's loop query runs Iris detection
(models/loop_closure.py), the loop-closure solve (ops/icp.py) and the
pose-graph optimisation (the host "manual" backend, or the float64 device
solve of the "distributed" one), then posts a result that the main thread
applies before its next frame or chunk: keyframe poses, the map rehash
(ops/voxel_map.py transform_and_rehash) and the live pose. With
sync_loop=True the query runs inline; otherwise a worker thread takes the
newest query and launches its kernels on its own CUDA stream, after an
event that the main stream recorded when it queued the keyframe. The
worker logs an error and carries on, as the JAX worker does; every such
error is counted in `loop_errors`. The rehash always launches from the
main thread, on the stream that owns the map.

The map lives behind a backend (models/map_backend.py): one device, or the
map sharded over a ShardGroup (ShardedMapBackend, BASELINE config 5),
which runs through process_frame only. With more than one rank every rank
must issue the same collectives in the same order: the same scans, and
the loop queries inline (sync_loop=True), so that each rank rehashes at
the same frame.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..ops import icp, iris, pko
from ..ops import voxel_filter as vf
from ..ops import voxel_map as vm
from ..utils import lie
from ..utils import logging_util as log
from . import fast_pipeline as fp
from .loop_closure import LoopCandidate, LoopClosureConfig, LoopClosureDetector
from .map_backend import SingleChipMapBackend
from .pose_graph import PoseGraphOptimizer

__all__ = ["Estimator", "KeyframeRecord", "FrameRecord", "TimingStats"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class KeyframeRecord:
    """Host-side keyframe state. The feature cloud of a keyframe older than
    the window (`keyframe.window_size`) spills its live points to disk and
    reloads on the rare paths that read it (loop-closure ICP against a
    matched old keyframe, map export). A cloud may also be a device tensor
    (deferred chunk ingest, loops off) until something reads it."""

    __slots__ = ("kf_id", "stored_pose", "relative_pose", "frame_index",
                 "_cloud", "_mask", "_spill_path")

    def __init__(self, kf_id, stored_pose, relative_pose, feature_cloud,
                 feature_mask, frame_index=-1):
        self.kf_id = kf_id
        self.stored_pose = stored_pose
        self.relative_pose = relative_pose
        self.frame_index = frame_index
        self._cloud = feature_cloud
        self._mask = feature_mask
        self._spill_path = None

    @property
    def feature_cloud(self) -> np.ndarray:
        c = self._cloud
        if c is not None:
            if not isinstance(c, np.ndarray):
                c = _host(c)
                self._cloud = c
            return c
        live = np.load(self._spill_path)["pts"]
        out = np.zeros((self._mask.shape[0], 3), np.float32)
        out[self._mask] = live
        return out

    @property
    def feature_mask(self) -> np.ndarray:
        return self._mask

    @property
    def is_spilled(self) -> bool:
        return self._cloud is None

    def spill(self, directory: str) -> None:
        """Write the live points to disk and release the copy in memory
        (idempotent)."""
        if self._cloud is None:
            return
        path = os.path.join(directory, f"kf_{self.kf_id:06d}.npz")
        np.savez(path, pts=self.feature_cloud[self._mask])
        self._spill_path = path
        self._cloud = None


@dataclass
class FrameRecord:
    """Per-frame trajectory record. A non-keyframe's pose is its reference
    keyframe's pose times `relative_pose`, derived when read."""
    kf_ref: int                         # index into keyframes; -1 if none
    relative_pose: np.ndarray           # from the reference keyframe
    is_keyframe: bool
    kf_index: int = -1                  # own keyframe index if keyframe


@dataclass
class TimingStats:
    preprocessing_ms: float = 0.0
    icp_ms: float = 0.0
    map_update_ms: float = 0.0
    total_ms: float = 0.0


@dataclass
class PGOResult:
    last_optimized_kf_id: int
    optimized_poses: Dict[int, np.ndarray]
    last_kf_correction: np.ndarray


class Estimator:
    def __init__(self, config: SystemConfig, sync_loop: bool = False, device="cuda",
                 map_backend=None):
        """`sync_loop` runs each loop query inline at its keyframe (the
        deterministic mode); else a worker thread runs them. `map_backend`
        (None: SingleChipMapBackend on `device`) holds the map; a
        ShardedMapBackend must live on `device`."""
        self.cfg = config
        self.sync_loop = sync_loop
        self.device = device
        self.backend = map_backend or SingleChipMapBackend(config, device=device)
        if torch.device(self.backend.device) != torch.device(device):
            raise ValueError(f"the map backend lives on {self.backend.device}, the estimator "
                             f"on {device}")
        group = getattr(self.backend, "group", None)
        if group is not None and group.world_size > 1 and not sync_loop:
            raise ValueError(
                "a map sharded over more than one rank needs sync_loop=True: every rank must "
                "issue the same collectives in the same order, and a loop worker thread "
                "would rehash each rank's map at a different frame")

        self.icp_cfg = icp.ICPConfig(
            max_iterations=config.max_iterations,
            translation_tolerance=config.translation_threshold,
            rotation_tolerance=config.rotation_threshold,
            max_correspondence_distance=config.max_correspondence_distance,
            min_correspondence_points=config.min_correspondence_points,
            use_robust_loss=True,
            robust_loss_delta=0.1,
            use_surfel_correspondence=config.use_surfel_correspondence,
            loss_type=config.loss_type,
            use_adaptive_m_estimator=config.use_adaptive_m_estimator,
            voxel_size=config.map_voxel_size,
            hierarchy_factor=config.derived_hierarchy_factor(),
        )
        self.pko_consts = pko.make_pko_constants(
            config.min_scale_factor, config.max_scale_factor,
            config.num_alpha_segments, config.truncated_threshold,
            config.pko_kernel_type, config.gmm_components,
            config.gmm_sample_size, device=device)
        self.loop_detector = LoopClosureDetector(
            LoopClosureConfig(
                enable_loop_detection=config.enable_loop_detection,
                similarity_threshold=config.similarity_threshold,
                min_keyframe_gap=config.min_keyframe_gap,
                max_search_distance=config.max_search_distance,
                enable_debug_output=config.enable_debug_output),
            capacity=config.keyframe_capacity, device=device)
        self._chunk_runner = None
        self._spool_dir: Optional[str] = None   # keyframe cloud spill dir

        # the loop worker: queries (newest wins) under _query_cv; reset()
        # bumps the generation and waits for the worker to go idle, so an
        # in-flight query can neither touch the fresh state nor post a
        # result whose keyframe ids alias the new sequence's
        self._query_queue: deque = deque()
        self._query_cv = threading.Condition()
        self._result_lock = threading.Lock()
        self._keyframes_lock = threading.Lock()
        self._stage_lock = threading.Lock()
        self._generation = 0
        self._worker_busy = False
        self._thread_running = False
        self._thread: Optional[threading.Thread] = None
        self._loop_stream = (torch.cuda.Stream(device=torch.device(device))
                             if torch.device(device).type == "cuda" else None)
        self._init_state()
        if not sync_loop and config.enable_loop_detection:
            self._start_worker()

    def _init_state(self) -> None:
        self.map_state = self.backend.empty()
        self.pose_graph = PoseGraphOptimizer(backend=self.cfg.pgo_backend, device=self.device)
        self.initialized = False
        self.T_current = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_keyframe_pose = np.eye(4, dtype=np.float32)
        self._prev_pose = np.eye(4, dtype=np.float32)
        self.next_keyframe_id = 0
        with self._keyframes_lock:
            self.keyframes: List[KeyframeRecord] = []
        self.frames: List[FrameRecord] = []
        self.last_successful_loop_kf_id = -1
        with self._result_lock:
            self._pending_result: Optional[PGOResult] = None
        self._drop_spool()
        self.timing_history: List[TimingStats] = []
        self.frame_count = 0
        self.loop_constraint_count = 0
        self.loop_icp_attempts = 0
        self.loop_errors = 0
        self.rehash_count = 0
        with self._stage_lock:
            self._loop_stage_ms: Dict[str, float] = {}
        self._chunk_carry = None        # the device-resident odometry carry
        self._deferred_chunks = []      # packed results awaiting bookkeeping
        # the last per-frame-path frame's feature cloud, its mask and its
        # pre-ICP pose, as device tensors: the viewer's scan and debug
        # clouds, fetched when it draws
        self._last_feat = self._last_mask = self._last_icp_guess = None

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # Per-frame path
    # ------------------------------------------------------------------

    def process_frame(self, raw_points, n_points: Optional[int] = None) -> bool:
        """Process one scan: `raw_points` is (N, 3) float32, numpy or a
        tensor, padded (non-finite pad rows) or exact; `n_points` marks the
        valid leading rows when padded. Chunks still deferred are drained
        first: this path reads the host pose state they bring."""
        t_start = time.perf_counter()
        timing = TimingStats()
        if raw_points is None or len(raw_points) == 0:
            log.warn("[Estimator] Invalid frame or point cloud")
            return False
        if n_points is None:
            n_points = len(raw_points)
        if self._deferred_chunks:
            self.drain_chunks()
        self._apply_pending_pgo_result_if_available()

        t0 = time.perf_counter()
        feat, mask, _ = self._preprocess(raw_points, n_points)
        timing.preprocessing_ms = (time.perf_counter() - t0) * 1e3

        if not self.initialized:
            self._initialize_first_frame(feat, mask)
            timing.total_ms = (time.perf_counter() - t_start) * 1e3
            self._record_timing(timing)
            return True

        t0 = time.perf_counter()
        guess = self._t(self._prev_pose) @ self._t(self.velocity)
        T_dev, _success, _n_corr = self.backend.icp_optimize(
            self.map_state, feat, mask, guess, self.pko_consts, self.icp_cfg)
        T_new = _host(T_dev)
        self._last_icp_guess = guess
        timing.icp_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        self.T_current = self._normalize_rotation(T_new)
        self.velocity = np.linalg.inv(self._prev_pose) @ self.T_current
        kf_ref = len(self.keyframes) - 1
        rel = np.linalg.inv(self.keyframes[kf_ref].stored_pose) @ self.T_current
        frame = FrameRecord(kf_ref=kf_ref, relative_pose=rel.astype(np.float32),
                            is_keyframe=False)
        self.frames.append(frame)
        if self._should_create_keyframe(self.T_current):
            self._create_keyframe(feat, mask, frame)
        timing.map_update_ms = (time.perf_counter() - t0) * 1e3

        self._prev_pose = self.T_current
        self._last_feat, self._last_mask = feat, mask
        # the host pose state moved on outside the chunk path: the
        # device-resident chunk carry no longer matches it
        self._chunk_carry = None
        timing.total_ms = (time.perf_counter() - t_start) * 1e3
        self._record_timing(timing)
        return True

    def _preprocess(self, raw_points, n_points: int):
        """Stride + voxel downsample; the downsampled cloud is the feature
        cloud."""
        if isinstance(raw_points, torch.Tensor):
            raw = raw_points.to(device=self.device, dtype=torch.float32).contiguous()
        else:
            raw = self._t(np.ascontiguousarray(raw_points, dtype=np.float32))
        return vf.voxel_filter(
            raw, min(n_points, len(raw_points)), voxel_size=self.cfg.voxel_size,
            stride=self.cfg.point_stride, out_capacity=self.cfg.scan_capacity,
            compact_keys=vf.compact_keys_ok(self.cfg.voxel_size, 200.0))

    def _initialize_first_frame(self, feat, mask):
        self.T_current = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        frame = FrameRecord(kf_ref=-1, relative_pose=np.eye(4, dtype=np.float32),
                            is_keyframe=False)
        self.frames.append(frame)
        self._create_keyframe(feat, mask, frame)
        self._prev_pose = self.T_current
        self._last_feat, self._last_mask = feat, mask
        self.initialized = True

    def _should_create_keyframe(self, pose: np.ndarray) -> bool:
        """Distance / rotation thresholds against the last keyframe pose."""
        if not self.keyframes:
            return True
        diff = pose[:3, 3] - self.last_keyframe_pose[:3, 3]
        distance = float(np.linalg.norm(diff))
        R_rel = self.last_keyframe_pose[:3, :3].T @ pose[:3, :3]
        cos_t = np.clip((np.trace(R_rel) - 1.0) * 0.5, -1.0, 1.0)
        angle = float(np.arccos(cos_t))
        return (distance > self.cfg.keyframe_distance_threshold
                or angle > self.cfg.keyframe_rotation_threshold)

    @staticmethod
    def _normalize_rotation(T: np.ndarray) -> np.ndarray:
        """SVD projection of the rotation block onto SO(3)."""
        U, _, Vt = np.linalg.svd(T[:3, :3])
        R = U @ Vt
        if np.linalg.det(R) < 0:
            U[:, 2] *= -1
            R = U @ Vt
        out = T.copy()
        out[:3, :3] = R
        return out

    def _create_keyframe(self, feat, mask, frame: FrameRecord,
                         pose: Optional[np.ndarray] = None,
                         update_map: bool = True, lazy_cloud: bool = False):
        """Record a keyframe and, with update_map, insert its features into
        the map (the chunk path has already updated the map on the
        device). With lazy_cloud the cloud stays a device tensor until it
        is read."""
        kf_id = self.next_keyframe_id
        self.next_keyframe_id += 1
        pose = (self.T_current if pose is None else pose).astype(np.float32)
        if self.keyframes:
            prev = self.keyframes[-1]
            rel_raw = np.linalg.inv(prev.stored_pose) @ pose
            rel = self._normalize_rotation(rel_raw).astype(np.float32)
            if self.cfg.enable_pgo:
                self.pose_graph.add_keyframe_with_odom(
                    prev.kf_id, kf_id, pose, rel, self.cfg.odometry_translation_noise,
                    self.cfg.odometry_rotation_noise)
        else:
            rel = np.eye(4, dtype=np.float32)
            if self.cfg.enable_pgo:
                self.pose_graph.add_first_keyframe(kf_id, pose)
        feat_host = feat if lazy_cloud else _host(feat)
        mask_host = _host(mask)
        record = KeyframeRecord(
            kf_id=kf_id, stored_pose=pose, relative_pose=rel, feature_cloud=feat_host,
            feature_mask=mask_host, frame_index=len(self.frames) - 1)
        with self._keyframes_lock:
            self.keyframes.append(record)
        self._spill_old_keyframes()
        frame.is_keyframe = True
        frame.kf_index = len(self.keyframes) - 1
        frame.kf_ref = len(self.keyframes) - 1
        frame.relative_pose = np.eye(4, dtype=np.float32)

        if update_map:
            # the radius-eviction scan runs on every 4th keyframe, as in
            # the chunk runner
            pose_t = self._t(pose)
            self.map_state = self.backend.update(
                self.map_state, lie.transform_points(pose_t, feat), mask,
                pose_t[:3, 3].contiguous(), self.cfg.max_range * 1.2,
                evict_enabled=torch.full((), kf_id % 4 == 0, dtype=torch.bool,
                                         device=self.device))
        self.last_keyframe_pose = pose

        if self.cfg.enable_loop_detection:
            self.loop_detector.add_keyframe(feat_host, mask_host, kf_id, pose[:3, 3])
            if kf_id - self.last_successful_loop_kf_id >= self.cfg.min_keyframe_gap:
                if self.sync_loop:
                    self._process_loop_query(kf_id)
                else:
                    # the worker's stream waits for what this stream has queued
                    ev = None
                    if self._loop_stream is not None:
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(self._loop_stream.device))
                    with self._query_cv:
                        self._query_queue.append((kf_id, ev))
                        self._query_cv.notify()

    # ------------------------------------------------------------------
    # Chunk path: the fused chunk runner on the device, the keyframe
    # bookkeeping on the host afterwards
    # ------------------------------------------------------------------

    @staticmethod
    def _pack_chunk_head(poses, is_kf, n_corr, masks, T_prev, velocity, last_kf_pose):
        """The chunk's scalar outputs in one small (F+1, 48) f32 tensor:
        per frame [pose(16) | is_kf | n_corr | n_valid | zeros], then a
        tail row [T_prev(16) | velocity(16) | last_kf_pose(16)]. Feature
        clouds stay on the device; only keyframe rows are fetched."""
        f = poses.shape[0]
        cols = [poses.reshape(f, 16), is_kf[:, None], n_corr[:, None],
                masks.sum(1)[:, None]]
        head = torch.cat([c.to(torch.float32) for c in cols]
                         + [torch.zeros((f, 29), dtype=torch.float32, device=poses.device)], 1)
        tail = torch.cat([T_prev.reshape(16), velocity.reshape(16), last_kf_pose.reshape(16)])
        return torch.cat([head, tail[None]], 0)

    def process_chunk(self, raw_scans, sample_stages: bool = False,
                      defer_host: bool = False) -> bool:
        """Process (F, N, 3) scans (numpy, or a tensor already staged on
        the device) in one run of the chunk runner. Pad rows must be NaN.
        Equivalent to F process_frame calls.

        sample_stages=True runs the FIRST frame through the per-frame path,
        which records the preprocess / ICP / map-update breakdown that
        print_timing_statistics shows (the chunk runner can only be timed
        as a whole).

        defer_host=True queues the packed result instead of fetching it,
        so consecutive chunks run back to back with no host round trip;
        drain_chunks() (or trajectory() / finalize_loops(), which call it)
        runs the queued bookkeeping. It needs loop detection off: deferred
        bookkeeping would delay the loop queries, and a correction would
        rebase poses that deferred chunks still hold."""
        if defer_host and self.cfg.enable_loop_detection:
            raise ValueError(
                "defer_host requires loop detection off: deferred keyframe bookkeeping "
                "would delay loop queries and a PGO correction would rebase poses while "
                "deferred chunks still hold pre-correction values")
        if sample_stages and not defer_host and len(raw_scans) > 1:
            self.process_frame(raw_scans[0])
            raw_scans = raw_scans[1:]

        t_start = time.perf_counter()
        if self.backend.name != "single":
            raise NotImplementedError(
                "process_chunk (the fused chunk runner) needs the single-device map "
                "backend; a sharded map runs through process_frame")
        if self._chunk_runner is None:
            self._chunk_runner = fp.make_chunk_runner(
                self.icp_cfg, self.pko_consts,
                scan_voxel_size=self.cfg.voxel_size,
                point_stride=self.cfg.point_stride,
                scan_capacity=self.cfg.scan_capacity,
                keyframe_distance=self.cfg.keyframe_distance_threshold,
                keyframe_rotation=self.cfg.keyframe_rotation_threshold,
                max_distance=self.cfg.max_range * 1.2,
                planarity_threshold=self.cfg.surfel_planarity_threshold,
                compute_surfels=self.cfg.use_surfel_correspondence,
                return_features=True)

        self._apply_pending_pgo_result_if_available()
        if self._chunk_carry is not None:
            carry = self._chunk_carry._replace(map_state=self.map_state)
        else:
            carry = fp.OdomCarry(
                map_state=self.map_state,
                T_prev=self._t(self._prev_pose),
                velocity=self._t(self.velocity),
                last_kf_pose=self._t(self.last_keyframe_pose),
                initialized=torch.full((), self.initialized, dtype=torch.bool,
                                       device=self.device),
                kf_count=torch.full((), self.next_keyframe_id, dtype=torch.int32,
                                    device=self.device))
        if isinstance(raw_scans, torch.Tensor):
            scans = raw_scans.to(device=self.device, dtype=torch.float32)
        else:
            scans = self._t(np.ascontiguousarray(raw_scans, np.float32))
        carry, (poses, is_kf, n_corr, feats, masks) = self._chunk_runner(carry, scans)
        self.map_state = carry.map_state
        self._chunk_carry = carry._replace(map_state=None)
        head = self._pack_chunk_head(poses, is_kf, n_corr, masks, carry.T_prev,
                                     carry.velocity, carry.last_kf_pose)
        entry = (head, feats, poses.shape[0], feats.shape[1])
        if defer_host:
            self._deferred_chunks.append(entry)
            return True
        self._fetch_and_ingest([entry], (time.perf_counter() - t_start) * 1e3)
        return True

    def drain_chunks(self) -> None:
        """Run the host bookkeeping of the chunks processed with
        defer_host=True, in order: one fetch of all their heads, and the
        keyframe clouds kept on the device until read."""
        pending, self._deferred_chunks = self._deferred_chunks, []
        if pending:
            self._fetch_and_ingest(pending, 0.0, lazy=True)

    def _fetch_and_ingest(self, entries, chunk_ms: float, lazy: bool = False) -> None:
        """Fetch the chunks' heads in one transfer and run the bookkeeping
        of each chunk in order. Keyframe feature rows are either fetched in
        one transfer (lazy=False) or kept as per-keyframe device copies
        that move to the host when first read (lazy=True)."""
        heads = _host(torch.stack([e[0] for e in entries]))
        kf_rows = [np.nonzero(heads[ci, :e[2], 16] > 0.5)[0] for ci, e in enumerate(entries)]
        if lazy:
            per_chunk = [{int(r): e[1][int(r)].clone() for r in rows}
                         for e, rows in zip(entries, kf_rows)]
        else:
            gathered = [e[1][torch.as_tensor(rows, device=e[1].device)]
                        for e, rows in zip(entries, kf_rows) if len(rows)]
            flat = _host(torch.cat(gathered)) if gathered else None
            per_chunk, ofs = [], 0
            for rows in kf_rows:
                per_chunk.append({int(r): flat[ofs + j] for j, r in enumerate(rows)})
                ofs += len(rows)
        for ci, (_head, _feats, f, cap) in enumerate(entries):
            self._ingest_chunk(heads[ci], per_chunk[ci], f, cap, chunk_ms, lazy=lazy)

    def _ingest_chunk(self, head: np.ndarray, kf_feats, f: int, cap: int,
                      chunk_ms: float, lazy: bool = False) -> None:
        """Host bookkeeping of one chunk (FrameRecord, KeyframeRecord), as
        the per-frame path keeps it. `kf_feats` maps a keyframe's row in
        the chunk to its (cap, 3) feature cloud."""
        poses = head[:f, :16].reshape(f, 4, 4)
        is_kf = head[:f, 16] > 0.5
        # the voxel filter's mask is a prefix, so one count per frame gives it
        n_valid = head[:f, 18].astype(np.int32)
        masks = np.arange(cap)[None, :] < n_valid[:, None]
        tail = head[f, :48]

        self.T_current = self._normalize_rotation(tail[:16].reshape(4, 4))
        self.velocity = tail[16:32].reshape(4, 4).copy()
        self._prev_pose = self.T_current
        self.initialized = True

        for i in range(f):
            pose = self._normalize_rotation(poses[i]).astype(np.float32)
            if is_kf[i]:
                frame = FrameRecord(kf_ref=-1, relative_pose=np.eye(4, dtype=np.float32),
                                    is_keyframe=False)
                self.frames.append(frame)
                self._create_keyframe(kf_feats[i], masks[i], frame, pose=pose,
                                      update_map=False, lazy_cloud=lazy)
            else:
                kf_ref = len(self.keyframes) - 1
                rel = (np.linalg.inv(self.keyframes[kf_ref].stored_pose) @ pose
                       if kf_ref >= 0 else np.eye(4))
                self.frames.append(FrameRecord(
                    kf_ref=kf_ref, relative_pose=rel.astype(np.float32), is_keyframe=False))
            self.frame_count += 1
        # the keyframe-pose base as the device carry holds it
        self.last_keyframe_pose = tail[32:48].reshape(4, 4).copy()

        # one history entry per frame (the chunk's wall time / frames)
        n = max(f, 1)
        self.timing_history.extend(TimingStats(total_ms=chunk_ms / n) for _ in range(n))
        if self.cfg.enable_console_statistics and self.frame_count % 100 < n:
            self.print_timing_statistics()

    # ------------------------------------------------------------------
    # Outputs
    # ------------------------------------------------------------------

    def trajectory(self) -> np.ndarray:
        """(F, 4, 4) per-frame poses."""
        if self._deferred_chunks:
            self.drain_chunks()
        out = np.zeros((len(self.frames), 4, 4), np.float32)
        for i, fr in enumerate(self.frames):
            if fr.is_keyframe:
                out[i] = self.keyframes[fr.kf_index].stored_pose
            elif fr.kf_ref >= 0:
                out[i] = self.keyframes[fr.kf_ref].stored_pose @ fr.relative_pose
            else:
                out[i] = np.eye(4, dtype=np.float32)
        return out

    def map_counts(self) -> Dict[str, int]:
        """n_l0, n_l1 and n_dropped of the map (summed over this rank's
        shards for a sharded map)."""
        return self.backend.counts(self.map_state)

    def map_points(self) -> np.ndarray:
        """Every live L0 centroid of the map, (M, 3) (this rank's shards of
        a sharded map, whose sink rows hold no voxel)."""
        pts, valid = vm.l0_points(self.map_state)
        return _host(pts)[_host(valid)]

    def accumulated_map(self, voxel_size: Optional[float] = None) -> np.ndarray:
        """World-frame accumulation of the keyframes' feature clouds,
        optionally voxel-downsampled."""
        clouds = []
        with self._keyframes_lock:
            kfs = list(self.keyframes)
        for kf in kfs:
            pts = kf.feature_cloud[kf.feature_mask]
            clouds.append(pts @ kf.stored_pose[:3, :3].T + kf.stored_pose[:3, 3])
        if not clouds:
            return np.zeros((0, 3), np.float32)
        acc = np.concatenate(clouds).astype(np.float32)
        if voxel_size and voxel_size > 0:
            keys_i = np.floor(acc / voxel_size).astype(np.int64)
            _, inv = np.unique(keys_i, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            sums = np.zeros((inv.max() + 1, 3))
            counts = np.zeros(inv.max() + 1)
            np.add.at(sums, inv, acc)
            np.add.at(counts, inv, 1)
            acc = (sums / counts[:, None]).astype(np.float32)
        return acc

    def save_map_to_ply(self, output_path: str, voxel_size: Optional[float] = None) -> bool:
        """The accumulated keyframe map, voxel-downsampled (default the
        scan voxel size), as a binary PLY; False when there is no
        keyframe."""
        from ..io.ply import save_ply
        pts = self.accumulated_map(self.cfg.voxel_size if voxel_size is None else voxel_size)
        if len(pts) == 0:
            log.warn("[Estimator] No keyframes to save")
            return False
        save_ply(output_path, pts)
        log.info("[Estimator] Saved final map to {} ({} points)", output_path, len(pts))
        return True

    def get_current_pose(self) -> np.ndarray:
        return self.T_current.copy()

    def get_keyframe_count(self) -> int:
        with self._keyframes_lock:
            return len(self.keyframes)

    def get_keyframe(self, index: int) -> Optional[KeyframeRecord]:
        with self._keyframes_lock:
            if 0 <= index < len(self.keyframes):
                return self.keyframes[index]
        return None

    def get_loop_closure_count(self) -> int:
        return self.loop_constraint_count

    def enable_loop_closure(self, enable: bool) -> None:
        """Turn loop detection on or off at run time; starts the worker if
        it is needed and not running."""
        group = getattr(self.backend, "group", None)
        if enable and not self.sync_loop and group is not None and group.world_size > 1:
            raise ValueError("a map sharded over more than one rank needs sync_loop=True")
        self.loop_detector.config.enable_loop_detection = enable
        self.cfg = self.cfg.replace(enable_loop_detection=enable)
        if enable and not self.sync_loop and self._thread is None:
            self._start_worker()

    # ------------------------------------------------------------------
    # Loop closure and pose-graph optimisation
    # ------------------------------------------------------------------

    def _start_worker(self) -> None:
        self._thread_running = True
        self._thread = threading.Thread(target=self._loop_pgo_thread, daemon=True)
        self._thread.start()

    def _on_loop_stream(self):
        return (torch.cuda.stream(self._loop_stream) if self._loop_stream is not None
                else contextlib.nullcontext())

    def _loop_pgo_thread(self) -> None:
        while self._thread_running:
            with self._query_cv:
                self._query_cv.wait_for(lambda: self._query_queue or not self._thread_running,
                                        timeout=0.2)
                if not self._thread_running:
                    break
                if not self._query_queue:
                    continue
                query_kf_id, ev = self._query_queue[-1]     # newest wins
                self._query_queue.clear()
                self._worker_busy = True
                gen = self._generation
            try:
                with self._on_loop_stream():
                    if ev is not None:
                        torch.cuda.current_stream().wait_event(ev)
                    self._process_loop_query(query_kf_id, gen)
            except Exception as e:  # the worker carries on, and counts it
                self._loop_error("[Background] loop/PGO worker error: {}", repr(e))
            finally:
                with self._query_cv:
                    self._worker_busy = False
                    self._query_cv.notify_all()

    def _loop_error(self, fmt: str, *args) -> None:
        self.loop_errors += 1
        log.error(fmt, *args)

    def _find_keyframe(self, kf_id: int) -> Optional[KeyframeRecord]:
        with self._keyframes_lock:
            for kf in self.keyframes:
                if kf.kf_id == kf_id:
                    return kf
        return None

    def _process_loop_query(self, query_kf_id: int, gen: Optional[int] = None) -> None:
        if gen is None:
            gen = self._generation
        query_kf = self._find_keyframe(query_kf_id)
        if query_kf is None:
            return
        candidates = self.loop_detector.detect_loop_closures(
            query_kf.feature_cloud, query_kf.feature_mask, query_kf_id,
            query_kf.stored_pose[:3, 3])
        if candidates:
            self._run_pgo_for_loop(query_kf, candidates, gen)

    def _run_pgo_for_loop(self, current_kf: KeyframeRecord, candidates: List[LoopCandidate],
                          gen: Optional[int] = None) -> bool:
        """The loop-closure solve, the pose-graph optimisation, and the
        result posted for the main thread."""
        candidate = candidates[0]
        matched_kf = self._find_keyframe(candidate.match_keyframe_id)
        if matched_kf is None:
            return False
        self.loop_icp_attempts += 1
        # both poses under the lock: the main thread may rewrite stored_pose
        with self._keyframes_lock:
            current_pose = current_kf.stored_pose.copy()
            matched_pose = matched_kf.stored_pose.copy()

        t0 = time.perf_counter()
        # the query cloud at half density (every other row), the matched
        # keyframe's in full for its point tables; 8-wide bin probes
        packed = _host(icp.loop_closure_solve(
            self._t(current_kf.feature_cloud[::2]),
            torch.as_tensor(np.ascontiguousarray(current_kf.feature_mask[::2]),
                            device=self.device),
            self._t(current_pose), self._t(matched_kf.feature_cloud),
            torch.as_tensor(matched_kf.feature_mask, device=self.device),
            self._t(matched_pose),
            torch.tensor(float(candidate.bias), dtype=torch.float32, device=self.device),
            self.pko_consts, self.icp_cfg, prealign=self.cfg.loop_prealign, bucket_width=8,
            max_loop_iterations=(30 if self.cfg.loop_prealign else 100)))
        self._add_stage_ms("loop_icp", (time.perf_counter() - t0) * 1e3)
        T_rel = packed[:16].reshape(4, 4).astype(np.float64)
        inlier_ratio, resid_rms = float(packed[17]), float(packed[18])
        if not packed[16] > 0.5:
            log.warn("[Background] Loop ICP failed {} <-> {}",
                     candidate.query_keyframe_id, candidate.match_keyframe_id)
            return False
        if inlier_ratio < 0.3:
            log.warn("[Background] Loop rejected: {:.1f}% inliers < 30%", inlier_ratio * 100.0)
            return False

        T_world_current = current_pose.astype(np.float64)
        T_world_matched = matched_pose.astype(np.float64)
        T_matched_to_current = np.linalg.inv(T_world_matched) @ (T_world_current @ T_rel)
        if not self.cfg.enable_pgo:
            return False
        if gen is not None and gen != self._generation:
            log.warn("[Background] dropping stale loop (generation {} != {})",
                     gen, self._generation)
            return False
        self.loop_constraint_count += 1
        with self._keyframes_lock:
            kf_ids = [kf.kf_id for kf in self.keyframes]
            before = self.keyframes[-1].stored_pose.astype(np.float64)

        # the loop factor's noise: scaled by the polish phase's RMS plane
        # distance (over 5 mm), and made inert (x1000) when the measured
        # relative pose agrees with the trajectory within the innovation
        # gate, where the factor would only add measurement noise
        noise_scale = 1.0
        if self.cfg.loop_residual_weighting and resid_rms > 0.0:
            noise_scale = float(np.clip(resid_rms / 0.005, 1.0, 100.0))
        D = np.linalg.inv(T_matched_to_current) @ (np.linalg.inv(T_world_matched)
                                                   @ T_world_current)
        innov_t = float(np.linalg.norm(D[:3, 3]))
        innov_r = float(np.arccos(np.clip((np.trace(D[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)))
        inert = (self.cfg.loop_residual_weighting and innov_t < self.cfg.loop_innovation_gate_t
                 and innov_r < self.cfg.loop_innovation_gate_r)
        if inert:
            noise_scale = 1000.0
        t0 = time.perf_counter()
        ok = self.pose_graph.add_loop_and_optimize(
            matched_kf.kf_id, current_kf.kf_id, T_matched_to_current,
            self.cfg.loop_translation_noise * noise_scale,
            self.cfg.loop_rotation_noise * noise_scale)
        self._add_stage_ms("pgo_solve", (time.perf_counter() - t0) * 1e3)
        if not ok:
            self._loop_error("[Background] PGO failed!")
            return False

        optimized = self.pose_graph.get_all_optimized_poses()
        last_kf_id = kf_ids[-1]
        correction = optimized[last_kf_id] @ np.linalg.inv(before)
        result = PGOResult(last_optimized_kf_id=last_kf_id, optimized_poses=optimized,
                           last_kf_correction=correction.astype(np.float32))
        if gen is not None and gen != self._generation:
            log.warn("[Background] dropping stale PGO result (generation {} != {})",
                     gen, self._generation)
            return False
        with self._result_lock:
            self._pending_result = result
        # further queries are gated from accept time, not apply time
        self.last_successful_loop_kf_id = max(self.last_successful_loop_kf_id, last_kf_id)
        if self.sync_loop:
            self._apply_pending_pgo_result_if_available()
        log.info("[Background] Loop {} <-> {} accepted ({:.0f}% inliers, resid {:.1f} mm, "
                 "innov {:.1f} mm/{:.2f} mrad{}); PGO over {} KFs",
                 candidate.query_keyframe_id, candidate.match_keyframe_id,
                 inlier_ratio * 100.0, resid_rms * 1e3, innov_t * 1e3, innov_r * 1e3,
                 ", inert: consistent within noise" if inert else f", noise x{noise_scale:.1f}",
                 len(kf_ids))
        return True

    def _add_stage_ms(self, key: str, ms: float) -> None:
        with self._stage_lock:
            self._loop_stage_ms[key] = self._loop_stage_ms.get(key, 0.0) + ms

    def loop_stage_snapshot(self) -> Dict[str, float]:
        """Cumulative loop-path stage times in ms (loop_icp, pgo_solve,
        pgo_apply)."""
        with self._stage_lock:
            return dict(self._loop_stage_ms)

    def _apply_pending_pgo_result_if_available(self) -> None:
        """On the main thread: the optimised keyframe poses, the poses of
        newer keyframes chained onto them, the map rehash by the last
        keyframe's correction, and the live pose moved into the corrected
        world frame. The device chunk carry is dropped (it holds
        pre-correction poses). The stage time includes the rehash's device
        time (a synchronise)."""
        with self._result_lock:
            result, self._pending_result = self._pending_result, None
        if result is None:
            return
        t0 = time.perf_counter()
        last_id = result.last_optimized_kf_id
        with self._keyframes_lock:
            for kf in self.keyframes:
                if kf.kf_id > last_id:
                    break
                opt = result.optimized_poses.get(kf.kf_id)
                if opt is not None:
                    kf.stored_pose = opt.astype(np.float32)
        self._propagate_poses_after_pgo(last_id)
        self.map_state = self.backend.rehash(self.map_state, result.last_kf_correction)
        self.rehash_count += 1
        self.last_successful_loop_kf_id = max(self.last_successful_loop_kf_id, last_id)
        with self._keyframes_lock:
            self.last_keyframe_pose = self.keyframes[-1].stored_pose.copy()
        C = result.last_kf_correction.astype(np.float32)
        self.T_current = C @ self.T_current
        self._prev_pose = C @ self._prev_pose
        self._chunk_carry = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.current_stream(torch.device(self.device)).synchronize()
        self._add_stage_ms("pgo_apply", (time.perf_counter() - t0) * 1e3)

    def _propagate_poses_after_pgo(self, last_optimized_kf_id: int) -> None:
        """Chain the relative poses of keyframes newer than the
        optimisation onto the optimised one."""
        with self._keyframes_lock:
            accumulated = None
            for kf in self.keyframes:
                if kf.kf_id == last_optimized_kf_id:
                    accumulated = kf.stored_pose.copy()
                    continue
                if accumulated is None:
                    continue
                accumulated = accumulated @ kf.relative_pose
                kf.stored_pose = accumulated.copy()

    def warm_loop_programs(self) -> None:
        """Run each loop-path program once on stand-in data before the
        first loop query: builds the kernels' libraries and plans cuFFT's
        transforms, so the first real query does not pay for them. The DB
        rows it writes lie past the live region. The rehash's result is
        dropped, and a sharded map's pending inserts stay pending (a
        flush here would land them in the dropped state)."""
        cap = self.cfg.scan_capacity
        rng = np.random.default_rng(0)
        cloud = rng.uniform(-20.0, 20.0, (cap, 3)).astype(np.float32)
        mask = np.ones(cap, bool)
        det = self.loop_detector
        with self._on_loop_stream():
            if det._db_n == 0 and det.capacity >= 2:
                det._extract_store(np.stack([cloud, cloud]), np.stack([mask, mask]), 0)
                iris.compare_rows(det._img, det._T, det._M, 0,
                                  torch.zeros((2,), dtype=torch.int32, device=self.device),
                                  torch.ones((2,), dtype=torch.bool, device=self.device))
            eye = torch.eye(4, dtype=torch.float32, device=self.device)
            cj = self._t(cloud)
            mj = torch.as_tensor(mask, device=self.device)
            icp.loop_closure_solve(
                cj[::2].contiguous(), mj[::2].contiguous(), eye, cj, mj, eye,
                torch.zeros((), dtype=torch.float32, device=self.device), self.pko_consts,
                self.icp_cfg, prealign=self.cfg.loop_prealign, bucket_width=8,
                max_loop_iterations=(30 if self.cfg.loop_prealign else 100))
        self.backend.rehash(self.map_state, np.eye(4, dtype=np.float32), flush=False)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(torch.device(self.device))

    def reset(self) -> None:
        """Clear all state (map, trajectory, keyframes, Iris DB, pose graph)
        and keep the chunk runner: a fresh sequence on the same estimator.
        The loop worker is quiesced first."""
        with self._query_cv:
            self._query_queue.clear()
            self._generation += 1
            if not self._query_cv.wait_for(lambda: not self._worker_busy, timeout=60.0):
                log.warn("[Estimator] reset(): loop/PGO worker still busy after 60 s; "
                         "stale results will be dropped by generation check")
        self.loop_detector.clear()
        self._init_state()

    def _spill_old_keyframes(self) -> None:
        """Spill the feature clouds of keyframes older than the window to
        the estimator's spool directory. Device-held clouds (deferred
        chunk ingest) move to the host in one batched fetch once 64 of
        them wait."""
        w = self.cfg.window_size
        if w <= 0:
            return
        with self._keyframes_lock:
            old = [kf for kf in self.keyframes[:-w] if not kf.is_spilled]
        if not old:
            return
        dev = [kf for kf in old if not isinstance(kf._cloud, np.ndarray)]
        ready = [kf for kf in old if isinstance(kf._cloud, np.ndarray)]
        if len(dev) >= 64:
            flat = _host(torch.stack([kf._cloud for kf in dev]))
            for i, kf in enumerate(dev):
                kf._cloud = flat[i]
            ready += dev
        if not ready:
            return
        if self._spool_dir is None:
            self._spool_dir = tempfile.mkdtemp(prefix="lot_kfspool_")
        for kf in ready:
            kf.spill(self._spool_dir)

    def _drop_spool(self) -> None:
        if self._spool_dir is not None:
            shutil.rmtree(self._spool_dir, ignore_errors=True)
            self._spool_dir = None

    def shutdown(self) -> None:
        """Stop the loop worker. The keyframe spool lives until reset() or
        garbage collection: finalize_loops still reads spilled clouds."""
        if self._thread is not None:
            self._thread_running = False
            with self._query_cv:
                self._query_cv.notify_all()
            self._thread.join(timeout=5.0)
            self._thread = None

    def __del__(self):  # pragma: no cover - interpreter-dependent timing
        try:
            self._drop_spool()
        except Exception:
            pass

    def finalize_loops(self) -> None:
        """End of a run: stop the worker, drain the deferred chunks, flush a
        sharded map's pending inserts, run the newest still-queued loop
        query inline and apply any pending result."""
        self.shutdown()
        if self._deferred_chunks:
            self.drain_chunks()
        # a batched sharded backend may hold keyframe inserts
        if hasattr(self.backend, "flush"):
            self.map_state = self.backend.flush(self.map_state)
        pending = None
        with self._query_cv:
            if self._query_queue:
                pending = self._query_queue[-1][0]
                self._query_queue.clear()
        if pending is not None:
            try:
                self._process_loop_query(pending)
            except Exception as e:
                self._loop_error("[Estimator] finalize_loops query failed: {}", repr(e))
        self._apply_pending_pgo_result_if_available()

    # ------------------------------------------------------------------
    # Timing statistics
    # ------------------------------------------------------------------

    def _record_timing(self, timing: TimingStats) -> None:
        self.timing_history.append(timing)
        self.frame_count += 1
        if self.cfg.enable_console_statistics and self.frame_count % 100 == 0:
            self.print_timing_statistics()

    def print_timing_statistics(self) -> None:
        """The per-stage table over the last 100 frames. Stage rows use the
        entries that have a stage breakdown (frames of the per-frame path);
        chunk totals feed the Total row as per-frame averages."""
        if not self.timing_history:
            return
        hist = self.timing_history[-100:]

        def stats(vals):
            if not vals:
                return (0.0, 0.0, 0.0)
            return (sum(vals) / len(vals), min(vals), max(vals))

        staged = [t for t in hist if t.preprocessing_ms > 0.0 or t.icp_ms > 0.0]
        rows = [
            ("Preprocess", stats([t.preprocessing_ms for t in staged])),
            ("ICP", stats([t.icp_ms for t in staged])),
            ("Map Update", stats([t.map_update_ms for t in staged])),
            ("Total", stats([t.total_ms for t in hist])),
        ]
        log.info("=" * 60)
        log.info("[Timing Stats] Frame {} (last {} frames, {} staged)",
                 self.frame_count, len(hist), len(staged))
        log.info("{:<13s}|   Avg (ms)  |   Min (ms)  |   Max (ms)", "")
        for name, (avg, mn, mx) in rows:
            log.info(" {:<12s}| {:>10.2f}  | {:>10.2f}  | {:>10.2f}", name, avg, mn, mx)
        log.info("=" * 60)
