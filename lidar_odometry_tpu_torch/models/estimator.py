"""The odometry front door with loop closure off (counterpart of the JAX
package's models/estimator.py).

`process_frame` runs one scan: preprocess (voxel filter) -> ICP against
the map with a constant-velocity guess -> velocity update -> keyframe
decision -> keyframe record and map update. `process_chunk` runs a chunk
of scans through the fused chunk runner (models/fast_pipeline.py) and
does the same host bookkeeping afterwards, optionally deferred so that
consecutive chunks run with no host round trip. Poses, keyframe records
and the trajectory live on the host as numpy arrays; the map and the
chunk carry stay on the device.

Loop closure and pose-graph optimization come with their own slice
(ROADMAP queue 1, item 10): a config with enable_loop_detection raises
at construction. The pose graph is left out as well. With loops off the
JAX estimator only appends odometry factors to its graph and never
optimizes it (add_loop_and_optimize is called only from the loop
worker), so leaving the graph out changes no pose and no map.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..ops import icp, pko
from ..ops import voxel_filter as vf
from ..ops import voxel_map as vm
from ..utils import lie
from ..utils import logging_util as log
from . import fast_pipeline as fp
from .map_backend import SingleChipMapBackend

__all__ = ["Estimator", "KeyframeRecord", "FrameRecord", "TimingStats"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class KeyframeRecord:
    """Host-side keyframe state. The feature cloud of a keyframe older than
    the window (`keyframe.window_size`) spills its live points to disk and
    reloads on the rare paths that read it (map export). A cloud may also
    be a device tensor (deferred chunk ingest) until something reads it."""

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


class Estimator:
    def __init__(self, config: SystemConfig, device="cuda"):
        if config.enable_loop_detection:
            raise ValueError(
                "the port has no loop closure yet (ROADMAP queue 1, item 10): "
                "set enable_loop_detection to false")
        self.cfg = config
        self.device = device
        self.backend = SingleChipMapBackend(config, device=device)

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
        self._chunk_runner = None
        self._spool_dir: Optional[str] = None   # keyframe cloud spill dir
        self.reset()

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
            rel_raw = np.linalg.inv(self.keyframes[-1].stored_pose) @ pose
            rel = self._normalize_rotation(rel_raw).astype(np.float32)
        else:
            rel = np.eye(4, dtype=np.float32)
        record = KeyframeRecord(
            kf_id=kf_id, stored_pose=pose, relative_pose=rel,
            feature_cloud=feat if lazy_cloud else _host(feat),
            feature_mask=_host(mask), frame_index=len(self.frames) - 1)
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
        runs the queued bookkeeping."""
        if sample_stages and not defer_host and len(raw_scans) > 1:
            self.process_frame(raw_scans[0])
            raw_scans = raw_scans[1:]

        t_start = time.perf_counter()
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

    def map_points(self) -> np.ndarray:
        """Every live L0 centroid of the map, (M, 3)."""
        pts, valid = vm.l0_points(self.map_state)
        return _host(pts)[_host(valid)]

    def accumulated_map(self, voxel_size: Optional[float] = None) -> np.ndarray:
        """World-frame accumulation of the keyframes' feature clouds,
        optionally voxel-downsampled."""
        clouds = []
        for kf in self.keyframes:
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

    def get_current_pose(self) -> np.ndarray:
        return self.T_current.copy()

    def get_keyframe_count(self) -> int:
        return len(self.keyframes)

    def get_keyframe(self, index: int) -> Optional[KeyframeRecord]:
        if 0 <= index < len(self.keyframes):
            return self.keyframes[index]
        return None

    def get_loop_closure_count(self) -> int:
        return 0

    def reset(self) -> None:
        """Clear all state (map, trajectory, keyframes) and keep the chunk
        runner: a fresh sequence on the same estimator."""
        self.map_state = self.backend.empty()
        self.initialized = False
        self.T_current = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_keyframe_pose = np.eye(4, dtype=np.float32)
        self._prev_pose = np.eye(4, dtype=np.float32)
        self.next_keyframe_id = 0
        self.keyframes: List[KeyframeRecord] = []
        self.frames: List[FrameRecord] = []
        self._drop_spool()
        self.timing_history: List[TimingStats] = []
        self.frame_count = 0
        self._chunk_carry = None        # the device-resident odometry carry
        self._deferred_chunks = []      # packed results awaiting bookkeeping

    def _spill_old_keyframes(self) -> None:
        """Spill the feature clouds of keyframes older than the window to
        the estimator's spool directory. Device-held clouds (deferred
        chunk ingest) move to the host in one batched fetch once 64 of
        them wait."""
        w = self.cfg.window_size
        if w <= 0:
            return
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
        """Nothing runs in the background with loops off; the keyframe
        spool lives until reset() or garbage collection."""

    def __del__(self):  # pragma: no cover - interpreter-dependent timing
        try:
            self._drop_spool()
        except Exception:
            pass

    def finalize_loops(self) -> None:
        """End of a run: drain the deferred chunks (there is no loop query
        to finish with loops off)."""
        if self._deferred_chunks:
            self.drain_chunks()

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
