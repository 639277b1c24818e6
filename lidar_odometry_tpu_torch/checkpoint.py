"""Checkpoint and resume of a live Estimator (counterpart of the JAX
package's checkpoint.py).

`save` writes the JAX package's version-3 archive entry for entry: the
same entry names, dtypes and shapes, so that either package restores the
other's archive. It is a plain zip of .npy entries (np.load reads it
lazily, entry by entry):
  * map.<field>: the ten VoxelMapState fields in the JAX layout (the port's
    sink rows stripped, convert.map_state_to_numpy);
  * kf.*, fr.*: the keyframe and frame records; each keyframe's cloud is
    its own entry kf.cloud.<id>, the live rows only, written one keyframe
    at a time, so that saving a long run never holds every spilled cloud
    in memory and never changes which keyframes are resident;
  * pg.*: the pose graph's factors, its poses keyed by keyframe id;
  * lc.*: the loop detector's Iris DB, its code words as uint32 (the JAX
    DB's dtype; the port keeps the same bits as int32);
  * meta_json: the version, the odometry state and the counters.

`restore` reads versions 1, 2 and 3. Keyframes older than the window
(`window_size`) go straight to the estimator's spool with no padded cloud
built; version 1 and 2 archives stack the padded clouds in kf.clouds
instead, and a version 1 archive has no lc.* entries, so the Iris DB is
rebuilt from the clouds (its queue-time positions become the stored
poses').

Where the JAX module differs, the port keeps the fault out: JAX's restore
refuses version 2 archives (it asserts version 1 or 3), and its save
leaves the chunks that process_chunk(defer_host=True) queued out of the
archive; this save drains them first, and applies a loop result the
worker posted but the main thread has not applied yet. A map sharded
over a ShardGroup is refused: JAX's save writes the sharded layout, and
its restore loads that into a single-device map that fails at the next
keyframe.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from typing import Dict

import numpy as np
import torch

from . import convert
from .config import SystemConfig
from .models.estimator import Estimator, FrameRecord, KeyframeRecord, _host

__all__ = ["CHECKPOINT_VERSION", "save", "restore"]

CHECKPOINT_VERSION = 3
_IRIS_FIELDS = ("iris_img", "iris_T", "iris_M", "iris_kf_ids", "iris_positions")


def _live_prefix(kf: KeyframeRecord) -> np.ndarray:
    """The keyframe's live points (n_live, 3), its residency untouched: a
    spilled record reads its spill file, a device-held cloud is fetched
    without being kept on the host."""
    if kf.is_spilled:
        return np.load(kf._spill_path)["pts"]
    return _host(kf._cloud)[kf.feature_mask]


def _write_npy(zf: zipfile.ZipFile, name: str, arr: np.ndarray) -> None:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.ascontiguousarray(arr), allow_pickle=False)
    zf.writestr(name + ".npy", buf.getvalue())


def save(path: str, est: Estimator) -> None:
    """Write `est`'s state to `path` (the JAX version-3 archive)."""
    if est.backend.name != "single":
        raise ValueError(
            f"checkpoint.save: the {est.backend.name} map backend cannot be saved; the archive "
            "holds one device's map (a sharded map restored from it would not run)")
    est.drain_chunks()
    est._apply_pending_pgo_result_if_available()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {
        f"map.{name}": a for name, a in convert.map_state_to_numpy(est.map_state).items()}
    with est._keyframes_lock:
        kfs = list(est.keyframes)
    arrays["kf.ids"] = np.asarray([k.kf_id for k in kfs], np.int32)
    arrays["kf.frame_index"] = np.asarray([k.frame_index for k in kfs], np.int32)
    if kfs:
        arrays["kf.poses"] = np.stack([k.stored_pose for k in kfs])
        arrays["kf.relatives"] = np.stack([k.relative_pose for k in kfs])
        arrays["kf.masks"] = np.stack([k.feature_mask for k in kfs])
    arrays["fr.kf_ref"] = np.asarray([f.kf_ref for f in est.frames], np.int32)
    arrays["fr.kf_index"] = np.asarray([f.kf_index for f in est.frames], np.int32)
    arrays["fr.is_kf"] = np.asarray([f.is_keyframe for f in est.frames], bool)
    if est.frames:
        arrays["fr.relatives"] = np.stack([f.relative_pose for f in est.frames])

    g = est.pose_graph.export_factors()
    ids = [int(k) for k in g["keyframe_ids"]]
    arrays["pg.kf_ids"] = np.asarray(ids, np.int32)
    if ids:
        by_id = dict(zip(ids, g["poses"]))
        arrays["pg.pose_ids"] = np.asarray(sorted(by_id), np.int32)
        arrays["pg.poses"] = np.stack([by_id[k] for k in sorted(by_id)]).astype(np.float64)
    if len(g["prior_keys"]):
        arrays["pg.prior_keys"] = g["prior_keys"].astype(np.int32)
        arrays["pg.prior_meas"] = g["prior_measured"].astype(np.float64)
        arrays["pg.prior_sqrt"] = g["prior_sqrt_info"].astype(np.float64)
    if len(g["between_keys"]):
        arrays["pg.bt_from"] = g["between_keys"][:, 0].astype(np.int32)
        arrays["pg.bt_to"] = g["between_keys"][:, 1].astype(np.int32)
        arrays["pg.bt_meas"] = g["between_measured"].astype(np.float64)
        arrays["pg.bt_sqrt"] = g["between_sqrt_info"].astype(np.float64)

    for name, val in est.loop_detector.export_state().items():
        arrays[f"lc.{name}"] = val.view(np.uint32) if name in ("iris_T", "iris_M") else val

    meta = {
        "version": CHECKPOINT_VERSION,
        "initialized": bool(est.initialized),
        "next_keyframe_id": int(est.next_keyframe_id),
        "last_successful_loop_kf_id": int(est.last_successful_loop_kf_id),
        "frame_count": int(est.frame_count),
        "T_current": est.T_current.tolist(),
        "velocity": est.velocity.tolist(),
        "prev_pose": est._prev_pose.tolist(),
        "last_keyframe_pose": est.last_keyframe_pose.tolist(),
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            _write_npy(zf, name, arr)
        for kf in kfs:
            _write_npy(zf, f"kf.cloud.{kf.kf_id:06d}", _live_prefix(kf))


def restore(path: str, config: SystemConfig, sync_loop: bool = False,
            device="cuda") -> Estimator:
    """A fresh Estimator on `device` holding the archive's state. The
    archive's map tables must have the config's capacities."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("checkpoint.restore: no CUDA device (pass device='cpu' for the CPU)")
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta_json"]).decode())
    if meta["version"] not in (1, 2, CHECKPOINT_VERSION):
        raise ValueError(f"checkpoint.restore: unknown archive version {meta['version']}")

    est = Estimator(config, sync_loop=sync_loop, device=device)
    state = convert.map_state_from_numpy(
        {name: data[f"map.{name}"] for name in convert.MAP_FIELDS}, device=device)
    for name in convert.TABLES:
        have, want = getattr(state, name).shape, getattr(est.map_state, name).shape
        if have != want:
            raise ValueError(f"checkpoint.restore: map.{name} has shape {tuple(have)}, the "
                             f"config's map {tuple(want)}")
    est.map_state = state

    # each npz member is read (and inflated) once
    ids = data["kf.ids"]
    if len(ids):
        masks, poses, rels = data["kf.masks"], data["kf.poses"], data["kf.relatives"]
        frame_index = data["kf.frame_index"]
    stacked = data["kf.clouds"] if "kf.clouds" in data else None
    w = config.window_size
    kfs = []
    for i in range(len(ids)):
        kf_id = int(ids[i])
        mask = masks[i]
        in_window = w <= 0 or i >= len(ids) - w
        prefix = None
        if stacked is None:                # v3: the live rows, one entry a keyframe
            prefix = data[f"kf.cloud.{kf_id:06d}"]
            cloud = None
            if in_window:
                cloud = np.zeros((mask.shape[0], 3), np.float32)
                cloud[mask] = prefix
        else:                              # v1, v2: the padded clouds, stacked
            cloud = stacked[i]
        rec = KeyframeRecord(kf_id=kf_id, stored_pose=poses[i], relative_pose=rels[i],
                             feature_cloud=cloud, feature_mask=mask,
                             frame_index=int(frame_index[i]))
        if cloud is None:
            # out of the window: the live rows go straight to the spool
            if est._spool_dir is None:
                est._spool_dir = tempfile.mkdtemp(prefix="lot_kfspool_")
            rec._spill_path = os.path.join(est._spool_dir, f"kf_{kf_id:06d}.npz")
            np.savez(rec._spill_path, pts=prefix)
        kfs.append(rec)
    with est._keyframes_lock:
        est.keyframes = kfs
    est._spill_old_keyframes()     # v1 and v2 clouds land resident

    fr_ref, fr_index, fr_is_kf = data["fr.kf_ref"], data["fr.kf_index"], data["fr.is_kf"]
    fr_rel = data["fr.relatives"] if len(fr_ref) else None
    est.frames = [FrameRecord(kf_ref=int(fr_ref[i]), relative_pose=fr_rel[i],
                              is_keyframe=bool(fr_is_kf[i]), kf_index=int(fr_index[i]))
                  for i in range(len(fr_ref))]

    kf_ids = [int(k) for k in data["pg.kf_ids"]]
    pg_poses = (dict(zip((int(k) for k in data["pg.pose_ids"]), data["pg.poses"]))
                if "pg.pose_ids" in data else {})
    has_p, has_b = "pg.prior_keys" in data, "pg.bt_from" in data
    bt_keys = (np.stack([data["pg.bt_from"], data["pg.bt_to"]], 1) if has_b
               else np.zeros((0, 2), np.int64))
    n_loops = int(np.sum(bt_keys[:, 1] != bt_keys[:, 0] + 1))
    est.pose_graph.import_factors({
        "keyframe_ids": np.asarray(kf_ids, np.int64),
        "poses": (np.stack([pg_poses[k] for k in kf_ids]) if kf_ids else np.zeros((0, 4, 4))),
        "prior_keys": data["pg.prior_keys"] if has_p else np.zeros((0,), np.int64),
        "prior_measured": data["pg.prior_meas"] if has_p else np.zeros((0, 4, 4)),
        "prior_sqrt_info": data["pg.prior_sqrt"] if has_p else np.zeros((0, 6, 6)),
        "between_keys": bt_keys,
        "between_measured": data["pg.bt_meas"] if has_b else np.zeros((0, 4, 4)),
        "between_sqrt_info": data["pg.bt_sqrt"] if has_b else np.zeros((0, 6, 6)),
        "counts": np.asarray([max(len(kf_ids) - 1, 0), n_loops], np.int64),
    })

    est.initialized = bool(meta["initialized"])
    est.next_keyframe_id = int(meta["next_keyframe_id"])
    est.last_successful_loop_kf_id = int(meta["last_successful_loop_kf_id"])
    est.frame_count = int(meta["frame_count"])
    est.T_current = np.asarray(meta["T_current"], np.float32)
    est.velocity = np.asarray(meta["velocity"], np.float32)
    est._prev_pose = np.asarray(meta["prev_pose"], np.float32)
    est.last_keyframe_pose = np.asarray(meta["last_keyframe_pose"], np.float32)

    if "lc.iris_kf_ids" in data:
        est.loop_detector.import_state({name: data[f"lc.{name}"] for name in _IRIS_FIELDS})
    elif config.enable_loop_detection:
        for kf in est.keyframes:
            est.loop_detector.add_keyframe(kf.feature_cloud, kf.feature_mask, kf.kf_id,
                                           kf.stored_pose[:3, 3])
    return est
