"""PLY dataset player for MID360-style indoor datasets (counterpart of the
JAX package's io/ply.py): a directory of per-frame .ply files, the frame
number parsed from the file name, the trajectory saved in TUM or KITTI
format.

The header parser takes binary_little_endian and ascii files with any
per-vertex property layout.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from ..config import SystemConfig
from ..models.estimator import Estimator
from ..utils import logging_util as log

__all__ = ["load_ply", "save_ply", "frame_number", "PlyPlayerResult", "PLYPlayer"]

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> np.ndarray:
    """(N, 3) float32 x,y,z from an ascii or binary_little_endian PLY."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        n_vertex = 0
        props: List[tuple] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((tok[2], _PLY_TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex, ndmin=2)
            names = [p[0] for p in props]
            idx = [names.index(c) for c in ("x", "y", "z")]
            return data[:, idx].astype(np.float32)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format: {fmt}")
        dtype = np.dtype([(name, "<" + t) for name, t in props])
        data = np.fromfile(f, dtype=dtype, count=n_vertex)
        out = np.empty((len(data), 3), np.float32)
        for i, c in enumerate(("x", "y", "z")):
            out[:, i] = data[c].astype(np.float32)
        return out


def save_ply(path: str, points: np.ndarray):
    """Binary little-endian PLY of (N, 3) float32 points."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pts = np.ascontiguousarray(points, dtype="<f4")
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(pts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"end_header\n")
        f.write(pts.tobytes())


def frame_number(path: str) -> int:
    """The frame index: the last run of digits in the file name."""
    m = re.findall(r"(\d+)", os.path.basename(path))
    return int(m[-1]) if m else 0


# what a player never skips: a kernel's build, launch or input fault and
# torch's CUDA errors (out of memory, a failed CUDA call, a fault during a
# kernel's run)
DEVICE_FAULTS = (kernels.KernelError, torch.OutOfMemoryError, torch.AcceleratorError,
                 torch.cuda.CudaError)


@dataclass
class PlyPlayerResult:
    frames_processed: int = 0
    frames_failed: int = 0      # of frames_processed: process_frame raised
    total_time_s: float = 0.0
    fps: float = 0.0
    trajectory_path: str = ""


class PLYPlayer:
    """Runs the Estimator over a directory of .ply frames: in chunk mode
    (chunk_frames > 1) the full chunks go through process_chunk, fed by a
    ChunkFeeder, and the frames left over go through process_frame; else
    every frame goes through process_frame. As the JAX player does, an
    exception from process_frame is logged with the frame's index in the
    run, the frame counts as processed (and failed) and the run goes on;
    a kernel fault (kernels.KernelError, a wrapper's refusal of its
    tensors included) or torch's CUDA error is raised all the same
    (DEVICE_FAULTS), since skipping it would hide the device's failure.
    An error in a chunk is raised. A file that fails to decode is skipped."""

    def __init__(self, config: SystemConfig, device="cuda"):
        self.cfg = config
        self.device = device
        self.estimator: Optional[Estimator] = None

    def ply_files(self) -> List[str]:
        # the dataset is data_directory/seq, or the bare directory for flat layouts
        d = os.path.join(self.cfg.data_directory, self.cfg.seq)
        if not os.path.isdir(d):
            d = self.cfg.data_directory
        if not os.path.isdir(d):
            return []
        files = [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".ply")]
        return sorted(files, key=frame_number)

    def run(self, start: int = 0, end: Optional[int] = None, skip: int = 1,
            chunk_frames: Optional[int] = None, sync_loop: bool = False,
            live_viewer=None) -> PlyPlayerResult:
        """`sync_loop` runs each loop query inline at its keyframe instead
        of on the loop worker thread. `live_viewer` (a viewer.LiveViewer) gates
        the loop by its auto/step/finish controls, before each chunk and
        each frame, and takes a snapshot after each chunk, and after every
        5th frame or each frame in step mode."""
        from .feeder import ChunkFeeder, ReadAhead
        result = PlyPlayerResult()
        files = self.ply_files()[start:end:skip]
        if not files:
            log.error("[PLYPlayer] No .ply files found under {}", self.cfg.data_directory)
            return result
        log.info("[PLYPlayer] {} frames", len(files))
        if chunk_frames is None:
            chunk_frames = self.cfg.chunk_frames
        use_chunked = bool(chunk_frames and chunk_frames > 1)
        est_cfg = self.cfg
        if use_chunked and self.cfg.point_stride > 1:
            # the stride-skip moves to decode time (io/feeder.py)
            est_cfg = self.cfg.replace(point_stride=1)
        self.estimator = Estimator(est_cfg, sync_loop=sync_loop, device=self.device)
        frames_done = 0
        t_run = time.perf_counter()
        rest = files
        if use_chunked:
            if self.cfg.enable_loop_detection:
                self.estimator.warm_loop_programs()
            feeder = ChunkFeeder(files, int(chunk_frames), loader=load_ply, device=self.device,
                                 point_stride=self.cfg.point_stride)
            try:
                for c, chunk in enumerate(feeder):
                    # a finish stops the frame loop below at its first gate too
                    if live_viewer is not None and not live_viewer.wait_if_stepping():
                        break
                    self.estimator.process_chunk(chunk, sample_stages=(c % 8 == 0))
                    frames_done += int(chunk_frames)
                    if live_viewer is not None:
                        live_viewer.update(self.estimator)
            finally:
                feeder.close()
            rest = feeder.tail
        stride = max(self.cfg.point_stride, 1) if use_chunked else 1
        tail_load = (lambda p: load_ply(p)[::stride]) if stride > 1 else load_ply
        clouds = ReadAhead(rest, tail_load)
        try:
            for i, cloud in enumerate(clouds):
                if live_viewer is not None and not live_viewer.wait_if_stepping():
                    log.info("[PLYPlayer] finish requested by viewer")
                    break
                try:
                    if cloud is not None:
                        self.estimator.process_frame(cloud)
                except DEVICE_FAULTS:
                    raise
                except Exception as e:
                    log.error("[PLYPlayer] frame {} failed: {}", frames_done, repr(e))
                    result.frames_failed += 1
                frames_done += 1
                if live_viewer is not None and (i % 5 == 0 or live_viewer.mode == "step"):
                    live_viewer.update(self.estimator)
        finally:
            clouds.close()
        self.estimator.finalize_loops()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        result.total_time_s = time.perf_counter() - t_run
        result.frames_processed = frames_done
        result.fps = frames_done / max(result.total_time_s, 1e-9)

        if self.cfg.save_trajectory and self.cfg.output_directory:
            from .kitti import save_trajectory_kitti, save_trajectory_tum
            traj = self.estimator.trajectory()
            out_dir = os.path.join(self.cfg.output_directory, self.cfg.seq)
            result.trajectory_path = os.path.join(out_dir, f"{self.cfg.seq}_lo_tpu.txt")
            if self.cfg.trajectory_format == "tum":
                save_trajectory_tum(result.trajectory_path, traj)
            else:
                save_trajectory_kitti(result.trajectory_path, traj)
        self.estimator.shutdown()
        return result
