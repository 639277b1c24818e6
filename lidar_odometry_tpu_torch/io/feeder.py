"""Chunk feeder: background assembly and device staging of scan batches
for the players' chunk mode (counterpart of the JAX package's
io/feeder.py).

A fill thread decodes the files of the next chunk, assembles them into a
NaN-padded (F, N, 3) batch in pinned host memory, and starts its copy to
the device on a side stream, so that the upload of chunk c+1 overlaps the
device work of chunk c; the consumer's stream waits for the copy before
it reads the batch. A bounded queue (`lookahead`, 2 chunks by default)
throttles the reader to the consumer's speed; `prestage` lifts the bound,
so that every chunk uploads as fast as the reader goes.

.bin files are read with numpy (KITTI layout: float32 x, y, z, intensity).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..utils import logging_util as log

__all__ = ["ChunkFeeder", "ReadAhead", "raw_capacity_for", "load_bin"]

_END = object()


def load_bin(path: str) -> np.ndarray:
    """(N, 3) float32 x, y, z of a KITTI velodyne .bin file."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3].copy()


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put unless stopped; False once the consumer has closed."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class ReadAhead:
    """Per-frame read-ahead: decodes the next few files on a background
    thread while the current frame is processed. Yields raw (N, 3) arrays;
    a decode error yields None for the caller to skip. close() stops the
    thread even when the consumer leaves early."""

    def __init__(self, paths: List[str], loader: Callable[[str], np.ndarray],
                 lookahead: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._stop = threading.Event()

        def fill():
            for p in paths:
                try:
                    item = loader(p)
                except Exception as e:
                    log.error("[feeder] decode failed for {}: {}", p, repr(e))
                    item = None
                if not _put(self._q, item, self._stop):
                    return
            _put(self._q, _END, self._stop)

        self._thread = threading.Thread(target=fill, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _END:
                return
            yield item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def raw_capacity_for(paths: List[str], cap_multiple: int = 2048,
                     point_stride: int = 1) -> int:
    """Fixed raw-scan pad size for a dataset: the largest point count over
    the files (after decode-time striding), rounded up to a multiple, so
    that every chunk has one shape. .bin sizes follow from the file size
    (16 bytes a point); other formats load their largest file."""
    if all(p.endswith(".bin") for p in paths):
        n_max = max(os.path.getsize(p) // 16 for p in paths)
    else:
        from .ply import load_ply
        biggest = max(paths, key=os.path.getsize)
        n_max = len(load_ply(biggest) if biggest.endswith(".ply") else load_bin(biggest))
    n_max = -(-n_max // max(point_stride, 1))
    return int(-(-max(n_max, 1) // cap_multiple) * cap_multiple)


class ChunkFeeder:
    """Iterate (chunk_frames, raw_capacity, 3) NaN-padded scan batches over
    `paths`, assembled (and staged on `device`) ahead of the consumer. Only
    full chunks are yielded; the remaining paths are in `.tail` for the
    caller's per-frame path. A CUDA device gets tensors already on the
    card; "cpu" gets numpy arrays."""

    def __init__(self, paths: List[str], chunk_frames: int,
                 loader: Optional[Callable[[str], np.ndarray]] = None,
                 device="cuda", point_stride: int = 1, lookahead: int = 2,
                 prestage: bool = False, stage_device: bool = True):
        """`point_stride` > 1 applies the pipeline's stride-skip at decode
        time instead of on the device: the same points (it is the voxel
        filter's first step) and a smaller upload. The consumer's voxel
        filter must then run with stride 1. `lookahead` chunks are
        assembled ahead of the consumer; `prestage` assembles (and
        uploads) all of them as fast as the reader goes.

        `stage_device` is accepted as True only: on a CUDA device each
        chunk is always staged on the card by the fill thread's stream,
        because a host batch would make the consumer's upload a blocking
        copy on its own stream, in series with the chunk's device work;
        device="cpu" yields numpy batches."""
        if not stage_device:
            raise ValueError("ChunkFeeder stages every chunk on its device; stage_device=False "
                             "is not supported (pass device='cpu' for host batches)")
        n_full = (len(paths) // chunk_frames) * chunk_frames
        self.paths = list(paths[:n_full])
        self.tail = list(paths[n_full:])
        self.chunk_frames = chunk_frames
        self.point_stride = max(int(point_stride), 1)
        self.capacity = raw_capacity_for(paths, point_stride=self.point_stride)
        self.device = torch.device(device)
        self.n_chunks = len(self.paths) // chunk_frames
        self._loader = loader or load_bin
        self._q: queue.Queue = queue.Queue(maxsize=self.n_chunks + 1 if prestage
                                           else max(int(lookahead), 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(device=self.device) if cuda else None
        try:
            for c in range(self.n_chunks):
                if self._stop.is_set():
                    return
                shape = (self.chunk_frames, self.capacity, 3)
                # the copy below reads the pinned tensor itself, so that the
                # pinned-memory allocator holds the block until the copy ends
                pinned = torch.empty(shape, dtype=torch.float32, pin_memory=True) if cuda else None
                host = pinned.numpy() if cuda else np.empty(shape, np.float32)
                host.fill(np.nan)
                for i in range(self.chunk_frames):
                    cloud = self._loader(self.paths[c * self.chunk_frames + i])
                    if cloud is None:
                        continue
                    cloud = cloud[::self.point_stride]
                    n = min(len(cloud), self.capacity)
                    host[i, :n] = cloud[:n]
                item = host
                if cuda:
                    with torch.cuda.stream(stream):
                        dev = pinned.to(self.device, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    item = (dev, ready)
                if not _put(self._q, item, self._stop):
                    return
        except Exception as e:   # surface the error, end the stream
            log.error("[feeder] chunk assembly failed: {}", repr(e))
        _put(self._q, _END, self._stop)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _END:
                return
            if isinstance(item, tuple):
                dev, ready = item
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ready)
                dev.record_stream(cur)
                item = dev
            yield item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
