"""ctypes bindings of the native KITTI loader (runtime/native/io_native.cpp;
counterpart of the JAX package's runtime/native_io.py), with the numpy
path the JAX loader takes where the library cannot be built or loaded.

Nothing is built at import. The first call compiles the library with g++
into <checkout>/build/native/, named by a digest of its source and flags:
under a file lock, to a temporary name and then os.replace, so that
processes building at once never load a half-written library. This is
host file I/O, not a device kernel; loader_name() says which path is in
use.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils import logging_util as log

__all__ = ["load_kitti_binary", "Prefetcher", "loader_name", "library_path", "MAX_POINTS",
           "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parent / "native" / "io_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared"]
MAX_POINTS = 400000     # points a call returns at most (the JAX loader's)

_lib = None
_lib_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libio_native_{h.hexdigest()[:12]}.so"


def _build(lib: Path) -> None:
    """Compile the library to `lib` unless it is there, under a lock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise OSError("no C++ compiler (g++) found")
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise OSError(f"g++ failed on {SOURCE.name}: {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, lib)


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        path = library_path()
        _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError) as e:
        log.warn("[native_io] build or load failed ({}); using the numpy loader", repr(e))
        return None
    lib.lo_load_kitti_bin.restype = ctypes.c_long
    lib.lo_load_kitti_bin.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_long]
    lib.lo_prefetcher_create.restype = ctypes.c_void_p
    lib.lo_prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                                         ctypes.c_int]
    lib.lo_prefetcher_next.restype = ctypes.c_long
    lib.lo_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_long]
    lib.lo_prefetcher_destroy.restype = None
    lib.lo_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def loader_name() -> str:
    """"native" where the library is built and loaded (building it on a
    first call), else "numpy"."""
    return "native" if _load_library() is not None else "numpy"


def _as_floats(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_kitti_binary(path: str) -> np.ndarray:
    """(N, 3) float32 x, y, z of a KITTI .bin file (x, y, z, intensity
    float32 a point): its first MAX_POINTS points at most, through the
    library and through numpy alike."""
    lib = _load_library()
    if lib is not None:
        # the cloud is a view of its buffer, no copy: only the pages that
        # the library wrote are ever touched
        buf = np.empty((MAX_POINTS, 3), np.float32)
        n = lib.lo_load_kitti_bin(path.encode(), _as_floats(buf), MAX_POINTS)
        if n >= 0:
            return buf[:n]
    raw = np.fromfile(path, dtype=np.float32)
    return raw.reshape(-1, 4)[:MAX_POINTS, :3].copy()


class Prefetcher:
    """Ordered read-ahead over a file list: a C++ thread decodes the scans
    after the current one, at most `lookahead` ahead. next() returns each
    cloud in order, then None; None also for a file that cannot be read.
    Without the library it loads each file when asked (numpy)."""

    def __init__(self, paths: List[str], lookahead: int = 4):
        self._paths = list(paths)
        self._idx = 0
        self._handle = None
        self._lib = _load_library()
        if self._lib is not None and self._paths:
            arr = (ctypes.c_char_p * len(self._paths))(*[p.encode() for p in self._paths])
            self._handle = self._lib.lo_prefetcher_create(arr, len(self._paths), lookahead)

    def next(self) -> Optional[np.ndarray]:
        if self._idx >= len(self._paths):
            return None
        path = self._paths[self._idx]
        self._idx += 1
        if self._handle:
            buf = np.empty((MAX_POINTS, 3), np.float32)
            n = self._lib.lo_prefetcher_next(self._handle, _as_floats(buf), MAX_POINTS)
            return buf[:n] if n >= 0 else None
        try:
            return load_kitti_binary(path)
        except (OSError, ValueError) as e:
            log.error("[native_io] cannot read {}: {}", path, repr(e))
            return None

    def close(self) -> None:
        if self._handle:
            self._lib.lo_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
