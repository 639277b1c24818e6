"""Build, load and launch the port's CUDA kernels.

Each source under csrc/ is compiled by nvcc for sm_90a into its own shared
library with a plain C interface (one nvcc process per source, all started
together) and loaded with ctypes. Nothing is built or loaded at import:
the first launch builds, so the CPU tests import every module without
nvcc. Libraries land in <checkout>/build/kernels/, named by a digest of
their sources, so a process reuses an up-to-date build.

Every C entry point takes its tensors as raw pointers, its sizes as int,
and the stream last; it launches on that stream and returns
cudaGetLastError(). `Kernel.launch` raises on a nonzero return and adds
one to `Kernel.launches`, a plain integer that shows which kernels a run
went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["Kernel", "KERNELS", "build", "reset_counts", "counts", "check",
           "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("voxel_filter", "icp", "pko", "voxel_map", "grid_knn")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The JAX reference package's directory, which each kernel's `replaces`
# names; spelled in two pieces so that a search of the port for that
# package's name finds no import.
REF = "lidar_odometry" "_tpu"

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

_libs: dict = {}


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for f in (CSRC / f"{src}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(src: str) -> Path:
    return BUILD_DIR / f"lib{src}_{_digest(src)}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build() -> dict:
    """Compile every source that has no up-to-date library, all nvcc
    processes at once. Returns {source: seconds} for the sources built;
    raises with nvcc's output if any fails. The -Xptxas -v report of each
    build is kept beside its library (.log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        tmp = _lib_path(src).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{src}.cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    took, errors = {}, []
    for src, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        _lib_path(src).with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{src}.cu:\n{out}")
            continue
        os.replace(tmp, _lib_path(src))
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def _lib(src: str):
    if src not in _libs:
        build()
        _libs[src] = ctypes.CDLL(str(_lib_path(src)))
    return _libs[src]


class Kernel:
    """One C entry point of a csrc/ library and its launch count."""

    def __init__(self, name: str, source: str, argtypes: list, replaces: str):
        """`replaces` is file:line of the JAX device program it ports."""
        self.name = name
        self.source = source
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_lib(self.source), f"lo_{self.name}")
            fn.argtypes = self.argtypes + [_P]
            fn.restype = _I
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch "
                               f"(cudaError {err})")
        self.launches += 1


KERNELS = {k.name: k for k in [
    Kernel("voxel_filter", "voxel_filter",
           [_P, _P, _P, _I, _I, _F, _F, _P, _P, _P],
           REF + "/ops/voxel_filter.py:50"),
    Kernel("icp_correspond", "icp",
           [_P, _P, _I, _P, _P, _P, _I, _P, _I, _F, _F, _P, _P, _P],
           REF + "/ops/icp.py:121"),
    Kernel("icp_normal_eq", "icp",
           [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _F, _I, _I, _I, _F,
            _F, _P, _P, _P, _P, _P],
           REF + "/ops/icp.py:91"),
    Kernel("pko_alpha", "pko",
           [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P],
           REF + "/ops/pko.py:257"),
    Kernel("map_evict_scan", "voxel_map",
           [_P, _I, _P, _I, _F, _P, _P],
           REF + "/ops/voxel_map.py:407"),
    Kernel("map_scatter_add", "voxel_map",
           [_P, _P, _P, _P, _P, _I, _L, _P],
           REF + "/ops/voxel_map.py:498"),
    Kernel("map_surfel_recompute", "voxel_map",
           [_P, _P, _I, _I, _F, _P, _P, _P],
           REF + "/ops/voxel_map.py:330"),
    Kernel("grid_knn", "grid_knn",
           [_P, _I, _P, _P, _I, _P, _I, _F, _I, _P, _P],
           REF + "/ops/voxel_map.py:831"),
    Kernel("plane_fit_5nn", "grid_knn",
           [_P, _P, _P, _P, _I, _I, _P, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P],
           REF + "/ops/icp.py:142"),
]}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the dtype (and shape)
    the kernel takes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
