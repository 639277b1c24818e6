"""Build, load and launch the port's CUDA kernels.

Each source under csrc/ is compiled by nvcc for sm_90a into its own shared
library with a plain C interface (one nvcc process per source, all started
together) and loaded with ctypes. Nothing is built or loaded at import:
the first launch builds, so the CPU tests import every module without
nvcc. Libraries land in <checkout>/build/kernels/, named by a digest of
their sources, so a process reuses an up-to-date build.

Every C entry point takes its tensors as raw pointers, its sizes as int,
and the stream last; it launches on that stream and returns
cudaGetLastError(). The lane-batched kernels (K1, K2b, K3) take the lane
count after the per-lane size and derive each lane's offsets from those
two; K2a takes the count of (lane, shard) instances, the instances a lane
holds, and each map table's lane and shard strides (lane strides 0 for
lanes that share one map); the shard kernels (K11a-d) take the count of shard
instances (lanes x local shards) the same way; the host solvers' kernels
(K12a, K12b) take an f64 flag and run in float or double. `Kernel.launch`
raises KernelError (a RuntimeError) on a nonzero return and adds one to
`Kernel.launches`, a plain integer that shows which kernels a run went
through; a launch that also runs another kernel's work in its grid (K11c's
sample slice in K11b's launch) adds one to that kernel's `Kernel.fused`
instead of its `launches` (`fused_counts`); a wrapper refuses tensors it
cannot launch on (device, dtype, layout, shape, alignment: `check`,
`check_aligned`) with
KernelInputError, a KernelError and a ValueError. The loop-closure worker launches from its own thread and stream
while the main thread runs chunks: the build, the library loads and the
counts are taken under one lock, and a launch goes to the calling
thread's current stream. K1's and K9b's wrappers keep scratch memory
between calls (`zeroed_scratch`): one zeroed buffer per kernel, device and
stream, which each launch leaves zeroed, so no fill is launched before it;
the others allocate theirs per call (K2b, K11b and K10d, whose sums meet
in a thread-block cluster's shared memory, need none).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["Kernel", "KernelError", "KernelInputError", "KERNELS", "build", "library",
           "ptxas_info", "ptxas_entries", "reset_counts", "counts", "fused_counts", "check",
           "check_aligned", "zeroed_scratch", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("voxel_filter", "icp", "pko", "voxel_map", "grid_knn", "knn", "bev_align", "iris",
           "rehash", "pgo", "shard", "schur")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The JAX reference package's directory, which each kernel's `replaces`
# names; spelled in two pieces so that a search of the port for that
# package's name finds no import.
REF = "lidar_odometry" "_tpu"

_P, _I, _F, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
                      ctypes.c_double)

_libs: dict = {}
_lock = threading.RLock()
_scratch: dict = {}


class KernelError(RuntimeError):
    """A kernel that could not be built or launched: nvcc missing or
    failing, or a launch refused (its cudaError). Callers that carry on
    past a failing frame (the PLY player) re-raise it: a kernel fault is
    never skipped."""


class KernelInputError(KernelError, ValueError):
    """A wrapper's refusal of the tensors it was given (device, dtype,
    layout, shape or alignment): the kernel did not run. A KernelError, so
    it is never skipped either, and a ValueError, as the wrong argument it
    is."""


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for f in [CSRC / f"{src}.cu"] + sorted(CSRC.glob("*.cuh")):
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
    raise KernelError("nvcc not found: the port's CUDA kernels cannot be built")


def build() -> dict:
    """Compile every source that has no up-to-date library, all nvcc
    processes at once. Returns {source: seconds} for the sources built;
    raises KernelError with nvcc's output if any fails. The -Xptxas -v
    report of each build is kept beside its library (.log)."""
    with _lock:
        return _build()


def _build() -> dict:
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
        raise KernelError("\n".join(errors))
    return took


def ptxas_info(src: str, kernel: str) -> dict:
    """ptxas's -v report of the first entry function of csrc/<src>.cu whose
    (mangled) name holds `kernel`, read from its build's log: registers,
    and the stack frame, spill stores and spill loads in bytes. Builds the
    kernels if needed."""
    return next(iter(ptxas_entries(src, kernel).values()))


def ptxas_entries(src: str, kernel: str) -> dict:
    """ptxas_info of every entry function of csrc/<src>.cu whose mangled
    name holds `kernel` (each instantiation of a template), by that name,
    in the log's order."""
    with _lock:
        _build()
    lines = _lib_path(src).with_suffix(".log").read_text().splitlines()
    heads = [i for i, l in enumerate(lines) if "Compiling entry function" in l]
    out = {}
    for n, head in enumerate(heads):
        name = re.search(r"Compiling entry function '([^']+)'", lines[head])
        if name is None or kernel not in name.group(1):
            continue
        end = heads[n + 1] if n + 1 < len(heads) else len(lines)
        text = " ".join(lines[head:end])
        grab = lambda pat: int(re.search(pat, text).group(1))
        out[name.group(1)] = dict(registers=grab(r"Used (\d+) registers"),
                                  stack=grab(r"(\d+) bytes stack frame"),
                                  spill_stores=grab(r"(\d+) bytes spill stores"),
                                  spill_loads=grab(r"(\d+) bytes spill loads"))
    if not out:
        raise KernelError(f"no entry function {kernel!r} in the build log of csrc/{src}.cu")
    return out


def library(src: str):
    """The loaded library of csrc/<src>.cu, built first if needed."""
    with _lock:
        if src not in _libs:
            _build()
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
        self.fused = 0      # launches of this kernel's work inside another's launch
        self._fn = None

    def launch_shape(self) -> dict:
        """A cluster kernel's launch shape as its source builds the launch
        (its `lo_<name>_shape` export): CTAs a cluster, threads a CTA, CTAs
        a launch. Builds the kernels if needed."""
        fn = getattr(library(self.source), f"lo_{self.name}_shape")
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
        out = (ctypes.c_int * 3)()
        fn(out)
        return dict(zip(("cluster", "threads", "grid"), out))

    def launch(self, *args, fused: tuple = ()) -> None:
        """Launch on the calling thread's current stream; `fused` names the
        kernels whose work this launch runs in its grid as well."""
        if self._fn is None:
            fn = getattr(library(self.source), f"lo_{self.name}")
            fn.argtypes = self.argtypes + [_P]
            fn.restype = _I
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise KernelError(f"CUDA kernel {self.name} failed to launch "
                               f"(cudaError {err})")
        with _lock:
            self.launches += 1
            for name in fused:
                KERNELS[name].fused += 1


KERNELS = {k.name: k for k in [
    Kernel("voxel_filter", "voxel_filter",
           [_P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
           REF + "/ops/voxel_filter.py:50"),
    Kernel("icp_correspond", "icp",
           [_P, _P, _I, _I, _I, _P, _P, _P, _L, _L, _I, _P, _L, _L, _I, _F, _F, _P, _P, _P],
           REF + "/ops/icp.py:121"),
    Kernel("icp_normal_eq", "icp",
           [_P] * 5 + [_I] * 2 + [_P] * 5 + [_I, _F, _I, _I, _I, _F, _F] + [_P] * 3,
           REF + "/ops/icp.py:91"),
    Kernel("pko_alpha", "pko",
           [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P],
           REF + "/ops/pko.py:257"),
    Kernel("map_evict_scan", "voxel_map",
           [_P, _I, _P, _I, _F, _P, _P],
           REF + "/ops/voxel_map.py:407"),
    Kernel("map_scatter_add", "voxel_map",
           [_P] * 7 + [_I, _L, _P],
           REF + "/ops/voxel_map.py:498"),
    Kernel("map_surfel_recompute", "voxel_map",
           [_P, _P, _I, _I, _F, _P, _P, _P],
           REF + "/ops/voxel_map.py:330"),
    Kernel("grid_knn", "grid_knn",
           [_P, _I, _P, _P, _P, _I, _P, _I, _F, _I, _P, _P],
           REF + "/ops/voxel_map.py:831"),
    Kernel("plane_fit_5nn", "grid_knn",
           [_P, _P, _P, _P, _I, _I, _P, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P],
           REF + "/ops/icp.py:142"),
    Kernel("point_grid", "knn",
           [_P, _P, _I, _F, _P, _P],
           REF + "/ops/knn.py:47"),
    Kernel("point_knn", "knn",
           [_P, _I, _P, _P, _P, _I, _P, _P, _F, _I, _I, _P, _P, _P],
           REF + "/ops/knn.py:112"),
    Kernel("point_nn1", "knn",
           [_P, _I, _P, _P, _P, _I, _P, _P, _F, _I, _I, _P, _P, _P],
           REF + "/ops/knn.py:152"),
    Kernel("bev_raster", "bev_align",
           [_P, _P, _I, _P, _P, _P, _I, _P, _I, _F, _P],
           REF + "/ops/bev_align.py:40"),
    Kernel("cross_power", "bev_align",
           [_P, _I, _P, _I, _P, _I, _P],
           REF + "/ops/bev_align.py:61"),
    Kernel("iris_image", "iris",
           [_P, _P, _I, _I, _F, _P],
           REF + "/ops/iris.py:50"),
    Kernel("gabor_product", "iris",
           [_P, _P, _I, _P],
           REF + "/ops/iris.py:114"),
    Kernel("iris_encode", "iris",
           [_P, _I, _F, _F, _P, _P],
           REF + "/ops/iris.py:105"),
    Kernel("iris_hamming", "iris",
           [_P, _P, _I, _P, _P, _P, _I, _P],
           REF + "/ops/iris.py:144"),
    Kernel("map_bulk_index", "rehash",
           [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
           REF + "/ops/voxel_map.py:967"),
    Kernel("map_bulk_merge", "rehash",
           [_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
           REF + "/ops/voxel_map.py:1029"),
    Kernel("pgo_linearize", "pgo",
           [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I] + [_P] * 9,
           REF + "/parallel/distributed_pgo.py:521"),
    Kernel("pgo_eliminate", "pgo",
           [_P] * 12 + [_I] * 3 + [_P] * 7,
           REF + "/parallel/distributed_pgo.py:450"),
    Kernel("pgo_reduced_solve", "pgo",
           [_P] * 12 + [_I] * 2 + [_P] * 3,
           REF + "/parallel/distributed_pgo.py:625"),
    Kernel("pgo_backsub_retract", "pgo",
           [_P] * 8 + [_I] * 3 + [_D] + [_P] * 2,
           REF + "/parallel/distributed_pgo.py:649"),
    Kernel("pgo_block_thomas", "schur",
           [_P] * 3 + [_I] * 3 + [_P] * 2,
           REF + "/parallel/distributed_pgo.py:74"),
    Kernel("pgo_eliminate_lu", "schur",
           [_P] * 7 + [_I] * 3 + [_P] * 6,
           REF + "/parallel/distributed_pgo.py:104"),
    Kernel("shard_own", "shard",
           [_P, _P, _I, _I, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P],
           REF + "/parallel/sharded_map.py:92"),
    Kernel("shard_alpha_normal_eq", "shard",
           [_P] * 4 + [_I] * 3 + [_P] * 3 + [_I, _P] + [_I] * 5 + [_P, _P] + [_I] * 3,
           REF + "/parallel/sharded_map.py:312"),
    Kernel("shard_sample", "shard",
           [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _I, _I, _P],
           REF + "/parallel/sharded_map.py:331"),
    Kernel("shard_gn_select", "shard",
           [_P] + [_I] * 6 + [_P] * 5 + [_I] * 2 + [_F] * 2 + [_P] * 3,
           REF + "/parallel/sharded_map.py:346"),
]}


def reset_counts() -> None:
    with _lock:
        for k in KERNELS.values():
            k.launches = 0
            k.fused = 0


def counts() -> dict:
    with _lock:
        return {name: k.launches for name, k in KERNELS.items()}


def fused_counts() -> dict:
    """Each kernel's work launched inside another kernel's launch."""
    with _lock:
        return {name: k.fused for name, k in KERNELS.items()}


def check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise KernelInputError unless `t` is a contiguous CUDA tensor of the
    dtype (and shape) the kernel takes."""
    if not t.is_cuda:
        raise KernelInputError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise KernelInputError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise KernelInputError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise KernelInputError(f"{name}: expected shape {tuple(shape)}, "
                               f"got {tuple(t.shape)}")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise KernelInputError unless `t` starts on a 16-byte boundary: the
    kernels read its rows as 16-byte vectors."""
    if t.data_ptr() % 16:
        raise KernelInputError(f"{name}: the kernel reads 16-byte vectors; expected a "
                               f"16-byte aligned tensor")


def zeroed_scratch(name: str, device, words: int) -> torch.Tensor:
    """At least `words` int64 of zeroed scratch for kernel `name` on the
    calling thread's current stream of `device`, kept between calls: its
    kernel leaves it zeroed when it ends. A stream runs its launches in
    order, so they share one buffer; a larger request replaces it with a
    new zeroed one (the only fill, at a first or larger call)."""
    key = (name, torch.device(device).index, torch.cuda.current_stream().cuda_stream)
    with _lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.zeros((max(words, 256),), dtype=torch.int64, device=device)
            _scratch[key] = buf
        return buf
