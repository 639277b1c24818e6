"""Host times of the port's two KITTI .bin loaders and their read-ahead, on
full-size scans: the native library (runtime/native_io.py:
load_kitti_binary, Prefetcher) against numpy (io/feeder.py: load_bin,
ReadAhead).

It writes FILES scans of POINTS points (x, y, z, intensity float32, 1.92
MB a scan at 120000 points, a KITTI HDL-64 scan's size) from a seed into
a temporary directory, then, for each loader:
  * a load: the median and mean of one file's load over every file, in
    PASSES passes (the files were just written, so the reads are warm:
    page cache, no disk);
  * the read-ahead in order over every file, consumed by a frame loop
    that works W ms a frame before asking for the next cloud, for each W
    of WORK_MS, in two ways: sleeping (the GIL free, as while the host
    waits on the card) and spinning in Python (the GIL held, as while the
    host issues the frame's device work). Reported: the loop's wall time
    and the time it waited for clouds, a frame.
Both loaders must return the same clouds (checked on every file).

    python tools/kitti_loader_times.py [--files 100] [--points 120000]
        [--lookahead 4] [--passes 3] [--out chiprun_out/kitti_loader_times.json]

It imports nothing of JAX and needs no card; it prints the host's CPU
model and core count beside its numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORK_MS = (0.0, 4.0, 8.0)


def write_scans(root: Path, files: int, points: int, seed: int) -> list:
    g = np.random.default_rng(seed)
    paths = []
    for i in range(files):
        rows = g.uniform(-80.0, 80.0, size=(points, 4)).astype(np.float32)
        p = root / f"{i:06d}.bin"
        rows.tofile(p)
        paths.append(str(p))
    return paths


def load_times(load, paths: list, passes: int) -> dict:
    ms = []
    for _ in range(passes):
        for p in paths:
            t0 = time.perf_counter()
            load(p)
            ms.append((time.perf_counter() - t0) * 1e3)
    return dict(median_ms=statistics.median(ms), mean_ms=statistics.fmean(ms))


def work(ms: float, spin: bool) -> None:
    if ms <= 0:
        return
    if not spin:
        time.sleep(ms / 1e3)
        return
    end = time.perf_counter() + ms / 1e3
    x = 0
    while time.perf_counter() < end:
        x += 1


def read_ahead(make_next, n: int, ms: float, spin: bool) -> dict:
    """A frame loop over n clouds from make_next() (a callable giving the
    next cloud), working `ms` a frame."""
    nxt, close = make_next()
    waited = 0.0
    t_run = time.perf_counter()
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            cloud = nxt()
            waited += time.perf_counter() - t0
            if cloud is None:
                raise SystemExit("a read-ahead returned no cloud")
            work(ms, spin)
    finally:
        close()
    wall = time.perf_counter() - t_run
    return dict(wall_ms_per_frame=wall * 1e3 / n, wait_ms_per_frame=waited * 1e3 / n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--files", type=int, default=100)
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--lookahead", type=int, default=4)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from lidar_odometry_tpu_torch.io import feeder
    from lidar_odometry_tpu_torch.runtime import native_io

    cpu = next((line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
                if line.startswith("model name")), "unknown")
    host = f"{cpu}, {os.cpu_count()} cores visible"
    if native_io.loader_name() != "native":
        raise SystemExit("the native library did not build or load")
    tmp = Path(tempfile.mkdtemp(prefix="kitti_loader_"))
    try:
        paths = write_scans(tmp, args.files, args.points, args.seed)
        for p in paths:
            if not np.array_equal(native_io.load_kitti_binary(p), feeder.load_bin(p)):
                raise SystemExit(f"the loaders disagree on {p}")
        out = dict(host=host, files=args.files, points=args.points,
                   mb_a_file=args.points * 16 / 1e6, lookahead=args.lookahead, reads="warm",
                   load=dict(native=load_times(native_io.load_kitti_binary, paths, args.passes),
                             numpy=load_times(feeder.load_bin, paths, args.passes)))
        print(f"host: {host}; {args.files} files of {args.points} points "
              f"({args.points * 16 / 1e6:.2f} MB), warm reads", flush=True)
        for k, v in out["load"].items():
            print(f"  load ({k}): median {v['median_ms']:.4f} ms, mean {v['mean_ms']:.4f} ms a "
                  f"file", flush=True)

        def native():
            pf = native_io.Prefetcher(paths, lookahead=args.lookahead)
            return pf.next, pf.close

        def numpy_ra():
            ra = feeder.ReadAhead(paths, feeder.load_bin, lookahead=args.lookahead)
            it = iter(ra)
            return (lambda: next(it)), ra.close

        runs = []
        for ms in WORK_MS:
            for spin in (False, True):
                for name, make in (("native Prefetcher", native), ("numpy ReadAhead", numpy_ra),
                                   ("numpy ReadAhead", numpy_ra), ("native Prefetcher", native)):
                    r = dict(loader=name, work_ms=ms, work="spin (GIL held)" if spin
                             else "sleep (GIL free)", **read_ahead(make, len(paths), ms, spin))
                    runs.append(r)
                    print(f"  read-ahead ({name}; {r['work']}, {ms:g} ms a frame): "
                          f"{r['wall_ms_per_frame']:.4f} ms a frame, waited "
                          f"{r['wait_ms_per_frame']:.4f} ms a frame", flush=True)
        out["read_ahead"] = runs
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
        print(json.dumps(out))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
