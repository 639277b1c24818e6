#!/usr/bin/env python3
"""Odometry drift on the loop circuit against scan density, for the JAX
estimator and the PyTorch port, on the CPU.

    python tools/loop_scan_density.py [--points 10000 16384] [--frames 220]

The circuit is the JAX loop test's (tests/test_loop_closure.py: seed 9, a
60 m world of 18 buildings, a 30 m x 10 m stadium at 0.6 m a frame, 220
frames) with scans of --points returns at 45 m range and noise 0.02. Both
estimators run config/kitti.yaml with point_stride 1 and loop closure off,
frame by frame, each in its own process (`--side jax` imports only the JAX
package, `--side torch` only the port). For each side and density it
prints one JSON line: per-frame ATE, the worst frame's position error, the
first frame whose position error passes 0.5 m, and the error at the
revisit frame (205, one lap after frame 0),
all relative to the first pose. This is the reading behind the
scan density of chip_smoke.py's loops path.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REVISIT = 205


def _scans(n_points: int, n_frames: int, synthetic):
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(220, length=30.0, radius=10.0, step=0.6)[:n_frames]
    rng = np.random.default_rng(9)
    scans = [synthetic.sample_scan(world, p, n_points, rng, max_range=45.0, noise=0.02)
             for p in poses]
    return scans, poses


def _run_side(side: str, n_points: int, n_frames: int) -> dict:
    sys.path.insert(0, ROOT)
    if side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from lidar_odometry_tpu.config import load_config
        from lidar_odometry_tpu.eval import ate_rmse
        from lidar_odometry_tpu.io import synthetic
        from lidar_odometry_tpu.models.estimator import Estimator
        make = lambda cfg: Estimator(cfg, sync_loop=True)
    else:
        import torch
        torch.set_num_threads(4)
        from lidar_odometry_tpu_torch.config import load_config
        from lidar_odometry_tpu_torch.eval import ate_rmse
        from lidar_odometry_tpu_torch.io import synthetic
        from lidar_odometry_tpu_torch.models.estimator import Estimator
        make = lambda cfg: Estimator(cfg, device="cpu")
    scans, gt = _scans(n_points, n_frames, synthetic)
    cfg = load_config(os.path.join(ROOT, "config", "kitti.yaml")).replace(
        point_stride=1, enable_loop_detection=False, enable_console_statistics=False)
    est = make(cfg)
    t0 = time.perf_counter()
    for s in scans:
        est.process_frame(s)
    wall = time.perf_counter() - t0
    traj = est.trajectory()
    # the estimator starts at the identity: compare with the ground truth
    # relative to its first pose
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    err = np.linalg.norm(traj[:, :3, 3] - rel[:, :3, 3], axis=1)
    lost = np.nonzero(err > 0.5)[0]
    return dict(side=side, points=n_points, frames=n_frames,
                returns_mean=float(np.mean([len(s) for s in scans])),
                ate_m=float(ate_rmse(traj, gt)), worst_m=float(err.max()),
                worst_frame=int(err.argmax()), first_frame_over_0_5_m=int(lost[0]) if len(lost)
                else None, revisit_err_m=float(err[REVISIT]) if n_frames > REVISIT else None,
                keyframes=len(est.keyframes), wall_s=wall)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, nargs="+", default=[10000, 16384])
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--side", choices=["jax", "torch"], help="run one side in this process")
    a = ap.parse_args()
    if a.side:
        for n in a.points:
            print(json.dumps(_run_side(a.side, n, a.frames)), flush=True)
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for side in ("jax", "torch"):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--side", side,
                        "--frames", str(a.frames), "--points", *map(str, a.points)],
                       env=env, check=True)


if __name__ == "__main__":
    main()
