#!/usr/bin/env python3
"""What the JAX package's checkpoint does with a sharded map, on the CPU.

    python tools/jax_sharded_checkpoint.py [--out DIR]

Runs the JAX Estimator with its ShardedMapBackend over a mesh of 4 CPU
devices (loops off, 8 frames of a straight drive), saves it with the JAX
checkpoint.save, restores the archive with checkpoint.restore and runs 4
more frames. It prints the map fields' shapes before the save and after
the restore, the restored estimator's backend, and what the next frames
did. JAX's restore builds a single-device estimator and loads the sharded
layout into it (the scalars keep their (4,) shard axis), so the first
keyframe update after it raises. This is the reading behind the port's
checkpoint.save refusing a sharded map.
"""
import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory of the archive (default: a temp dir)")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh
    from lidar_odometry_tpu import checkpoint
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.io import synthetic
    from lidar_odometry_tpu.models.estimator import Estimator
    from lidar_odometry_tpu.models.map_backend import ShardedMapBackend

    cfg = SystemConfig(scan_capacity=4096, map_l0_capacity=32768, map_l1_capacity=8192,
                       keyframe_capacity=64, point_stride=1, enable_loop_detection=False,
                       enable_console_statistics=False)
    world = synthetic.make_world(seed=5, extent=50.0, n_buildings=12)
    poses = synthetic.straight_trajectory(12, step=0.4)
    rng = np.random.default_rng(5)
    scans = [synthetic.sample_scan(world, p, 4000, rng, max_range=45.0, noise=0.01)
             for p in poses]
    mesh = Mesh(np.array(jax.devices()[:4]), ("map",))
    est = Estimator(cfg, sync_loop=True, map_backend=ShardedMapBackend(cfg, mesh))
    for s in scans[:8]:
        est.process_frame(s)
    shapes = lambda st: {k: tuple(np.shape(v)) for k, v in st._asdict().items()}
    print(f"sharded map before the save: {shapes(est.map_state)}")
    path = os.path.join(args.out or tempfile.mkdtemp(), "sharded.npz")
    checkpoint.save(path, est)
    back = checkpoint.restore(path, cfg, sync_loop=True)
    print(f"restored: backend {back.backend.name}, map {shapes(back.map_state)}")
    try:
        for s in scans[8:]:
            back.process_frame(s)
        print("the restored estimator ran 4 more frames")
    except Exception as e:
        print(f"the restored estimator failed at its next frame: {type(e).__name__}: "
              f"{str(e).splitlines()[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
