"""PLY-dataset odometry CLI (counterpart of the repository's
apps/lidar_odometry.py, without the live viewer):

    python -m lidar_odometry_tpu_torch.apps.lidar_odometry <config.yaml>
        [--start N] [--end N] [--skip N] [--format kitti|tum] [--output DIR]
        [--chunk N] [--device cuda|cpu] [--no-loop-closure]

The port has no loop closure yet: a config that enables it (as
config/mid360.yaml does) is refused unless --no-loop-closure turns it off.
"""
import argparse
import sys

from lidar_odometry_tpu_torch.config import load_config
from lidar_odometry_tpu_torch.io.ply import PLYPlayer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PLY LiDAR odometry on PyTorch + CUDA")
    ap.add_argument("config")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--format", choices=["kitti", "tum"], default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--chunk", type=int, default=None, metavar="N",
                    help="frames per chunk-runner call (0 = per-frame)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--no-loop-closure", action="store_true",
                    help="run with enable_loop_detection off")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.format:
        cfg = cfg.replace(trajectory_format=args.format)
    if args.output:
        cfg = cfg.replace(output_directory=args.output)
    if args.no_loop_closure:
        cfg = cfg.replace(enable_loop_detection=False)

    print("=" * 60)
    print(" lidar_odometry_tpu_torch — LiDAR odometry (PLY player)")
    print("=" * 60)
    player = PLYPlayer(cfg, device=args.device)
    result = player.run(start=args.start, end=args.end, skip=args.skip,
                        chunk_frames=args.chunk)
    if result.frames_processed == 0:
        return 1
    print("-" * 60)
    print(f" Frames: {result.frames_processed}   "
          f"Time: {result.total_time_s:.1f}s   FPS: {result.fps:.1f}")
    if result.trajectory_path:
        print(f" Trajectory: {result.trajectory_path}")
    print("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
