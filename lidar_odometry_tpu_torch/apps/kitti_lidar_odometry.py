"""KITTI odometry CLI (counterpart of the repository's
apps/kitti_lidar_odometry.py):

    python -m lidar_odometry_tpu_torch.apps.kitti_lidar_odometry <config.yaml>
        [--start N] [--end N] [--skip N] [--sync-loop] [--save-map FILE]
        [--shards N] [--chunk N] [--prestage] [--device cuda|cpu]
        [--live-viewer [PORT]] [--step] [--no-viewer]

over data_directory/sequences/<seq>/velodyne/*.bin, with the ground truth
ground_truth_directory/<seq>.txt where it exists. --sync-loop runs each
loop query inline at its keyframe (deterministic); --shards N holds the
map sharded over N shards of this process (frame by frame, the
distributed pose graph); --chunk N runs N frames a process_chunk call (0:
frame by frame; default the config's chunk_frames); --prestage uploads
every chunk before the timed loop; --live-viewer serves the run's live
view and its auto/step/finish controls on 127.0.0.1 (viewer.LiveViewer),
in step mode with --step; --no-viewer serves none.
"""
import argparse
import sys

from lidar_odometry_tpu_torch.config import load_config
from lidar_odometry_tpu_torch.io.kitti import KittiPlayer
from lidar_odometry_tpu_torch.utils import logging_util as log


def live_viewer(args):
    """The LiveViewer that --live-viewer, --step and --no-viewer ask for, or None."""
    if args.live_viewer is None or args.no_viewer:
        return None
    from lidar_odometry_tpu_torch.viewer import LiveViewer
    return LiveViewer(port=args.live_viewer, step_mode=args.step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="KITTI LiDAR odometry on PyTorch + CUDA")
    ap.add_argument("config", help="YAML config path (config/kitti.yaml's schema)")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--sync-loop", action="store_true",
                    help="run loop queries inline instead of on the worker thread")
    ap.add_argument("--save-map", default=None, help="save the final map as a PLY file here")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the voxel map over N shards of this process")
    ap.add_argument("--chunk", type=int, default=None, metavar="N",
                    help="frames per process_chunk call (0 = per-frame)")
    ap.add_argument("--prestage", action="store_true",
                    help="upload every chunk before the timed loop")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--live-viewer", type=int, nargs="?", const=8123, default=None,
                    metavar="PORT", help="serve a live 3D view with auto/step/finish controls "
                    "on 127.0.0.1:PORT (default 8123)")
    ap.add_argument("--step", action="store_true",
                    help="start the live viewer in step mode (a frame or chunk a step)")
    ap.add_argument("--no-viewer", action="store_true", help="serve no live viewer")
    args = ap.parse_args(argv)

    print("=" * 60)
    print(" lidar_odometry_tpu_torch — LiDAR odometry (KITTI player)")
    print("=" * 60)
    cfg = load_config(args.config)
    player = KittiPlayer(cfg, device=args.device)
    lv = live_viewer(args)
    try:
        result = player.run(start=args.start, end=args.end, skip=args.skip,
                            sync_loop=args.sync_loop, shards=args.shards,
                            chunk_frames=args.chunk, prestage=args.prestage, live_viewer=lv)
        if lv is not None and player.estimator is not None:
            lv.update(player.estimator)
    finally:
        if lv is not None:
            lv.close()
    if result.frames_processed == 0:
        return 1
    if args.save_map and player.estimator is not None:
        from lidar_odometry_tpu_torch.io.ply import save_ply
        save_ply(args.save_map, player.estimator.accumulated_map(cfg.map_voxel_size))
        log.info("Saved map: {}", args.save_map)

    print("-" * 60)
    print(f" Frames: {result.frames_processed} ({result.frames_failed} failed)   "
          f"Time: {result.total_time_s:.1f}s   FPS: {result.fps:.1f}")
    if result.error_stats and result.error_stats.available:
        s = result.error_stats
        print(f" ATE RMSE: {s.ate_rmse:.3f} m   ATE mean: {s.ate_mean:.3f} m")
        print(f" Translation: {s.translation_mean:.2f}%   "
              f"Rotation: {s.rotation_mean:.4f} deg/100m")
    if result.trajectory_path:
        print(f" Trajectory: {result.trajectory_path}")
    print("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
