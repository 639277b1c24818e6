"""K4c map_surfel_recompute against its plain twin on every launch of
chip_smoke.py's loops path and sharded path, on the card.

Drives the loops path (config/kitti.yaml, loops on, the manual pose graph,
Estimator(sync_loop=True).process_chunk in chunks of 20 and finalize_loops
over the 220-frame circuit) and the sharded path (the same scans through
Estimator(map_backend=ShardedMapBackend) with the distributed pose graph,
4 shards on a one-rank NCCL group, process_frame) with every K4c call
(each keyframe's update_map, each shard's, and the rehash's bulk_build)
taken by one implementation, --drive:
  kernel  the port's K4c (this checkout's csrc/voxel_map.cu);
  twin    the plain PyTorch twin, map_surfel_recompute_plain, on the card.
Every call also runs through the other one on the same inputs
(chip_smoke.k4c_gaps), and the largest gaps are kept: the means and
flags, the planarities and well-conditioned normals of the rows the map
can use (at least 5 live children; apart, the planarity of the others),
the live-child masks that differ, and the non-planar verdicts that differ
inside and outside the 1e-5 band around the threshold. Prints one line a path: launches, rows
with a live child, the gaps; the keyframes' frame indices, the accepted
loop pairs (current <-> matched keyframe), rehashes, loop errors and ATE.

    python tools/k4c_twin_agreement.py --drive kernel|twin [--path loops|sharded|both]

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drive", choices=("kernel", "twin"), default="kernel")
    ap.add_argument("--path", choices=("loops", "sharded", "both"), default="both")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k4c_twin_agreement: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.models.map_backend import ShardedMapBackend
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.parallel import mesh

    kernel, twin = vm.map_surfel_recompute, vm.map_surfel_recompute_plain
    fresh = dict(calls=0, live=0, err=0.0, err_normal=0.0, sep=0.0, err_rest=0.0,
                 plan_few=0.0, kid=0, flips_in=0, flips_out=0)
    stats = dict(fresh)      # the warm-up's launches are counted, then dropped

    def checked(l0, r_slot, c1, thr):
        k = kernel(l0, r_slot, c1, thr)
        p = twin(l0, r_slot, c1, thr)
        gap = cs.k4c_gaps(k, p, l0, r_slot, c1, thr)
        stats["calls"] += 1
        stats["live"] += gap["live"]
        if gap["err_normal"] > stats["err_normal"]:
            stats["err_normal"], stats["sep"] = gap["err_normal"], gap["sep"]
        for key in ("err", "err_rest", "plan_few"):
            stats[key] = max(stats[key], gap[key])
        for key in ("kid", "flips_in", "flips_out"):
            stats[key] += gap[key]
        return k if args.drive == "kernel" else p

    vm.map_surfel_recompute = checked
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    loop_scans, loop_gt = cs.make_loop_scans()
    cfg = cs.kitti_config()
    runs = []
    if args.path in ("loops", "both"):
        runs.append(("loops", lambda: Estimator(cfg, sync_loop=True, device="cuda")))
    group = None
    if args.path in ("sharded", "both"):
        group = cs.one_rank_nccl_group()
        dcfg = cfg.replace(pgo_backend="distributed")
        runs.append(("sharded", lambda: Estimator(
            dcfg, sync_loop=True, device="cuda",
            map_backend=ShardedMapBackend(dcfg, mesh.make_group(cs.SHARDS, device="cuda",
                                                                group=group)))))
    try:
        for path, make in runs:
            est = make()
            est.warm_loop_programs()
            est.reset()
            pairs = []
            add = est.pose_graph.add_loop_and_optimize

            def recording(matched, current, *a, **k):
                pairs.append((int(current), int(matched)))
                return add(matched, current, *a, **k)

            est.pose_graph.add_loop_and_optimize = recording
            stats.update(fresh)
            if path == "loops":
                cs._run_chunks(est, loop_scans)
            else:
                for s in loop_scans:
                    est.process_frame(s)
                est.finalize_loops()
            torch.cuda.synchronize()
            ate = ate_rmse(est.trajectory(), loop_gt)
            kf = [est.get_keyframe(i).frame_index for i in range(est.get_keyframe_count())]
            digest = hashlib.sha256(repr(kf).encode()).hexdigest()[:12]
            print(f"{path} path ({card}), K4c by {args.drive}: {stats['calls']} launches, "
                  f"{stats['live']} rows with a live child; kernel against twin: max_abs_err "
                  f"{stats['err']:.2e} (normals {stats['err_normal']:.2e}, at a row whose "
                  f"(lambda_1 - lambda_0) / lambda_2 is {stats['sep']:.1e}; the rest "
                  f"{stats['err_rest']:.2e}; the unused planarity of parents with fewer than 5 "
                  f"live children {stats['plan_few']:.1e}), live-child masks differing "
                  f"{stats['kid']}, verdicts "
                  f"flipped inside the 1e-5 band {stats['flips_in']}, outside it "
                  f"{stats['flips_out']}; keyframes {len(kf)} (frame indices sha256 {digest}, "
                  f"last {kf[-5:]}), loops {pairs} (current <-> matched keyframe), rehashes "
                  f"{est.rehash_count}, loop errors {est.loop_errors}; ATE {ate:.4f} m",
                  flush=True)
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
