"""K5b plane_fit_5nn against its plain twin on every launch of chip_smoke.py's
loops path (both pose-graph backends) and mid360 path, on the card.

Drives the loops path (config/kitti.yaml, loops on, Estimator(sync_loop=
True).process_chunk in chunks of 20 and finalize_loops over the 220-frame
circuit; the K5b calls of every loop solve's coarse and polish steps), once
with the "manual" pose graph and once with the "distributed" one, and the
mid360 path (config/mid360.yaml, loops off, the PLY player over the 66
corridor scans; every KD-tree ICP iteration's K5b call), with every K5b
call taken by one implementation, --drive:
  kernel  the port's K5b (this checkout's csrc/grid_knn.cu);
  twin    the plain PyTorch twin, plane_fit_5nn_plain, on the card.
Every live call (no solve's done flag set: a finished solve's launch leaves
the kernel's outputs unwritten) also runs through the other one on the
same inputs (chip_smoke.k5b_gaps), and the rows whose selection differs,
the validity flags that differ on the well-conditioned rows (the two
smallest eigenvalues of the 5 points' covariance more than 1e-2 of the
largest apart) and the largest gap of dist and resid there are kept.
Prints one line a path: calls, live calls and rows, the gaps; the
keyframes' frame indices, the accepted loop pairs (current <-> matched
keyframe), rehashes, loop errors and ATE.

    python tools/k5b_twin_agreement.py --drive kernel|twin [--path loops|mid360|all]

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drive", choices=("kernel", "twin"), default="kernel")
    ap.add_argument("--path", choices=("loops", "mid360", "all"), default="all")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k5b_twin_agreement: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.io.ply import PLYPlayer, save_ply
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.ops import icp

    kernel, twin = icp.plane_fit_5nn, icp.plane_fit_5nn_plain
    fresh = dict(calls=0, live=0, rows=0, sel_rows=0, flips=0, err=0.0)
    stats = dict(fresh)

    def checked(p_world, cand, cand_ok, mask, cfg, gate, flags=None):
        k = kernel(p_world, cand, cand_ok, mask, cfg, gate, flags=flags)
        p = twin(p_world, cand, cand_ok, mask, cfg, gate)
        stats["calls"] += 1
        if flags is None or int(flags[0]) == 0:
            gap = cs.k5b_gaps(k, p, cand, cand_ok)
            stats["live"] += 1
            stats["rows"] += int(mask.sum())
            stats["sel_rows"] += gap["sel_rows"]
            stats["flips"] += gap["flips"]
            stats["err"] = max(stats["err"], gap["err"])
        return k if args.drive == "kernel" else p

    icp.plane_fit_5nn = checked
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    def report(path, est, gt, extra=""):
        torch.cuda.synchronize()
        ate = ate_rmse(est.trajectory(), gt)
        kf = [est.get_keyframe(i).frame_index for i in range(est.get_keyframe_count())]
        digest = hashlib.sha256(repr(kf).encode()).hexdigest()[:12]
        print(f"{path} path ({card}), K5b by {args.drive}: {stats['calls']} launches, "
              f"{stats['live']} live ({stats['rows']} masked-in rows); kernel against twin: "
              f"rows with another selection {stats['sel_rows']}, validity flags differing on "
              f"well-conditioned rows {stats['flips']}, dist and resid there within "
              f"{stats['err']:.2e}; keyframes {len(kf)} (frame indices sha256 {digest}, last "
              f"{kf[-5:]}){extra}; ATE {ate:.4f} m", flush=True)

    if args.path in ("loops", "all"):
        loop_scans, loop_gt = cs.make_loop_scans()
        cfg = cs.kitti_config()
        for backend in ("manual", "distributed"):
            est = Estimator(cfg.replace(pgo_backend=backend), sync_loop=True, device="cuda")
            est.warm_loop_programs()
            est.reset()
            pairs = []
            add = est.pose_graph.add_loop_and_optimize

            def recording(matched, current, *a, add=add, pairs=pairs, **k):
                pairs.append((int(current), int(matched)))
                return add(matched, current, *a, **k)

            est.pose_graph.add_loop_and_optimize = recording
            stats.update(fresh)
            cs._run_chunks(est, loop_scans)
            report(f"loops ({backend})", est, loop_gt,
                   f", loops {pairs} (current <-> matched keyframe), rehashes "
                   f"{est.rehash_count}, loop errors {est.loop_errors}")
    if args.path in ("mid360", "all"):
        scans, gt = cs.make_indoor_scans(cs.MID_FRAMES)
        sysc = cs.mid360_config()
        data = ROOT / "build" / "k5b_twin_mid360"
        shutil.rmtree(data, ignore_errors=True)
        for i, s in enumerate(scans):
            save_ply(str(data / sysc.seq / f"{i:06d}.ply"), s)
        player = PLYPlayer(sysc.replace(data_directory=str(data),
                                        output_directory=str(data / "out"),
                                        trajectory_format="tum"), device="cuda")
        stats.update(fresh)
        res = player.run()
        report("mid360", player.estimator, gt, f", frames {res.frames_processed} "
               f"({res.frames_failed} failed)")
        shutil.rmtree(data, ignore_errors=True)


if __name__ == "__main__":
    main()
