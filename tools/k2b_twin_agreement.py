"""K2b icp_normal_eq against its plain twin on every launch of chip_smoke.py's
loops path, on the card.

Drives the loops path (config/kitti.yaml, loops on, the manual pose graph,
Estimator(sync_loop=True).process_chunk in chunks of 20 and finalize_loops
over the 220-frame circuit) with every K2b call of the ICP (the odometry's
and the loop solve's, the weight residual included) taken by one
implementation, --drive:
  kernel  the port's K2b (this checkout's csrc/icp.cu);
  twin    the plain PyTorch twin, icp_normal_eq_plain, on the card.
Every live lane of every call also runs through the other one on the same
inputs, and the largest gaps are kept: T (absolute), the 27 sums of H and g
(relative to max(|twin's|, 1)), and the lanes whose flags differ. Prints
one line: launches, live lanes, the gaps, loops, rehashes and ATE.

    python tools/k2b_twin_agreement.py --drive kernel|twin

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drive", choices=("kernel", "twin"), default="kernel")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2b_twin_agreement: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.ops import icp

    kernel, twin = icp.icp_normal_eq, icp.icp_normal_eq_plain
    stats = dict(calls=0, live=0, T=0.0, hg=0.0, flags=0)

    def checked(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg, rw=None):
        lanes = pts.shape[0] if pts.dim() == 3 else None
        outs = []
        for b in (range(lanes) if lanes else [None]):
            pick = (lambda t: None if t is None else t[b].contiguous()) if lanes else (lambda t: t)
            a = [pick(x) for x in (pts, nrm, r, valid, T, scale, flags, aux)]
            k = kernel(*a, consts, cfg, pick(rw))
            stats["calls"] += 1
            if bool(a[6][0]):          # a done lane passes its state through
                outs.append(k)
                continue
            p = twin(*a, consts, cfg, pick(rw))
            stats["live"] += 1
            stats["T"] = max(stats["T"], float((k[0] - p[0]).abs().max()))
            stats["hg"] = max(stats["hg"], float(((k[2] - p[2]).abs()
                                                  / p[2].abs().clamp(min=1.0)).max()))
            stats["flags"] += int(not torch.equal(k[1], p[1]))
            outs.append(k if args.drive == "kernel" else p)
        if not lanes:
            return outs[0]
        return tuple(torch.stack(c) for c in zip(*outs))

    icp.icp_normal_eq = checked
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    loop_scans, loop_gt = cs.make_loop_scans()
    est = Estimator(cs.kitti_config(), sync_loop=True, device="cuda")
    est.warm_loop_programs()
    est.reset()
    for k in stats:
        stats[k] = 0 if isinstance(stats[k], int) else 0.0
    cs._run_chunks(est, loop_scans)
    ate = ate_rmse(est.trajectory(), loop_gt)
    print(f"loops path ({card}), K2b by {args.drive}: {stats['calls']} lane launches, "
          f"{stats['live']} live; kernel against twin: T within {stats['T']:.2e}, H and g "
          f"within {stats['hg']:.2e} relative, {stats['flags']} lanes with other flags; loops "
          f"{est.get_loop_closure_count()}, rehashes {est.rehash_count}, loop errors "
          f"{est.loop_errors}; ATE {ate:.4f} m", flush=True)


if __name__ == "__main__":
    main()
