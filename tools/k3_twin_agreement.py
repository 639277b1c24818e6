"""K3 pko_alpha against its plain twin on every launch of two of
chip_smoke.py's paths, on the card.

Drives the surfel path (120 bench frames, make_chunk_runner) and the loops
path (config/kitti.yaml, loops on, the manual pose graph, Estimator(
sync_loop=True) over the 220-frame circuit) with the ICP's K3 calls taken
by one implementation, --drive:
  kernel  the port's K3 (this checkout's csrc/pko.cu);
  old     the K3 of another tree (--src DIR, for example an older commit
          unpacked with `git archive` under build/), built here with the
          port's nvcc flags;
  twin    the plain PyTorch twin, pko_alpha_index_plain, on the card.
Every live lane of every call is also run through the twin on the same
inputs, and the alpha indices and counts that differ from the twin's are
counted, with the largest relative difference of the scale. Prints one
line a path: launches, live lanes, mismatches, ATE.

    python tools/k3_twin_agreement.py --drive kernel|old|twin [--src DIR]

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def old_kernel(src: Path):
    """lo_pko_alpha of src's csrc/pko.cu, built into build/k3_old/."""
    from k3_phase_stamps import build_pko
    from lidar_odometry_tpu_torch import kernels
    out = kernels.BUILD_DIR.parent / "k3_old" / src.resolve().name / "libpko_old.so"
    return build_pko(src / "lidar_odometry_tpu_torch" / "csrc", out).lo_pko_alpha


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drive", choices=("kernel", "old", "twin"), default="kernel")
    ap.add_argument("--src", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k3_twin_agreement: needs a CUDA device")
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.ops import pko

    kernel = pko.pko_alpha_index
    old = old_kernel(args.src) if args.drive == "old" else None
    stats = {}

    def one_lane(r, v, f, s, first, consts):
        """The driving implementation on one lane: (aux (2,), scale (1,))."""
        if args.drive == "kernel":
            return kernel(r, v, f, s, first, consts)
        if bool(f[0]):
            return torch.zeros((2,), dtype=torch.int32, device=r.device), s
        if args.drive == "twin":
            a, c, sc = pko.pko_alpha_index_plain(r, v, s.reshape(()), first, consts)
            return torch.stack([c, a]).to(torch.int32), sc.reshape(1)
        n_alpha, n_grid = consts.Q.shape
        aux = torch.empty((2,), dtype=torch.int32, device=r.device)
        s_out = torch.empty((1,), device=r.device)
        err = old(r.data_ptr(), v.data_ptr(), r.shape[0], 1, f.data_ptr(), s.data_ptr(),
                  int(first), consts.u.data_ptr(), consts.pick.data_ptr(),
                  consts.alphas.data_ptr(), consts.r_grid.data_ptr(), consts.Q.data_ptr(),
                  n_alpha, n_grid, s_out.data_ptr(), aux.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"old K3 failed to launch: cudaError {err}")
        return aux, s_out

    def checked(resid, valid, flags, scale, compute_scale, consts):
        lanes = resid.shape[0] if resid.dim() == 2 else None
        outs = []
        for b in (range(lanes) if lanes else [None]):
            pick = (lambda t: t[b].contiguous()) if lanes else (lambda t: t)
            r, v, f, s = pick(resid), pick(valid), pick(flags), pick(scale)
            aux, s_out = one_lane(r, v, f, s, compute_scale, consts)
            stats["calls"] = stats.get("calls", 0) + 1
            if not bool(f[0]):
                a, c, sc = pko.pko_alpha_index_plain(r, v, s.reshape(()), compute_scale, consts)
                stats["live"] = stats.get("live", 0) + 1
                if int(aux[1]) != int(a) or int(aux[0]) != int(c):
                    stats["mismatch"] = stats.get("mismatch", 0) + 1
                    stats.setdefault("examples", []).append((int(aux[1]), int(a)))
                rel = abs(float(s_out[0]) - float(sc)) / max(abs(float(sc)), 1e-12)
                stats["scale_rel"] = max(stats.get("scale_rel", 0.0), rel)
            outs.append((aux, s_out))
        if not lanes:
            return outs[0]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    pko.pko_alpha_index = checked
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    def report(path, ate):
        ex = stats.get("examples", [])[:8]
        print(f"{path} ({card}), K3 by {args.drive}: {stats.get('calls', 0)} lane launches, "
              f"{stats.get('live', 0)} live, {stats.get('mismatch', 0)} alpha or count "
              f"mismatches against the twin (kernel, twin alpha: {ex}), scale within "
              f"{stats.get('scale_rel', 0.0):.2e} relative; ATE {ate:.4f} m", flush=True)
        stats.clear()

    cfg, consts, kw = cs.setup()
    scans, gt = cs.make_scans(cs.N_FRAMES)
    runner = fp.make_chunk_runner(cfg, consts, **kw)
    carry = fp.init_carry(0, cs.C1, device="cuda")
    poses = []
    for c in range(0, len(scans), cs.CHUNK):
        carry, out = runner(carry, torch.as_tensor(scans[c:c + cs.CHUNK], device="cuda"))
        poses.append(out[0])
    report("surfel path", ate_rmse(torch.cat(poses).cpu().numpy(), gt))

    loop_scans, loop_gt = cs.make_loop_scans()
    est = Estimator(cs.kitti_config(), sync_loop=True, device="cuda")
    est.warm_loop_programs()
    est.reset()
    stats.clear()
    cs._run_chunks(est, loop_scans)
    report(f"loops path (loops {est.get_loop_closure_count()}, rehashes {est.rehash_count})",
           ate_rmse(est.trajectory(), loop_gt))


if __name__ == "__main__":
    main()
