"""Device times and phase split of K10a pgo_linearize and K8b iris_encode
on the card, at the shapes the paths give them, from CUDA events and
clock64 stamps.

Inputs (made once on the card by --make-inputs with this checkout's
package and kept in --inputs, so that every tree of one call runs on the
same tensors):
  K10a  the PGO path's KITTI-00-sized graph (chip_smoke.make_pgo_graph,
        n_pad 4096) as pack_graph and upload give it, at its initial
        poses; and a revisit graph of 7400 keyframes and 64 loop edges
        (n_pad 8192);
  K8b   the inverse-FFT responses of 16 keyframe Iris images (a drain
        batch: clouds of 10000 returns scanned along a circuit of the
        synthetic world, chip_smoke.make_loop_scans' world), the first of
        them alone (b = 1, the loops path's shape), and
        synthetic.iris_threshold_responses at b = 3 (squared magnitudes on
        and beside the magnitude threshold, NaN, +-inf, +-0).

Each call is held against the tree's plain twin (K10a within 1e-10 of
each output's largest magnitude, K8b 0 differing words) and timed on the
device (CUDA events over 30 calls queued behind a ~25 ms spin,
chip_smoke.device_ms) and as issued (chip_smoke.time_ms), with the device
records (kernels, memcpy, memset) of one call; and the PGO path's GN
iterations on the device (gn_iterations on chip_smoke.make_pgo_graph's
graph, the median of 5 solves, each behind the spin). Every tree's outputs
of one call from the inputs (K10a's diag, off, b and lb at both sizes,
K8b's T and M at every shape, the PGO path's poses) are kept in
build/k10a_k8b_outputs_<tag>.pt; where another tree's file is there, they
are compared with its bit for bit.

Then, unless --plain, a tree whose kernels carry phase comments ("//
---- name") has K10a's linearize_kernel (stamped by thread 0 of block 0:
the warp of poses 0 and 1) and K8b's iris_encode_kernel (thread 0 of block 0)
copied into build/k10a_k8b_stamps/<tag>/ with a stamp (tools/phase_stamps.py)
before every phase comment, one at the start and one before the closing
brace; an older tree's two-kernel K10a and one-thread-a-word K8b are
timed only.

    python tools/k10a_k8b_phase_stamps.py --make-inputs
    python tools/k10a_k8b_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of both
kernels are printed from the tree's build.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT
ENTRIES = (("pgo", "linearize_kernel"), ("pgo", "factor_kernel"),
            ("pgo", "assemble_kernel"), ("iris", "iris_encode_kernel"))
BIG_N, BIG_LOOPS = 7400, 64


def make_inputs(path: Path) -> None:
    """K10a's and K8b's inputs, made on the card with this checkout's
    package; saved to `path`."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.ops import iris
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    k10a = {}
    for graph in (cs.make_pgo_graph(), synthetic.revisit_pose_graph(BIG_N, BIG_LOOPS, seed=BIG_N)):
        init, priors, betweens, _ = graph
        g = dpgo.upload(dpgo.pack_graph(init, priors, betweens), "cuda")
        k10a[g["poses"].shape[0]] = {k: v.clone() for k, v in g.items()}
    world = synthetic.make_world(seed=7, extent=60.0, n_buildings=14)
    poses = synthetic.circuit_trajectory(16, length=60.0, radius=10.0, step=4.0)
    rng = np.random.default_rng(7)
    clouds = np.zeros((16, 10000, 3), np.float32)
    masks = np.zeros((16, 10000), bool)
    for i, pose in enumerate(poses):
        s = synthetic.sample_scan(world, pose, 10000, rng, max_range=45.0, noise=0.01)
        clouds[i, :len(s)] = s
        masks[i, :len(s)] = True
    bits = iris.iris_bits(torch.as_tensor(clouds, device="cuda"),
                          torch.as_tensor(masks, device="cuda"))
    filters = torch.as_tensor(iris.log_gabor_filters(), device="cuda")
    resp = iris._responses(bits.to(torch.float32), filters).contiguous()
    edge, _ = synthetic.iris_threshold_responses(3, iris.MAG_SQ_THRESHOLD, seed=3)
    k8b = {"b16": resp, "b1": resp[:1].contiguous(),
           "threshold b3": torch.as_tensor(edge, device="cuda")}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(k10a=k10a, k8b=k8b), path)
    print(f"inputs: K10a n_pad {sorted(k10a)}; K8b {[tuple(v.shape) for v in k8b.values()]} "
          f"({int((bits > 0).sum())} occupied pixels in the 16 images); saved to {path}",
          flush=True)


def timings(tag: str, card: str, inp) -> dict:
    """Every call against its twin, its device and as-issued times; the
    outputs of one call from the inputs kept for the comparison across
    trees."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import iris
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    keep = {}
    for n_pad, g in sorted(inp["k10a"].items()):
        poses = g["poses"]
        out = dpgo.linearize(g, poses)
        twin = dpgo.linearize_plain(poses, *[g[k] for k in dpgo.LIN_KEYS])
        err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
                  for a, b in zip(out, twin))
        same = all(torch.equal(a, b) for a, b in zip(out, dpgo.linearize(g, poses)))
        if not (err <= 1e-10 and same):
            raise SystemExit(f"K10a at n_pad {n_pad}: {err:.3e} from its twin, two calls "
                             f"equal {same}")
        for name, t in zip(("diag", "off", "b", "lb"), out):
            keep[f"K10a {name} {n_pad}"] = t
        call = lambda: dpgo.linearize(g, poses)
        print(f"  K10a ({tag}; {card}): n_pad {n_pad}: {cs.device_ms(call, 30):.4f} ms on the "
              f"device ({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device "
              f"records a call; {err:.1e} of the twin's largest, two calls bit-equal",
              flush=True)
    for name, resp in inp["k8b"].items():
        T, M = iris.iris_encode(resp)
        Tp, Mp = iris.iris_encode_plain(resp.cpu())
        diff = int((T.cpu() != Tp).sum() + (M.cpu() != Mp).sum())
        if diff:
            raise SystemExit(f"K8b ({name}): {diff} words differ from the CPU twin's")
        keep[f"K8b T {name}"], keep[f"K8b M {name}"] = T, M
        call = lambda: iris.iris_encode(resp)
        print(f"  K8b ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device records "
              f"a call; 0 words differ from the CPU twin's", flush=True)
    keep["PGO path poses"] = ps.pgo_path(tag, card)
    return keep


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import iris
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    if "// ---- header" not in (csrc / "pgo.cu").read_text():
        print(f"no stamps ({tag}): its K10a and K8b have no phase comments", flush=True)
        return
    us_per_cycle = ps.sm_us_per_cycle()
    base = ROOT / "build" / "k10a_k8b_stamps" / tag
    lib, labels = ps.stamped(tree, base / "k10a", "pgo", [
        ("pgo.cu", r"^linearize_kernel\(", "start", "end", ())], 0, "linearize_kernel",
        ["pgo_linearize"])
    g = inp["k10a"][4096]
    call = lambda: dpgo.linearize(g, g["poses"])
    ms = cs.device_ms(call, 30)
    ps.clear(lib)
    call()
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"K10a phase split ({tag}; {card}): n_pad 4096, thread 0 of block 0 (pose 0's "
          f"lane 0): {total} cycles from its first stamp to its last "
          f"({total * us_per_cycle:.2f} us at {1 / us_per_cycle:.0f} cycles a us), {n_st} "
          f"stamps; {ms:.4f} ms a launch on the device (stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)
    lib, labels = ps.stamped(tree, base / "k8b", "iris", [
        ("iris.cu", r"^iris_encode_kernel\(", "start", "end", ())], 0, "iris_encode_kernel",
        ["iris_encode"])
    for name in ("b16", "b1"):
        resp = inp["k8b"][name]
        call = lambda: iris.iris_encode(resp)
        ms = cs.device_ms(call, 30)
        ps.clear(lib)
        call()
        torch.cuda.synchronize()
        phases, total, n_st = ps.split(lib, labels)
        print(f"K8b phase split ({tag}; {card}): {name}, thread 0 of block 0: {total} cycles "
              f"from its first stamp to its last ({total * us_per_cycle:.2f} us), {n_st} "
              f"stamps; {ms:.4f} ms a launch on the device (stamped)", flush=True)
        ps.report(phases, total, us_per_cycle)


if __name__ == "__main__":
    ps.main(__doc__, "k10a_k8b", "K10a and K8b", ENTRIES, make_inputs, timings, stamps)
