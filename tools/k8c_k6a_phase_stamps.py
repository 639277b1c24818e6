"""Device times of K8c iris_hamming and K6a point_grid, and their phase
splits, on the card, at the shapes the loops path gives them, from CUDA
events and clock64 stamps.

Inputs (made once on the card by --make-inputs with this checkout's
package and kept in --inputs, so that every tree of one call runs on the
same tensors):
  K8c  an Iris code DB of 16 keyframes of the loops path's world
       (chip_smoke.make_loop_scans' circuit: frames 0, 2, ..., 30 scanned
       with its 10000 returns at 45 m, their features at kitti.yaml's scan
       capacity of 16384, then iris_bits and features), row 0 the query
       against K = 1, 2 (the loops path's), 4 and 32 candidates (rows 1, 2,
       ... mod 16; K = 4 with 3 valid and K = 32 with 30, the rest padding,
       as the loop closure pads) at the shifts iris.phase_shifts gives;
  K6a  the matched keyframe of the loops path's loop (frame 0's features
       in the world frame, 16384 rows) binned at kitti.yaml's 2 m (the
       coarse table, which fits the dense window) and 0.5 m (the fine one,
       which does not), sorted by their keys.

Each call is held against the tree's plain twin on the card (K8c's
distances and biases and K6a's grid and meta bit-equal) and timed on the
device (CUDA events over 30 calls queued behind a ~25 ms spin,
chip_smoke.device_ms) and as issued (chip_smoke.time_ms), with the device
records (kernels, memcpy, memset) of one call. Every tree's outputs of one
call are kept in build/k8c_k6a_outputs_<tag>.pt; where another tree's file
is there, they are compared with its bit for bit.

Then, unless --plain, a tree whose kernels carry phase comments ("//
---- name") has each copied into build/k8c_k6a_stamps/<tag>/ with a stamp
(tools/phase_stamps.py) before every phase comment, one at the start and
one before the closing brace, read from thread 0 of block 0 (K8c:
candidate 0's cluster rank 0; K6a: the cluster's rank 0); an older tree's
kernels are timed only.

    python tools/k8c_k6a_phase_stamps.py --make-inputs
    python tools/k8c_k6a_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

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
ENTRIES = (("iris", "iris_hamming_kernel"), ("knn", "point_grid_kernel"))
K8C_SIZES = {1: 1, 2: 2, 4: 3, 32: 30}   # K: valid slots (the loops path's K = 1, 2, 4)


def make_inputs(path: Path) -> None:
    """K8c's and K6a's inputs, made on the card with this checkout's
    package; saved to `path`."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.ops import iris
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    from lidar_odometry_tpu_torch.utils import keys as K, lie
    cfg = cs.kitti_config()
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(cs.LOOP_FRAMES, length=30.0, radius=10.0, step=0.6)
    rng = np.random.default_rng(9)
    feats, masks = [], []
    for f in range(0, 32, 2):
        s = synthetic.sample_scan(world, poses[f], cs.LOOP_POINTS, rng, max_range=cs.LOOP_RANGE,
                                  noise=0.02)
        raw = torch.as_tensor(s, device="cuda")
        x, m, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=cfg.voxel_size, stride=1,
                                  out_capacity=cfg.scan_capacity, compact_keys=True)
        feats.append(x)
        masks.append(m)
    clouds, cmask = torch.stack(feats).contiguous(), torch.stack(masks).contiguous()
    img = iris.iris_bits(clouds, cmask).to(torch.float32)
    filters = torch.as_tensor(iris.log_gabor_filters(), device="cuda")
    dbT, dbM = iris.features(img, filters)
    k8c = {}
    for k, n_valid in K8C_SIZES.items():
        cand = ((torch.arange(k, device="cuda") + 1) % 16).to(torch.int32)
        valid = torch.arange(k, device="cuda") < n_valid
        shifts = iris.phase_shifts(img[0], img[cand.long()])
        k8c[f"K = {k}"] = (cand, shifts, valid)
    k6a = {}
    m_world = lie.transform_points(torch.as_tensor(poses[0], device="cuda"), feats[0])
    for label, bin_size in (("coarse 2 m", cfg.map_voxel_size * 4.0),
                            ("fine 0.5 m", cfg.map_voxel_size)):
        inv = K.f32(1.0 / K.f32(bin_size))
        key = torch.where(masks[0], K.sort_key(*K.pack_key(K.voxel_coords(m_world, inv))),
                          K.INVALID_SORT_KEY)
        key_s, idx = torch.sort(key, stable=True)
        k6a[label] = (key_s, m_world[idx].contiguous(), inv)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(dbT=dbT, dbM=dbM, k8c=k8c, k6a=k6a), path)
    print(f"inputs: K8c a DB of {dbT.shape[0]} keyframes, K = {list(K8C_SIZES)}; K6a "
          f"{int(masks[0].sum())} valid rows of {masks[0].shape[0]}, saved to {path}", flush=True)


def timings(tag: str, card: str, inp) -> dict:
    """Every call against its twin, its device and as-issued times; the
    outputs of one call from the inputs kept for the comparison across
    trees."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import iris, knn
    keep = {}
    dbT, dbM = inp["dbT"], inp["dbM"]
    for name, (cand, shifts, valid) in inp["k8c"].items():
        out = iris.iris_hamming(dbT, dbM, 0, cand, shifts, valid)
        twin = iris.iris_hamming_plain(dbT, dbM, 0, cand, shifts, valid)
        if not torch.equal(out.view(torch.int32), twin.view(torch.int32)):
            raise SystemExit(f"K8c ({name}): not bit-equal to the twin on the card")
        keep[f"K8c {name}"] = out.view(torch.int32)
        call = lambda: iris.iris_hamming(dbT, dbM, 0, cand, shifts, valid)
        print(f"  K8c ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device records "
              f"a call; best distance {float(out[:, 0].min()):.4f}, bit-equal to the twin",
              flush=True)
    for name, (key_s, pts_s, inv) in inp["k6a"].items():
        grid, meta = knn.point_grid(key_s, pts_s, inv)
        gp, mp = knn.point_grid_plain(key_s, pts_s, inv)
        if not (torch.equal(grid, gp) and torch.equal(meta, mp)):
            raise SystemExit(f"K6a ({name}): grid or meta differ from the twin's")
        keep[f"K6a grid {name}"], keep[f"K6a meta {name}"] = grid, meta
        call = lambda: knn.point_grid(key_s, pts_s, inv)
        print(f"  K6a ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device records "
              f"a call; {int((grid != key_s.shape[0]).sum())} occupied bins, fits "
              f"{int(meta[3])}, grid and meta equal to the twin's", flush=True)
    return keep


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import iris, knn
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    us_per_cycle = ps.sm_us_per_cycle()
    base = ROOT / "build" / "k8c_k6a_stamps" / tag
    dbT, dbM = inp["dbT"], inp["dbM"]
    if "// ---- counts" in (csrc / "iris.cu").read_text():
        lib, labels = ps.stamped(tree, base / "k8c", "iris", [
            ("iris.cu", r"^iris_hamming_kernel\(", "start", "end", ())], 0,
            "iris_hamming_kernel", ["iris_hamming"])
        for name, (cand, shifts, valid) in inp["k8c"].items():
            call = lambda: iris.iris_hamming(dbT, dbM, 0, cand, shifts, valid)
            run(lib, labels, call, f"K8c phase split ({tag}; {card}): {name}, thread 0 of "
                f"candidate 0's rank 0", us_per_cycle)
    else:
        print(f"no stamps ({tag}): its K8c has no phase comments", flush=True)
    if "// ---- scatter" in (csrc / "knn.cu").read_text():
        lib, labels = ps.stamped(tree, base / "k6a", "knn", [
            ("knn.cu", r"^point_grid_kernel\(", "start", "end", ())], 0, "point_grid_kernel",
            ["point_grid"])
        for name, (key_s, pts_s, inv) in inp["k6a"].items():
            call = lambda: knn.point_grid(key_s, pts_s, inv)
            run(lib, labels, call, f"K6a phase split ({tag}; {card}): {name}, thread 0 of the "
                f"cluster's rank 0", us_per_cycle)
    else:
        print(f"no stamps ({tag}): its K6a has no phase comments", flush=True)


def run(lib, labels, call, what: str, us_per_cycle: float) -> None:
    import torch
    import chip_smoke as cs
    ms = cs.device_ms(call, 30)
    ps.clear(lib)
    call()
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"{what}: {total} cycles from its first stamp to its last ({total * us_per_cycle:.2f} "
          f"us), {n_st} stamps; {ms:.4f} ms a launch on the device (stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)


if __name__ == "__main__":
    ps.main(__doc__, "k8c_k6a", "K8c and K6a", ENTRIES, make_inputs, timings, stamps)
