"""Phase split and device times of K6b point_knn / point_nn1 and K5b
plane_fit_5nn on the card, from clock64 stamps, at the shapes the paths give
them.

Inputs (made once on the card with the tree's own wrappers and kept in
--inputs, so that every tree of one call runs on the same tensors):
  K6b  chip_smoke.py's loop query (chip_smoke.loop_query: frame 205's
       features of a dense scan, every second, 8192 rows, prealigned
       against frame 0's keyframe) and the keyframe's two point tables,
       coarse (2 m bins, fits the dense window) and fine (0.5 m, does not):
         coarse       k 5, r 1, W 8, the coarse table (the coarse phase)
         nn1          k 1, r 1, W 8, the coarse table (the inlier ratio)
         polish       k 5, r 1, W 4, the coarse table
         polish fine  k 5, r 1, W 4, the fine table (the polish phase)
         r 2          k 5, r 2, W 16, the fine table (the solve's defaults
                      without prealign: the binary-search path)
  K5b  mid360  chip_smoke.kd_inputs: 16384 rows x 125 candidates of K5a on
               the map of the mid360 path's first chunk, gated;
       loop    the coarse shape's k = 5 neighbours, 8192 rows x 5, ungated.

Each shape is held against the plain twin (K6b: neighbours of every slot
and ok flags equal, distances within 1e-5; K5b: chip_smoke.k5b_gaps, the
selection equal, the validity flags equal and dist and resid within 1e-4
on the well-conditioned rows) and timed on the device (CUDA events over 30
launches queued behind a ~25 ms spin, chip_smoke.device_ms) and as issued
(chip_smoke.time_ms). Then, unless --plain, each kernel is copied into
build/k6b_k5b_stamps/<tag>/ with a stamp (tools/phase_stamps.py) before
every phase comment ("// ---- name"), one at its start and one before its
closing brace; commit b4a4ac8's point_knn_kernel, which has no such
comments, is stamped at its statements (K6B_ANCHORS). Thread 0 of block 0
stamps: query 0's chain at the coarse shape (K6b) and point 0's at the
mid360 shape (K5b; eigvals3 in common.cuh too). Each phase prints in
cycles and microseconds (the SM clock read by timing a spin of known
cycles), beside the stamped launch's device time.

    python tools/k6b_k5b_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of every
instantiation of both kernels are printed from the tree's build.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT

# the old K6b kernel's phases, at its statements (regex, label), in order
K6B_ANCHORS = (
    (r"const float qx = q\[3 \* i\]", "the query's bin and the table's window"),
    (r"^\s*int m = 0;", "the walk: every bin's rows, loaded and inserted one by one"),
    (r"const size_t o = \(size_t\)i \* K \+ j;", "write"),
)
K6B_SHAPES = (("coarse", 5, "coarse", 1, 8), ("nn1", 1, "coarse", 1, 8),
              ("polish", 5, "coarse", 1, 4), ("polish fine", 5, "fine", 1, 4),
              ("r 2", 5, "fine", 2, 16))


def make_inputs(path: Path) -> dict:
    """The loop query, its two tables, the coarse shape's neighbours and the
    mid360 shape's candidates, on the card; saved to `path`."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.ops import icp, knn
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.utils import keys as K, lie
    cfg = cs.kitti_config()
    cs.DENSE_FRAMES = (0, cs.LOOP_REVISIT)
    dense = cs.make_dense_loop_frames()
    gt = synthetic.circuit_trajectory(cs.LOOP_FRAMES, length=30.0, radius=10.0, step=0.6)
    lq = cs.loop_query(dense, gt, cfg)
    T_init = icp.loop_prealign(lq["q_pose"], lq["m_pose"], torch.tensor(0.0, device=cs.DEVICE),
                               lq["q_pts"], lq["q_mask"], lq["m_pts"], lq["m_mask"])
    qw = lie.transform_points(T_init, lq["q_pts"]).contiguous()
    tables = {}
    for tag, bin_size in (("coarse", K.f32(cfg.map_voxel_size * 4.0)),
                          ("fine", cfg.map_voxel_size)):
        t = knn.build_point_table(lq["m_world"], lq["m_mask"], bin_size=bin_size)
        tables[tag] = dict(t._asdict())
    nb, nb_ok, _ = knn.knn_query(knn.PointTable(**tables["coarse"]), qw, k=5, radius=1,
                                 bucket_width=8)
    icfg = lq["icfg"]
    state, kcfg, p, mask = cs.kd_inputs(cs.make_indoor_scans(cs.MID_CHUNK + 1)[0],
                                        cs.mid360_config())
    ck, okk = vm.grid_knn_neighbors(state, p, voxel_size=kcfg.voxel_size,
                                    radius=kcfg.grid_knn_radius)
    inp = dict(qw=qw, q_mask=lq["q_mask"], tables=tables, nb=nb, nb_ok=nb_ok,
               loop_cfg=(icfg.max_correspondence_distance, icfg.plane_fit_planarity),
               p=p, cand=ck, cand_ok=okk & mask[:, None], mask=mask,
               mid_cfg=(kcfg.max_correspondence_distance, kcfg.plane_fit_planarity))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(inp, path)
    return inp


def k6b_calls(inp):
    """[(label, call of the kernel's wrapper, call of the twin, k)]."""
    from lidar_odometry_tpu_torch.ops import knn
    out = []
    for label, k, tag, r, w in K6B_SHAPES:
        t = knn.PointTable(**inp["tables"][tag])
        out.append((f"{label:11s} k {k}, r {r}, W {w:2d}, {1 / t.inv:g} m bins, "
                    f"fits={int(t.fits)}",
                    lambda t=t, k=k, r=r, w=w: knn.knn_query(t, inp["qw"], k=k, radius=r,
                                                             bucket_width=w),
                    lambda t=t, k=k, r=r, w=w: knn.knn_query_plain(t, inp["qw"], k=k, radius=r,
                                                                   bucket_width=w), k))
    return out


def k5b_calls(inp):
    """[(label, call of the kernel's wrapper, call of the twin, (cand,
    cand_ok))] at the mid360 and loop shapes."""
    from lidar_odometry_tpu_torch.ops import icp
    mid = icp.ICPConfig(max_correspondence_distance=inp["mid_cfg"][0],
                        plane_fit_planarity=inp["mid_cfg"][1])
    loop = icp.ICPConfig(max_correspondence_distance=inp["loop_cfg"][0],
                         plane_fit_planarity=inp["loop_cfg"][1])
    a = (inp["p"], inp["cand"], inp["cand_ok"], inp["mask"])
    b = (inp["qw"], inp["nb"], inp["nb_ok"], inp["q_mask"])
    return [(f"mid360 {a[1].shape[0]} x {a[1].shape[1]}, gated",
             lambda: icp.plane_fit_5nn(*a, mid, True),
             lambda: icp.plane_fit_5nn_plain(*a, mid, True), a[1:3]),
            (f"loop   {b[1].shape[0]} x {b[1].shape[1]}, ungated",
             lambda: icp.plane_fit_5nn(*b, loop, False),
             lambda: icp.plane_fit_5nn_plain(*b, loop, False), b[1:3])]


def check_k6b(call, plain) -> float:
    import torch
    (nk, ok_k, dk), (np_, ok_p, dp) = call(), plain()
    fin = torch.isfinite(dp)
    if not (torch.equal(ok_k, ok_p) and torch.equal(nk, np_)
            and torch.equal(torch.isfinite(dk), fin)):
        raise SystemExit("K6b differs from its twin")
    err = float((dk[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err > 1e-5:
        raise SystemExit(f"K6b's distances differ from its twin's by {err}")
    return err


def check_k5b(call, plain, cand) -> dict:
    import chip_smoke as cs
    gap = cs.k5b_gaps(call(), plain(), *cand)
    if gap["sel_rows"] or gap["flips"] or gap["err"] > 1e-4:
        raise SystemExit(f"K5b differs from its twin: {gap['sel_rows']} rows chose others, "
                         f"{gap['flips']} flags flipped, {gap['err']:.2e}")
    return gap


def timings(tag: str, card: str, inp) -> None:
    """Every shape against the twin and its device and as-issued times."""
    import chip_smoke as cs
    print(f"K6b ({tag}; {card}): {inp['qw'].shape[0]} queries", flush=True)
    for label, call, plain, _ in k6b_calls(inp):
        err = check_k6b(call, plain)
        print(f"  K6b {label}: {cs.device_ms(call, 30):.4f} ms on the device, "
              f"{cs.time_ms(call, 30):.4f} as issued; equal to the twin, distances within "
              f"{err:.1e}", flush=True)
    print(f"K5b ({tag}; {card}):", flush=True)
    for label, call, plain, cand in k5b_calls(inp):
        gap = check_k5b(call, plain, cand)
        print(f"  K5b {label}: {cs.device_ms(call, 30):.4f} ms on the device, "
              f"{cs.time_ms(call, 30):.4f} as issued; selection equal, "
              f"{int(gap['well'].sum())} well-conditioned rows, flags equal there, dist and "
              f"resid within {gap['err']:.1e}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a tree holding lidar_odometry_tpu_torch/ (default: this checkout)")
    ap.add_argument("--plain", action="store_true",
                    help="no stamps: ptxas's report and the times alone")
    ap.add_argument("--inputs", type=Path, default=ROOT / "build" / "k6b_k5b_inputs.pt",
                    help="the inputs, made here (and saved) if the file is missing")
    args = ap.parse_args()
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree))     # the tree's package and its own wrappers
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k6b_k5b_phase_stamps: needs a CUDA device")
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {tree}")
    card = ps.card()
    kernels.build()
    for src, fn, parts in (("knn", "point_knn_kernel", ("ILi5E", "ILi1E")),
                           ("grid_knn", "plane_fit_kernel", ("",))):
        if hasattr(kernels, "ptxas_entries"):
            entries = kernels.ptxas_entries(src, fn)
        else:                         # an older tree: one entry a template argument K
            entries = {fn + x: kernels.ptxas_info(src, fn + x) for x in parts}
        for name, info in entries.items():
            print(f"ptxas {cs.entry_name(name)} ({tag}): {info['registers']} registers, "
                  f"{info['stack']} bytes of stack, spills {info['spill_stores']} / "
                  f"{info['spill_loads']} bytes", flush=True)
    inp = (torch.load(args.inputs, map_location="cuda") if args.inputs.exists()
           else make_inputs(args.inputs))
    timings(tag, card, inp)
    if args.plain:
        return

    us_per_cycle = ps.sm_us_per_cycle()
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    base = ROOT / "build" / "k6b_k5b_stamps" / tag
    new6 = "// ---- merge" in (csrc / "knn.cu").read_text()
    lib, labels = ps.stamped(tree, base / "k6b", "knn", [
        ("knn.cu", r"^point_knn_kernel\(", "start", "end", () if new6 else K6B_ANCHORS)],
        0, "point_knn_kernel", ["point_knn"])
    label, call, plain, _ = k6b_calls(inp)[0]
    check_k6b(call, plain)
    ms = cs.device_ms(call, 30)
    ps.clear(lib)
    call()
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"K6b phase split ({tag}; {card}): {label}, query 0's chain (thread 0 of block 0): "
          f"{total} cycles from its first stamp to its last ({total * us_per_cycle:.2f} us at "
          f"{1 / us_per_cycle:.0f} cycles a us), {n_st} stamps; {ms:.4f} ms a launch on the "
          f"device (stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)

    lib, labels = ps.stamped(tree, base / "k5b", "grid_knn", [
        ("grid_knn.cu", r"^plane_fit_kernel\(", "start", "end", ()),
        ("common.cuh", r"^__device__ __forceinline__ void eigvals3\(",
         "eigvals3: trace, p, B, det", None, ())],
        0, "plane_fit_kernel", ["plane_fit_5nn"])
    label, call, plain, cand = k5b_calls(inp)[0]
    check_k5b(call, plain, cand)
    ms = cs.device_ms(call, 30)
    ps.clear(lib)
    call()
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"K5b phase split ({tag}; {card}): {label}, point 0's chain (thread 0 of block 0): "
          f"{total} cycles from its first stamp to its last ({total * us_per_cycle:.2f} us), "
          f"{n_st} stamps; {ms:.4f} ms a launch on the device (stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)


if __name__ == "__main__":
    main()
