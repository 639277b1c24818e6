"""Phase split and device times of K4c map_surfel_recompute and K11a
shard_own on the card, from clock64 stamps, at the shapes the paths give
them.

Inputs (made once on the card with the tree's own chunk runner and kept in
--inputs, so that every tree of one call runs on the same tensors): a boot
chunk of 20 of chip_smoke.py's bench frames builds a map of 65536
parents; its update_map calls of K4c are recorded.
  K4c at three shapes:
    phase    chip_smoke.py's phase-3 input: R = 14336 rows, every parent of
             the boot map with at least 5 children, then dead rows (-1);
    keyframe the update of the boot chunk's keyframe with the median count
             of live rows (the bulk first keyframe left out): its R and l0;
    rehash   every slot of the boot map, R = c1 = 65536, as bulk_build
             calls it after a pose-graph correction.
  K11a at N = 16384 features of frame 20 (K1 at a capacity of 16384),
    S = 1, 2, 4 and 8, with the chunk's pose guess T and without; and at
    the step path's shape, 2 lanes (frames 20 and 21 at N = 14336, two
    guesses) x 4 shards, with T and without.

Each shape is held against the plain twin (K4c by chip_smoke.k4c_agreement:
kidmask equal, 1e-4, no verdict flip outside the 1e-5 band; K11a's four
outputs equal) and timed on the device (CUDA events over 30 launches
queued behind a ~25 ms spin, chip_smoke.device_ms). Then, unless --plain,
each kernel is copied into build/k4c_k11a_stamps/<tag>/ with a stamp
(tools/phase_stamps.py) before every phase comment ("// ---- name"), one
at its start and one before its closing brace; a tree without such
comments (commit 724645d and before) is stamped at its statements
(*_ANCHORS). K4c is stamped by thread 0 of block 0 (parent 0's chain;
eigvals3 in common.cuh too), at the phase shape; K11a by thread 0 of
every CTA of lane 0 (the old kernel: of every instance's block), at N =
16384, S = 4, with T. Each phase prints in cycles and microseconds (the
SM clock read by timing a spin of known cycles), beside the stamped
launch's device time.

    python tools/k4c_k11a_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of both
kernels are printed from the tree's build.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT

# the old kernels' phases, at their statements (regex, label), in order
K4C_ANCHORS = (
    (r"const long long s = r_slot\[i\];", "load: the slot"),
    (r"for \(int k = 0; k < lo::NCH; \+\+k\) \{", "mean pass: 27 children"),
    (r"const float denom =", "mean divide"),
    (r"for \(int k = 0; k < lo::NCH; \+\+k\) \{", "covariance pass: 27 children"),
    (r"lo::eigvals3\(A, lam\);", "eigen-solve"),
    (r"lo::eigvec_for\(A, lam\[0\], nrm\);", "eigenvector"),
    (r"const float plan =", "outputs"),
)
EIG_ANCHORS = (
    (r"const float phi = acosf\(r\) / 3.0f;", "eigvals3: acos and the two cosines"),
    (r"lam\[0\] = l0;", "eigvals3: the eigenvalues"),
)
K11A_ANCHORS = (
    (r"^\s*int c = 0;", "count: owners"),
    (r"lo::block_inclusive_scan\(c, scan\)", "block scan"),
    (r"for \(int i = b0; i < b1 && pos < cap; \+\+i\)", "writes: owners again"),
    (r"for \(int j = total \+ threadIdx.x; j < cap", "tail"),
)
SHARD_COUNTS = (1, 2, 4, 8)


def make_inputs(path: Path) -> dict:
    """The boot chunk's map, its recorded K4c calls and two frames'
    features, on the card; saved to `path`."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    cfg, consts, kw = cs.setup()
    scans, _ = cs.make_scans(cs.CHUNK + 2)
    calls = []
    wrapped = vm.map_surfel_recompute

    def recorder(l0, r_slot, c1, thr):
        calls.append((l0.clone(), r_slot.clone(), int((r_slot >= 0).sum())))
        return wrapped(l0, r_slot, c1, thr)

    vm.map_surfel_recompute = recorder
    try:
        carry = fp.init_carry(0, cs.C1, device="cuda")
        carry, _ = fp.make_chunk_runner(cfg, consts, **kw)(
            carry, torch.as_tensor(scans[:cs.CHUNK], device="cuda"))
    finally:
        vm.map_surfel_recompute = wrapped
    later = sorted(calls[1:], key=lambda c: c[2])
    kf = later[len(later) // 2]
    T = (carry.T_prev @ carry.velocity).reshape(16).contiguous()
    feats = {}
    for cap in (16384, cs.SCAN_CAP):
        for f in (cs.CHUNK, cs.CHUNK + 1):
            raw = torch.as_tensor(scans[f], device="cuda")
            feats[f"{f}_{cap}"] = vf.voxel_filter(raw, raw.shape[0], voxel_size=0.5, stride=1,
                                                  out_capacity=cap, compact_keys=True)[:2]
    inp = dict(l0=carry.map_state.l0_data.clone(), meta2=carry.map_state.l1_meta[:cs.C1, 2].clone(),
               kf_l0=kf[0], kf_slot=kf[1], live_by_call=[c[2] for c in calls],
               r_by_call=[int(c[1].shape[0]) for c in calls], T=T, feats=feats)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(inp, path)
    return inp


def k4c_shapes(inp):
    """[(label, l0, r_slot)] at the phase, keyframe and rehash shapes."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    r_n = min(cs.SCAN_CAP, cs.C1)
    live = torch.nonzero(inp["meta2"] >= vm.MIN_OCCUPIED_CHILDREN).flatten()[:r_n]
    phase = torch.full((r_n,), -1, dtype=torch.int64, device="cuda")
    phase[:live.numel()] = live
    return [("phase", inp["l0"], phase), ("keyframe", inp["kf_l0"], inp["kf_slot"]),
            ("rehash", inp["l0"], torch.arange(cs.C1, device="cuda"))]


def k11a_shapes(inp):
    """[(label, (pts, mask, T, S, first, n_local, cap, inv))]."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    inv = so.owner_inv(0.5, 3)
    T = inp["T"].view(1, 16)
    f, m = inp["feats"][f"{cs.CHUNK}_16384"]
    pts, mask = f[None].contiguous(), m[None].contiguous()
    out = []
    for s in SHARD_COUNTS:
        cap = so.owned_cap(pts.shape[1], s)
        for Tx, tag in ((T, "T"), (None, "no T")):
            out.append((f"N {pts.shape[1]}, 1 lane, S {s}, {tag}",
                        (pts, mask, Tx, s, 0, s, cap, inv)))
    two = [inp["feats"][f"{k}_{cs.SCAN_CAP}"] for k in (cs.CHUNK, cs.CHUNK + 1)]
    pts2 = torch.stack([a for a, _ in two]).contiguous()
    mask2 = torch.stack([b for _, b in two]).contiguous()
    T2 = T.repeat(2, 1)
    T2[1, 3] += 0.05
    T2 = T2.contiguous()
    cap = so.owned_cap(pts2.shape[1], 4)
    for Tx, tag in ((T2, "T"), (None, "no T")):
        out.append((f"N {pts2.shape[1]}, 2 lanes, S 4, {tag}",
                    (pts2, mask2, Tx, 4, 0, 4, cap, inv)))
    return out


def check_k11a(args):
    import torch
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    got, ref = so.shard_own(*args), so.shard_own_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise SystemExit("K11a differs from its twin")
    return got


def timings(tag: str, card: str, inp) -> None:
    """Every shape against the twin and its device time."""
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    print(f"K4c ({tag}; {card}); the boot chunk's K4c calls: R {inp['r_by_call']}, live rows "
          f"{inp['live_by_call']}", flush=True)
    for label, l0, r_slot in k4c_shapes(inp):
        a = cs.k4c_agreement(l0, r_slot, cs.C1, 0.1)
        ms = cs.device_ms(lambda: vm.map_surfel_recompute(l0, r_slot, cs.C1, 0.1), 30)
        print(f"  K4c {label:8s} R {r_slot.shape[0]:6d}, {int((r_slot >= 0).sum()):6d} slots, "
              f"{a['live']:6d} with a live child: {ms:.4f} ms on the device; max_abs_err "
              f"{a['err']:.2e}, verdicts flipped in the band {a['flips_in']}, planarity of the "
              f"rows with fewer than 5 children (unused) {a['plan_few']:.1e}", flush=True)
    print(f"K11a ({tag}; {card}):", flush=True)
    for label, args in k11a_shapes(inp):
        got = check_k11a(args)
        ms = cs.device_ms(lambda: so.shard_own(*args), 30)
        print(f"  K11a {label:26s} cap {args[6]:6d}: {ms:.4f} ms on the device; equal to the "
              f"twin; over {got[3].tolist()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a tree holding lidar_odometry_tpu_torch/ (default: this checkout)")
    ap.add_argument("--plain", action="store_true",
                    help="no stamps: ptxas's report and the device times alone")
    ap.add_argument("--inputs", type=Path, default=ROOT / "build" / "k4c_k11a_inputs.pt",
                    help="the inputs, made here (and saved) if the file is missing")
    args = ap.parse_args()
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree))     # the tree's package and its own wrappers
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k4c_k11a_phase_stamps: needs a CUDA device")
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {tree}")
    card = ps.card()
    kernels.build()
    for src, fn in (("voxel_map", "surfel_recompute_kernel"), ("shard", "own_compact_kernel")):
        info = kernels.ptxas_info(src, fn)
        print(f"ptxas {fn} ({tag}): {info['registers']} registers, {info['stack']} bytes of "
              f"stack, spills {info['spill_stores']} / {info['spill_loads']} bytes", flush=True)
    inp = (torch.load(args.inputs, map_location="cuda") if args.inputs.exists()
           else make_inputs(args.inputs))
    timings(tag, card, inp)
    if args.plain:
        return

    us_per_cycle = ps.sm_us_per_cycle()
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    base = ROOT / "build" / "k4c_k11a_stamps" / tag

    new4 = "// ---- sums" in (csrc / "voxel_map.cu").read_text()
    new_eig = "// ---- eigvals3" in (csrc / "common.cuh").read_text()
    lib, labels = ps.stamped(tree, base / "k4c", "voxel_map", [
        ("voxel_map.cu", r"^surfel_recompute_kernel\(", "start", "end",
         () if new4 else K4C_ANCHORS),
        ("common.cuh", r"^__device__ __forceinline__ void eigvals3\(",
         "eigvals3: trace, p, B, det", None, () if new_eig else EIG_ANCHORS)],
        0, "surfel_recompute_kernel", ["map_surfel_recompute"])
    _, l0, r_slot = k4c_shapes(inp)[0]
    a = cs.k4c_agreement(l0, r_slot, cs.C1, 0.1)
    run = lambda: vm.map_surfel_recompute(l0, r_slot, cs.C1, 0.1)
    ms = cs.device_ms(run, 30)
    ps.clear(lib)
    run()
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"K4c phase split ({tag}; {card}): the phase shape, R {r_slot.shape[0]}, parent 0's "
          f"chain (thread 0 of block 0): {total} cycles from its first stamp to its last "
          f"({total * us_per_cycle:.2f} us at {1 / us_per_cycle:.0f} cycles a us), {n_st} "
          f"stamps; {ms:.4f} ms a launch on the device (stamped); max_abs_err {a['err']:.2e}",
          flush=True)
    ps.report(phases, total, us_per_cycle)

    new11 = "// ---- ranks in the warp" in (csrc / "shard.cu").read_text()
    lib, labels = ps.stamped(tree, base / "k11a", "shard", [
        ("shard.cu", r"^own_compact_kernel\(", "prologue", "end", () if new11 else K11A_ANCHORS)],
        -1, "own_compact_kernel", ["shard_own"])
    label, args11 = [s for s in k11a_shapes(inp) if s[0].endswith("1 lane, S 4, T")][0]
    check_k11a(args11)
    run = lambda: so.shard_own(*args11)
    ms = cs.device_ms(run, 30)
    ps.clear(lib)
    run()
    torch.cuda.synchronize()
    blocks = ps.split(lib, labels, every=True)
    print(f"K11a phase split ({tag}; {card}): {label}; {ms:.4f} ms a launch on the device "
          f"(stamped); stamped span of each block: "
          f"{[round(t * us_per_cycle, 2) for _, t, _ in blocks.values()]} us", flush=True)
    for b, (ph, total, _) in blocks.items():
        print(f" block {b}:")
        ps.report(ph, total, us_per_cycle)


if __name__ == "__main__":
    main()
