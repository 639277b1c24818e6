"""Device times and phase split of K11c shard_sample (alone, and inside K11b
shard_alpha_normal_eq's launch) and K5a grid_knn on the card, at the shapes
the paths give them, from CUDA events and clock64 stamps.

Inputs (made once on the card with the tree's own wrappers and kept in
--inputs, so that every tree of one call runs on the same tensors):
  K11b/K11c  tools/k2b_phase_stamps.py's K11b input at S = 1, 2, 4 and 8:
             frame 20 of the bench's scans after a boot chunk, its features
             split by K11a's compaction at the guess (cap rows a shard),
             each row with the scan's correspondence, the moments, A = 101
             alphas and the committed draws of S shards;
  K5a        chip_smoke.kd_inputs: the mid360 path's map after its first
             chunk and the next frame's 16384 features at its guess, at r
             = 2 (the mid360 shape) and r = 1, and with the features' row
             mask.

Each call is held against the plain twin (K11c's slots and K5a's
centroids and flags exactly; K11b's blocks within 1e-5 of their largest
entry, its count exactly) and timed on the device (CUDA events over 30
calls queued behind a ~25 ms spin, chip_smoke.device_ms) and as issued
(chip_smoke.time_ms): K11c alone, K11b alone, and the ICP round's
systems and sample as the tree issues them (a tree without
shard_alpha_normal_eq_sample: K11b then K11c, two launches; else the one
fused launch); K5a alone, and with the row mask as the KD-tree ICP takes
it (an older tree: K5a then the torch `&`). Every tree's outputs are kept
in build/k11c_k5a_outputs_<tag>.pt; where another tree's file is there,
K11b's rows, K11c's slots and K5a's outputs are compared with its
bit for bit.

Then, unless --plain, K11c's sample (the new tree's sample_slice, an older
tree's sample_kernel, stamped at its statements: K11C_ANCHORS) and K5a's
grid_knn_kernel (GRID_ANCHORS for an older tree) are copied into
build/k11c_k5a_stamps/<tag>/ with a stamp (tools/phase_stamps.py) before
every phase comment ("// ---- name"), one at the start and one before the
closing brace, taken by thread 0 of block 0: instance 0's sample at S = 4
(K11c alone), and K5a's first warp at the mid360 shape.

    python tools/k11c_k5a_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of the kernels
are printed from the tree's build.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT
SHARDS = (1, 2, 4, 8)

# an older tree's kernels, at their statements (regex, label), in order
K11C_ANCHORS = (
    (r"const float denom = fmaxf\(scale_from_moments", "the scale"),
    (r"const int chunk = \(n \+ SAMPLE_THREADS - 1\)", "the thread's flags, byte by byte"),
    (r"const int incl = lo::block_inclusive_scan", "the block scan"),
    (r"^\s*if \(t < q\) \{", "the ranks"),
    (r"^\s*if \(c > 0\) \{", "every rank against the chunk, re-walked in memory"),
    (r"const float okf = t < nv", "the residuals' gather and the write"),
)
GRID_ANCHORS = (
    (r"int qc\[3\], pq\[3\], lp\[3\];", "the point's voxel"),
    (r"^\s*int slot = -1;", "the probe"),
    (r"for \(int m0 = 0; m0 < M; m0 \+= 32\)",
     "candidates: 4 rounds of shuffle, row, 3 divisions, 4 stores"),
)


def make_inputs(path: Path) -> dict:
    """K11b/K11c's inputs at every S and K5a's at the mid360 shape, on the
    card; saved to `path`."""
    import torch
    import chip_smoke as cs
    import k2b_phase_stamps as k2b
    from lidar_odometry_tpu_torch.ops import pko
    ne_args, mask = k2b.k2b_input()
    shards = {}
    for s in SHARDS:
        k11, out = k2b.k11b_input(ne_args, mask, s)
        shards[s] = dict(args=k11[:8], ld=out.shape[1], u=torch.as_tensor(
            pko.shard_draws(s)[0], device="cuda"))
    state, kcfg, p, fmask = cs.kd_inputs(cs.make_indoor_scans(cs.MID_CHUNK + 1)[0],
                                         cs.mid360_config())
    inp = dict(shards=shards, cfg=(ne_args[9].loss_type, ne_args[9].use_robust_loss),
               state=state._asdict(), p=p, mask=fmask, voxel=kcfg.voxel_size)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(inp, path)
    return inp


def k11_calls(inp, s: int):
    """(K11c alone, K11b alone, the round as the tree issues it, the
    twins' round, out) at S = s; each call writes into `out`."""
    import torch
    from lidar_odometry_tpu_torch.ops import icp
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    d = inp["shards"][s]
    args, u = d["args"], d["u"]
    cfg = icp.ICPConfig(loss_type=inp["cfg"][0], use_robust_loss=inp["cfg"][1])
    r, v, flags, mom = args[2], args[3], args[5], args[6]
    off = args[7].shape[0] * 42
    out = torch.zeros((s, d["ld"]), device="cuda")

    def sample(o=out):
        return so.shard_sample(r, v, flags, mom, u, first=0, n_local=s, off=off, out=o)

    def ne(o=out):
        return so.shard_alpha_normal_eq(*args, cfg, n_local=s, out=o)

    if hasattr(so, "shard_alpha_normal_eq_sample"):
        def round_(o=out):
            return so.shard_alpha_normal_eq_sample(*args, u, cfg, first=0, n_local=s, off=off,
                                                   out=o)
    else:
        def round_(o=out):
            ne(o)
            return sample(o)

    def twins(o):
        so.shard_alpha_normal_eq_plain(*args, cfg, n_local=s, out=o)
        return so.shard_sample_plain(r, v, flags, mom, u, first=0, n_local=s, off=off, out=o)

    return sample, ne, round_, twins, out


def check_round(got, ref, a: int) -> float:
    """K11b's blocks within 1e-5 of their largest entry (returned), its
    count and K11c's slots exactly."""
    import torch
    a42 = a * 42
    err = float((got[:, :a42] - ref[:, :a42]).abs().max() / ref[:, :a42].abs().max())
    if not (err <= 1e-5 and torch.equal(got[:, a42:], ref[:, a42:])):
        raise SystemExit(f"K11b/K11c differ from the twins: {err:.3e} of the largest entry, "
                         f"slots equal {torch.equal(got[:, a42:-1], ref[:, a42:-1])}")
    return err


def k5a_calls(inp):
    """(label, call, twin) of K5a at r = 2 and 1, and with the row mask as
    the KD-tree ICP takes it."""
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    st = vm.VoxelMapState(**inp["state"])
    p, mask, vox = inp["p"], inp["mask"], inp["voxel"]
    masked = ("mask" in vm.grid_knn_neighbors.__code__.co_varnames)

    def with_mask():
        if masked:
            return vm.grid_knn_neighbors(st, p, voxel_size=vox, radius=2, mask=mask)
        c, ok = vm.grid_knn_neighbors(st, p, voxel_size=vox, radius=2)
        return c, ok & mask[:, None]

    def twin_mask():
        c, ok = vm.grid_knn_neighbors_plain(st, p, voxel_size=vox, radius=2)
        return c, ok & mask[:, None]

    out = [(f"r {r}, {p.shape[0]} x {(2 * r + 1) ** 3}",
            lambda r=r: vm.grid_knn_neighbors(st, p, voxel_size=vox, radius=r),
            lambda r=r: vm.grid_knn_neighbors_plain(st, p, voxel_size=vox, radius=r))
           for r in (2, 1)]
    out.append((f"r 2 with the row mask ({'in the kernel' if masked else 'K5a, then torch &'})",
                with_mask, twin_mask))
    return out


def timings(tag: str, card: str, inp) -> dict:
    """Every call against its twin, its device and as-issued times; the
    outputs kept for the comparison across trees."""
    import torch
    import chip_smoke as cs
    keep = {}
    for s in SHARDS:
        sample, ne, round_, twins, out = k11_calls(inp, s)
        a = inp["shards"][s]["args"][7].shape[0]
        ref = twins(torch.zeros_like(out))
        out.zero_()
        round_()
        err = check_round(out, ref, a)
        keep[f"round S={s}"] = out.clone()
        out.zero_()
        ne()
        keep[f"K11b S={s}"] = out.clone()
        alone = torch.zeros_like(out)
        sample(alone)
        if not torch.equal(alone[:, a * 42:-1], ref[:, a * 42:-1]):
            raise SystemExit(f"K11c alone differs from its twin at S = {s}")
        n, nv = inp["shards"][s]["args"][2].shape[1], int(inp["shards"][s]["args"][3].sum())
        print(f"  S={s} ({tag}; {card}): cap {n}, {nv} valid, q "
              f"{inp['shards'][s]['u'].shape[1]}: K11c alone {cs.device_ms(sample, 30):.4f} ms "
              f"on the device ({cs.time_ms(sample, 30):.4f} as issued); K11b alone "
              f"{cs.device_ms(ne, 30):.4f} ({cs.time_ms(ne, 30):.4f}); the round as issued "
              f"{cs.device_ms(round_, 30):.4f} ({cs.time_ms(round_, 30):.4f}); K11b "
              f"{err:.1e} of its largest entry from the twin, K11c exact", flush=True)
    for label, call, twin in k5a_calls(inp):
        (ck, okk), (cp, okp) = call(), twin()
        if not (torch.equal(ck, cp) and torch.equal(okk, okp)):
            raise SystemExit(f"K5a {label} differs from its twin")
        keep[f"K5a {label.split(' (')[0]}"] = (ck, okk)
        print(f"  K5a {label} ({tag}; {card}): {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued); {int(okk.sum())} live candidates, "
              f"equal to the twin", flush=True)
    return keep


def compare(keep: dict, tag: str) -> None:
    """This tree's outputs against every other tree's saved ones."""
    import torch
    here = ROOT / "build" / f"k11c_k5a_outputs_{tag}.pt"
    torch.save(keep, here)
    for other in sorted(here.parent.glob("k11c_k5a_outputs_*.pt")):
        if other == here:
            continue
        theirs = torch.load(other, map_location="cuda")
        same = {k: (all(torch.equal(x, y) for x, y in zip(v, theirs[k]))
                    if isinstance(v, tuple) else torch.equal(v, theirs[k]))
                for k, v in keep.items() if k in theirs}
        print(f"outputs bit-equal to {other.stem[len('k11c_k5a_outputs_'):]}'s: {same}",
              flush=True)


def ptxas(tag: str) -> None:
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    kernels.build()
    for src, fn in (("grid_knn", "grid_knn_kernel"), ("shard", "alpha_ne_kernel"),
                    ("shard", "sample_kernel")):
        try:
            entries = kernels.ptxas_entries(src, fn)
        except kernels.KernelError:
            continue            # the new tree has no sample_kernel
        for name, info in entries.items():
            print(f"ptxas {cs.entry_name(name)} ({tag}): {info['registers']} registers, "
                  f"{info['stack']} bytes of stack, spills {info['spill_stores']} / "
                  f"{info['spill_loads']} bytes", flush=True)


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    import torch
    import chip_smoke as cs
    us_per_cycle = ps.sm_us_per_cycle()
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    base = ROOT / "build" / "k11c_k5a_stamps" / tag
    new11 = "void sample_slice(" in (csrc / "shard.cu").read_text()
    spec = (("shard.cu", r"^__device__ __forceinline__ void sample_slice\(", "start", "end", ())
            if new11 else ("shard.cu", r"^sample_kernel\(", "start", "end", K11C_ANCHORS))
    lib, labels = ps.stamped(tree, base / "k11c", "shard", [spec], 0,
                             "alpha_ne_kernel" if new11 else "sample_kernel", ["shard_sample"])
    sample, _, _, twins, out = k11_calls(inp, 4)
    sample()
    ms = cs.device_ms(sample, 30)
    ps.clear(lib)
    sample()
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"K11c phase split ({tag}; {card}): S = 4, instance 0's sample (thread 0 of block "
          f"0): {total} cycles from its first stamp to its last ({total * us_per_cycle:.2f} us "
          f"at {1 / us_per_cycle:.0f} cycles a us), {n_st} stamps; {ms:.4f} ms a launch on the "
          f"device (stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)

    new5 = "// ---- probes" in (csrc / "grid_knn.cu").read_text()
    lib, labels = ps.stamped(tree, base / "k5a", "grid_knn", [
        ("grid_knn.cu", r"^grid_knn_kernel\(", "start", "end", () if new5 else GRID_ANCHORS)],
        0, "grid_knn_kernel", ["grid_knn"])
    label, call, twin = k5a_calls(inp)[0]
    (ck, okk), (cp, okp) = call(), twin()
    if not (torch.equal(ck, cp) and torch.equal(okk, okp)):
        raise SystemExit("the stamped K5a differs from its twin")
    ms = cs.device_ms(call, 30)
    ps.clear(lib)
    call()
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"K5a phase split ({tag}; {card}): {label}, the first warp's chain (thread 0 of "
          f"block 0): {total} cycles from its first stamp to its last "
          f"({total * us_per_cycle:.2f} us), {n_st} stamps; {ms:.4f} ms a launch on the device "
          f"(stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a tree holding lidar_odometry_tpu_torch/ (default: this checkout)")
    ap.add_argument("--plain", action="store_true",
                    help="no stamps: ptxas's report and the times alone")
    ap.add_argument("--inputs", type=Path, default=ROOT / "build" / "k11c_k5a_inputs.pt",
                    help="the inputs, made here (and saved) if the file is missing")
    args = ap.parse_args()
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree))     # the tree's package and its own wrappers
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k11c_k5a_phase_stamps: needs a CUDA device")
    from lidar_odometry_tpu_torch import kernels
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {tree}")
    card = ps.card()
    ptxas(tag)
    inp = (torch.load(args.inputs, map_location="cuda") if args.inputs.exists()
           else make_inputs(args.inputs))
    print(f"K11b/K11c and K5a ({tag}; {card}):", flush=True)
    compare(timings(tag, card, inp), tag)
    if not args.plain:
        stamps(tree, tag, card, inp)


if __name__ == "__main__":
    main()
