"""Phase split of K2b icp_normal_eq on the card, from clock64 stamps, and
the device times of K2b and K11b shard_alpha_normal_eq.

Copies csrc/ of a source tree (this checkout's lidar_odometry_tpu_torch/,
or --src DIR, for example an older commit unpacked with `git archive` into
a directory that .gitignore lists) into build/k2b_stamps/<tag>/ with a
stamp (tools/phase_stamps.py) before every phase comment ("// ---- name")
of normal_eq_kernel, one at its start and one before its closing brace,
taken by thread 0 of every block. A tree whose kernel has no such
comments (the grid-and-ticket kernel of commit 14bb3b4 and before) is
stamped at its statements instead (TICKET_ANCHORS). The split printed is
that of the block that ran the tail (the solve): the last block to take
the ticket in the old kernel, rank 0 of the cluster in the new one.

It builds the copy with the port's nvcc flags (printing ptxas's report of
normal_eq_kernel), launches it through the tree's own wrapper on
chip_smoke.py's phase-3 K2b input (a boot chunk of 20 bench frames, then
frame 20's correspondences, K3's scale and alpha), checks it against the
plain twin (T within 1e-5, flags equal), and prints each phase's cycles
and microseconds (at the SM clock read by timing a spin of known cycles),
beside the launch's device time from CUDA events (30 launches queued
behind a spin, so that the host's cost of issuing them is hidden).

    python tools/k2b_phase_stamps.py [--src DIR] [--plain]

With --plain nothing is stamped: it prints the tree's own build's ptxas
report of normal_eq_kernel and alpha_ne_kernel and the device times of
K2b at B = 1 and at B = 4 (the input four times) and of K11b at S = 4,
A = 101 (and A = 32) on the same frame's features split by K11a's owner compaction
(each shard's rows taking the whole scan's correspondences; held against
its twin at 1e-5 of the largest entry), the time the stamps do not
perturb, on any tree (an older kernel included), and of K11d (which
shares K2b's gn.cuh) on those rows and K11c's samples.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT

# the old kernel's phases, at its statements (regex, label), in order
TICKET_ANCHORS = (
    (r"^\s*float acc\[NSUM\];", "per-point sums"),
    (r"^\s*const int warp = tid / 32, lane = tid % 32;", "block reduce"),
    (r"^\s*__threadfence\(\);", "fence and ticket"),
    (r"lo::solve6\(sums, x\);", "solve6"),
    (r"lo::gn_retract\(T, x, tol_t, tol_r, Tn\)", "gn_retract"),
    (r"^\s*const int count = aux\[0\];", "outputs"),
)


def k2b_input():
    """chip_smoke.py's phase-3 K2b input on the card: (args of
    icp.icp_normal_eq, feat's mask)."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import icp, pko, voxel_filter as vf
    cfg, consts, kw = cs.setup()
    scans, _ = cs.make_scans(cs.CHUNK + 1)
    runner = fp.make_chunk_runner(cfg, consts, **kw)
    carry = fp.init_carry(0, cs.C1, device="cuda")
    carry, _ = runner(carry, torch.as_tensor(scans[:cs.CHUNK], device="cuda"))
    raw = torch.as_tensor(scans[cs.CHUNK], device="cuda")
    feat, mask, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=0.5, stride=1,
                                    out_capacity=cs.SCAN_CAP, compact_keys=True)
    T = (carry.T_prev @ carry.velocity).reshape(16).contiguous()
    flags = torch.zeros((3,), dtype=torch.int32, device="cuda")
    nrm, r, v = icp.icp_correspond(feat, mask, T, flags, carry.map_state, cfg)
    aux, scale = pko.pko_alpha_index(r, v, flags, torch.ones((1,), device="cuda"), True, consts)
    return (feat, nrm, r, v, T, scale, flags, aux, consts, cfg), mask


def k11b_input(args, mask, n_shards: int = 4):
    """K11b's arguments on the K2b frame: the features split over n_shards
    by K11a's compaction at T, each row with the scan's correspondence."""
    import torch
    from lidar_odometry_tpu_torch.ops import pko
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    feat, nrm, r, v, T, _, _, _, consts, cfg = args
    n = feat.shape[0]
    cap = so.owned_cap(n, n_shards)
    T1 = T.reshape(1, 16)
    p_own, ok, sel, _ = so.shard_own(feat[None].contiguous(), mask[None].contiguous(), T1,
                                     n_shards, 0, n_shards, cap, so.owner_inv(0.5, 3))
    idx = sel.long()
    nrm_s, r_s = nrm[idx].contiguous(), r[idx].contiguous()
    v_s = (v[idx] & ok).contiguous()
    live = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    mom = so.shard_alpha_normal_eq(p_own, nrm_s, r_s, v_s, T1, live, None, None, cfg,
                                   n_local=n_shards, moments=True).view(1, n_shards, 3)
    q = pko.shard_draws(n_shards)[0].shape[1]
    out = torch.zeros((n_shards, so.buffer_width(consts.alphas.shape[0], n_shards, q)),
                      device="cuda")
    return (p_own, nrm_s, r_s, v_s, T1, live, mom.contiguous(), consts.alphas, cfg), out


def k11d_args(k11, out):
    """K11d's arguments on K11b's rows: K11c's samples added into `out`,
    the gathered (1, S, ld) buffer, pose, flags, constants and draws."""
    import torch
    from lidar_odometry_tpu_torch.ops import pko
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    p_own, nrm, r, v, T1, live, mom, alphas, cfg = k11
    s = r.shape[0]
    u, pick = (torch.as_tensor(a, device="cuda") for a in pko.shard_draws(s))
    so.shard_sample(r, v, live, mom, u, first=0, n_local=s, off=alphas.shape[0] * 42, out=out)
    consts = pko.make_pko_constants(0.1, 10.0, 100, 10.0, "huber", 3, 100, device="cuda")
    return (out[None].contiguous(), T1, live, consts, pick, cfg), dict(
        n_alpha=alphas.shape[0], quota=u.shape[1], use_pko=True)


def k11b_stamps(csrc: Path, out: Path, ne_args, mask, tag: str, card: str) -> None:
    """K11b's phase split: alpha_ne_kernel stamped at its phase comments
    in every CTA of the cluster of instance 0 and alphas 0-31, launched
    through the tree's wrapper on k11b_input at S = 4, A = 101."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    stamps = ps.Stamps()
    texts = {"shard.cu": stamps.function((csrc / "shard.cu").read_text().splitlines(),
                                         r"^alpha_ne_kernel\(", first="prologue", last="end")}
    ps.copy_sources(csrc, out, "shard", texts)
    lib = ps.build(out, "shard", out / "libshard_stamped.so", -1, "alpha_ne_kernel")
    k = kernels.KERNELS["shard_alpha_normal_eq"]
    fn = lib.lo_shard_alpha_normal_eq
    fn.argtypes = k.argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k._fn = fn
    k11, buf = k11b_input(ne_args, mask)
    run = lambda: so.shard_alpha_normal_eq(*k11, n_local=4, out=buf)
    run()
    ref = so.shard_alpha_normal_eq_plain(*k11, n_local=4, out=torch.zeros_like(buf))
    a42 = k11[7].shape[0] * 42
    err = float((buf[:, :a42] - ref[:, :a42]).abs().max() / ref[:, :a42].abs().max())
    if not err <= 1e-5:
        raise SystemExit(f"the stamped K11b differs from the twin: {err:.3e}")
    ms = cs.device_ms(run, 30)
    ps.clear(lib)
    run()
    torch.cuda.synchronize()
    blocks = ps.split(lib, stamps.labels, every=True)
    print(f"K11b phase split ({tag}; {card}): S = 4, cap {k11[0].shape[1]}, "
          f"{int(k11[3][0].sum())} valid rows in instance 0, A = {k11[7].shape[0]}; {ms:.4f} ms "
          f"a launch on the device (stamped); stamped span of each CTA of the cluster: "
          f"{[t for _, t, _ in blocks.values()]} cycles")
    for b, (phases, total, _) in blocks.items():
        print(f" CTA {b}:")
        ps.report(phases, total)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a tree holding lidar_odometry_tpu_torch/ (default: this checkout)")
    ap.add_argument("--plain", action="store_true",
                    help="no stamps: ptxas's report and the device times alone")
    ap.add_argument("--k11b", action="store_true",
                    help="stamp K11b's alpha_ne_kernel (its cluster of instance 0, alphas "
                         "0-31) in place of K2b")
    args = ap.parse_args()
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree))     # the tree's package and its own wrappers
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2b_phase_stamps: needs a CUDA device")
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.ops import icp
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {tree}")

    ne_args, mask = k2b_input()
    card = ps.card()

    def checked(fn):
        """Run K2b, hold it against the twin, and return its outputs."""
        got = fn()
        ref = icp.icp_normal_eq_plain(*ne_args)
        err = float((got[0] - ref[0]).abs().max())
        if not (err <= 1e-5 and torch.equal(got[1], ref[1])):
            raise SystemExit(f"K2b differs from the twin: T {err:.3e}, flags "
                             f"{got[1].tolist()} vs {ref[1].tolist()}")
        return got, err

    n, nv = ne_args[0].shape[0], int(ne_args[3].sum())
    if args.plain:
        kernels.build()
        for src, fn in (("icp", "normal_eq_kernel"), ("shard", "alpha_ne_kernel")):
            log = kernels.BUILD_DIR / f"lib{src}_{kernels._digest(src)}.log"
            lines = log.read_text().splitlines()
            head = next(i for i, l in enumerate(lines) if "Compiling" in l and fn in l)
            for line in lines[head:head + 4]:
                print(f"ptxas {src}: {line.strip()}")
        _, err = checked(lambda: icp.icp_normal_eq(*ne_args))
        ms1 = cs.device_ms(lambda: icp.icp_normal_eq(*ne_args), 30)
        four = [torch.stack([a] * 4).contiguous() if isinstance(a, torch.Tensor) else a
                for a in ne_args[:8]] + list(ne_args[8:])
        ms4 = cs.device_ms(lambda: icp.icp_normal_eq(*four), 30)
        k11, out = k11b_input(ne_args, mask)
        so.shard_alpha_normal_eq(*k11, n_local=4, out=out)
        first = out.clone()
        so.shard_alpha_normal_eq(*k11, n_local=4, out=out)
        same = torch.equal(first, out)
        ref = so.shard_alpha_normal_eq_plain(*k11, n_local=4, out=torch.zeros_like(out))
        a42 = k11[7].shape[0] * 42
        err11 = float((out[:, :a42] - ref[:, :a42]).abs().max() / ref[:, :a42].abs().max())
        if not (err11 <= 1e-5 and torch.equal(out[:, -1], ref[:, -1])):
            raise SystemExit(f"K11b differs from the twin: {err11:.3e} of the largest entry")
        ms11 = cs.device_ms(lambda: so.shard_alpha_normal_eq(*k11, n_local=4, out=out), 30)
        k32 = k11[:7] + (k11[7][:32].contiguous(), k11[8])   # one group of 32 alphas
        ms32 = cs.device_ms(lambda: so.shard_alpha_normal_eq(*k32, n_local=4, out=out), 30)
        print(f"K2b ({tag}, no stamps; {card}): N {n}, {nv} valid, {ms1:.4f} ms a launch on "
              f"the device at B = 1, {ms4:.4f} at B = 4 (CUDA events, 30 launches), T "
              f"{err:.2e} from the twin")
        d_args, d_kw = k11d_args(k11, out)
        sel = so.shard_gn_select(*d_args, **d_kw)
        ref_d = so.shard_gn_select_plain(*d_args, **d_kw)
        err_d = float((sel[0] - ref_d[0]).abs().max())
        if not (err_d <= 1e-6 and torch.equal(sel[2], ref_d[2])):
            raise SystemExit(f"K11d differs from the twin: T {err_d:.3e}, alpha "
                             f"{sel[2].tolist()} vs {ref_d[2].tolist()}")
        ms_d = cs.device_ms(lambda: so.shard_gn_select(*d_args, **d_kw), 30)
        print(f"K11d ({tag}, no stamps; {card}): S = 4, alpha {int(sel[2][0, 0])}: {ms_d:.4f} ms "
              f"a launch on the device, T {err_d:.2e} from the twin")
        print(f"K11b ({tag}, no stamps; {card}): S = 4, cap {k11[0].shape[1]}, "
              f"{int(k11[3].sum())} valid rows, A = {k11[7].shape[0]}: {ms11:.4f} ms a launch on "
              f"the device ({ms32:.4f} at A = 32), {err11:.2e} of the largest entry from the "
              f"twin; two calls bit-equal: {same}")
        return

    out = ROOT / "build" / "k2b_stamps" / tag
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    if args.k11b:
        k11b_stamps(csrc, out.with_name(tag + "_k11b"), ne_args, mask, tag, card)
        return
    lines = (csrc / "icp.cu").read_text().splitlines()
    anchors = () if any("// ---- per-point sums" in l for l in lines) else TICKET_ANCHORS
    stamps = ps.Stamps()
    texts = {"icp.cu": stamps.function(lines, r"^normal_eq_kernel\(",
                                       first="prologue: pointers, done flag, T, delta",
                                       last="end", anchors=anchors)}
    ps.copy_sources(csrc, out, "icp", texts)
    lib = ps.build(out, "icp", out / "libicp_stamped.so", -1, "normal_eq_kernel")
    k = kernels.KERNELS["icp_normal_eq"]
    fn = lib.lo_icp_normal_eq
    fn.argtypes = k.argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k._fn = fn          # the tree's wrapper now launches the stamped copy

    _, err = checked(lambda: icp.icp_normal_eq(*ne_args))
    ms = cs.device_ms(lambda: icp.icp_normal_eq(*ne_args), 30)
    # the SM clock: a spin of known cycles timed by CUDA events
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    cyc_per_us = 20_000_000 / (start.elapsed_time(end) * 1e3)
    ps.clear(lib)
    icp.icp_normal_eq(*ne_args)
    torch.cuda.synchronize()
    blocks = ps.split(lib, stamps.labels, every=True)
    tail = [b for b, (ph, _, _) in blocks.items() if "solve6" in ph]
    if len(tail) != 1:
        raise SystemExit(f"expected one block to run the solve, found {tail}")
    phases, total, n_st = blocks[tail[0]]
    sums = [ph["per-point sums"][0] for ph, _, _ in blocks.values() if "per-point sums" in ph]
    print(f"K2b phase split ({tag}; {card}): N {n}, {nv} valid, {len(blocks)} blocks stamped, "
          f"block {tail[0]} ran the tail: {total} cycles from its first stamp to its last "
          f"({total / cyc_per_us:.2f} us at {cyc_per_us:.0f} cycles a us), {ms:.4f} ms a "
          f"launch on the device (stamped; CUDA events, 30 launches), T {err:.2e} from the twin; "
          f"per-point sums over the blocks {min(sums)}-{max(sums)} cycles")
    ps.report(phases, total, 1.0 / cyc_per_us)


if __name__ == "__main__":
    main()
