"""Device times of K7c cross_power and K9b map_bulk_merge, and their phase
splits, on the card, at the shapes the paths give them, from CUDA events
and clock64 stamps.

Inputs (made once on the card by --make-inputs with this checkout's
package and kept in --inputs, so that every tree of one call runs on the
same tensors):
  K7c  the Iris images of 16 keyframes of the loops path's world
       (chip_smoke.make_loop_scans' circuit: frames 0, 2, ..., 30 scanned
       with its 10000 returns at 45 m, their features at kitti.yaml's scan
       capacity of 16384, then iris_bits), row 0 the query against K = 1,
       2, 4 (the loops path's) and 32 candidates (rows 1, 2, ... mod 16):
       the spectra iris.phase_shifts takes (the query's, the candidates'
       forward and flipped: 2K rows of 80 x 360), and the images for whole
       phase_shifts calls; the prealign's two 128 x 128 BEV spectra (the
       bev_raster images of frames 0 and 2 about frame 0's position);
  K9b  the surfel path's map (chip_smoke.C1 = 65536 parents, built by the
       first chunk of the bench's scans, as tools/k8a_k9a_phase_stamps.py
       builds it) moved by that tool's correction: the records of its
       rehash in key order as bulk_plan gives them to K9b (M = 4 c1 =
       262144), and the sharded path's per-shard shape
       (chip_smoke.shard_merge_plan: every shard's L0 rows, M = 4 x 16384 x
       27, shard 0's live records).

Each call is held against the tree's plain twin on the card (bit for bit
where the tree's twin repeats the kernel's arithmetic and order, else
K7c within 1e-6 and K9b's counts equal and its rows within 1e-5
relative) and timed on the device (CUDA events over 30 calls queued
behind a ~25 ms spin, chip_smoke.device_ms) and as issued
(chip_smoke.time_ms), with the device records (kernels, memcpy, memset)
of one call. K7c is timed as the tree's Iris query calls it (a tree whose
cross_power takes x2: the forward and flipped spectra as two tensors;
an older tree: one concatenated tensor, made before the timing) and with
one tensor; whole phase_shifts calls are timed and their device records
counted. Every tree's outputs of one call are kept in
build/k7c_k9b_outputs_<tag>.pt; where another tree's file is there, they
are compared with its bit for bit.

Then, unless --plain, a tree whose kernels carry phase comments ("//
---- name") has each copied into build/k7c_k9b_stamps/<tag>/ with a stamp
(tools/phase_stamps.py) before every phase comment, one at the start and
one before the closing brace, read from thread 0 of block 0 (K7c: the
first column pair of the first row chunk; K9b: the first tile's warp);
an older tree's kernels are timed only.

    python tools/k7c_k9b_phase_stamps.py --make-inputs
    python tools/k7c_k9b_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of both
kernels are printed from the tree's build.

    python tools/k7c_k9b_phase_stamps.py --library-variant DIR

writes a copy of this checkout's package into DIR in which K7c computes
its magnitude and reciprocal with the library's hypotf and __fdiv_rn (the
calls into their slow paths kept) in place of hypot_exact and
lo::fast_div, and stops; run the tool with --src DIR to time that form
beside the checkout's (its outputs must be the same bits).

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import inspect
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402
from k8a_k9a_phase_stamps import VOXEL, correction  # noqa: E402
from k8c_k6a_phase_stamps import run  # noqa: E402

ROOT = ps.ROOT
ENTRIES = (("bev_align", "cross_power_kernel"), ("rehash", "bulk_merge_kernel"))
K7C_SIZES = (1, 2, 4, 32)


def make_inputs(path: Path) -> None:
    """K7c's and K9b's inputs, made on the card with this checkout's
    package; saved to `path`."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import bev_align, iris
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.utils import lie
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
    img = iris.iris_bits(torch.stack(feats).contiguous(), torch.stack(masks).contiguous())
    img = img.to(torch.float32)
    c64 = lambda a: a.to(torch.complex64)
    k7c = {}
    for k in K7C_SIZES:
        cand = img[((torch.arange(k, device="cuda") + 1) % 16)]
        fd = torch.fft.fft2(c64(cand)).reshape(k, -1)
        fdx = torch.fft.fft2(c64(torch.roll(cand, 180, -1))).reshape(k, -1)
        k7c[f"K = {k}"] = dict(qf=torch.fft.fft2(c64(img[0])).reshape(-1), fd=fd, fdx=fdx,
                               q=img[0].clone(), cand=cand.contiguous())
    T0 = torch.as_tensor(poses[0], device="cuda")
    w = [lie.transform_points(torch.as_tensor(poses[f], device="cuda"), feats[i])
         for i, f in ((0, 0), (1, 2))]
    bev = bev_align.bev_raster(w[1], masks[1], torch.eye(4, device="cuda").reshape(16), w[0],
                               masks[0], T0[:3, 3].contiguous())
    prealign = dict(fa=torch.fft.fft2(c64(bev[0])).reshape(-1),
                    fb=torch.fft.fft2(c64(bev[1])).reshape(1, -1))

    cfg_s, consts, kw = cs.setup()
    scans, _ = cs.make_scans(cs.CHUNK)
    carry = fp.init_carry(0, cs.C1, device="cuda")
    carry, _ = fp.make_chunk_runner(cfg_s, consts, **kw)(
        carry, torch.as_tensor(scans, device="cuda"))
    cen, cnt, live, cap, _ = vm.rehash_records(carry.map_state, correction().to("cuda"))
    k9b = {}
    for name, plan in (("surfel c1 65536", vm.bulk_plan(cen, cnt, live, cap, cs.C1,
                                                        voxel_size=VOXEL)),
                       ("sharded shard c1 16384", cs.shard_merge_plan(cen, cnt, live, VOXEL))):
        k9b[name] = dict(l0=plan.fresh.l0_data.clone(), s_key=plan.s_key, s_idx=plan.s_idx,
                         first=plan.first, counts=plan.counts, centroids=plan.centroids,
                         index=plan.fresh.l1_index)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(k7c=k7c, prealign=prealign, k9b=k9b), path)
    print(f"inputs: K7c K = {list(K7C_SIZES)} and the prealign's {tuple(bev.shape)} images; K9b "
          + ", ".join(f"{name}: M {a['s_key'].shape[0]}, {int(a['first'].sum())} merged voxels"
                      for name, a in k9b.items())
          + f"; saved to {path}", flush=True)


def k7c_calls(inp):
    """(name, the tree's call, its twin's output) for each K7c shape: the
    Iris queries as the tree passes them and the prealign."""
    import torch
    from lidar_odometry_tpu_torch.ops import bev_align
    two = "x2" in inspect.signature(bev_align.cross_power).parameters
    out = []
    for name, a in inp["k7c"].items():
        qf, fd, fdx = a["qf"], a["fd"], a["fdx"]
        cat = torch.cat([fd, fdx])
        twin = bev_align.cross_power_plain(cat, qf)
        if two:
            out.append((f"{name}, two tensors", lambda qf=qf, fd=fd, fdx=fdx:
                        bev_align.cross_power(fd, qf, fdx), twin))
        out.append((f"{name}, one tensor", lambda qf=qf, cat=cat:
                    bev_align.cross_power(cat, qf), twin))
    fa, fb = inp["prealign"]["fa"], inp["prealign"]["fb"]
    out.append(("prealign 128 x 128", lambda: bev_align.cross_power(fb, fa),
                bev_align.cross_power_plain(fb, fa)))
    return out


def k9b_call(a, l0):
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    return lambda: vm.map_bulk_merge(l0, a["s_key"], a["s_idx"], a["first"], a["counts"],
                                     a["centroids"], a["index"])


def timings(tag: str, card: str, inp) -> dict:
    """Every call against its twin, its device and as-issued times; the
    outputs of one call from the inputs kept for the comparison across
    trees."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import iris
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    keep = {}
    bits = lambda t: torch.view_as_real(t).view(torch.int32)
    for name, call, twin in k7c_calls(inp):
        out = call()
        err = float((out - twin).abs().max())
        same = torch.equal(bits(out), bits(twin))
        if err > 1e-6:
            raise SystemExit(f"K7c ({name}): {err} from the twin on the card")
        keep[f"K7c {name.split(',')[0]}"] = bits(out)
        print(f"  K7c ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device records "
              f"a call; bit-equal to the twin: {same} (max abs err {err:.3e})", flush=True)
    for name, a in inp["k7c"].items():
        call = lambda a=a: iris.phase_shifts(a["q"], a["cand"])
        keep[f"phase_shifts {name}"] = call()
        print(f"  phase_shifts ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the "
              f"device ({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device "
              f"records a call; shifts {keep[f'phase_shifts {name}'][:2].tolist()}...",
              flush=True)
    for name, a in inp["k9b"].items():
        l0k, l0p = a["l0"].clone(), a["l0"].clone()
        nk = k9b_call(a, l0k)()
        np_ = vm.map_bulk_merge_plain(l0p, a["s_key"], a["s_idx"], a["first"], a["counts"],
                                      a["centroids"], a["index"])
        same = torch.equal(l0k.view(torch.int32), l0p.view(torch.int32))
        err = float(((l0k - l0p).abs() / l0p.abs().clamp(min=1.0)).max())
        if not torch.equal(nk, np_) or err > 1e-5:
            raise SystemExit(f"K9b ({name}): counts {nk.tolist()} vs the twin's {np_.tolist()}, "
                             f"rows {err} relative")
        again = k9b_call(a, l0k)()
        if not torch.equal(again, nk):
            raise SystemExit(f"K9b ({name}): a second call counted {again.tolist()}, the first "
                             f"{nk.tolist()}")
        keep[f"K9b l0 {name}"], keep[f"K9b counts {name}"] = l0k.view(torch.int32), nk
        call = k9b_call(a, l0k)
        n_live = int((a["s_key"] != torch.iinfo(torch.int64).max).sum())
        print(f"  K9b ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device records "
              f"a call; M {a['s_key'].shape[0]}, {n_live} live records, placed/dropped "
              f"{nk.tolist()} (twin's equal, again equal); rows bit-equal to the twin: {same} "
              f"({err:.3e} relative)", flush=True)
    return keep


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    us_per_cycle = ps.sm_us_per_cycle()
    base = ROOT / "build" / "k7c_k9b_stamps" / tag
    if "// ---- loads" in (csrc / "bev_align.cu").read_text():
        lib, labels = ps.stamped(tree, base / "k7c", "bev_align", [
            ("bev_align.cu", r"^cross_power_kernel\(", "start", "end", ())], 0,
            "cross_power_kernel", ["cross_power"])
        for name, call, _ in k7c_calls(inp):
            run(lib, labels, call, f"K7c phase split ({tag}; {card}): {name}, thread 0 of "
                f"block (0, 0)", us_per_cycle)
    else:
        print(f"no stamps ({tag}): its K7c has no phase comments", flush=True)
    if "// ---- runs" in (csrc / "rehash.cu").read_text():
        lib, labels = ps.stamped(tree, base / "k9b", "rehash", [
            ("rehash.cu", r"^bulk_merge_kernel\(", "start", "end", ())], 0, "bulk_merge_kernel",
            ["map_bulk_merge"])
        for name, a in inp["k9b"].items():
            run(lib, labels, k9b_call(a, a["l0"].clone()), f"K9b phase split ({tag}; {card}): "
                f"{name}, thread 0 of block 0 (the first tile)", us_per_cycle)
    else:
        print(f"no stamps ({tag}): its K9b has no phase comments", flush=True)


def library_variant(dst: Path) -> None:
    """This checkout's package copied to dst/, K7c's hypot_exact and
    lo::fast_div replaced by hypotf and __fdiv_rn."""
    import shutil
    pkg = dst / "lidar_odometry_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(ROOT / "lidar_odometry_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = pkg / "csrc" / "bev_align.cu"
    src = cu.read_text()
    for a, b in (("fmaxf(hypot_exact(re[e], im[e]), 1e-12f)", "fmaxf(hypotf(re[e], im[e]), 1e-12f)"),
                 ("lo::fast_div(1.0f, mag[e])", "__fdiv_rn(1.0f, mag[e])"),
                 ("if (!(mag[e] < RCP_FAST))", "if (false)")):
        if src.count(a) != 1:
            raise SystemExit(f"{cu}: expected one `{a}`")
        src = src.replace(a, b)
    cu.write_text(src)
    print(f"K7c with the library's hypotf and __fdiv_rn: {pkg}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--library-variant"] and len(sys.argv) == 3:
        library_variant(Path(sys.argv[2]).resolve())
        raise SystemExit(0)
    ps.main(__doc__, "k7c_k9b", "K7c and K9b", ENTRIES, make_inputs, timings, stamps)
