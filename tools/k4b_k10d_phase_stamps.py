"""Device times and phase split of K4b map_scatter_add and K10d
pgo_backsub_retract on the card, at the shapes the paths give them, from
CUDA events and clock64 stamps.

Inputs (made once on the card by --make-inputs with this checkout's
package and kept in --inputs, so that every tree of one call runs on the
same tensors):
  K4b   the surfel path's shape (chip_smoke.check_kernels' K4b block): the
        map of 65536 parents built by the first chunk of the bench's
        scans, frame 20's 14336 features moved by the chunk's last pose
        and velocity, their key sort, run starts and validity, and by
        point the parent slot (where the parent is in the map), its
        placement and the child offset;
  K10d  the PGO path's KITTI-00-sized graph (chip_smoke.make_pgo_graph,
        n_pad 4096): the first GN iteration's xs, F, G and g from the plain
        twins; and synthetic.backsub_system at n_pad 8192 (past one
        cluster of 16 x 256 threads), 60 partitions.

Each call is held against the plain twin (K4b's rows within 1e-6, the
sink row zero; K10d's poses within 1e-9) and timed on the device (CUDA
events over 30 calls queued behind a ~25 ms spin, chip_smoke.device_ms)
and as issued (chip_smoke.time_ms): K4b alone (an older tree's kernel
with its targets given), and the map update's step as the tree issues
it (an older tree: the torch ops of the targets, then its K4b), with
the device records (kernels, memcpy, memset) of one step; K10d at both
sizes, with the device records of one call, with tol 0 and an unbounded
max_iters on a scratch copy, so that every call runs; and the PGO path's
GN iterations on the device (gn_iterations on chip_smoke.make_pgo_graph's
graph, the median of 5 solves, each behind the spin). Every tree's
outputs of one call from the inputs (K4b's l0, K10d's poses and loop
state, the PGO path's poses) are kept in build/k4b_k10d_outputs_<tag>.pt; where another tree's
file is there, they are compared with its bit for bit.

Then, unless --plain, K4b's scatter_add_kernel (stamped by thread 0 of
block 0, the leader of the first run) and K10d's backsub_kernel (by
thread 0 of every block; the tree's tail block is read: the new kernel's
rank 0, an older tree's last block to take a ticket) are copied into
build/k4b_k10d_stamps/<tag>/ with a stamp (tools/phase_stamps.py) before
every phase comment ("// ---- name"), or at the statements of an older
tree's kernels (K4B_ANCHORS, K10D_ANCHORS), one at the start and one
before the closing brace.

    python tools/k4b_k10d_phase_stamps.py --make-inputs
    python tools/k4b_k10d_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

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
ENTRIES = (("voxel_map", "scatter_add_kernel"), ("pgo", "backsub_kernel"))
BIG_N_PAD = 8192

# an older tree's kernels, at their statements (regex, label), in order
K4B_ANCHORS = (
    (r"if \(i >= p \|\| !firstk\[i\]\) return;", "firstk"),
    (r"const long long t = tgt\[i\];", "the target"),
    (r"float c = 0.f, x = 0.f, y = 0.f, z = 0.f;", "the run, walked in global memory"),
    (r"float4 r = l0\[t\];", "the row's read-modify-write"),
)
K10D_ANCHORS = (
    (r"^\s*double ss = 0.0, bad = 0.0;", "dx: the rows of F and G, xs"),
    (r"for \(int o = 16; o > 0; o >>= 1\)", "block sums"),
    (r"^\s*__threadfence\(\);", "threadfence and ticket"),
    (r"^\s*if \(!last\) return;", "the last block: partials in block order"),
    (r"^\s*if \(!ok_s\) return;", "retract: every pose by one block"),
)


def make_inputs(path: Path) -> None:
    """K4b's and K10d's inputs, made on the card with this checkout's
    package; saved to `path`."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf, voxel_map as vm
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    from lidar_odometry_tpu_torch.utils import keys as K, lie
    cfg, consts, kw = cs.setup()
    scans, _ = cs.make_scans(cs.CHUNK + 1)
    carry = fp.init_carry(0, cs.C1, device="cuda")
    carry, _ = fp.make_chunk_runner(cfg, consts, **kw)(
        carry, torch.as_tensor(scans[:cs.CHUNK], device="cuda"))
    state = carry.map_state
    raw = torch.as_tensor(scans[cs.CHUNK], device="cuda")
    feat, mask, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=0.5, stride=1,
                                    out_capacity=cs.SCAN_CAP, compact_keys=True)
    T = (carry.T_prev @ carry.velocity).reshape(4, 4)
    world = lie.transform_points(T, feat).contiguous()
    pc = K.voxel_coords(world, K.f32(1.0 / 0.5))
    slot, hit, _, _ = vm.bucket_find(state.l1_index,
                                     *K.pack_key(torch.div(pc, 3, rounding_mode="floor")))
    kkey = torch.where(mask, K.sort_key(*K.pack_key(pc)), K.INVALID_SORT_KEY)
    s_key, s_idx = torch.sort(kkey, stable=True)
    firstk = torch.ones_like(mask)
    firstk[1:] = s_key[1:] != s_key[:-1]
    k4b = dict(l0=state.l0_data.clone(), pts=world, s_idx=s_idx, firstk=firstk,
               valid_s=mask[s_idx], placed=hit & mask, pslot=slot.contiguous(),
               ch_off=vm._child_offset_of(pc))
    init, priors, betweens, _ = cs.make_pgo_graph()
    g = dpgo.upload(dpgo.pack_graph(init, priors, betweens), "cuda")
    poses = g["poses"]
    lin = dpgo.linearize_plain(poses, *[g[k] for k in dpgo.LIN_KEYS])
    el = dpgo.eliminate_plain(*lin[:3], *[g[k] for k in dpgo.PLAN_KEYS])
    xs = dpgo.reduced_solve_plain(*lin, *el[:2], *[g[k] for k in dpgo.RED_KEYS])[0]
    keys = ("real_mask", "pose_row", "st", *dpgo.BACK_KEYS)
    k10d = {4096: dict(g={k: g[k].clone() for k in keys}, poses=poses.clone(), xs=xs,
                       F=el[2], G=el[3], gv=el[4])}
    a, _ = synthetic.backsub_system(BIG_N_PAD, 60, seed=BIG_N_PAD, zero_rows=100)
    big = {k: torch.as_tensor(a[k], device="cuda") for k in a}
    big_g = {k: big[k] for k in ("real_mask", "pose_row", *dpgo.BACK_KEYS)}
    big_g["st"] = torch.tensor([0.0, float("inf"), 1.0, 1.0], dtype=torch.float64,
                               device="cuda")
    k10d[BIG_N_PAD] = dict(g=big_g, poses=big["poses"], xs=big["xs"], F=big["F"],
                           G=big["G"], gv=big["g"])
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(k4b=k4b, k10d=k10d), path)
    print(f"inputs: K4b p {world.shape[0]} ({int(mask.sum())} valid, {int(firstk.sum())} "
          f"runs, {int((firstk & (hit & mask)[s_idx]).sum())} placed leaders), K10d n_pad "
          f"{poses.shape[0]} and {BIG_N_PAD}; saved to {path}", flush=True)


def k4b_calls(inp):
    """(K4b alone, the map update's step as the tree issues it, twin, l0)."""
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    d = inp["k4b"]
    l0 = d["l0"].clone()
    pts, s_idx, firstk, valid_s = d["pts"], d["s_idx"], d["firstk"], d["valid_s"]
    placed, pslot, ch_off = d["placed"], d["pslot"], d["ch_off"]
    nrows = l0.shape[0] - 1

    def targets():
        import torch
        return torch.where(firstk & placed[s_idx], pslot[s_idx] * 27 + ch_off[s_idx], nrows)

    if "placed" in vm.map_scatter_add.__code__.co_varnames:
        def alone(o=l0):
            return vm.map_scatter_add(o, pts, s_idx, firstk, valid_s, placed, pslot, ch_off)
        step = alone

        def twin(o):
            return vm.map_scatter_add_plain(o, pts, s_idx, firstk, valid_s, placed, pslot,
                                            ch_off)
    else:
        tgt = targets()

        def alone(o=l0):
            return vm.map_scatter_add(o, pts, s_idx, firstk, valid_s, tgt)

        def step(o=l0):
            return vm.map_scatter_add(o, pts, s_idx, firstk, valid_s, targets())

        def twin(o):
            return vm.map_scatter_add_plain(o, pts, s_idx, firstk, valid_s, targets())
    return alone, step, twin, l0


def k10d_call(inp, n_pad: int, timed: bool):
    """(call, twin, poses, g) of K10d at n_pad; `timed`: tol 0 and an
    unbounded max_iters, so that every call runs."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    d = inp["k10d"][n_pad]
    g = {k: v.clone() for k, v in d["g"].items()}
    poses = d["poses"].clone()
    args = (d["xs"], d["F"], d["G"], d["gv"])
    iters, tol = (1 << 30, 0.0) if timed else (10, 1e-6)

    def call():
        return dpgo.backsub_retract(g, poses, *args, iters, tol)

    def twin():
        return dpgo.backsub_retract_plain(d["poses"], *args, *[g[k] for k in dpgo.BACK_KEYS],
                                          g["real_mask"])
    return call, twin, poses, g


def timings(tag: str, card: str, inp) -> dict:
    """Every call against its twin, its device and as-issued times; the
    outputs of one call from the inputs kept for the comparison across
    trees."""
    import torch
    import chip_smoke as cs
    keep = {}
    alone, step, twin, l0 = k4b_calls(inp)
    nrows = l0.shape[0] - 1
    ref = twin(inp["k4b"]["l0"].clone())
    out = inp["k4b"]["l0"].clone()
    step(out)
    err = float((out[:nrows] - ref[:nrows]).abs().max())
    if not (err <= 1e-6 and bool((out[nrows] == 0.0).all())):
        raise SystemExit(f"K4b differs from its twin: {err:.3e}")
    keep["K4b l0"] = out
    print(f"  K4b ({tag}; {card}): p {inp['k4b']['pts'].shape[0]}: alone "
          f"{cs.device_ms(alone, 30):.4f} ms on the device ({cs.time_ms(alone, 30):.4f} as "
          f"issued); the step as issued {cs.device_ms(step, 30):.4f} "
          f"({cs.time_ms(step, 30):.4f}), {ps.device_records(step)} device records a step; "
          f"{err:.1e} from the twin", flush=True)
    for n_pad in sorted(inp["k10d"]):
        call, tw, poses, g = k10d_call(inp, n_pad, timed=False)
        p_p, dxn, ok = tw()
        call()
        perr = float((poses - p_p).abs().max())
        if not (bool(ok) and perr <= 1e-9):
            raise SystemExit(f"K10d differs from its twin at n_pad {n_pad}: {perr:.3e}")
        keep[f"K10d poses {n_pad}"] = poses.clone()
        keep[f"K10d st {n_pad}"] = g["st"].clone()
        call, _, _, _ = k10d_call(inp, n_pad, timed=True)
        print(f"  K10d ({tag}; {card}): n_pad {n_pad}: {cs.device_ms(call, 30):.4f} ms on "
              f"the device ({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} "
              f"device records a call; poses {perr:.1e} from the twin, |dx| "
              f"{float(g['st'][1]):.6e}", flush=True)
    keep["PGO path poses"] = ps.pgo_path(tag, card)
    return keep


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    import torch
    import chip_smoke as cs
    us_per_cycle = ps.sm_us_per_cycle()
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    base = ROOT / "build" / "k4b_k10d_stamps" / tag
    new4 = "// ---- fold" in (csrc / "voxel_map.cu").read_text()
    lib, labels = ps.stamped(tree, base / "k4b", "voxel_map", [
        ("voxel_map.cu", r"^scatter_add_kernel\(", "start", "end",
         () if new4 else K4B_ANCHORS)], 0, "scatter_add_kernel", ["map_scatter_add"])
    alone, _, _, _ = k4b_calls(inp)
    ms = cs.device_ms(alone, 30)
    ps.clear(lib)
    alone(inp["k4b"]["l0"].clone())
    torch.cuda.synchronize()
    phases, total, n_st = ps.split(lib, labels)
    print(f"K4b phase split ({tag}; {card}): the first run's leader (thread 0 of block 0): "
          f"{total} cycles from its first stamp to its last ({total * us_per_cycle:.2f} us at "
          f"{1 / us_per_cycle:.0f} cycles a us), {n_st} stamps; {ms:.4f} ms a launch on the "
          f"device (stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)

    new10 = "// ---- cluster" in (csrc / "pgo.cu").read_text()
    lib, labels = ps.stamped(tree, base / "k10d", "pgo", [
        ("pgo.cu", r"^backsub_kernel\(", "start", "end", () if new10 else K10D_ANCHORS)],
        -1, "backsub_kernel", ["pgo_backsub_retract"])
    call, _, _, _ = k10d_call(inp, 4096, timed=True)
    ms = cs.device_ms(call, 30)
    ps.clear(lib)
    call()
    torch.cuda.synchronize()
    blocks = ps.split(lib, labels, every=True)
    b = 0    # the cluster's rank 0; in the older kernel, the block that retracts
    if not new10:
        tail = [k for k, (ph, _, _) in blocks.items() if "retract: every pose by one block" in ph]
        if len(tail) != 1:
            raise SystemExit(f"expected one block to run the retraction, found {tail}")
        b = tail[0]
    phases, total, n_st = blocks[b]
    print(f"K10d phase split ({tag}; {card}): n_pad 4096, {len(blocks)} blocks stamped, block "
          f"{b} read: {total} cycles from its first stamp to its last "
          f"({total * us_per_cycle:.2f} us), {n_st} stamps; {ms:.4f} ms a launch on the device "
          f"(stamped)", flush=True)
    ps.report(phases, total, us_per_cycle)


if __name__ == "__main__":
    ps.main(__doc__, "k4b_k10d", "K4b and K10d", ENTRIES, make_inputs, timings, stamps)
