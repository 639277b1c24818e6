"""Device times of K8a iris_image and K9a map_bulk_index, and K9a's phase split,
on the card, at the shapes the paths give them, from CUDA events and
clock64 stamps.

Inputs (made once on the card by --make-inputs with this checkout's
package and kept in --inputs, so that every tree of one call runs on the
same tensors):
  K8a  16 keyframe clouds of the loops path's world (chip_smoke.
       make_loop_scans': frames 0, 2, ..., 30 of its circuit scanned with
       its 10000 returns at 45 m, padded with masked rows to kitti.yaml's
       feature capacity of 16384): b = 16 (a drain batch) and the first
       alone (b = 1, the loops path's shape); and synthetic.iris_edge_clouds
       at b = 4 x 16384 (points on and beside the ring, height and yaw
       edges, NaN and +-inf);
  K9a  the surfel path's map (chip_smoke.C1 = 65536 parents, built by the
       first chunk of the bench's scans, as tools/k4b_k10d_phase_stamps.py
       builds it) moved by a correction of 0.3 degrees about z and 1.3 m:
       the distinct parents of its rehash as bulk_parents gives them to K9a
       (n = 65536); and the sharded path's per-shard shape, the records of
       shard 0 of 4 (sharded_map.sharded_transform_and_rehash's owner
       split) at its c1 of 16384.

Each call is held against the tree's plain twin on the card (K8a's
pixels and K9a's index, meta rows and count equal) and timed on the
device (CUDA events over 30 calls queued behind a ~25 ms spin,
chip_smoke.device_ms) and as issued (chip_smoke.time_ms), with the device
records (kernels, memcpy, memset) of one call; and the whole
transform_and_rehash of the surfel map: its device busy time (the sum of
one call's device records: queued behind the spin, a call never got
ahead of the card) and its time as issued. Every tree's outputs of
one call from the inputs (K8a's images, K9a's index, meta and count, the
rehashed state's fields) are kept in build/k8a_k9a_outputs_<tag>.pt;
where another tree's file is there, they are compared with its bit for
bit.

Then, unless --plain, a tree whose K9a carries phase comments ("//
---- name") has its bulk_index_kernel copied into
build/k8a_k9a_stamps/<tag>/ with a stamp (tools/phase_stamps.py) before
every phase comment, one at the start and one before the closing brace,
read from thread 0 of the cluster's rank 0; an older tree's one-block K9a
is timed only, and K8a (a thread a point, no phases) always.

    python tools/k8a_k9a_phase_stamps.py --make-inputs
    python tools/k8a_k9a_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of both
kernels are printed from the tree's build.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT
ENTRIES = (("iris", "iris_image_kernel"), ("rehash", "bulk_index_kernel"))
SHARDS = 4
VOXEL = 0.5


def correction():
    """The rehash's correction: 0.3 degrees about z and (1.3, -0.7, 0.2) m."""
    import torch
    a = math.radians(0.3)
    T = torch.eye(4)
    T[:2, :2] = torch.tensor([[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]])
    T[:3, 3] = torch.tensor([1.3, -0.7, 0.2])
    return T


def make_inputs(path: Path) -> None:
    """K8a's and K9a's inputs, made on the card with this checkout's
    package; saved to `path`."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(cs.LOOP_FRAMES, length=30.0, radius=10.0, step=0.6)
    rng = np.random.default_rng(9)
    clouds = np.zeros((16, 16384, 3), np.float32)
    masks = np.zeros((16, 16384), bool)
    for i, f in enumerate(range(0, 32, 2)):
        s = synthetic.sample_scan(world, poses[f], cs.LOOP_POINTS, rng, max_range=cs.LOOP_RANGE,
                                  noise=0.02)
        clouds[i, :len(s)] = s
        masks[i, :len(s)] = True
    edge, edge_m, _ = synthetic.iris_edge_clouds(4, 16384, seed=4)
    c16, m16 = torch.as_tensor(clouds, device="cuda"), torch.as_tensor(masks, device="cuda")
    k8a = {"b16": (c16, m16), "b1": (c16[:1].contiguous(), m16[:1].contiguous()),
           "edges b4": (torch.as_tensor(edge, device="cuda"),
                        torch.as_tensor(edge_m, device="cuda"))}

    cfg, consts, kw = cs.setup()
    scans, _ = cs.make_scans(cs.CHUNK)
    carry = fp.init_carry(0, cs.C1, device="cuda")
    carry, _ = fp.make_chunk_runner(cfg, consts, **kw)(
        carry, torch.as_tensor(scans, device="cuda"))
    state = carry.map_state
    T = correction().to("cuda")
    cen, cnt, live, cap, _ = vm.rehash_records(state, T)
    plan = vm.bulk_plan(cen, cnt, live, cap, cs.C1, voxel_size=VOXEL)
    k9a = {"surfel c1 65536": (vm.bulk_parents(plan.s_key, plan.first, cap, cs.C1,
                                               plan.fresh.n_buckets), cs.C1)}
    c1s = cs.C1 // SHARDS
    owner = so.shard_owner(cen.contiguous(), SHARDS, so.owner_inv(VOXEL, 3))
    mine = live & (owner == 0)
    plan = vm.bulk_plan(cen, cnt, mine, cap, c1s, voxel_size=VOXEL)
    k9a["sharded shard c1 16384"] = (vm.bulk_parents(plan.s_key, plan.first, cap, c1s,
                                                     plan.fresh.n_buckets), c1s)
    fields = {k: v.clone() if torch.is_tensor(v) else v for k, v in state._asdict().items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(k8a=k8a, k9a=k9a, state=fields, T=T), path)
    print(f"inputs: K8a {[tuple(c.shape) for c, _ in k8a.values()]}; K9a "
          + ", ".join(f"{name}: {int((a[0] < vm._n_buckets(n)).sum())} distinct parents"
                      for name, (a, n) in k9a.items())
          + f"; the surfel map's {int(state.n_l1)} parents; saved to {path}", flush=True)


def rehash_call(inp):
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    state = vm.VoxelMapState(**inp["state"])
    return lambda: vm.transform_and_rehash(state, inp["T"], voxel_size=VOXEL,
                                           planarity_threshold=0.1)


def timings(tag: str, card: str, inp) -> dict:
    """Every call against its twin, its device and as-issued times; the
    outputs of one call from the inputs kept for the comparison across
    trees."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import iris
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    keep = {}
    for name, (pts, m) in inp["k8a"].items():
        img = iris.iris_bits(pts, m)
        diff = int((img != iris._iris_bits_plain(pts, m)).sum())
        if diff:
            raise SystemExit(f"K8a ({name}): {diff} pixels differ from the twin's on the card")
        keep[f"K8a {name}"] = img
        call = lambda: iris.iris_bits(pts, m)
        print(f"  K8a ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device records "
              f"a call; {int((img > 0).sum())} occupied pixels, 0 differ from the twin's",
              flush=True)
    for name, (args, c1) in inp["k9a"].items():
        a, p = vm.empty_map(0, c1, device="cuda"), vm.empty_map(0, c1, device="cuda")
        na = vm.map_bulk_index(*args, a.l1_index, a.l1_meta, c1)
        npl = vm.map_bulk_index_plain(*args, p.l1_index, p.l1_meta, c1)
        if not (int(na) == int(npl) and torch.equal(a.l1_index, p.l1_index)
                and torch.equal(a.l1_meta, p.l1_meta)):
            raise SystemExit(f"K9a ({name}) differs from its twin")
        keep[f"K9a index {name}"], keep[f"K9a meta {name}"] = a.l1_index, a.l1_meta
        keep[f"K9a placed {name}"] = na
        call = lambda: vm.map_bulk_index(*args, a.l1_index, a.l1_meta, c1)
        print(f"  K9a ({tag}; {card}): {name}: {cs.device_ms(call, 30):.4f} ms on the device "
              f"({cs.time_ms(call, 30):.4f} as issued), {ps.device_records(call)} device records "
              f"a call; {int(na)} placed, index and meta equal to the twin's", flush=True)
    call = rehash_call(inp)
    out = call()
    for k, v in out._asdict().items():   # float fields by their bits (NaN equal to NaN)
        keep[f"rehash {k}"] = v.view(torch.int32) if v.dtype == torch.float32 else v
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy, recs = cs.device_busy_us(prof)
    print(f"  transform_and_rehash ({tag}; {card}): the surfel map, c1 "
          f"{inp['state']['l1_meta'].shape[0] - 1}: device busy {busy / 1e3:.4f} ms over {recs} "
          f"records a call, {cs.time_ms(call, 10):.4f} ms as issued; {int(out.n_l1)} parents, "
          f"{int(out.n_l0)} children", flush=True)
    return keep


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    if "// ---- walk" not in (csrc / "rehash.cu").read_text():
        print(f"no stamps ({tag}): its K9a has no phase comments", flush=True)
        return
    us_per_cycle = ps.sm_us_per_cycle()
    base = ROOT / "build" / "k8a_k9a_stamps" / tag
    lib, labels = ps.stamped(tree, base / "k9a", "rehash", [
        ("rehash.cu", r"^bulk_index_kernel\(", "start", "end", ())], 0, "bulk_index_kernel",
        ["map_bulk_index"])
    for name, (args, c1) in inp["k9a"].items():
        a = vm.empty_map(0, c1, device="cuda")
        call = lambda: vm.map_bulk_index(*args, a.l1_index, a.l1_meta, c1)
        ms = cs.device_ms(call, 30)
        ps.clear(lib)
        call()
        torch.cuda.synchronize()
        phases, total, n_st = ps.split(lib, labels)
        print(f"K9a phase split ({tag}; {card}): {name}, thread 0 of the cluster's rank 0: "
              f"{total} cycles from its first stamp to its last ({total * us_per_cycle:.2f} us), "
              f"{n_st} stamps; {ms:.4f} ms a launch on the device (stamped)", flush=True)
        ps.report(phases, total, us_per_cycle)


if __name__ == "__main__":
    ps.main(__doc__, "k8a_k9a", "K8a and K9a", ENTRIES, make_inputs, timings, stamps)
