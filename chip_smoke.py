#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile [DIR]
        # also a torch.profiler window over one chunk of each path; the
        # tables and Chrome traces go to DIR (default build/profile)

Phases, each of which exits nonzero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel source of lidar_odometry_tpu_torch/csrc with nvcc
     (sm_90a, one process per source, in parallel) into build/kernels/;
  3. every kernel against its plain PyTorch twin on the card, at its path's
     shapes, with max abs error against a stated tolerance, kernel and plain
     times by CUDA events (as launched, and on the device with the host's
     launch cost taken out), the time of one PyTorch library call that
     computes the same function where there is one (the same two ways),
     and the least time the
     card could take (bytes over 3.35 TB/s or fp32 operations over
     67 TFLOP/s, whichever is larger):
       - the surfel-path kernels (K1-K4c; K3 with the k-means and EM
         rounds of its input's plain fit) at the JAX bench's shapes
         (131072-point synthetic KITTI-like scans strided by 8, scan
         capacity 14336, a map of 65536 parents built by the port's own
         first keyframes); K1 also on voxel runs that cross its 512-entry
         tiles, one run longer than a tile, at two caps, against the twin
         on the card and on the CPU, two calls bit-equal; K4c also at the
         rehash's shape (every one of the 65536 slots), its live-child
         masks equal to the twin's and no non-planar verdict different
         outside a 1e-5 band around the threshold at either shape; K4b
         with its targets computed in the kernel, timed beside the torch
         ops that computed them before;
       - the KD-tree kernels (K5a grid_knn, K5b plane_fit_5nn) at the mid360
         shapes (scan capacity 16384, 0.4 m voxels, radius 2, a map of 65536
         parents built without surfels by the mid360 path's first keyframes);
         K5a also at radius 1, with the row mask in the kernel (timed beside
         K5a then torch's &) and on a tail warp, all exactly, and the
         KD-tree correspondences with one K5a launch and no torch & of the
         mask;
       - the loop-closure kernels at kitti.yaml's shapes (keyframes of the
         loops path's circuit scanned densely enough to fill the scan
         capacity of 16384 features, so a loop query of 8192 valid rows
         against a 16384-row keyframe; a 16-keyframe Iris batch, 32
         candidates, the rehash of a 65536-parent map): K6a point_grid (the
         coarse 2 m table and the fine 0.5 m one, grid and meta equal to
         the twin's, one launch a call and no torch fill beside it), K6b
         point_knn (k = 5) and point_nn1 (k = 1) at the coarse shape (2 m
         bins, r = 1, W = 8), point_knn also at the polish width (W = 4) on
         that table and on the 0.5 m table (which does not fit the dense
         window: the binary-search path) and at r = 2, W = 16 on the
         0.5 m table, neighbours and flags equal to the twin's in every
         slot, distances within 1e-5; K5b also at the loop shape (K6b's
         coarse k = 5 output, 8192 rows, ungated), K7 bev_raster (the
         prealign's complex64 images, every cell bit-equal to the twin's,
         one device record a call where the parent's raster and its casts
         were four, one cluster of 16 x 512 as built and as traced; the
         device records and time of a whole bev_translation_offset, the
         loop query's prealigned T_init), K7c
         cross_power (the Iris query's forward and flipped spectra as two
         tensors at 32 candidates and the loops path's K = 1, 2 and 4, and
         the prealign's; bit-equal to the twin; a phase_shifts call
         launches it once and concatenates nothing),
         K8a iris_image (also at b = 1), K8g gabor_product (also at b = 1),
         K8b iris_encode (also at b = 1, and at b = 3 on responses whose
         squared magnitudes sit on and beside its threshold, every word
         equal to the CPU twin's), K8c iris_hamming (32 candidates and the
         loops path's K = 1 and 4, distances and biases bit-equal to the
         twin's, a cluster a candidate), K9a map_bulk_index
         (also at the sharded path's per-shard c1 of 16384), K9b
         map_bulk_merge (also at the sharded path's per-shard shape, M = 4
         x 16384 x 27 records; rows and counts bit-equal to the twin's, one
         device record a call: no zero fill), and K2b with the loop's
         weight residual;
       - the pose-graph kernels (K10a pgo_linearize, K10b pgo_eliminate,
         K10c pgo_reduced_solve, K10d pgo_backsub_retract) on a
         KITTI-00-sized graph (3700 keyframes padded to 4096, 32 loop
         edges: make_pgo_graph), each fed the first GN iteration's inputs
         of its twin: at most 1e-10 of each output's largest magnitude,
         1e-9 on the retracted poses, and for K10c's solve of a system of
         kappa ~5e9 its normwise backward error at most 1e-13, two calls
         bit-equal, and the same on a synthetic D = 200 separator system;
         its cluster size and panel width are printed; K10a also two calls
         bit-equal and at n_pad 8192 (a revisit graph of 7400 keyframes);
         K10d also at n_pad 8192 (past its one cluster:
         synthetic.backsub_system), its cluster size printed; K10b also two
         calls bit-equal, its longest partition longer than its staging
         ring, and an input that is not positive definite ending in NaN
         and ok false (check_eliminate_edges); their bounds count
         f64 operations at 67 TFLOP/s (the host solvers' K12a and K12b, on
         the same graph, are held in phase 7b);
       - the sharded map's kernels (K11a shard_own, K11b
         shard_alpha_normal_eq, K11c shard_sample, K11d shard_gn_select)
         at kitti.yaml's width (16384 features of a dense loop frame, 101
         alphas, a map of 65536 parents built by the sharded update from
         the earlier dense frames) at 1, 2, 4 and 8 shards: K11a and K11c
         exactly (K11c alone and inside K11b's launch, K11b's part of that
         launch bit-equal to K11b alone, both timed at every S), K11b within
         1e-5 of its largest entry, K11d the same
         alpha and T within 1e-6, each shard of a launch bit-equal to a
         one-shard launch, and K2a's one launch over every shard (and over
         2 lanes x 4 shards) bit-equal to its per-instance launches; times
         at 4 shards, K11a's device times at every S and at the step
         path's 2 lanes x 4 shards (with and without the lanes' poses);
  4. the surfel path: make_chunk_runner over chunks of 20 frames, run
     twice from an empty map: eagerly (graph=False) and as captured CUDA
     graphs (the default: a warm-up chunk, a capture, replays); the
     captured run must be bit-equal to the eager one (poses, is_kf,
     n_corr and every carry tensor, the map's ten included) and launch
     every kernel as often; scans/s after the first chunk, ATE against the
     synthetic ground truth (must stay below 0.5 m), keyframes, map size;
     the device ms of one map update at these shapes for a keyframe (with
     and without the eviction scan) and for a non-keyframe's predicated
     update; then one more chunk each way: wall, device busy ms and busy
     share (torch.profiler), host kernel and graph launches, host syncs
     (none allowed in a captured chunk) and each graph's nodes
     (libcuda's cuGraphGetNodes);
  5. the mid360 path: config/mid360.yaml (loop closure off, chunks of 20)
     through the PLY player over indoor-corridor ring scans written as PLY
     files: process_chunk with its sampled per-frame first frame, then the
     per-frame tail; player scans/s, ATE (below 0.5 m), keyframes, map size;
  6. the loops path: config/kitti.yaml (loop closure and PGO on, the
     "manual" backend, prealign on, keyframe capacity 4096) through
     Estimator(sync_loop=True).process_chunk in chunks of 20 and
     finalize_loops, over a synthetic circuit that revisits its start; it
     must accept a loop, rehash the map, log no loop error and end with ATE
     below 0.5 m; then the same scans with pgo_backend "distributed" (the
     same loops and rehashes, no loop error, ATE within 1 mm of the manual
     run's; pgo_solve ms of both), then loops off, for scans/s and ATE;
  6c. checkpoint and viewer: the loops path's run again in a fresh
     Estimator, saved (checkpoint.save) at the chunk boundary before the
     last one before the frame whose keyframe closes the loops path's loop
     (the restored run's second chunk, a captured one, closes it), restored
     (checkpoint.restore) into a fresh Estimator on the card and run to the
     end with finalize_loops: it must accept the same loop and rehash, and
     stay within 1e-3 m of the loops path's manual run on every frame; the
     largest gap, the save and restore ms and the archive's MB are
     printed; then LiveViewer.update on the restored estimator (state.json
     fetched over 127.0.0.1, its n_map equal to map_points()'s length),
     export_state into build/viewer_smoke/ and save_map_to_ply (a snapshot
     PNG only where matplotlib is installed); its launches are the path
     "checkpoint";
  6b. the KITTI player: the loops path's 220 scans (NaN rows dropped, a
     zero intensity column) written as sequences/00/velodyne/%06d.bin
     with a camera-frame 00.txt under build/kitti_smoke/, through
     KittiPlayer (config/kitti.yaml, sync_loop) in chunks of 20: all 220
     frames, none failed, finite poses, ATE below 0.5 m and within 0.02 m
     of the loops path's, a KITTI trajectory of 220 rows of 12 values, a
     statistics file, and the native loader in use (the numpy path fails
     the phase); then its first 40 frames frame by frame through the
     native Prefetcher, none failed; each run's launches are counted on
     their own, as the paths "kitti" (the loops path's kernels) and
     "kitti_frames" (the front door's: its 40 frames reach no loop query);
  7. the PGO path: gn_optimize_device on the KITTI-00-sized graph: it must
     converge, come within 1e-6 of the manual backend and 1e-9 of the plain
     twins, give bit-equal poses in two calls and sync the host at most
     once a call; device ms of the GN iterations beside the manual
     backend's host ms;
  7b. the Schur path, the distributed backend's host solvers on the same
     graph over a one-rank NCCL process group: K12a pgo_block_thomas and
     K12b pgo_eliminate_lu against their plain twins on the first GN
     iteration's system (K12a on its block-tridiagonal part in float64 and
     float32, beside torch.linalg.solve of the dense 22200 x 22200 matrix;
     K12b on D = 72 partitions of max_m = 211 rows, in float64 and
     float32; for both ptxas's stack of each instantiation, 0 bytes, and
     one launch a call, with K12a's cluster, partitions and dependent
     depth in rows, and K12b's); then
     block_tridiag_solve, schur_partitioned_solve (normwise backward error
     at most N eps, kappa_1 beside it), the host Gauss-Newton iteration
     _optimize_distributed_host (converged, within 1e-6 of the manual
     backend and of gn_optimize_device; its wall ms beside theirs) and the
     solve over a ShardGroup of 4 shards (bit-equal to no group);
  8. the blocked path: make_blocked_runner, B = 4 lanes over one shared
     map of 4 x 65536 parents at the JAX bench's blocked operating point
     (bench.py:153-200: lane b the bench's world and drive with seed
     11 + b, 131072-point scans strided by 8, scan capacity 14336), a boot
     chunk of 20 frames at block=1, then two chunks of 20 at block=4, 60
     frames a lane, eagerly and captured (the block=4 chunks), the
     captured run bit-equal to the eager one with equal launches;
     aggregate scans/s after the boot chunk beside the surfel path's, ATE
     per lane (each below 0.5 m), keyframes per lane (lane 0 within 1 of
     the surfel path's over the same 60 frames), map size, and one more
     block=4 chunk each way as in phase 4 (no host sync in a captured
     one);
  9. the sharded path and the data x map step, over the one-rank NCCL
     process group with 4 shards on the card: config/kitti.yaml with the
     distributed pose graph through Estimator(sync_loop=True,
     map_backend=ShardedMapBackend).process_frame over the loops path's
     220 scans (it must accept a loop, rehash the sharded map, log no loop
     error, end below 0.5 m ATE and within 0.02 m of the loops path's
     distributed run, launch K11a, K11b and K11d and no K5a, and run
     K11c inside K11b's launch once an ICP iteration, never alone); then
     multichip_odometry_step at 2 lanes x 4 shards over the blocked path's
     first two lanes, 60 frames (each lane below 0.5 m ATE);
 10. one JSON line of kernels, then the card line, then the result line.
Phase 3 also holds K1, K2a, K3 and K2b at B = 4 (the first frame of each
lane after a boot chunk) against their plain versions, and each lane
bit for bit against a one-lane launch on its inputs. K2b (B = 1, B = 4,
the weight residual) and K11b (at each S) are also held to two calls
bit-equal; for both, the cluster size they launch with, and for them,
K4c, K11a, K5b, K6b, K5a, K11c (K11b's kernel), K4b, K10d, K8a and K9a
ptxas's stack frame of every instantiation (0 bytes, else the run fails;
K10d's 40 bytes are the double sin and cos's slow path) and one launch a
call with no torch op that launches device work beside it (no zero fill
but K8a's, read from torch.profiler's op events) are printed and kept in
the kernels line (with K10d's and K9a's cluster shapes, as their sources
build the launch and as the profiler traced its grid and block), with K11b's and
K11c's device and as-issued times at every S (K11b alone and with the
sample), K6b's at each of its shapes, K5b's at the loop shape, K5a's at
r = 1 and with the row mask, K8a's at b = 1 and K9a's at the sharded
path's per-shard c1.
The Estimator's chunks (phases 5, 6, 6c and 6b's chunked run) run as
captured CUDA graphs: each of those runs must have replayed one. A
replay adds its graph's captured launches to the counts, so they count
kernel executions either way.
Each path is run with every kernel's launch count set to 0 just before it
and read just after: the surfel path must launch its seven kernels, the
mid360 path K1, K3, K2b, K4a, K4b, K5a and K5b, and never K2a or K4c, the
loops path the surfel path's kernels, K5b and every loop-closure kernel
(and with the distributed backend K10a-K10d too, which the manual run must
not launch), the checkpoint path (its run before the save and after the
restore, and the viewer) and the KITTI path (both of its runs) the manual
loops path's kernels, the PGO path K10a-K10d, the Schur path K12a and K12b and no
K10 kernel, the blocked path the surfel path's
kernels (K4b once a block) and no KD-tree or loop kernel, the sharded path
the loops path's kernels, K10a-d and K11a, K11b, K11d, the step path
K11a, K11b, K11d, K1, K2a and K4a-c; on both, K2a once an ICP iteration (as
many launches as K11d's), one launch for every lane and shard, and K11c's
sample inside K11b's launch once an ICP iteration and never launched alone
(its runs there are counted in its `fused` count, and the kernels line
adds them to its launches: fused_launches_by_path). `--profile` also profiles
20 frames of the sharded path and of the step path, and a 40-frame run of
the KITTI player; a window's device busy
time is the sum of its device activity records (kernels, memcpy, memset),
each counted once (the first window also prints the op table's sum, which
counts an op's kernels twice). Lanes 1-3's scans
are made in spawned worker processes while the parent makes the other
scans.

It imports nothing of JAX. It needs torch with CUDA and a CUDA toolkit.
"""
import functools
import json
import multiprocessing
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RAW_N = 131072
STRIDE = 8
N_FRAMES = 120
CHUNK = 20
C1 = 65536
DEVICE = "cuda"
PROFILE = "--profile" in sys.argv[1:]
PROFILE_DIR = Path(sys.argv[sys.argv.index("--profile") + 1]
                   if PROFILE and sys.argv[-1] != "--profile" else "build/profile")
SCAN_CAP = 14336
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 67e12   # the H100 SXM's FP64 tensor-core peak
# the mid360 path: config/mid360.yaml over indoor-corridor ring scans
MID_FRAMES = 66          # three chunks of 20 and a per-frame tail of 6
MID_CHUNK = 20
MID_RAW = 32768          # raw pad of one ring scan (40 x 720 rays)
SURFEL_KERNELS = ("voxel_filter", "icp_correspond", "icp_normal_eq", "pko_alpha",
                  "map_evict_scan", "map_scatter_add", "map_surfel_recompute")
MID_KERNELS = ("voxel_filter", "pko_alpha", "icp_normal_eq", "map_evict_scan",
               "map_scatter_add", "grid_knn", "plane_fit_5nn")
MID_NEVER = ("icp_correspond", "map_surfel_recompute")
# the loops path: config/kitti.yaml over a circuit that revisits its start,
# the JAX loop test's circuit (tests/test_loop_closure.py) with denser
# scans: 10000 returns at 45 m range. With 16384 returns both the JAX
# estimator and the port lose track at the circuit's first corner (frame
# 52; per-frame ATE 1.26 m and 5.29 m on the CPU, where 10000 returns give
# 0.023 m on both: tools/loop_scan_density.py), so the path's scans stop
# short of the scan capacity; every table keeps the kitti.yaml width, and
# phase 3 holds the loop kernels at that width on densely scanned frames.
LOOP_FRAMES = 220
LOOP_CHUNK = 20
LOOP_POINTS = 10000
LOOP_RANGE = 45.0
LOOP_REVISIT = 205        # the frame one lap after frame 0
# (K, valid) of the loops path's Iris comparisons: it queries 1, 2 and 3
# candidates, padded to a power of two
LOOP_CANDIDATES = ((1, 1), (4, 3))
# K of the loops path's Iris queries, each a K7c launch over 2K spectra
K7C_CANDIDATES = (1, 2, 4)
DENSE_POINTS = 65536      # returns whose 0.5 m features fill a scan capacity of 16384
DENSE_FRAMES = tuple(range(0, 32, 2)) + (LOOP_REVISIT,)
LOOP_KERNELS = ("point_grid", "point_knn", "point_nn1", "bev_raster", "cross_power",
                "iris_image", "gabor_product", "iris_encode", "iris_hamming", "map_bulk_index",
                "map_bulk_merge")
LOOPS_PATH_KERNELS = SURFEL_KERNELS + ("plane_fit_5nn",) + LOOP_KERNELS
KITTI_PER_FRAME = 40      # frames of the KITTI player's per-frame run
# the blocked path: B lanes over one shared map, the JAX bench's blocked
# mode (bench.py:153-200) cut to 60 frames a lane; lane 0's scans are the
# surfel path's first 60
LANES = 4
LANE_FRAMES = 60
LANE_CHUNK = 20
LANE_BLOCK = 4
LANE_KERNELS = ("voxel_filter", "icp_correspond", "pko_alpha", "icp_normal_eq")
BLOCKED_NEVER = ("grid_knn", "plane_fit_5nn") + LOOP_KERNELS
# the distributed pose-graph backend: K10a-K10d, in the loops path's second
# run and on a KITTI-00-sized graph (3700 keyframes, ~3.7 km at kitti.yaml's
# 1 m keyframe distance, padded to its keyframe capacity of 4096; 32 loop
# edges, each joining a keyframe to its revisit one or more laps later)
PGO_KERNELS = ("pgo_linearize", "pgo_eliminate", "pgo_reduced_solve", "pgo_backsub_retract")
PGO_N = 3700
PGO_LOOPS = 32
PGO_SEED = 0
# K10a's stack: se3_log's double acos, sin and tan keep their slow-path
# argument reduction in local memory
LINEARIZE_STACK = 40
LINEARIZE_STACK_NOTE = ("a half-warp a pose, then a half-warp a loop edge; its 40-byte stack "
                        "is the double acos, sin and tan's slow-path argument reduction in "
                        "se3_log")
# the host solvers (K12a, K12b) on the same graph: phase 7b
SCHUR_KERNELS = ("pgo_block_thomas", "pgo_eliminate_lu")
# the sharded map: K11a-d checked at these shard counts (the committed
# draws'), the sharded path and the data x map step at SHARDS shards on
# this card's one rank; the step over the blocked path's first STEP_LANES
# lanes
SHARD_CHECK = (1, 2, 4, 8)
SHARDS = 4
STEP_LANES = 2
SHARD_KERNELS = ("shard_own", "shard_alpha_normal_eq", "shard_sample", "shard_gn_select")
# launched by the sharded ICP (K11c runs inside K11b's launch: check_sample_in_k11b)
SHARD_PATH_KERNELS = ("shard_own", "shard_alpha_normal_eq", "shard_gn_select")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 30) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 30):
    """A kernel's device time per call, with the host's launch cost taken
    out: the card first spins (~25 ms) while the host enqueues all the
    calls, so they run back to back. None when the host did not get ahead
    (a wrapper that synchronises)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if ahead else None


def fmt_ms(ms) -> str:
    """A device time from device_ms for a line of text ("not measured"
    where the host did not get ahead)."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_ms_once(fn):
    """The device time of one call of fn, the host's launch cost taken out
    as in device_ms; None when the host did not get ahead."""
    import torch
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) if ahead else None


# torch ops a wrapper may run that launch nothing on the device
NO_LAUNCH_OPS = ("aten::empty", "aten::slice", "aten::view", "aten::as_strided")


def launches_of(fn, kernel: str):
    """One call of fn: the launches of the port's kernel `kernel` (its
    count) and the torch ops it ran that launch device work, from
    torch.profiler's op events (a zero fill shows as aten::zeros, zero_
    or fill_; allocation and views are NO_LAUNCH_OPS)."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch import kernels
    fn()
    sync()
    n0 = kernels.KERNELS[kernel].launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        sync()
    ops = sorted({e.name for e in prof.events()
                  if e.name.startswith("aten::") and e.name not in NO_LAUNCH_OPS})
    return kernels.KERNELS[kernel].launches - n0, ops


def device_records(fn, tries: int = 3) -> int:
    """The device activity records (kernels, memcpy, memset) of one call
    of fn, from torch.profiler (device_busy_us). The call is profiled up
    to `tries` times, as in traced_dims: a window in which CUPTI delivered
    no device record at all (seen once for K9b in a full run of this
    script) is a window the profiler missed, not a call that ran nothing
    on the device; 0 comes back only where every window was empty."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        n = device_busy_us(prof)[1]
        if n:
            return n
    return 0


def entry_name(mangled: str) -> str:
    """`name<args>` of a mangled kernel name: the last component of its
    nested name and its template arguments (integers, bools, float and
    double), so that each instantiation keeps a name of its own."""
    import re
    if not mangled.startswith("_ZN"):
        return mangled
    at, name = 3, mangled
    while at < len(mangled) and mangled[at].isdigit():
        digits = re.match(r"\d+", mangled[at:]).group()
        name = mangled[at + len(digits):at + len(digits) + int(digits)]
        at += len(digits) + int(digits)
    rest = mangled[at:]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"Li(-?\d+)E|Lb([01])E|([fd])(?=[fdL]|E|$)", rest.split("EEv", 1)[0][1:])
    words = [i or ("true" if b == "1" else "false") if i or b else
             {"f": "float", "d": "double"}[t] for i, b, t in args]
    return f"{name}<{', '.join(words)}>"


def traced_dims(fn, kernel: str, tries: int = 3):
    """One call of fn under torch.profiler with the device's activity: the
    (grid, block) of every launch of a device kernel whose name holds
    `kernel`, as CUPTI recorded it (the Chrome trace's kernel events).
    The call is profiled up to `tries` times; [] comes back where no
    window recorded the kernel (K10d's in a full run of this script, which
    a process of its own does record)."""
    import json
    from torch.profiler import ProfilerActivity, profile
    path = ROOT / "build" / "traced_dims.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(tries):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "kernel" and kernel in e.get("name", "")
                  and "grid" in e.get("args", {})]
        path.unlink()
        if events:
            return [(tuple(e["args"]["grid"]), tuple(e["args"]["block"])) for e in events]
    return []


def check_one_launch(rows, name, src, kernel, fns, shape=None, note="", stack=0, fill=(),
                     expect=None, grids=None):
    """A kernel's build and launch: ptxas's report of every entry function
    whose name holds `kernel` (each instantiation of a template; at most
    `stack` bytes of stack, 0 unless the note says why, else fail), its
    launch shape where given (a cluster kernel's, as built) or a `note` on
    it, and for each call in `fns` one launch of the kernel `name` and no
    torch op that launches device work beside it but the zero fill `fill`
    names (the ops of the wrapper's torch.zeros, where its design keeps
    one), all kept in rows[name]. A one-cluster kernel gives `expect`, its
    CTAs a cluster and threads a CTA ({} where the build's export is the
    only statement of them): its shape is then read from the
    build (Kernel.launch_shape) and the grid and block the profiler traced
    on each call (a call the profiler did not record shows []), and the
    run fails unless they agree; a kernel of a cluster per work item (K8c's
    per candidate) gives each call's grid in CTAs as `grids`."""
    from lidar_odometry_tpu_torch import kernels
    entries = {entry_name(m): info for m, info in kernels.ptxas_entries(src, kernel).items()}
    ran = [launches_of(fn, name) for fn in fns]
    if expect is not None:
        shape = kernels.KERNELS[name].launch_shape()
        if {k: shape[k] for k in expect} != expect:
            fail(f"{name}: built with {shape}, expected {expect}")
        traced = [traced_dims(fn, kernel) for fn in fns]
        for i, dims in enumerate(traced):
            built = ((shape["grid"] if grids is None else grids[i], 1, 1),
                     (shape["threads"], 1, 1))
            if any(d != built for d in dims):
                fail(f"{name}: traced (grid, block) {dims}, built {built}")
        shape = dict(shape, traced=[[list(map(list, d)) for d in dims] for dims in traced])
    what = ("" if shape is None else
            f"a cluster of {shape['cluster']} CTAs x {shape['threads']} threads ({shape}); ")
    what += f"{note}; " if note else ""
    report = "; ".join(f"ptxas {k}: {i['registers']} registers, {i['stack']} bytes of stack, "
                       f"spills {i['spill_stores']} / {i['spill_loads']} bytes"
                       for k, i in entries.items())
    print(f"  {name}: {what}{report}; a call: {[n for n, _ in ran]} launches, torch ops that "
          f"launch {[o for _, o in ran]}", flush=True)
    for k, info in entries.items():
        if info["stack"] > stack:
            fail(f"{name}: ptxas reports {info['stack']} bytes of stack for {k}")
    for n, ops in ran:
        if n != 1 or set(ops) - set(fill):
            fail(f"{name}: one call launched it {n} times beside the torch ops {ops}")
    rows[name].update(ptxas=next(iter(entries.values())) if len(entries) == 1 else entries,
                      launches_a_call=1)
    if shape is not None:
        rows[name].update(launch_shape=shape)
    if note:
        rows[name].update(launch_note=note)


def record(rows, name, err, tol, kernel, plain_ms, nbytes, ops, library=None, note="",
           ops_per_s=FP32_OPS_PER_S, library_reps=30):
    """Time one kernel (`kernel` is a call of its wrapper: CUDA events over
    30 calls as launched, and device_ms) and its library call (`library`,
    the same two ways, so that device times are compared with device
    times), print its comparison with its plain version, fail if it is out
    of tolerance, and keep its numbers in rows[name]."""
    ms, dev_ms = time_ms(kernel), device_ms(kernel)
    library_ms = library_dev = None
    if library is not None:
        library_ms = time_ms(library, library_reps)
        library_dev = device_ms(library, library_reps)
    b, by = bound_ms(nbytes, ops, ops_per_s)
    ok = err <= tol
    print(f"  {name:22s} max_abs_err {err:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}"
          f" | kernel {ms:.4f} ms"
          + (f" (device {dev_ms:.4f} ms)" if dev_ms is not None else "")
          + f", plain {plain_ms:.4f} ms, bound {b:.5f} ms ({by})"
          + (f", library {library_ms:.4f} ms" if library_ms is not None else "")
          + (f" (device {library_dev:.4f} ms)" if library_dev is not None else "")
          + (f" | {note}" if note else ""), flush=True)
    if not ok:
        fail(f"kernel {name} disagrees with its plain version: {err} > {tol}")
    rows[name] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b,
                      bound_by=by, library_ms=library_ms, library_device_ms=library_dev)


def gmm_rounds(r, valid, scale, consts):
    """The (k-means, EM) rounds of the plain GMM fit that K3 runs on these
    residuals at this scale."""
    import torch
    from lidar_odometry_tpu_torch.ops import pko
    samples = pko.stratified_sample(r.abs() / torch.clamp(scale, min=1e-6), valid, consts.u)
    return list(pko.fit_gmm(samples, consts.pick, rounds=True)[3])


def make_scans(n_frames: int, seed: int = 11):
    """The bench's world and trajectory: 131072-point scans, 80 m range,
    strided by 8 at decode, NaN-padded."""
    import numpy as np
    from lidar_odometry_tpu_torch.io import synthetic
    world = synthetic.make_world(seed=seed, extent=120.0, n_buildings=28)
    poses = synthetic.straight_trajectory(n_frames, step=0.25)
    rng = np.random.default_rng(seed)
    out = np.full((n_frames, RAW_N // STRIDE, 3), np.nan, np.float32)
    for i in range(n_frames):
        s = synthetic.sample_scan(world, poses[i], RAW_N, rng, max_range=80.0,
                                  noise=0.01)[::STRIDE]
        out[i, :len(s)] = s
    return out, poses


def make_indoor_scans(n_frames: int):
    """MID360-style ring scans along an indoor corridor loop, as
    tools/bench_accuracy.py makes them: 40 rings x 720 azimuths, 25 m range,
    elevation -7 to 52 degrees. Returns ((N, 3) sensor-frame scans, poses)."""
    import numpy as np
    from lidar_odometry_tpu_torch.io import synthetic
    poses = synthetic.circuit_trajectory(n_frames, length=24.0, radius=7.0, step=0.12,
                                         height=1.2)
    center = synthetic.circuit_trajectory(64, length=24.0, radius=7.0,
                                          step=(2 * 24.0 + 2 * np.pi * 7.0) / 64, height=1.2)
    world = synthetic.make_corridor_world(center[:, :2, 3], width=5.0, height=3.0, extent=25.0)
    rng = np.random.default_rng(33)
    scans = [synthetic.sample_scan_rings(world, p, rng, n_rings=40, azimuth_steps=720,
                                         max_range=25.0, noise=0.008,
                                         elevation_range=(-7.0, 52.0)) for p in poses]
    return scans, poses


def make_loop_scans():
    """The JAX loop test's circuit (seed 9: a 60 m world of 18 buildings, a
    30 m x 10 m stadium at 0.6 m a frame, 220 frames = 1.07 laps) with
    scans of LOOP_POINTS returns at LOOP_RANGE, NaN-padded. Returns
    ((F, LOOP_POINTS, 3) scans, poses)."""
    import numpy as np
    from lidar_odometry_tpu_torch.io import synthetic
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(LOOP_FRAMES, length=30.0, radius=10.0, step=0.6)
    rng = np.random.default_rng(9)
    out = np.full((LOOP_FRAMES, LOOP_POINTS, 3), np.nan, np.float32)
    for i in range(LOOP_FRAMES):
        s = synthetic.sample_scan(world, poses[i], LOOP_POINTS, rng, max_range=LOOP_RANGE,
                                  noise=0.02)
        out[i, :len(s)] = s
    return out, poses


def make_dense_loop_frames():
    """Frames DENSE_FRAMES of the loops path's circuit scanned with
    DENSE_POINTS returns at LOOP_RANGE, NaN-padded: their features fill
    kitti.yaml's scan capacity. Returns {frame: (DENSE_POINTS, 3) scan}."""
    import numpy as np
    from lidar_odometry_tpu_torch.io import synthetic
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(LOOP_FRAMES, length=30.0, radius=10.0, step=0.6)
    rng = np.random.default_rng(19)
    out = {}
    for i in DENSE_FRAMES:
        out[i] = np.full((DENSE_POINTS, 3), np.nan, np.float32)
        s = synthetic.sample_scan(world, poses[i], DENSE_POINTS, rng, max_range=LOOP_RANGE,
                                  noise=0.02)
        out[i][:len(s)] = s
    return out


def kitti_config():
    """config/kitti.yaml through the port's loader. The scans are made at
    the density the estimator keeps, so point_stride 8 becomes 1."""
    from lidar_odometry_tpu_torch.config import load_config
    return load_config(str(ROOT / "config" / "kitti.yaml")).replace(
        point_stride=1, enable_console_statistics=False, chunk_frames=LOOP_CHUNK)


def mid360_config():
    """config/mid360.yaml through the port's loader, loop closure off, chunks
    of MID_CHUNK."""
    from lidar_odometry_tpu_torch.config import load_config
    return load_config(str(ROOT / "config" / "mid360.yaml")).replace(
        enable_loop_detection=False, chunk_frames=MID_CHUNK)


def check_launches(path: str, launches: dict, must, never=()) -> None:
    print(f"{path} path launches: {json.dumps(launches)}", flush=True)
    missing = [k for k in must if launches[k] == 0]
    if missing:
        fail(f"the {path} path never launched {missing}")
    extra = [k for k in never if launches[k] != 0]
    if extra:
        fail(f"the {path} path launched {extra}, which it must not")


def check_captured(path: str, est) -> None:
    """The Estimator's chunks went through captured CUDA graphs (its
    GraphedChunk): at least one graph and one replay."""
    run = est._chunk_runner
    graphs, replays = (0, 0) if run is None else (len(run.graphs), run.replays)
    print(f"{path} path: {graphs} captured chunk graph(s), {replays} replays", flush=True)
    if not replays:
        fail(f"{path} path: no chunk ran as a captured CUDA graph")


def check_sample_in_k11b(path: str, launches: dict, fused: dict) -> None:
    """The sharded ICP runs K11c's sample inside K11b's launch: no launch of
    its own, its work in every ICP iteration's K11b launch (as many as
    K11d's)."""
    n, k11d = fused["shard_sample"], launches["shard_gn_select"]
    print(f"{path} path: K11c's sample ran {n} times inside K11b's launch (K11b launches "
          f"{launches['shard_alpha_normal_eq']}), {launches['shard_sample']} launches of its "
          f"own, {k11d} ICP iterations", flush=True)
    if launches["shard_sample"] != 0 or n != k11d or n == 0:
        fail(f"{path} path: K11c ran {n} times in K11b's launch and {launches['shard_sample']} "
             f"times alone for {k11d} ICP iterations (all of them in K11b's expected)")


def setup():
    from lidar_odometry_tpu_torch.ops import icp, pko
    cfg = icp.ICPConfig(max_iterations=4, translation_tolerance=0.005,
                        rotation_tolerance=0.005, max_correspondence_distance=1.0,
                        min_correspondence_points=50, use_robust_loss=True,
                        use_surfel_correspondence=True, loss_type="huber",
                        use_adaptive_m_estimator=True, voxel_size=0.5)
    consts = pko.make_pko_constants(0.1, 10.0, 100, 10.0, "huber", 3, 100, device=DEVICE)
    kw = dict(scan_voxel_size=0.5, point_stride=1, scan_capacity=SCAN_CAP,
              keyframe_distance=1.0, keyframe_rotation=0.3, max_distance=120.0,
              planarity_threshold=0.1)
    return cfg, consts, kw


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin
# ---------------------------------------------------------------------------

def k4c_gaps(kernel_out, twin_out, l0, r_slot, c1: int, thr: float) -> dict:
    """K4c's outputs (srows, non_planar, kidmask) against its plain twin's
    on one input: the live-child masks that differ (kid); the largest gap
    (err) of the means and flags of every row, and of the planarities and
    normals of the rows the map can use (at least MIN_OCCUPIED_CHILDREN
    live children), the normals where the two smallest eigenvalues of the
    covariance are apart (float64); err split into the normals'
    (err_normal, with (lambda_1 - lambda_0) / lambda_2 of its row, sep)
    and the rest (err_rest); the non-planar verdicts that differ inside
    the 1e-5 band around the threshold and outside it; the rows with an
    ill-conditioned normal and those with a live child; and the planarity
    gap of the other rows (plan_few). Their smallest eigenvalue is ~0 (3
    live children are coplanar), which the float32 closed form does not
    resolve: their planarity is rounding noise (~2e-4 from the twin, the
    old kernel's too) and their normal may point anywhere (the twin itself
    up to ~1 from float64); no surfel of theirs is used (PERF.md §6)."""
    import torch
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    (sk, nk, kk), (sp, np_, kp) = kernel_out, twin_out
    rows_ix = (torch.clamp(r_slot, 0, c1 - 1)[:, None] * 27
               + torch.arange(27, device=l0.device)[None, :]).reshape(-1)
    blk = torch.where((r_slot >= 0)[:, None, None], l0[rows_ix].view(-1, 27, 4), 0.0)
    _c, _m, cov, kids = vm._block_stats(blk)
    # on the host: cuSOLVER's batched eigvalsh refuses a batch of 65536
    lam = torch.linalg.eigvalsh(cov.double().cpu()).to(cov.device)
    used = kids.sum(1) >= vm.MIN_OCCUPIED_CHILDREN
    well = ((lam[:, 1] - lam[:, 0]) > 1e-4 * (lam[:, 2] + 1e-6)) & used
    gap = (sk - sp).abs()
    top = lambda x: float(x.max()) if x.numel() else 0.0
    normal = torch.where(well, gap[:, :3].max(1).values, 0.0)
    err_normal = float(normal.max())
    # the relative gap of the two smallest eigenvalues at the largest normal gap
    at = int(normal.argmax())
    sep = float((lam[at, 1] - lam[at, 0]) / (lam[at, 2] + 1e-6))
    err_rest = max(top(gap[:, [3, 4, 5, 7]]), top(gap[used, 6]))
    near = (sp[:, 6] - thr).abs() < 1e-5
    flips = nk != np_
    return dict(err=max(err_rest, err_normal), err_normal=err_normal, err_rest=err_rest,
                sep=sep, kid=int((kk != kp).sum()),
                flips_in=int((flips & near).sum()), flips_out=int((flips & ~near).sum()),
                ill=int((~well & used).sum()), live=int((kp != 0).sum()),
                plan_few=top(gap[~used, 6]))


def k4c_agreement(l0, r_slot, c1: int, thr: float) -> dict:
    """K4c against its plain twin on one input (k4c_gaps): fails unless
    the live-child masks are equal and no verdict differs outside the
    band."""
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    out = k4c_gaps(vm.map_surfel_recompute(l0, r_slot, c1, thr),
                   vm.map_surfel_recompute_plain(l0, r_slot, c1, thr), l0, r_slot, c1, thr)
    if out["kid"]:
        fail(f"map_surfel_recompute: {out['kid']} live-child masks differ")
    if out["flips_out"]:
        fail(f"map_surfel_recompute: {out['flips_out']} non-planar verdicts differ outside "
             f"the 1e-5 band")
    return out


def check_kernels(scans_np, cfg, consts, kw):
    import torch
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import icp, pko, voxel_filter as vf, voxel_map as vm
    from lidar_odometry_tpu_torch.utils import keys as K, lie

    dev = DEVICE
    rows = {}
    # a map built by the port's own first keyframes
    runner = fp.make_chunk_runner(cfg, consts, **kw)
    carry = fp.init_carry(0, C1, device=dev)
    carry, _ = runner(carry, torch.as_tensor(scans_np[:CHUNK], device=dev))
    sync()
    state = carry.map_state
    raw = torch.as_tensor(scans_np[CHUNK], device=dev)

    row = functools.partial(record, rows)

    # ---- K1 voxel filter ----
    n = raw.shape[0]
    inv, vox = K.f32(1.0 / 0.5), K.f32(0.5)
    valid = torch.all(torch.isfinite(raw), dim=-1)
    coords = torch.floor(torch.nan_to_num(raw, 0.0, 0.0, 0.0) * inv).to(torch.int32)
    key, okk = K.compact_key(coords)
    key = torch.where(valid & okk, key, torch.full_like(key, K.INVALID_SORT_KEY))
    key_s, perm = torch.sort(key, stable=True)
    c_k, m_k, n_k = vf.voxel_segments(key_s, perm, raw, SCAN_CAP, inv, vox)
    c_p, m_p, n_p = vf.voxel_segments_plain(key_s, perm, raw, SCAN_CAP, inv, vox)
    if not (torch.equal(m_k, m_p) and int(n_k) == int(n_p)):
        fail("voxel_filter: mask or count differs from the plain version")
    err = float((c_k - c_p).abs().max())
    seg = torch.cumsum(K.segment_starts(key_s, key_s != K.INVALID_SORT_KEY)[0].long(), 0) - 1
    p_rel = torch.where((key_s != K.INVALID_SORT_KEY)[:, None], raw[perm], 0.0)
    lib_out = torch.zeros((SCAN_CAP + 1, 3), device=dev)
    seg_c = torch.clamp(seg, 0, SCAN_CAP)
    nv = int(n_k)
    row("voxel_filter", err, 1e-5,
        lambda: vf.voxel_segments(key_s, perm, raw, SCAN_CAP, inv, vox),
        time_ms(lambda: vf.voxel_segments_plain(key_s, perm, raw, SCAN_CAP, inv, vox)),
        n * (8 + 8 + 12) + SCAN_CAP * 13 + 4, n * 10,
        library=lambda: lib_out.index_add_(0, seg_c, p_rel),
        note=f"{nv} voxels from {int(valid.sum())} points")
    check_voxel_edges()

    # ---- K2a correspondences, K3 PKO, K2b normal equations ----
    feat, mask, _ = vf.voxel_filter(raw, n, voxel_size=0.5, stride=1,
                                    out_capacity=SCAN_CAP, compact_keys=True)
    T = (carry.T_prev @ carry.velocity).reshape(16).contiguous()
    flags = torch.zeros((3,), dtype=torch.int32, device=dev)
    nrm_k, r_k, v_k = icp.icp_correspond(feat, mask, T, flags, state, cfg)
    nrm_p, r_p, v_p = icp.icp_correspond_plain(feat, mask, T, state, cfg)
    mism = int((v_k != v_p).sum())
    both = v_k & v_p
    err = max(float((r_k - r_p)[both].abs().max()), float((nrm_k - nrm_p)[both].abs().max()))
    if mism > 2:
        fail(f"icp_correspond: {mism} validity flags differ from the plain version")
    N = feat.shape[0]
    qhi, qlo = K.pack_key(K.voxel_coords(lie.transform_points(T.view(4, 4), feat),
                                         vm.parent_inv(0.5, 3)))
    n_rows_b = int(torch.unique(vm.hash_bucket(qhi, qlo, state.n_buckets - 1)).numel())
    n_rows_s = int(torch.unique(vm.bucket_find(state.l1_index, qhi, qlo)[0]).numel())
    row("icp_correspond", err, 1e-4,
        lambda: icp.icp_correspond(feat, mask, T, flags, state, cfg),
        time_ms(lambda: icp.icp_correspond_plain(feat, mask, T, state, cfg)),
        N * (12 + 1) + 64 + 12 + n_rows_b * 128 + n_rows_s * 32 + N * 17, N * 40,
        note=f"{int(v_k.sum())} correspondences, {mism} flag mismatches")

    scale = torch.ones((1,), device=dev)
    aux_k, s_k = pko.pko_alpha_index(r_k, v_k, flags, scale, True, consts)
    a_p, c_p2, s_p = pko.pko_alpha_index_plain(r_k, v_k, scale.reshape(()), True, consts)
    if int(aux_k[1]) != int(a_p) or int(aux_k[0]) != int(c_p2):
        fail(f"pko_alpha: alpha index {int(aux_k[1])} / count {int(aux_k[0])} vs plain "
             f"{int(a_p)} / {int(c_p2)}")
    err = float((s_k.reshape(()) - s_p).abs()) / max(float(s_p), 1e-12)
    n_a, n_g = consts.Q.shape
    rounds = gmm_rounds(r_k, v_k, s_p, consts)
    row("pko_alpha", err, 1e-5,
        lambda: pko.pko_alpha_index(r_k, v_k, flags, scale, True, consts),
        time_ms(lambda: pko.pko_alpha_index_plain(r_k, v_k, scale.reshape(()), True, consts)),
        N * 5 + n_a * n_g * 4 + (n_a + n_g + 100) * 4 + 12, N * 4 + n_a * n_g * 12,
        note=f"alpha index {int(aux_k[1])}; its fit: {rounds[0]} k-means and {rounds[1]} EM "
             f"rounds; err is relative, of the scale")
    rows["pko_alpha"]["gmm_rounds"] = rounds

    Tk, fk, hgk = icp.icp_normal_eq(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k, consts, cfg)
    Tp, fp_, hgp = icp.icp_normal_eq_plain(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k,
                                           consts, cfg)
    if not torch.equal(fk, fp_):
        fail(f"icp_normal_eq: flags {fk.tolist()} vs plain {fp_.tolist()}")
    again = icp.icp_normal_eq(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k, consts, cfg)
    if not all(torch.equal(a, b) for a, b in zip(again, (Tk, fk, hgk))):
        fail("icp_normal_eq: two calls differ")
    hg_rel = float(((hgk - hgp).abs() / hgp.abs().clamp(min=1.0)).max())
    err = float((Tk - Tp).abs().max())
    nvld = int(v_k.sum())
    row("icp_normal_eq", err, 1e-5,
        lambda: icp.icp_normal_eq(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k,
                                          consts, cfg),
        time_ms(lambda: icp.icp_normal_eq_plain(feat, nrm_k, r_k, v_k, T, s_k, flags,
                                                aux_k, consts, cfg)),
        N * (12 + 12 + 4 + 1) + 64 + 28 + 64 + 12 + 108, nvld * 90,
        note=f"H,g relative err {hg_rel:.2e}; two calls bit-equal")
    check_one_launch(rows, "icp_normal_eq", "icp", "normal_eq_kernel",
                     [lambda: icp.icp_normal_eq(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k,
                                                consts, cfg)],
                     icp.icp_normal_eq_shape())

    # ---- K4a evict scan (a 40 m radius, so that parents do evict) ----
    l0 = state.l0_data
    sensors = T.view(4, 4)[:3, 3].reshape(1, 3).contiguous()
    on = torch.ones((), dtype=torch.bool, device=dev)
    maxd2 = K.f32(40.0 * 40.0)
    ck = vm.map_evict_scan(l0, C1, sensors, maxd2, on)
    cp = vm.map_evict_scan_plain(l0, C1, sensors, maxd2, on)
    err = float((ck != cp).sum())
    live = int((l0[:C1 * 27, 0] > 0).sum())
    row("map_evict_scan", err, 0,
        lambda: vm.map_evict_scan(l0, C1, sensors, maxd2, on),
        time_ms(lambda: vm.map_evict_scan_plain(l0, C1, sensors, maxd2, on)),
        C1 * 27 * 16 + 12 + 1 + C1, live * 20,
        note=f"{int(ck.sum())} evicting parents of {int(state.n_l1)}; err = differing flags")

    # ---- K4b scatter-add of a keyframe's points into existing parents ----
    world = lie.transform_points(T.view(4, 4), feat)
    pc = K.voxel_coords(world, inv)
    par = torch.div(pc, 3, rounding_mode="floor")
    off = vm._child_offset_of(pc)
    phi, plo = K.pack_key(par)
    slot, hit, _, _ = vm.bucket_find(state.l1_index, phi, plo)
    kkey = torch.where(mask, K.sort_key(*K.pack_key(pc)), K.INVALID_SORT_KEY)
    s_key, s_idx = torch.sort(kkey, stable=True)
    firstk = torch.ones((N,), dtype=torch.bool, device=dev)
    firstk[1:] = s_key[1:] != s_key[:-1]
    valid_s = mask[s_idx]
    nrows = C1 * 27
    placed = hit & mask
    k4b = (world, s_idx, firstk, valid_s, placed, slot, off)
    l0k, l0p = l0.clone(), l0.clone()
    vm.map_scatter_add(l0k, *k4b)
    vm.map_scatter_add_plain(l0p, *k4b)
    err = float((l0k[:nrows] - l0p[:nrows]).abs().max())
    # the bytes the function needs: firstk and valid_s at every sorted
    # position, s_idx and the point at each valid one, placed at each run
    # leader, and pslot, ch_off and the row's read-modify-write at a placed one
    n_valid, n_lead = int(mask.sum()), int(firstk.sum())
    n_placed = int((firstk & placed[s_idx]).sum())
    tgt_pt = torch.where(placed, slot * 27 + off, nrows)
    data4 = torch.cat([mask.float()[:, None], torch.where(mask[:, None], world, 0.0)], 1)
    l0_lib = l0.clone()

    def target_ops():
        """The torch ops that computed K4b's targets in update_map before
        K4b took placed, pslot and ch_off and computed them itself."""
        return torch.where(firstk & placed[s_idx], slot[s_idx] * 27 + off[s_idx], nrows)

    tops_ms, tops_dev = time_ms(target_ops), device_ms(target_ops)
    row("map_scatter_add", err, 1e-6,
        lambda: vm.map_scatter_add(l0k, *k4b),
        time_ms(lambda: vm.map_scatter_add_plain(l0p, *k4b)),
        N * 2 + n_valid * (12 + 8) + n_lead * 1 + n_placed * (16 + 32), N * 4,
        library=lambda: l0_lib.index_add_(0, tgt_pt, data4),
        note=f"{n_placed} voxel rows of {n_lead} runs; the targets computed in the "
             f"kernel: the torch ops that computed them before take {tops_ms:.4f} ms "
             f"as issued, " + ("n/a" if tops_dev is None else f"{tops_dev:.4f}")
             + " ms on the device")
    rows["map_scatter_add"].update(target_ops_ms=tops_ms, target_ops_device_ms=tops_dev)
    check_one_launch(rows, "map_scatter_add", "voxel_map", "scatter_add_kernel",
                     [lambda: vm.map_scatter_add(l0k, *k4b)])

    # ---- K4c surfel recompute of every parent with enough children ----
    r_n = min(SCAN_CAP, C1)
    live_par = torch.nonzero(state.l1_meta[:C1, 2] >= vm.MIN_OCCUPIED_CHILDREN).flatten()[:r_n]
    r_slot = torch.full((r_n,), -1, dtype=torch.int64, device=dev)
    r_slot[:live_par.numel()] = live_par
    thr = K.f32(0.1)
    agree = k4c_agreement(l0, r_slot, C1, thr)
    n_live = int(live_par.numel())
    row("map_surfel_recompute", agree["err"], 1e-4,
        lambda: vm.map_surfel_recompute(l0, r_slot, C1, thr),
        time_ms(lambda: vm.map_surfel_recompute_plain(l0, r_slot, C1, thr)),
        r_n * 8 + n_live * 27 * 16 + r_n * (32 + 1 + 4), n_live * (27 * 30 + 200),
        note=f"{n_live} parents, {agree['ill']} with an ill-conditioned normal left out of "
             f"the normal comparison, {agree['flips_in']} verdicts flipped inside the 1e-5 band")
    # the rehash's shape (bulk_build): every slot of the map, R = c1
    every = torch.arange(C1, device=dev)
    agree_r = k4c_agreement(l0, every, C1, thr)
    n_occ = agree_r["live"]
    b_r = bound_ms(C1 * 8 + C1 * 27 * 16 + C1 * (32 + 1 + 4), n_occ * (27 * 30 + 200))
    recompute_all = lambda: vm.map_surfel_recompute(l0, every, C1, thr)
    rehash = dict(rehash_ms=time_ms(recompute_all), rehash_device_ms=device_ms(recompute_all),
                  rehash_bound_ms=b_r[0], rehash_bound_by=b_r[1],
                  rehash_max_abs_err=agree_r["err"], rehash_parents=n_occ)
    rows["map_surfel_recompute"].update(rehash)
    dev_r = rehash["rehash_device_ms"]
    print(f"  map_surfel_recompute at the rehash's shape (R = c1 = {C1}, {n_occ} parents with a "
          f"live child): max_abs_err {agree_r['err']:.3e} (tol 1e-04; the planarity of parents "
          f"with fewer than {vm.MIN_OCCUPIED_CHILDREN}, unused: {agree_r['plan_few']:.1e}) | "
          f"kernel {rehash['rehash_ms']:.4f} ms (device "
          + ("n/a" if dev_r is None else f"{dev_r:.4f}")
          + f" ms), bound {b_r[0]:.5f} ms ({b_r[1]})", flush=True)
    if agree_r["err"] > 1e-4:
        fail(f"map_surfel_recompute at R = c1: {agree_r['err']} > 1e-4")
    check_one_launch(rows, "map_surfel_recompute", "voxel_map", "surfel_recompute_kernel",
                     [lambda: vm.map_surfel_recompute(l0, r_slot, C1, thr)])
    return rows, state


def check_voxel_edges():
    """K1 on the tests' edge case: runs of 3 sorted entries that cross its
    512-entry tiles, one run of 1500 (longer than a tile) and 7 invalid
    rows (n = 3607, not a multiple of the tile), at SCAN_CAP and at a cap
    below the voxel count: within 1e-5 of the plain twin, mask and count
    equal, two calls bit-equal."""
    import torch
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    from lidar_odometry_tpu_torch.utils import keys as K
    counts = [3] * 700 + [1500]
    raw = torch.tensor(synthetic.voxel_runs(counts, 7, seed=3), device=DEVICE)
    key, ok = K.compact_key(torch.floor(torch.nan_to_num(raw, 0.0, 0.0, 0.0) * 2.0)
                            .to(torch.int32))
    key = torch.where(ok & torch.all(torch.isfinite(raw), -1), key, K.INVALID_SORT_KEY)
    key_s, perm = torch.sort(key, stable=True)
    err = err_cpu = 0.0
    for cap in (SCAN_CAP, 500):
        c_k, m_k, n_k = vf.voxel_segments(key_s, perm, raw, cap, 2.0, 0.5)
        c_2, m_2, n_2 = vf.voxel_segments(key_s, perm, raw, cap, 2.0, 0.5)
        c_p, m_p, n_p = vf.voxel_segments_plain(key_s, perm, raw, cap, 2.0, 0.5)
        c_c = vf.voxel_segments_plain(key_s.cpu(), perm.cpu(), raw.cpu(), cap, 2.0, 0.5)[0]
        if not (int(n_k) == int(n_p) == len(counts) and torch.equal(m_k, m_p)):
            fail(f"voxel_filter edges: mask or count differs from the plain version (cap {cap})")
        if not (torch.equal(c_k, c_2) and torch.equal(m_k, m_2) and torch.equal(n_k, n_2)):
            fail(f"voxel_filter edges: two calls differ (cap {cap})")
        err = max(err, float((c_k - c_p).abs().max()))
        err_cpu = max(err_cpu, float((c_k.cpu() - c_c).abs().max()))
    if max(err, err_cpu) > 1e-5:
        fail(f"voxel_filter edges disagree with the plain version: {err}, {err_cpu} > 1e-5")
    # the twin's index_add_ adds with atomics on the card, in no fixed order,
    # and in index order (the kernel's) on the CPU
    print(f"  voxel_filter edges: {len(counts)} voxels in runs crossing 512-entry tiles, one "
          f"run of 1500, n {raw.shape[0]}, caps {SCAN_CAP} and 500: max_abs_err {err:.3e} "
          f"from the twin on the card, {err_cpu:.3e} from the twin on the CPU (tol 1e-05) ok, "
          f"two calls bit-equal", flush=True)


def k5b_bytes_ops(fit, cand_ok):
    """The bytes K5b's function must move on these inputs, and its fp32
    operations: every flag, the ok candidates' coordinates, the chosen
    not-ok candidates' coordinates (a padded row's first 5), the points
    and masks, and the outputs written once; ~9 operations an ok candidate
    and ~400 a point (the fit)."""
    import torch
    n, m = cand_ok.shape
    n_ok = int(cand_ok.sum())
    sel_not_ok = int((~torch.gather(cand_ok, 1, fit.sel.long())).sum())
    return (n * m + 12 * (n_ok + sel_not_ok) + n * 13 + n * (3 * 12 + 1 + 4 + 4 + 20),
            n_ok * 9 + n * 400)


def k5b_gaps(fk, fp_, cand, cand_ok) -> dict:
    """K5b's outputs (a PlaneFit) against its twin's on the same inputs:
    the rows whose selection differs; and on the rows whose 5 chosen
    points' covariance keeps its two smallest eigenvalues more than 1e-2 of
    the largest apart (float64; there the normal is fixed to ~1e-5) the
    validity flags that differ and the largest gap of dist and resid.
    `well` is that row mask."""
    import torch
    sel = fp_.sel.long()
    nb = torch.gather(cand, 1, sel[..., None].expand(-1, -1, 3)).double()
    w = torch.gather(cand_ok, 1, sel)[..., None].double()
    cnt = w.sum(1).clamp(min=1.0)
    d = (nb - ((nb * w).sum(1) / cnt)[:, None]) * w
    lam = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", d, d) / cnt[..., None])
    well = (lam[:, 1] - lam[:, 0]) > 1e-2 * (lam[:, 2] + 1e-6)
    err = 0.0
    if bool(well.any()):
        err = max(float((fk.dist - fp_.dist)[well].abs().max()),
                  float((fk.resid - fp_.resid)[well].abs().max()))
    return dict(sel_rows=int((fk.sel != fp_.sel).any(1).sum()),
                flips=int((fk.valid != fp_.valid)[well].sum()), err=err, well=well)


def kd_inputs(scans, sysc):
    """The mid360 shapes of K5a and K5b: the map built without surfels by
    the mid360 path's first chunk of keyframes (its own estimator), and the
    next frame's features moved by its pose guess. Returns (map state, ICP
    config, p (N, 3), mask (N,)), on the card."""
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    from lidar_odometry_tpu_torch.utils import lie
    dev = DEVICE
    stride = sysc.point_stride
    padded = np.full((MID_CHUNK + 1, MID_RAW // stride, 3), np.nan, np.float32)
    for i in range(MID_CHUNK + 1):
        s = scans[i][::stride]
        padded[i, :len(s)] = s
    est = Estimator(sysc.replace(point_stride=1), device=dev)
    est.process_chunk(padded[:MID_CHUNK])
    raw = torch.as_tensor(padded[MID_CHUNK], device=dev)
    feat, mask, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=sysc.voxel_size, stride=1,
                                    out_capacity=sysc.scan_capacity, compact_keys=True)
    guess = torch.as_tensor(est._prev_pose @ est.velocity, device=dev)
    return (est.map_state, est.icp_cfg, lie.transform_points(guess, feat).contiguous(), mask)


def check_kd_kernels(scans, sysc):
    """K5a and K5b against their plain twins at the mid360 shapes, on a map
    built without surfels by the mid360 path's first chunk of keyframes."""
    import torch
    from lidar_odometry_tpu_torch.ops import icp, voxel_map as vm
    from lidar_odometry_tpu_torch.utils import keys as K

    dev = DEVICE
    rows = {}
    row = functools.partial(record, rows)
    state, cfg, p, mask = kd_inputs(scans, sysc)
    r, vox = cfg.grid_knn_radius, cfg.voxel_size
    n = p.shape[0]

    # ---- K5a grid_knn ----
    ck, okk = vm.grid_knn_neighbors(state, p, voxel_size=vox, radius=r)
    cp, okp = vm.grid_knn_neighbors_plain(state, p, voxel_size=vox, radius=r)
    flips = int((okk != okp).sum())
    if flips:
        fail(f"grid_knn: {flips} candidate flags differ from the plain version")
    m = okk.shape[1]
    qc = K.voxel_coords(p, K.f32(1.0 / K.f32(vox)))

    def k5a_bytes(rr: int) -> int:
        """The points, every distinct bucket row probed and L0 row read, and
        the (N, M) candidates written."""
        span = (2 * rr) // 3 + 2
        par = (torch.div(qc - rr, 3, rounding_mode="floor")[:, None, :]
               + torch.as_tensor(vm._cube(0, span - 1), device=dev)[None])
        n_b = int(torch.unique(vm.hash_bucket(*K.pack_key(par.reshape(-1, 3)),
                                              state.n_buckets - 1)).numel())
        nbr = qc[:, None, :] + torch.as_tensor(vm._cube(-rr, rr), device=dev)[None]
        n_r = int(torch.unique(K.sort_key(*K.pack_key(nbr.reshape(-1, 3)))).numel())
        return n * 12 + n_b * 128 + n_r * 16 + n * (2 * rr + 1) ** 3 * 13, n_b, n_r

    b5, n_b, n_r = k5a_bytes(r)
    row("grid_knn", float((ck - cp).abs().max()), 0.0,
        lambda: vm.grid_knn_neighbors(state, p, voxel_size=vox, radius=r),
        time_ms(lambda: vm.grid_knn_neighbors_plain(state, p, voxel_size=vox, radius=r)),
        b5, n * m * 20,
        note=f"{n} rows x {m} candidates, {int(okk.sum())} live; {n_b} bucket rows, "
             f"{n_r} L0 rows")
    # r = 1, the row mask in the kernel (the KD-tree ICP's route) and a tail
    # warp (N % 4 = 1): each exactly the twin's (with the mask, ANDed)
    cases = (("r = 1", 1, p, None), ("the row mask", r, p, mask),
             ("a tail of 1 point", r, p[:n - 3].contiguous(), None))
    for label, rr, pts, msk in cases:
        ck2, ok2 = vm.grid_knn_neighbors(state, pts, voxel_size=vox, radius=rr, mask=msk)
        cp2, op2 = vm.grid_knn_neighbors_plain(state, pts, voxel_size=vox, radius=rr)
        if msk is not None:
            op2 = op2 & msk[:, None]
        if not (torch.equal(ck2, cp2) and torch.equal(ok2, op2)):
            fail(f"grid_knn with {label}: differs from the plain version")
    r1 = lambda: vm.grid_knn_neighbors(state, p, voxel_size=vox, radius=1)
    masked = lambda: vm.grid_knn_neighbors(state, p, voxel_size=vox, radius=r, mask=mask)

    def then_and():   # the route before the mask went into the kernel
        c, o = vm.grid_knn_neighbors(state, p, voxel_size=vox, radius=r)
        return c, o & mask[:, None]

    b1 = bound_ms(k5a_bytes(1)[0], n * 27 * 20)
    rows["grid_knn"].update(
        r1_ms=time_ms(r1), r1_device_ms=device_ms(r1), r1_bound_ms=b1[0],
        masked_ms=time_ms(masked), masked_device_ms=device_ms(masked),
        then_and_ms=time_ms(then_and), then_and_device_ms=device_ms(then_and))
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
    g = rows["grid_knn"]
    print(f"  grid_knn: r = 1 ({n} x 27) {fmt(g['r1_device_ms'])} ms on the device "
          f"({g['r1_ms']:.4f} as issued, bound {b1[0]:.5f}); with the row mask in the kernel "
          f"{fmt(g['masked_device_ms'])} ({g['masked_ms']:.4f}) against K5a then torch & "
          f"{fmt(g['then_and_device_ms'])} ({g['then_and_ms']:.4f}); r = 1, the row mask and a "
          f"tail warp equal to the plain version", flush=True)
    check_one_launch(rows, "grid_knn", "grid_knn", "grid_knn_kernel", [r1, masked],
                     note="4 points a warp, 4 warps a block")
    # the KD-tree correspondences: one K5a launch, no torch & of the mask
    eye = torch.eye(4, device=dev).reshape(16)
    n_k, ops = launches_of(lambda: icp._grid_plane_correspondences(state, p, mask, eye, None,
                                                                   cfg), "grid_knn")
    if n_k != 1 or {"aten::bitwise_and", "aten::__and__"} & set(ops):
        fail(f"KD-tree correspondences: {n_k} K5a launches beside the torch ops {ops}")

    # ---- K5b plane_fit_5nn ----
    cand_ok = okk & mask[:, None]   # as K5a writes them on the ICP's route
    fk = icp.plane_fit_5nn(p, ck, cand_ok, mask, cfg, True)
    fp_ = icp.plane_fit_5nn_plain(p, ck, cand_ok, mask, cfg, True)
    gap = k5b_gaps(fk, fp_, ck, cand_ok)
    if gap["sel_rows"]:
        fail(f"plane_fit_5nn: {gap['sel_rows']} rows chose other candidates than the plain "
             f"version")
    if gap["flips"]:
        fail(f"plane_fit_5nn: {gap['flips']} validity flags differ from the plain version")
    row("plane_fit_5nn", gap["err"], 1e-4,
        lambda: icp.plane_fit_5nn(p, ck, cand_ok, mask, cfg, True),
        time_ms(lambda: icp.plane_fit_5nn_plain(p, ck, cand_ok, mask, cfg, True)),
        *k5b_bytes_ops(fk, cand_ok),
        note=f"{int(fk.valid.sum())} valid of {int(mask.sum())} points, {int(cand_ok.sum())} ok "
             f"candidates; "
             f"{int((~gap['well'] & mask).sum())} masked-in rows with an ill-conditioned normal "
             f"left out of the comparison")
    check_one_launch(rows, "plane_fit_5nn", "grid_knn", "plane_fit_kernel",
                     [lambda: icp.plane_fit_5nn(p, ck, cand_ok, mask, cfg, True)],
                     note=f"k = {m}: 16 lanes a point, 8 points a warp, 64 a block")
    return rows


def loop_features(scans, cfg, i):
    """Frame i's features (K1 at kitti.yaml's voxel and scan capacity) and
    mask, on the card."""
    import torch
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    raw = torch.as_tensor(scans[i], device=DEVICE)
    f, m, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=cfg.voxel_size, stride=1,
                              out_capacity=cfg.scan_capacity, compact_keys=True)
    return f, m


def loop_query(scans, gt, cfg) -> dict:
    """check_loop_kernels's loop query: frame LOOP_REVISIT's features, every
    second, at its pose drifted by 2 degrees and (0.8, -0.5) m (q_pts,
    q_mask, q_pose), against frame 0's keyframe (m_pts, m_mask, m_pose and
    its world cloud m_world); with the drift (a numpy 4 x 4), the
    estimator's ICP config and PKO constants (icfg, consts)."""
    import math
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.utils import lie
    dev = DEVICE
    est = Estimator(cfg.replace(enable_loop_detection=False), device=dev)
    m_pts, m_mask = loop_features(scans, cfg, 0)
    q_full, q_mask_full = loop_features(scans, cfg, LOOP_REVISIT)
    m_pose = torch.as_tensor(gt[0], device=dev)
    drift = np.eye(4, dtype=np.float32)
    a = math.radians(2.0)
    drift[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
    drift[:3, 3] = (0.8, -0.5, 0.0)
    return dict(q_pts=q_full[::2].contiguous(), q_mask=q_mask_full[::2].contiguous(),
                q_pose=torch.as_tensor(drift @ gt[LOOP_REVISIT], device=dev),
                m_pts=m_pts, m_mask=m_mask, m_pose=m_pose,
                m_world=lie.transform_points(m_pose, m_pts).contiguous(),
                icfg=est.icp_cfg, consts=est.pko_consts, drift=drift)


def check_loop_kernels(scans, gt, cfg, surfel_map, rows_in):
    """The loop-closure kernels against their plain twins at kitti.yaml's
    shapes: a revisit query (frame LOOP_REVISIT, every second of its 16384
    features, with a drifted pose) against frame 0's keyframe, the Iris
    batch of 16 keyframe clouds, 32 candidates, and the rehash of the
    surfel path's 65536-parent map. `scans` holds the densely scanned
    frames of make_dense_loop_frames."""
    import torch
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.ops import bev_align, icp, iris, knn
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.utils import keys as K, lie

    dev = DEVICE
    rows = {}
    row = functools.partial(record, rows)
    lq = loop_query(scans, gt, cfg)
    icfg, consts = lq["icfg"], lq["consts"]
    feats = functools.partial(loop_features, scans, cfg)
    q_pts, q_mask, q_pose = lq["q_pts"], lq["q_mask"], lq["q_pose"]
    m_pts, m_mask, m_pose, m_world = lq["m_pts"], lq["m_mask"], lq["m_pose"], lq["m_world"]
    n_q, n_m = q_pts.shape[0], m_pts.shape[0]
    print(f"  loop query: {n_q} rows ({int(q_mask.sum())} valid) against a keyframe of {n_m} "
          f"rows ({int(m_mask.sum())} valid), scans of {DENSE_POINTS} returns", flush=True)

    # ---- K7 bev_raster (the prealign's query transform and two images) ----
    T_a = bev_align._yaw_corrected(q_pose, m_pose, torch.tensor(0.0, device=dev))
    T_a16 = T_a.reshape(16).contiguous()
    center = m_pose[:3, 3].contiguous()
    k7_call = lambda: bev_align.bev_raster(q_pts, q_mask, T_a16, m_world, m_mask, center)
    ik, ip = k7_call(), bev_align.bev_raster_plain(q_pts, q_mask, T_a16, m_world, m_mask, center)
    as_bits = lambda t: torch.view_as_real(t).view(torch.int32)
    n_diff = int((as_bits(ik) != as_bits(ip)).any(-1).sum())
    occ = int(ip.real.sum())
    # bytes: what the kernel loads, each once (a query point's x, y, z and
    # mask, a matched point's x, y and mask, T_a's first two rows, the
    # centre's x and y), both complex64 images written; the query's
    # transform 12 operations a point, the cell 6 a point of either cloud
    row("bev_raster", float(n_diff), 0, k7_call,
        time_ms(lambda: bev_align.bev_raster_plain(q_pts, q_mask, T_a16, m_world, m_mask,
                                                   center)),
        n_q * 13 + n_m * 9 + 32 + 8 + 2 * 128 * 128 * 8, n_q * 18 + n_m * 6,
        note=f"{occ} occupied cells of 2 x 128 x 128; err = cells not bit-equal to the twin's "
             f"(complex64, imaginary parts 0)")
    check_one_launch(rows, "bev_raster", "bev_align", "bev_raster_kernel", [k7_call],
                     expect={},
                     note="the images' bitmaps in shared memory, merged over the cluster, "
                          "every complex cell written: no fill, no cast")
    # the raster as the parent issued it was a memset, K7 and two casts to
    # complex64: this tree's one record is the comparable device time
    k7_records = device_records(k7_call)
    off_call = lambda: bev_align.bev_translation_offset(q_pts, q_mask, m_world, m_mask, center,
                                                        T_a=T_a)
    off_ms, off_records = device_ms(off_call), device_records(off_call)
    print(f"  bev_raster with its casts (the images as the FFT takes them): {k7_records} device "
          f"record(s), {fmt_ms(rows['bev_raster']['device_ms'])} on the device; the whole "
          f"bev_translation_offset: {off_records} device records, {fmt_ms(off_ms)} on the "
          f"device", flush=True)
    if k7_records != 1:
        fail(f"bev_raster: {k7_records} device records a call, expected 1")
    rows["bev_raster"].update(device_records=k7_records, offset_device_ms=off_ms,
                              offset_device_records=off_records)
    T_init = icp.loop_prealign(q_pose, m_pose, torch.tensor(0.0, device=dev), q_pts, q_mask,
                               m_pts, m_mask)
    print(f"  loop query's prealigned T_init: {T_init[:3].flatten().tolist()}", flush=True)

    # ---- K6a point_grid (the coarse 2 m and fine 0.5 m tables of the matched keyframe) ----
    grid_calls = []
    for label, bin_size in (("coarse", cfg.map_voxel_size * 4.0), ("fine", cfg.map_voxel_size)):
        inv_b = K.f32(1.0 / K.f32(bin_size))
        key = torch.where(m_mask, K.sort_key(*K.pack_key(K.voxel_coords(m_world, inv_b))),
                          K.INVALID_SORT_KEY)
        ks, idx = torch.sort(key, stable=True)
        ps_ = m_world[idx].contiguous()
        gk, mk = knn.point_grid(ks, ps_, inv_b)
        gp, mp = knn.point_grid_plain(ks, ps_, inv_b)
        n_bins = int((gp != n_m).sum())
        call = lambda ks=ks, ps_=ps_, inv_b=inv_b: knn.point_grid(ks, ps_, inv_b)
        grid_calls.append(call)
        # bytes: every key and point read, the whole grid and meta written
        args = (float((gk != gp).sum() + (mk != mp).sum()), 0, call,
                time_ms(lambda ks=ks, ps_=ps_, inv_b=inv_b: knn.point_grid_plain(ks, ps_, inv_b)),
                n_m * 20 + gk.numel() * 4 + 20, n_m * 12)
        note = (f"{label}: {n_bins} occupied {bin_size:g} m bins, fits={int(mk[3])}; err = "
                f"differing grid and meta entries")
        if label == "coarse":
            row("point_grid", *args, note=note)
            table = knn.PointTable(key=ks, pts=ps_, grid=gk, meta=mk, inv=inv_b)
        else:
            one = {}
            record(one, "point_grid", *args, note=note)
            rows["point_grid"]["fine"] = one["point_grid"]
    check_one_launch(rows, "point_grid", "knn", "point_grid_kernel", grid_calls,
                     expect=knn.POINT_GRID_SHAPE,
                     note="16 clusters of 8, each filling and scattering a sixteenth of "
                          "the grid; no torch fill")

    # ---- K6b point_knn (k = 5) and point_nn1 (k = 1) ----
    # (label, kernel, k, table, r, W): the coarse shape (each kernel's row),
    # then point_knn at the polish width on the coarse table (which fits the
    # dense window) and on the fine table of the polish phase, and at r = 2
    # and the solve's default width on the fine table, which does not fit
    qw = lie.transform_points(T_init, q_pts).contiguous()
    fine = knn.build_point_table(m_world, m_mask, bin_size=cfg.map_voxel_size)
    if bool(fine.fits) or not bool(table.fits):
        fail(f"point_knn: the {cfg.map_voxel_size * 4.0} m table fits={bool(table.fits)}, the "
             f"{cfg.map_voxel_size} m table fits={bool(fine.fits)}: the shapes need the first "
             f"to fit the dense window and the second not")
    shapes = [("coarse", "point_knn", 5, table, 1, 8), ("coarse", "point_nn1", 1, table, 1, 8),
              ("polish", "point_knn", 5, table, 1, 4),
              ("polish, fine table", "point_knn", 5, fine, 1, 4),
              ("r 2, fine table", "point_knn", 5, fine, 2, 16)]
    calls = {}
    for label, name, k, tb, r, w in shapes:
        call = lambda tb=tb, k=k, r=r, w=w: knn.knn_query(tb, qw, k=k, radius=r, bucket_width=w)
        plain = lambda tb=tb, k=k, r=r, w=w: knn.knn_query_plain(tb, qw, k=k, radius=r,
                                                                 bucket_width=w)
        calls.setdefault(name, []).append(call)
        nk, ok_k, dk = call()
        np_, ok_p, dp = plain()
        fin = torch.isfinite(dp)
        if not (torch.equal(ok_k, ok_p) and torch.equal(nk, np_)
                and torch.equal(torch.isfinite(dk), fin)):
            fail(f"{name} ({label}): other neighbours, flags or infinite distances than the "
                 f"plain version")
        err = float((dk[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0
        # bytes: the queries, the grid entries (a table that fits) and table
        # rows this run probes, and the k winners written
        qc = K.voxel_coords(qw, tb.inv)
        offs = torch.as_tensor(knn._neighbor_offsets(r), device=dev)
        lin = K.sort_key(*K.pack_key((qc[:, None, :] + offs[None]).reshape(-1, 3)))
        n_probe = int(torch.unique(lin).numel())
        n_bins = (2 * r + 1) ** 3
        args = (err, 1e-5, call, time_ms(plain),
                n_q * 12 + n_probe * 4 * int(tb.fits) + n_m * 20 + 20 + n_q * k * 17,
                n_q * n_bins * w * 10)
        note = (f"{label}: {n_q} queries x {n_bins} bins x {w}, {1 / tb.inv:g} m bins, "
                f"fits={int(tb.fits)}, {int(ok_k.sum())} neighbours found; {n_probe} distinct "
                f"bins probed")
        if label == "coarse":
            row(name, *args, note=note)
        else:
            one = {}
            record(one, name, *args, note=note)
            rows[name].setdefault("shapes", {})[label] = one[name]
    for name, k in (("point_knn", 5), ("point_nn1", 1)):
        check_one_launch(rows, name, "knn", f"point_knn_kernelILi{k}E", calls[name],
                         note="a warp a query, 8 queries a block")

    # ---- K5b plane_fit_5nn at the loop solve's shape: K6b's k = 5 output ----
    nb, nb_ok, _ = knn.knn_query(table, qw, k=5, radius=1, bucket_width=8)
    fit = icp.plane_fit_5nn(qw, nb, nb_ok, q_mask, icfg, gate=False)
    gap = k5b_gaps(fit, icp.plane_fit_5nn_plain(qw, nb, nb_ok, q_mask, icfg, gate=False), nb,
                   nb_ok)
    if gap["sel_rows"] or gap["flips"]:
        fail(f"plane_fit_5nn (loop shape): {gap['sel_rows']} rows chose other candidates and "
             f"{gap['flips']} validity flags differ from the plain version")
    one = {}
    fit_call = lambda: icp.plane_fit_5nn(qw, nb, nb_ok, q_mask, icfg, gate=False)
    record(one, "plane_fit_5nn", gap["err"], 1e-4, fit_call,
           time_ms(lambda: icp.plane_fit_5nn_plain(qw, nb, nb_ok, q_mask, icfg, gate=False)),
           *k5b_bytes_ops(fit, nb_ok),
           note=f"the loop shape: {n_q} rows x 5 candidates (point_knn's), ungated; "
                f"{int(fit.valid.sum())} valid, {int((~gap['well'] & q_mask).sum())} masked-in "
                f"rows with an ill-conditioned normal left out of the comparison")
    rows["plane_fit_5nn"] = dict(rows_in["plane_fit_5nn"], loop_shape=one["plane_fit_5nn"])
    check_one_launch(rows, "plane_fit_5nn", "grid_knn", "plane_fit_kernel", [fit_call],
                     note="k = 5: a group of 8 lanes a point, 32 points a block")

    # ---- K2b with the loop's weight residual (one coarse step) ----
    r_nn = torch.sum(fit.normal * (qw - fit.nearest), -1).contiguous()
    flags = torch.zeros((3,), dtype=torch.int32, device=dev)
    aux, scale = icp._scale_and_alpha(fit.dist, fit.valid, flags,
                                      torch.ones((1,), device=dev), True, consts, icfg)
    T16 = T_init.reshape(16).contiguous()
    args = (q_pts, fit.normal, r_nn, fit.valid, T16, scale, flags, aux, consts, icfg)
    Tk, fk, hk = icp.icp_normal_eq(*args, rw=fit.dist)
    Tp, fp_, _ = icp.icp_normal_eq_plain(*args, rw=fit.dist)
    if not torch.equal(fk, fp_):
        fail(f"icp_normal_eq (weight residual): flags {fk.tolist()} vs plain {fp_.tolist()}")
    if not all(torch.equal(a, b) for a, b in zip(icp.icp_normal_eq(*args, rw=fit.dist),
                                                 (Tk, fk, hk))):
        fail("icp_normal_eq (weight residual): two calls differ")
    err = float((Tk - Tp).abs().max())
    ms_k = time_ms(lambda: icp.icp_normal_eq(*args, rw=fit.dist))
    dev_k = device_ms(lambda: icp.icp_normal_eq(*args, rw=fit.dist))
    ms_p = time_ms(lambda: icp.icp_normal_eq_plain(*args, rw=fit.dist))
    b, by = bound_ms(n_q * (12 + 12 + 4 + 4 + 1) + 64 + 28 + 64 + 12 + 108,
                     int(fit.valid.sum()) * 90)
    print(f"  {'icp_normal_eq (loop)':22s} max_abs_err {err:.3e} (tol 1e-05) "
          f"{'ok' if err <= 1e-5 else 'FAIL'} | kernel {ms_k:.4f} ms"
          + (f" (device {dev_k:.4f} ms)" if dev_k is not None else "")
          + f", plain {ms_p:.4f} ms, "
          f"bound {b:.5f} ms ({by}) | the loop's coarse step: residual to the nearest "
          f"neighbour, weights from the plane distance; two calls bit-equal", flush=True)
    if err > 1e-5:
        fail(f"icp_normal_eq with a weight residual disagrees with its plain version: {err}")
    rows["icp_normal_eq"] = dict(rows_in["icp_normal_eq"],
                                 weight_residual=dict(max_abs_err=err, ms=ms_k, device_ms=dev_k,
                                                      plain_ms=ms_p, bound_ms=b, bound_by=by,
                                                      library_ms=None,
                                                      library_device_ms=None))

    # ---- K8a iris_image, K8b iris_encode (a drain batch of 16 keyframes) ----
    clouds = torch.stack([feats(i)[0] for i in range(0, 32, 2)]).contiguous()
    masks = torch.stack([feats(i)[1] for i in range(0, 32, 2)]).contiguous()
    nb_pts = int(masks.sum())
    bk = iris.iris_bits(clouds, masks)
    bp = iris._iris_bits_plain(clouds, masks)
    n_px = int((bp > 0).sum())
    # the bytes K8a needs: every mask, the coordinates of the masked-in
    # points, every pixel written once
    row("iris_image", float((bk != bp).sum()), max(2, n_px // 1000),
        lambda: iris.iris_bits(clouds, masks),
        time_ms(lambda: iris._iris_bits_plain(clouds, masks)),
        masks.numel() + nb_pts * 12 + bk.numel() * 4, nb_pts * 40,
        note=f"16 keyframes, {n_px} occupied pixels; err = differing pixels (points on a "
             f"ring, height or yaw edge)")
    c1_, m1_ = clouds[:1].contiguous(), masks[:1].contiguous()   # b = 1: the loops path's shape
    bk1 = iris.iris_bits(c1_, m1_)
    one = {}
    record(one, "iris_image", float((bk1 != iris._iris_bits_plain(c1_, m1_)).sum()), 0,
           lambda: iris.iris_bits(c1_, m1_), time_ms(lambda: iris._iris_bits_plain(c1_, m1_)),
           m1_.numel() + int(m1_.sum()) * 12 + bk1.numel() * 4, int(m1_.sum()) * 40,
           note=f"b = 1, the loops path's shape; {int((bk1 > 0).sum())} occupied pixels")
    rows["iris_image"]["b1"] = one["iris_image"]
    check_one_launch(rows, "iris_image", "iris", "iris_image_kernel",
                     [lambda: iris.iris_bits(clouds, masks), lambda: iris.iris_bits(c1_, m1_)],
                     note="a thread a point, atomicOr into the image that the wrapper zeroes",
                     fill=("aten::zeros", "aten::zero_", "aten::fill_"))
    filters = torch.as_tensor(iris.log_gabor_filters(), device=dev)
    spec = torch.fft.fft(bk.to(torch.complex64), dim=-1)
    gk = iris.gabor_product(spec, filters)
    gp = iris.gabor_product_plain(spec, filters)
    filt_c = filters.to(torch.complex64)[None, :, None, :]
    row("gabor_product", float((gk - gp).abs().max()), 0.0,
        lambda: iris.gabor_product(spec, filters),
        time_ms(lambda: iris.gabor_product_plain(spec, filters)),
        spec.numel() * 8 + filters.numel() * 4 + gk.numel() * 8, gk.numel() * 2,
        library=lambda: torch.mul(spec[:, None], filt_c),
        note="16 keyframes x 80 x 360 row spectra x 4 log-Gabor scales; library: one "
             "broadcast torch.mul")
    spec1 = spec[:1].contiguous()   # b = 1: one keyframe's image, as the loops path runs it
    one = {}
    record(one, "gabor_product",
           float((iris.gabor_product(spec1, filters)
                  - iris.gabor_product_plain(spec1, filters)).abs().max()), 0.0,
           lambda: iris.gabor_product(spec1, filters),
           time_ms(lambda: iris.gabor_product_plain(spec1, filters)),
           spec1.numel() * 8 + filters.numel() * 4 + 4 * spec1.numel() * 8, 4 * spec1.numel() * 2,
           library=lambda: torch.mul(spec1[:, None], filt_c),
           note="b = 1, the loops path's shape")
    rows["gabor_product"]["b1"] = one["gabor_product"]
    resp = iris._responses(bk.to(torch.float32), filters).contiguous()
    Tk8, Mk8 = iris.iris_encode(resp)
    Tp8, Mp8 = iris.iris_encode_plain(resp)
    row("iris_encode", float((Tk8 != Tp8).sum() + (Mk8 != Mp8).sum()), 0,
        lambda: iris.iris_encode(resp),
        time_ms(lambda: iris.iris_encode_plain(resp)),
        resp.numel() * 8 + 2 * Tk8.numel() * 4, resp.numel() * 10,
        note="16 keyframes x 4 scales x 80 x 360 responses; err = differing code words")
    resp1 = resp[:1].contiguous()   # b = 1: one keyframe, as the loops path runs it
    Tk1, Mk1 = iris.iris_encode(resp1)
    Tp1, Mp1 = iris.iris_encode_plain(resp1)
    record(one, "iris_encode", float((Tk1 != Tp1).sum() + (Mk1 != Mp1).sum()), 0,
           lambda: iris.iris_encode(resp1), time_ms(lambda: iris.iris_encode_plain(resp1)),
           resp1.numel() * 8 + 2 * Tk1.numel() * 4, resp1.numel() * 10,
           note="b = 1, the loops path's shape")
    rows["iris_encode"]["b1"] = one["iris_encode"]
    z, _ = synthetic.iris_threshold_responses(3, iris.MAG_SQ_THRESHOLD, seed=3)
    edge = torch.as_tensor(z, device=dev)
    Tke, Mke = iris.iris_encode(edge)
    Tpe, Mpe = iris.iris_encode_plain(edge.cpu())
    n_edge = int((Tke.cpu() != Tpe).sum() + (Mke.cpu() != Mpe).sum())
    print(f"  iris_encode at its threshold (b = 3, squared magnitudes on and beside x0 = "
          f"{iris.MAG_SQ_THRESHOLD!r}, NaN, +-inf, +-0): {n_edge} words differ from the CPU "
          f"twin's", flush=True)
    if n_edge:
        fail(f"iris_encode: {n_edge} words differ from the twin at the magnitude threshold")
    rows["iris_encode"]["threshold_words_differing"] = n_edge
    check_one_launch(rows, "iris_encode", "iris", "iris_encode_kernel",
                     [lambda: iris.iris_encode(resp), lambda: iris.iris_encode(resp1)])

    # ---- K8c iris_hamming (a query against 32 candidates of the DB, and the loops path's K) ----
    img8 = bk.to(torch.uint8)
    ham_calls, ham_shapes = [], ((32, 30),) + LOOP_CANDIDATES
    for k8, n_valid in ham_shapes:
        # 32: rows 0-15 twice, the query's own row among them; the loops
        # path's K: the next rows, padding slots last
        cand = (torch.arange(k8, device=dev, dtype=torch.int32) + int(k8 < 32)) % 16
        valid = torch.arange(k8, device=dev) < n_valid
        shifts = iris.phase_shifts(img8[0].float(), img8[cand.long()].float())
        hk = iris.iris_hamming(Tk8, Mk8, 0, cand, shifts, valid)
        hp = iris.iris_hamming_plain(Tk8, Mk8, 0, cand, shifts, valid)
        if not torch.equal(hk[:, 1], hp[:, 1]):
            fail(f"iris_hamming (K = {k8}): biases differ from the plain version")
        n_bits = int((hk.view(torch.int32) != hp.view(torch.int32)).sum())
        if n_bits:
            fail(f"iris_hamming (K = {k8}): {n_bits} distances or biases not bit-equal to the "
                 f"plain version's")
        fin = torch.isfinite(hp[:, 0])
        call = lambda cand=cand, shifts=shifts, valid=valid: iris.iris_hamming(
            Tk8, Mk8, 0, cand, shifts, valid)
        ham_calls.append(call)
        # bytes: the DB rows read (the query's and each distinct candidate's
        # T and M), the indices, shifts and flags, the output
        n_rows = int(torch.unique(torch.cat([cand, cand.new_zeros(1)])).numel())
        args = (float((hk[fin, 0] - hp[fin, 0]).abs().max()) if bool(fin.any()) else 0.0, 1e-6,
                call, time_ms(lambda cand=cand, shifts=shifts, valid=valid:
                              iris.iris_hamming_plain(Tk8, Mk8, 0, cand, shifts, valid)),
                n_rows * 2 * 7200 * 4 + k8 * (4 + 8 + 1 + 8), k8 * 10 * 7200 * 6)
        note = (f"{k8} candidates ({n_valid} valid, {int(torch.unique(cand).numel())} distinct "
                f"rows), best distance {float(hk[:, 0].min()):.4f}; distances and biases "
                f"bit-equal to the twin's")
        if k8 == 32:
            row("iris_hamming", *args, note=note)
        else:
            one = {}
            record(one, "iris_hamming", *args, note=note + "; a K of the loops path")
            rows["iris_hamming"][f"k{k8}"] = one["iris_hamming"]
    check_one_launch(rows, "iris_hamming", "iris", "iris_hamming_kernel", ham_calls,
                     expect=iris.HAMMING_SHAPE,
                     grids=[iris.HAMMING_SHAPE["cluster"] * k for k, _ in ham_shapes],
                     note="a cluster a candidate")
    cand = torch.arange(32, device=dev, dtype=torch.int32) % 16   # the 32 candidates, for K7c

    # ---- K7c cross_power (the Iris queries' spectra; the prealign's) ----
    imgf = img8.float()
    qf = torch.fft.fft2(imgf[0].to(torch.complex64)).reshape(-1)
    k7c_calls = []

    def k7c(rows_to, name, x, y, x2, note):
        """K7c on x (and x2) against y, bit for bit against its twin."""
        ck, cp = bev_align.cross_power(x, y, x2), bev_align.cross_power_plain(x, y, x2)
        n_bits = int((as_bits(ck) != as_bits(cp)).sum())
        if n_bits:
            fail(f"cross_power ({note}): {n_bits} values not bit-equal to the plain version's")
        call = lambda: bev_align.cross_power(x, y, x2)
        n_x = ck.numel()
        record(rows_to, name, float((ck - cp).abs().max()), 1e-6, call,
               time_ms(lambda: bev_align.cross_power_plain(x, y, x2)),
               2 * n_x * 8 + y.numel() * 8, n_x * 14,
               note=note + "; bit-equal to the twin")
        k7c_calls.append(call)

    def iris_spectra(c):
        """The forward and flipped spectra of the candidates c, (K, 28800)
        each, as iris.phase_shifts makes them."""
        cf = imgf[c.long()]
        return (torch.fft.fft2(cf.to(torch.complex64)).reshape(c.shape[0], -1),
                torch.fft.fft2(torch.roll(cf, 180, -1).to(torch.complex64)).reshape(
                    c.shape[0], -1))

    fd32, fdx32 = iris_spectra(cand)
    k7c(rows, "cross_power", fd32, qf, fdx32,
        note="32 candidates x (forward, flipped) x 80 x 360 against the query's spectrum, "
             "as two tensors")
    for k in K7C_CANDIDATES:
        one = {}
        fd, fdx = iris_spectra((torch.arange(k, device=dev, dtype=torch.int32) + 1) % 16)
        k7c(one, "cross_power", fd, qf, fdx, note=f"K = {k}, a K of the loops path")
        rows["cross_power"][f"k{k}"] = one["cross_power"]
    f_bev = torch.fft.fft2(ip)
    fa, fb = f_bev[0].reshape(-1), f_bev[1].reshape(1, -1)
    sub = {}
    k7c(sub, "cross_power", fb, fa, None, note="the prealign's 128 x 128 BEV spectra")
    rows["cross_power"]["prealign"] = sub["cross_power"]
    check_one_launch(rows, "cross_power", "bev_align", "cross_power_kernel", k7c_calls,
                     note="a thread a column pair of a row")
    # the Iris query at the loops path's K = 4: one K7c launch over the
    # forward and flipped spectra as they lie, no concatenation
    cand4 = imgf[(torch.arange(4, device=dev) + 1) % 16]
    q_call = lambda: iris.phase_shifts(imgf[0], cand4)
    n_q, q_ops = launches_of(q_call, "cross_power")
    q_records = device_records(q_call)
    print(f"  phase_shifts (K = 4): {n_q} cross_power launch, {q_records} device records a "
          f"call, torch ops that launch {q_ops}", flush=True)
    if n_q != 1 or "aten::cat" in q_ops:
        fail(f"phase_shifts: {n_q} cross_power launches beside the torch ops {q_ops}")
    rows["cross_power"]["phase_shifts_k4"] = dict(device_records=q_records, torch_ops=q_ops)

    # ---- K9a map_bulk_index (the fresh index of the surfel path's map) ----
    corr = torch.as_tensor(lq["drift"], device=dev)
    cen, cnt, live, cap, _ = vm.rehash_records(surfel_map, corr)
    plan = vm.bulk_plan(cen, cnt, live, cap, surfel_map.c1, voxel_size=cfg.map_voxel_size)
    c1 = surfel_map.c1
    bargs = vm.bulk_parents(plan.s_key, plan.first, cap, c1, plan.fresh.n_buckets)
    k9a_calls = []

    def k9a(rows_to, name, bargs, c1, what):
        """K9a at n = c1 against its twin; the bytes it needs: the sorted
        buckets and permutation of the live parents (a dead one sorts
        after every live one, so none is needed), the placed keys' bits,
        their index cells and meta rows, the count."""
        fk, fp9 = vm.empty_map(0, c1, device=dev), vm.empty_map(0, c1, device=dev)
        n_k = vm.map_bulk_index(*bargs, fk.l1_index, fk.l1_meta, c1)
        n_p = vm.map_bulk_index_plain(*bargs, fp9.l1_index, fp9.l1_meta, c1)
        if int(n_k) != int(n_p):
            fail(f"map_bulk_index ({what}): {int(n_k)} parents placed vs plain {int(n_p)}")
        n_par = int((bargs[0] < vm._n_buckets(c1)).sum())
        call = lambda: vm.map_bulk_index(*bargs, fk.l1_index, fk.l1_meta, c1)
        record(rows_to, name, float((fk.l1_index != fp9.l1_index).sum()
                                    + (fk.l1_meta != fp9.l1_meta).sum()), 0, call,
               time_ms(lambda: vm.map_bulk_index_plain(*bargs, fp9.l1_index, fp9.l1_meta, c1)),
               n_par * (8 + 8) + int(n_k) * (8 + 12 + 16) + 4, n_par * 10,
               note=f"{what}: n {c1}, {n_par} distinct parents, {int(n_k)} placed; err = "
                    f"differing index and meta entries")
        k9a_calls.append(call)

    k9a(rows, "map_bulk_index", bargs, c1, "the surfel path's map")
    # the sharded path's per-shard shape: shard 0's records of 4 at c1 / 4
    # (sharded_map.sharded_transform_and_rehash's owner split)
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    c1s = c1 // SHARDS
    own = so.shard_owner(cen.contiguous(), SHARDS, so.owner_inv(cfg.map_voxel_size, 3))
    plan_s = vm.bulk_plan(cen, cnt, live & (own == 0), cap, c1s, voxel_size=cfg.map_voxel_size)
    one = {}
    k9a(one, "map_bulk_index", vm.bulk_parents(plan_s.s_key, plan_s.first, cap, c1s,
                                               plan_s.fresh.n_buckets), c1s,
        f"the sharded path's shard 0 of {SHARDS}")
    rows["map_bulk_index"]["shard"] = one["map_bulk_index"]
    check_one_launch(rows, "map_bulk_index", "rehash", "bulk_index_kernel", k9a_calls,
                     expect=vm.BULK_INDEX_SHAPE,
                     note="one cluster; the cell positions in a global scratch of n ints")

    # ---- K9b map_bulk_merge (the rehash of the surfel path's map; a shard's) ----
    k9b_calls = []

    def k9b(rows_to, name, plan, c1, what):
        """K9b against its twin, bit for bit; the library call: index_add_
        of each live record's [count | sum] at its child row, given the
        rows. The bytes it needs: the live records' leader flags, keys,
        indices, counts and centroids, one dead key (where the live records
        end), a bucket row probed and a row written per merged voxel, the
        counts (a dead record's flag, key and index are not needed: dead
        records sort last)."""
        l0k, l0p = plan.fresh.l0_data.clone(), plan.fresh.l0_data.clone()
        args = (plan.s_key, plan.s_idx, plan.first, plan.counts, plan.centroids,
                plan.fresh.l1_index)
        a_k = vm.map_bulk_merge(l0k, *args)
        a_p = vm.map_bulk_merge_plain(l0p, *args)
        if not torch.equal(a_k, a_p):
            fail(f"map_bulk_merge ({what}): placed/dropped {a_k.tolist()} vs plain "
                 f"{a_p.tolist()}")
        n_bits = int((l0k.view(torch.int32) != l0p.view(torch.int32)).sum())
        if n_bits:
            fail(f"map_bulk_merge ({what}): {n_bits} values not bit-equal to the plain version's")
        again = vm.map_bulk_merge(l0k, *args)
        if not torch.equal(again, a_k):
            fail(f"map_bulk_merge ({what}): a second call counted {again.tolist()}, the first "
                 f"{a_k.tolist()}")
        err = float(((l0k - l0p).abs() / l0p.abs().clamp(min=1.0)).max())
        n_rec = plan.s_key.shape[0]
        ok_s = plan.s_key != K.INVALID_SORT_KEY
        n_live, n_merged = int(ok_s.sum()), int(plan.first.sum())
        rec_row = torch.full((n_rec,), c1 * 27, dtype=torch.int64, device=dev)
        coords = K.unpack_key(*K.split_sort_key(plan.s_key))
        par = torch.div(coords, 3, rounding_mode="floor")
        pslot, phit, _, _ = vm.bucket_find(plan.fresh.l1_index, *K.pack_key(par))
        rec_row[plan.s_idx] = torch.where(ok_s & phit, pslot.clamp(min=0) * 27
                                          + vm._child_offset_of(coords), c1 * 27)
        data4 = torch.cat([plan.counts[:, None], plan.centroids * plan.counts[:, None]], 1)
        l0_lib = plan.fresh.l0_data.clone()
        call = lambda: vm.map_bulk_merge(l0k, *args)
        record(rows_to, name, err, 1e-5, call,
               time_ms(lambda: vm.map_bulk_merge_plain(l0p, *args)),
               n_live * (1 + 16 + 16) + 8 + n_merged * (128 + 16) + 8, n_live * 8,
               library=lambda: l0_lib.index_add_(0, rec_row, data4),
               note=f"{what}: M {n_rec}, {n_live} live records, {n_merged} merged voxels, "
                    f"placed/dropped {a_k.tolist()}; err is relative, the rows bit-equal to "
                    f"the twin's")
        k9b_calls.append(call)

    k9b(rows, "map_bulk_merge", plan, c1, "the surfel path's map")
    one = {}
    k9b(one, "map_bulk_merge", shard_merge_plan(cen, cnt, live, cfg.map_voxel_size), c1s,
        f"the sharded path's shard 0 of {SHARDS}")
    rows["map_bulk_merge"]["shard"] = one["map_bulk_merge"]
    check_one_launch(rows, "map_bulk_merge", "rehash", "bulk_merge_kernel", k9b_calls,
                     note="a warp a tile of 32 records; no zero fill")
    recs = [device_records(c) for c in k9b_calls]
    print(f"  map_bulk_merge: device records a call {recs}", flush=True)
    if recs != [1] * len(recs):
        fail(f"map_bulk_merge: {recs} device records a call, not one")
    rows["map_bulk_merge"]["device_records_a_call"] = recs
    return rows


def shard_merge_plan(cen, cnt, live, voxel_size: float):
    """K9b's shape on the sharded path: sharded_transform_and_rehash
    gathers every shard's L0 rows (SHARDS x C1 / SHARDS x 27 records) and
    shard 0 bulk-builds the records it owns. Here the single map's records
    (cen, cnt, live) padded with dead ones to that count, shard 0's live
    ones, its bulk plan at c1 C1 / SHARDS."""
    import torch
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    c1s = C1 // SHARDS
    pad = SHARDS * c1s * vm.NCH - cen.shape[0]
    cen = torch.cat([cen, cen.new_zeros((pad, 3))]).contiguous()
    cnt = torch.cat([cnt, cnt.new_zeros((pad,))])
    live = torch.cat([live, live.new_zeros((pad,))])
    own = so.shard_owner(cen, SHARDS, so.owner_inv(voxel_size, 3))
    return vm.bulk_plan(cen, cnt, live & (own == 0), c1s * vm.NCH, c1s, voxel_size=voxel_size)


def make_pgo_graph():
    """The KITTI-00-sized pose graph: PGO_N keyframes 1 m apart on a 250 m x
    120 m stadium circuit (4.2 laps), odometry drifting 2 cm and 2 mrad a
    keyframe, PGO_LOOPS loop edges with the true relative pose, a prior at
    keyframe 0; information 1e4 on the prior, 1e4 (rotation) and 1e2
    (translation) on every between factor. Returns (initial poses, priors,
    betweens, true poses)."""
    from lidar_odometry_tpu_torch.io import synthetic
    return synthetic.revisit_pose_graph(PGO_N, PGO_LOOPS, seed=PGO_SEED)


def check_pgo_kernels(graph):
    """K10a-K10d against their plain twins on the full-width graph, one GN
    iteration's inputs (the first), each kernel fed its twin's inputs: an
    error relative to the output's largest magnitude of at most 1e-10 (the
    information blocks reach ~1e4), K10c's backward error (below), 1e-9 m
    on the retracted poses. The bounds are f64: bytes / 3.35 TB/s or f64
    operations / 67 TFLOP/s."""
    import torch
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo

    dev = DEVICE
    rows = {}
    init, priors, betweens, _ = graph
    pk = dpgo.pack_graph(init, priors, betweens)
    g = dpgo.upload(pk, dev)
    poses = g["poses"]
    n_pad, D, max_m, L = pk.n_pad, pk.D, pk.max_m, pk.L
    P_v, M_v = len(priors), len(betweens)
    n_rows = int(pk.i32["valid"].sum())
    n_adj = int(pk.i32["adj_mask"].sum())
    print(f"  pgo graph: {PGO_N} keyframes padded to {n_pad}, {M_v} between factors "
          f"({M_v - PGO_N + 1} loops), D = {D} partitions, max_m = {max_m} rows, "
          f"{n_rows} interior rows, reduced system {6 * D} x {6 * D}", flush=True)
    shape = dpgo.reduced_solve_shape()
    print(f"  pgo_reduced_solve launch: a cluster of {shape['cluster']} CTAs x "
          f"{shape['threads']} threads, {shape['smem_bytes']} B of shared memory each, "
          f"panels of {shape['panel']} columns", flush=True)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max()), float((a - b).abs().max())

    def row(name, errs, tol, kernel, plain_ms, nbytes, ops, library=None, note=""):
        """errs: (compared error, max abs error) of each output."""
        err = max(e[0] for e in errs)
        record(rows, name, err, tol, kernel, plain_ms, nbytes, ops, library, note,
               ops_per_s=FP64_OPS_PER_S)
        rows[name].update(max_abs_err=max(e[1] for e in errs), compared_err=err)

    lin_args = [g[k] for k in dpgo.LIN_KEYS]
    lin_k = dpgo.linearize(g, poses)
    lin_p = dpgo.linearize_plain(poses, *lin_args)
    row("pgo_linearize", [rel(a, b) for a, b in zip(lin_k, lin_p)], 1e-10,
        lambda: dpgo.linearize(g, poses), time_ms(lambda: dpgo.linearize_plain(poses, *lin_args)),
        *linearize_bytes_ops(pk, P_v, M_v),
        note=f"{P_v} prior, {M_v} between factors; diag, off, b, lb; err relative")
    if not all(torch.equal(a, c) for a, c in zip(lin_k, dpgo.linearize(g, poses))):
        fail("pgo_linearize: two calls differ")
    check_one_launch(rows, "pgo_linearize", "pgo", "linearize_kernel",
                     [lambda: dpgo.linearize(g, poses)], note=LINEARIZE_STACK_NOTE,
                     stack=LINEARIZE_STACK)
    check_linearize_second_size(rows)

    diag, off, b, lb = lin_p
    plan = [g[k] for k in dpgo.PLAN_KEYS]
    el_k = dpgo.eliminate(g, diag, off, b)
    el_p = dpgo.eliminate_plain(diag, off, b, *plan)
    row("pgo_eliminate", [rel(a, c) for a, c in zip(el_k, el_p)], 1e-10,
        lambda: dpgo.eliminate(g, diag, off, b),
        time_ms(lambda: dpgo.eliminate_plain(diag, off, b, *plan), reps=3),
        n_rows * (288 + 48 + 288) + D * (2 * 288 + 4 * 288 + 96)
        + D * max_m * (2 * 288 + 48) + D * max_m * 4 * 8, n_rows * 2900,
        note=f"{D} partitions x {max_m} rows, {n_rows} valid; S, r, F, G, g; err relative; "
             f"the earlier one-warp kernel: 4.2299 ms on the device (H100 80GB HBM3, "
             f"700.00 W)")
    check_eliminate_edges(g, lin_p, poses, el_k)

    S, r = el_p[0], el_p[1]
    red = [g[k] for k in dpgo.RED_KEYS]
    xs_k = dpgo.reduced_solve(g, diag, off, b, lb, S, r)
    xs_p, Hs, bs = dpgo.reduced_solve_plain(diag, off, b, lb, S, r, *red)
    N = 6 * D
    # The separator system of a 3700-keyframe chain is ill-conditioned
    # (kappa ~5e9), so two correct solves differ in xs by up to
    # kappa * eps: LAPACK's own LU and Cholesky solves of this Hs differ by
    # ~3e-10 of max|xs|. The kernel's solve is therefore held to its
    # normwise backward error in the twin's system, |Hs x - bs| / (|Hs|
    # |x|), at 1e-13 (N eps = 4.9e-14 at N = 438); its difference from the
    # twin's xs and kappa are printed beside it.
    inf = lambda t: float(t.abs().max())
    backward = inf(Hs @ xs_k.reshape(-1) - bs) / (float(Hs.abs().sum(1).max()) * inf(xs_k))
    forward, fwd_abs = rel(xs_k, xs_p)
    kappa = float(torch.linalg.cond(Hs))
    row("pgo_reduced_solve", [(backward, fwd_abs)], 1e-13,
        lambda: dpgo.reduced_solve(g, diag, off, b, lb, S, r),
        time_ms(lambda: dpgo.reduced_solve_plain(diag, off, b, lb, S, r, *red)),
        D * (288 + 4 * 288 + 96 + 48 + 48) + n_adj * 288 + L * 300,
        N ** 3 / 3 + 2 * N ** 2 + 4 * N ** 2,
        library=lambda: torch.linalg.solve_ex(Hs, bs, check_errors=False),
        note=f"xs of the {N} x {N} separator system (kappa {kappa:.3e}); err = normwise "
             f"backward error; xs differs from the twin's by {forward:.3e} of max|xs|; "
             f"library: torch.linalg.solve_ex on the assembled Hs, no error check")
    rows["pgo_reduced_solve"].update(forward_rel_err=forward, kappa=kappa)
    xs_2 = dpgo.reduced_solve(g, diag, off, b, lb, S, r)
    if not torch.equal(xs_k, xs_2):
        fail("pgo_reduced_solve: two calls differ")
    check_reduced_second_size()

    F, G, gv = el_p[2:]
    back = [g[k] for k in dpgo.BACK_KEYS]
    p_p, dxn, ok = dpgo.backsub_retract_plain(poses, xs_p, F, G, gv, *back, g["real_mask"])
    p_k = poses.clone()
    dpgo.backsub_retract(g, p_k, xs_p, F, G, gv, 10, 1e-6)
    st = g["st"].cpu().tolist()
    dxf = float(dxn)
    if not (bool(ok) and st[0] == 1 and st[2] == 1 and abs(st[1] - dxf) <= 1e-9 * dxf):
        fail(f"pgo_backsub_retract: loop state {st} vs plain |dx| {float(dxn)}, ok {bool(ok)}")
    err = float((p_k - p_p).abs().max())
    scratch = poses.clone()
    # timed with tol 0 and an unbounded max_iters on a scratch copy, so that
    # every call runs (the loop state would otherwise stop it)
    row("pgo_backsub_retract", [(err, err)], 1e-9,
        lambda: dpgo.backsub_retract(g, scratch, xs_p, F, G, gv, 1 << 30, 0.0),
        time_ms(lambda: dpgo.backsub_retract_plain(poses, xs_p, F, G, gv, *back,
                                                   g["real_mask"])),
        D * 48 + n_rows * (288 * 2 + 48) + n_pad * (12 + 2 * 128) + 32,
        n_rows * 156 + n_pad * 170,
        note=f"{n_pad} poses, |dx| {float(dxn):.4e}; err = max abs pose-entry difference")
    check_one_launch(rows, "pgo_backsub_retract", "pgo", "backsub_kernel",
                     [lambda: dpgo.backsub_retract(g, scratch, xs_p, F, G, gv, 1 << 30, 0.0)],
                     expect=dpgo.BACKSUB_SHAPE, note="its 40-byte stack is the double sin and cos's "
                     "slow-path argument reduction, which retract keeps as it was", stack=40)
    check_backsub_past_one_cluster(rows)
    return rows


def linearize_bytes_ops(pk, n_priors: int, n_betweens: int):
    """K10a's bytes (each input that linearize_kernel takes read once,
    each output written once) and f64 operations on a packed graph: the
    poses, pad_reg and both lists' pointers; a prior's meas and sqrtI; a
    between factor's from, to, meas and sqrtI (the lists carry each
    factor's pose and validity); the lists; a loop edge's loop_bt and
    loop_valid; the loop state; diag, b, off and lb."""
    n_pad, L = pk.n_pad, pk.L
    n_inc, n_chain = pk.i32["inc_ent"].size, pk.i32["chain_ent"].size
    return (n_pad * (128 + 8) + 2 * (n_pad + 1) * 4 + n_pad * (288 + 48) + (n_pad - 1) * 288
            + n_priors * (128 + 288) + n_betweens * (8 + 128 + 288)
            + (n_inc + n_chain) * 4 + L * (8 + 288) + 32,
            n_priors * 600 + n_betweens * 2000 + n_inc * 42 + n_chain * 36)


def check_linearize_second_size(rows, n: int = 7400, n_loops: int = 64):
    """K10a at n_pad 8192 (a revisit graph of n keyframes, n_loops loop
    edges): within 1e-10 of each output's largest magnitude of the twin,
    two calls bit-equal, its device time and bound."""
    import torch
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    init, priors, betweens, _ = synthetic.revisit_pose_graph(n, n_loops, seed=n)
    pk = dpgo.pack_graph(init, priors, betweens)
    g = dpgo.upload(pk, DEVICE)
    poses = g["poses"]
    lin_k = dpgo.linearize(g, poses)
    lin_p = dpgo.linearize_plain(poses, *[g[k] for k in dpgo.LIN_KEYS])
    err = max(float((a - c).abs().max() / c.abs().max().clamp(min=1e-300))
              for a, c in zip(lin_k, lin_p))
    same = all(torch.equal(a, c) for a, c in zip(lin_k, dpgo.linearize(g, poses)))
    fn = lambda: dpgo.linearize(g, poses)
    ms, dev_ms = time_ms(fn), device_ms(fn)
    b, by = bound_ms(*linearize_bytes_ops(pk, len(priors), len(betweens)), FP64_OPS_PER_S)
    print(f"  pgo_linearize at n_pad {pk.n_pad} ({n} keyframes, {len(betweens)} between factors, "
          f"{n_loops} loops): {err:.3e} of the twin's largest (tol 1e-10), two calls "
          f"bit-equal: {same} | kernel {ms:.4f} ms (device "
          + ("n/a" if dev_ms is None else f"{dev_ms:.4f}") + f" ms), bound {b:.5f} ms ({by})",
          flush=True)
    if not (err <= 1e-10 and same):
        fail(f"pgo_linearize at n_pad {pk.n_pad}: {err:.3e} from the twin, two calls equal {same}")
    rows["pgo_linearize"].update(
        {f"n_pad_{pk.n_pad}": dict(compared_err=err, ms=ms, device_ms=dev_ms, bound_ms=b,
                                   bound_by=by)})


def check_backsub_past_one_cluster(rows, n_pad: int = 8192):
    """K10d at an n_pad past its one cluster (synthetic.backsub_system, 60
    partitions): poses within 1e-9 of the twin, |dx| within 1e-12
    relative, two calls bit-equal, its device time and bound."""
    import torch
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    a, plan = synthetic.backsub_system(n_pad, 60, seed=n_pad, zero_rows=100)
    g = {k: torch.as_tensor(a[k], device=DEVICE) for k in ("real_mask", "pose_row",
                                                           *dpgo.BACK_KEYS)}
    g["st"] = torch.tensor([0.0, float("inf"), 1.0, 1.0], dtype=torch.float64, device=DEVICE)
    poses, xs, F, G, gv = (torch.as_tensor(a[k], device=DEVICE)
                           for k in ("poses", "xs", "F", "G", "g"))
    back = [g[k] for k in dpgo.BACK_KEYS]
    p_p, dxn, ok = dpgo.backsub_retract_plain(poses, xs, F, G, gv, *back, g["real_mask"])
    p_k, p_2 = poses.clone(), poses.clone()
    dpgo.backsub_retract(g, p_k, xs, F, G, gv, 1 << 30, 0.0)
    st = g["st"].clone()
    g["st"].copy_(torch.tensor([0.0, float("inf"), 1.0, 1.0], dtype=torch.float64))
    dpgo.backsub_retract(g, p_2, xs, F, G, gv, 1 << 30, 0.0)
    err = float((p_k - p_p).abs().max())
    rel = abs(float(st[1]) - float(dxn)) / float(dxn)
    if not (bool(ok) and err <= 1e-9 and rel <= 1e-12 and torch.equal(p_k, p_2)
            and torch.equal(st, g["st"])):
        fail(f"pgo_backsub_retract at n_pad {n_pad}: poses {err:.3e} from the twin, |dx| "
             f"{rel:.3e}, two calls equal {torch.equal(p_k, p_2)}")
    n_rows = int(plan["valid"].sum())
    fn = lambda: dpgo.backsub_retract(g, p_k, xs, F, G, gv, 1 << 30, 0.0)
    ms, dev_ms = time_ms(fn), device_ms(fn)
    b, by = bound_ms(plan["D"] * 48 + n_rows * (288 * 2 + 48) + n_pad * (12 + 2 * 128) + 32,
                     n_rows * 156 + n_pad * 170, FP64_OPS_PER_S)
    print(f"  pgo_backsub_retract at n_pad {n_pad} (past one cluster, {plan['D']} partitions): "
          f"poses {err:.3e} from the twin (tol 1e-09), |dx| {rel:.1e} relative, two calls "
          f"bit-equal | kernel {ms:.4f} ms (device "
          + ("n/a" if dev_ms is None else f"{dev_ms:.4f}") + f" ms), bound {b:.5f} ms ({by})",
          flush=True)
    rows["pgo_backsub_retract"].update(
        {f"n_pad_{n_pad}": dict(max_abs_err=err, ms=ms, device_ms=dev_ms, bound_ms=b,
                                bound_by=by)})


def check_eliminate_edges(g, lin, poses, el_k):
    """K10b beyond its twin comparison: a second call bit-equal to the
    first; the longest partition (max_m rows) longer than the kernel's
    staging ring; and an input that is not positive definite (one
    interior diagonal block of the longest partition negated): NaN in
    every one of that partition's outputs, as in the twin's, the other
    partitions unchanged, and one whole GN iteration on it ending with ok
    false and the poses left as they were."""
    import torch
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo

    diag, off, b, lb = lin
    again = dpgo.eliminate(g, diag, off, b)
    same = all(torch.equal(a, c) for a, c in zip(el_k, again))
    D, max_m = g["int_idx"].shape
    n_valid = g["valid"].sum(1)
    k0 = int(n_valid.argmax())            # the longest partition; its rows are the last m
    m0 = int(n_valid[k0])
    at = max_m - 1 - m0 // 2
    bad = diag.clone()
    pose = int(g["int_idx"][k0, at])
    bad[pose] = -bad[pose]
    plan = [g[k] for k in dpgo.PLAN_KEYS]
    st = torch.tensor(dpgo._state0(10, 1e-6), device=DEVICE)
    g2 = dict(g, st=st)
    S, r, F, G, gv = dpgo.eliminate(g2, bad, off, b)
    S_p = dpgo.eliminate_plain(bad, off, b, *plan)[0]
    nan0 = bool(torch.isnan(S[k0]).all() and torch.isnan(F[k0, max_m - m0:]).all()
                and torch.isnan(S_p[k0]).all())
    others = [j for j in range(D) if j != k0]
    rest = bool(torch.equal(S[others], el_k[0][others])
                and torch.equal(F[others], el_k[2][others]))
    xs = dpgo.reduced_solve(g2, bad, off, b, lb, S, r)
    p = poses.clone()
    dpgo.backsub_retract(g2, p, xs, F, G, gv, 10, 1e-6)
    it, _, ok, active = st.cpu().tolist()
    kept = bool(torch.equal(p, poses))
    ring = 16   # rows the kernel stages at once (csrc/pgo.cu EL_RING)
    print(f"  pgo_eliminate edges: two calls bit-equal: {'yes' if same else 'no'}; the longest "
          f"partition {max_m} rows against a staging ring of {ring}; not positive definite "
          f"(partition {k0}, keyframe {pose}): NaN in all its outputs {'yes' if nan0 else 'no'}, "
          f"the other partitions unchanged {'yes' if rest else 'no'}, after one GN iteration "
          f"ok {bool(ok)}, active {bool(active)}, poses kept {'yes' if kept else 'no'}",
          flush=True)
    if not (same and nan0 and rest and not ok and not active and kept and max_m > ring):
        fail("pgo_eliminate: calls differ, or a matrix that is not positive definite did not "
             "end in NaN and ok false")


def check_reduced_second_size(D: int = 200):
    """K10c on the tests' second size: a synthetic separator system of D =
    200 (a 1200 x 1200 system, 11.5 MB, larger than the cluster's shared
    memory; synthetic.separator_system, 6 loop blocks), held to the same
    backward error, 1e-13, and two calls bit-equal."""
    import torch
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    c = {k: torch.tensor(v, device=DEVICE)
         for k, v in synthetic.separator_system(D, 6, seed=D).items()}
    g = {k: c[k] for k in dpgo.RED_KEYS}
    g["st"] = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64, device=DEVICE)
    args = [c[k] for k in ("diag", "off", "b", "lb", "S", "r")]
    xs_k = dpgo.reduced_solve(g, *args)
    xs_2 = dpgo.reduced_solve(g, *args)
    xs_p, Hs, bs = dpgo.reduced_solve_plain(*args, *[g[k] for k in dpgo.RED_KEYS])
    x = xs_k.reshape(-1)
    backward = float((Hs @ x - bs).abs().max() / (Hs.abs().sum(1).max() * x.abs().max()))
    forward = float((xs_k - xs_p).abs().max() / xs_p.abs().max())
    ok = backward <= 1e-13 and torch.equal(xs_k, xs_2)
    print(f"  pgo_reduced_solve at D = {D}: backward error {backward:.3e} (tol 1e-13), "
          f"{forward:.3e} of max|xs| from the twin, two calls bit-equal: "
          f"{'yes' if torch.equal(xs_k, xs_2) else 'no'} | kernel "
          f"{time_ms(lambda: dpgo.reduced_solve(g, *args), reps=10):.4f} ms", flush=True)
    if not ok:
        fail(f"pgo_reduced_solve at D = {D}: backward error {backward} or calls differ")


def check_lane_kernels(lanes_np, cfg, consts, kw, rows):
    """K1, K2a, K3 and K2b at B = LANES on the first frame of each lane after
    a boot chunk of the blocked runner: each against its plain version (per
    lane, the one-lane tolerances) and each lane bit for bit against a
    one-lane launch on its inputs. The times go into rows[name]["lanes4"]."""
    import torch
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import icp, pko, voxel_filter as vf, voxel_map as vm
    from lidar_odometry_tpu_torch.utils import keys as K, lie

    dev = DEVICE
    boot = fp.make_blocked_runner(cfg, consts, batch=LANES, block=1, **kw)
    carry = fp.init_blocked_carry(LANES, 0, C1 * LANES, device=dev)
    carry, _ = boot(carry, torch.as_tensor(lanes_np[:, :LANE_CHUNK], device=dev))
    sync()
    state = carry.map_state
    raw = torch.as_tensor(lanes_np[:, LANE_CHUNK], device=dev)     # (B, n, 3)
    one = lambda t, b: t[b].contiguous()
    sub = {}

    def lane_row(name, err, tol, kernel, plain_ms, nbytes, ops, note, library=None):
        record(sub, name, err, tol, kernel, plain_ms, nbytes, ops, library, note)
        rows[name]["lanes4"] = sub[name]

    def same(name, a, b, lane):
        if not torch.equal(a, b):
            fail(f"{name}: lane {lane} of the B = {LANES} launch differs from a one-lane launch")

    print(f"  lanes: B = {LANES}, the first frame of each lane after a boot chunk of "
          f"{LANE_CHUNK} frames at block=1 (a shared map of {C1 * LANES} parents)", flush=True)
    # ---- K1 ----
    n = raw.shape[1]
    inv, vox = K.f32(1.0 / 0.5), K.f32(0.5)
    valid = torch.all(torch.isfinite(raw), dim=-1)
    key, okk = K.compact_key(torch.floor(torch.nan_to_num(raw, 0.0, 0.0, 0.0) * inv)
                             .to(torch.int32))
    key = torch.where(valid & okk, key, torch.full_like(key, K.INVALID_SORT_KEY))
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    ck, mk, nk = vf.voxel_segments(key_s, perm, raw, SCAN_CAP, inv, vox)
    err = 0.0
    for b in range(LANES):
        c1, m1, n1 = vf.voxel_segments(one(key_s, b), one(perm, b), one(raw, b), SCAN_CAP,
                                       inv, vox)
        for a, o in ((ck[b], c1), (mk[b], m1), (nk[b], n1)):
            same("voxel_filter", a, o, b)
        cp, mp, n_p = vf.voxel_segments_plain(key_s[b], perm[b], raw[b], SCAN_CAP, inv, vox)
        if not (torch.equal(mk[b], mp) and int(nk[b]) == int(n_p)):
            fail(f"voxel_filter: lane {b}'s mask or count differs from the plain version")
        err = max(err, float((ck[b] - cp).abs().max()))
    plain = lambda: [vf.voxel_segments_plain(key_s[b], perm[b], raw[b], SCAN_CAP, inv, vox)
                     for b in range(LANES)]
    # the library call: one index_add_ of every lane's points at its
    # segment's row, the lanes' rows side by side
    ok_s = key_s != K.INVALID_SORT_KEY
    seg = torch.cumsum(ok_s & torch.cat([ok_s[:, :1], key_s[:, 1:] != key_s[:, :-1]], 1), 1) - 1
    seg = (torch.clamp(seg, 0, SCAN_CAP)
           + (SCAN_CAP + 1) * torch.arange(LANES, device=dev)[:, None]).reshape(-1)
    p_rel = torch.where(ok_s[..., None], torch.gather(raw, 1, perm[..., None].expand(-1, -1, 3)),
                        0.0).reshape(-1, 3)
    lib_out = torch.zeros((LANES * (SCAN_CAP + 1), 3), device=dev)
    lane_row("voxel_filter", err, 1e-5,
             lambda: vf.voxel_segments(key_s, perm, raw, SCAN_CAP, inv, vox), time_ms(plain),
             LANES * (n * (8 + 8 + 12) + SCAN_CAP * 13 + 4), LANES * n * 10,
             note=f"B = {LANES}: {nk.tolist()} voxels; each lane bit-equal to a one-lane launch",
             library=lambda: lib_out.index_add_(0, seg, p_rel))

    # ---- K2a ----
    feat, mask, _ = vf.voxel_filter(raw, n, voxel_size=0.5, stride=1, out_capacity=SCAN_CAP,
                                    compact_keys=True)
    T = (carry.T_prev @ carry.velocity).reshape(LANES, 16).contiguous()
    flags = torch.zeros((LANES, 3), dtype=torch.int32, device=dev)
    nrm, r, v = icp.icp_correspond(feat, mask, T, flags, state, cfg)
    err, mism = 0.0, 0
    for b in range(LANES):
        outs = icp.icp_correspond(one(feat, b), one(mask, b), one(T, b), one(flags, b), state,
                                  cfg)
        for a, o in zip((nrm[b], r[b], v[b]), outs):
            same("icp_correspond", a, o, b)
        n_p, r_p, v_p = icp.icp_correspond_plain(feat[b], mask[b], T[b], state, cfg)
        mism = max(mism, int((v[b] != v_p).sum()))
        both = v[b] & v_p
        if bool(both.any()):
            err = max(err, float((r[b] - r_p)[both].abs().max()),
                      float((nrm[b] - n_p)[both].abs().max()))
    if mism > 2:
        fail(f"icp_correspond: {mism} validity flags of a lane differ from the plain version")
    N = feat.shape[1]
    qhi, qlo = K.pack_key(K.voxel_coords(lie.transform_points(T.view(LANES, 4, 4), feat),
                                         vm.parent_inv(0.5, 3)).reshape(-1, 3))
    n_rows_b = int(torch.unique(vm.hash_bucket(qhi, qlo, state.n_buckets - 1)).numel())
    n_rows_s = int(torch.unique(vm.bucket_find(state.l1_index, qhi, qlo)[0]).numel())
    lane_row("icp_correspond", err, 1e-4,
             lambda: icp.icp_correspond(feat, mask, T, flags, state, cfg),
             time_ms(lambda: [icp.icp_correspond_plain(feat[b], mask[b], T[b], state, cfg)
                              for b in range(LANES)]),
             LANES * (N * (12 + 1) + 64 + 12 + N * 17) + n_rows_b * 128 + n_rows_s * 32,
             LANES * N * 40,
             note=f"B = {LANES}: {v.sum(1).tolist()} correspondences, at most {mism} flag "
                  f"mismatches a lane")

    # ---- K3 ----
    scale = torch.ones((LANES, 1), device=dev)
    aux, s_k = pko.pko_alpha_index(r, v, flags, scale, True, consts)
    err, rounds = 0.0, []
    for b in range(LANES):
        outs = pko.pko_alpha_index(one(r, b), one(v, b), one(flags, b), one(scale, b), True,
                                   consts)
        same("pko_alpha", aux[b], outs[0], b)
        same("pko_alpha", s_k[b], outs[1], b)
        a_p, c_p, s_p = pko.pko_alpha_index_plain(r[b], v[b], scale[b].reshape(()), True, consts)
        if int(aux[b, 1]) != int(a_p) or int(aux[b, 0]) != int(c_p):
            fail(f"pko_alpha: lane {b}'s alpha index / count differ from the plain version")
        err = max(err, float((s_k[b, 0] - s_p).abs()) / max(float(s_p), 1e-12))
        rounds.append(gmm_rounds(r[b], v[b], s_p, consts))
    n_a, n_g = consts.Q.shape
    lane_row("pko_alpha", err, 1e-5,
             lambda: pko.pko_alpha_index(r, v, flags, scale, True, consts),
             time_ms(lambda: [pko.pko_alpha_index_plain(r[b], v[b], scale[b].reshape(()), True,
                                                        consts) for b in range(LANES)]),
             LANES * (N * 5 + 12 + 12) + n_a * n_g * 4 + (n_a + n_g + 100) * 4,
             LANES * (N * 4 + n_a * n_g * 12),
             note=f"B = {LANES}: alpha indices {aux[:, 1].tolist()}, (k-means, EM) rounds "
                  f"{rounds}; err is relative, of the scale")
    rows["pko_alpha"]["lanes4"]["gmm_rounds"] = rounds

    # ---- K2b ----
    Tk, fk, hk = icp.icp_normal_eq(feat, nrm, r, v, T, s_k, flags, aux, consts, cfg)
    if not all(torch.equal(a, b) for a, b in zip(
            icp.icp_normal_eq(feat, nrm, r, v, T, s_k, flags, aux, consts, cfg), (Tk, fk, hk))):
        fail(f"icp_normal_eq: two B = {LANES} calls differ")
    err = 0.0
    for b in range(LANES):
        outs = icp.icp_normal_eq(one(feat, b), one(nrm, b), one(r, b), one(v, b), one(T, b),
                                 one(s_k, b), one(flags, b), one(aux, b), consts, cfg)
        for a, o in zip((Tk[b], fk[b], hk[b]), outs):
            same("icp_normal_eq", a, o, b)
        Tp, fp_, _ = icp.icp_normal_eq_plain(feat[b], nrm[b], r[b], v[b], T[b], s_k[b],
                                             flags[b], aux[b], consts, cfg)
        if not torch.equal(fk[b], fp_):
            fail(f"icp_normal_eq: lane {b}'s flags {fk[b].tolist()} vs plain {fp_.tolist()}")
        err = max(err, float((Tk[b] - Tp).abs().max()))
    lane_row("icp_normal_eq", err, 1e-5,
             lambda: icp.icp_normal_eq(feat, nrm, r, v, T, s_k, flags, aux, consts, cfg),
             time_ms(lambda: [icp.icp_normal_eq_plain(feat[b], nrm[b], r[b], v[b], T[b],
                                                      s_k[b], flags[b], aux[b], consts, cfg)
                              for b in range(LANES)]),
             LANES * (N * (12 + 12 + 4 + 1) + 64 + 28 + 64 + 12 + 108),
             int(v.sum()) * 90, note=f"B = {LANES}: a cluster a lane; two calls bit-equal")


# ---------------------------------------------------------------------------
# phase 4: the surfel path
# ---------------------------------------------------------------------------

def drive_chunks(run, carry, chunks, dim: int = 0):
    """The chunks through `run` from `carry`: the last carry, the outputs
    (poses, is_kf, n_corr) concatenated along the frame axis `dim`, and
    the wall seconds of the first chunk and of the rest."""
    import torch
    sync()
    t0 = time.perf_counter()
    carry, out = run(carry, chunks[0])
    outs = [out]
    sync()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for ch in chunks[1:]:
        carry, out = run(carry, ch)
        outs.append(out)
    sync()
    return carry, [torch.cat(col, dim) for col in zip(*outs)], first, time.perf_counter() - t0


def check_same_run(path: str, eager, captured) -> None:
    """Fail unless the captured run (carry, outputs) is bit-equal to the
    eager one: poses, is_kf, n_corr and every carry tensor, the map's ten
    included."""
    import torch
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    (ce, oe), (cg, og) = eager, captured
    names = (["poses", "is_kf", "n_corr"] + list(vm.VoxelMapState._fields)
             + ["T_prev", "velocity", "last_kf_pose", "initialized", "kf_count"])
    pairs = zip(names, list(oe) + list(ce.map_state) + list(ce[1:]),
                list(og) + list(cg.map_state) + list(cg[1:]))
    bad = [n for n, a, b in pairs if a.shape != b.shape or not torch.equal(a, b)]
    print(f"{path} path: the captured run against graph=False: "
          f"{'bit-equal' if not bad else 'differs in ' + ', '.join(bad)} (poses, is_kf, n_corr "
          f"and the carry, the map's ten tensors included)", flush=True)
    if bad:
        fail(f"{path} path: the captured chunks differ from the eager ones in {bad}")


def graph_nodes(runner) -> list:
    """Each captured chunk of a GraphedChunk: frames a chunk, the CUDA
    graph's nodes and its kernel, memcpy and memset nodes (libcuda's
    cuGraphGetNodes and cuGraphNodeGetType), and the port's kernel
    launches captured in it."""
    import ctypes
    from collections import Counter
    cu = ctypes.CDLL("libcuda.so.1")
    out = []
    for key, cap in runner.graphs.items():
        g = ctypes.c_void_p(cap.graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
            fail("cuGraphGetNodes failed on a captured chunk")
        nodes = (ctypes.c_void_p * n.value)()
        cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
        kinds, t = Counter(), ctypes.c_int()
        for node in nodes:
            cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
            kinds[t.value] += 1
        out.append(dict(frames=key[1][-3], nodes=n.value, kernel_nodes=kinds[0],
                        memcpy_nodes=kinds[1], memset_nodes=kinds[2],
                        port_launches=sum(cap.capture.launches.values())))
    return out


def chunk_windows(path: str, eager_fn, captured_fn, runner) -> dict:
    """One more chunk each way on the runs' last carries (bit-equal, so
    both do the same work): wall ms (the median of 3 synchronised calls),
    device busy ms, busy share and host launches from a torch.profiler
    window, host syncs, and the captured graphs' nodes. Fails on a host
    sync in a captured chunk."""
    out = {}
    for way, fn in (("eager", eager_fn), ("captured", captured_fn)):
        walls = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        st = profile_stats(fn)
        out[way] = dict(wall_ms=sorted(walls)[1], busy_ms=st["busy_ms"], records=st["records"],
                        busy_share=st["busy_share"], profiled_wall_ms=st["wall_ms"],
                        kernel_launches=st["kernel_launches"],
                        graph_launches=st["graph_launches"],
                        host_syncs=count_syncs(fn, where=f"{path} path, one {way} chunk"))
    out["captured"]["graphs"] = graph_nodes(runner)
    for way in ("eager", "captured"):
        o = out[way]
        share = ("not measured (no device record in 3 windows)" if o["busy_ms"] is None
                 else f"{o['busy_ms']:.3f} ms busy ({100 * o['busy_share']:.1f} % of the "
                      f"profiled window's {o['profiled_wall_ms']:.3f} ms, "
                      f"{100 * o['busy_ms'] / o['wall_ms']:.1f} % of the unprofiled wall; "
                      f"{o['records']} records)")
        print(f"{path} path, one {way} chunk: wall {o['wall_ms']:.3f} ms; {share}; "
              f"{o['kernel_launches']} kernel and {o['graph_launches']} graph launches from the "
              f"host; {o['host_syncs']} host syncs", flush=True)
    print(f"{path} path, captured: graphs {json.dumps(out['captured']['graphs'])}", flush=True)
    if out["captured"]["host_syncs"]:
        fail(f"{path} path: {out['captured']['host_syncs']} host syncs in a captured chunk")
    return out


def update_costs(carry, scan, cfg, kw, reps: int = 5) -> dict:
    """Device ms of one map update at the surfel shapes, on copies of the
    surfel path's last map, the frame's features from `scan`: a keyframe
    with the eviction scan, one without, and a non-keyframe's predicated
    update (no inserts, no eviction scan), which the frame step runs since
    the branch moved onto the device. CUDA events around each of `reps`
    updates behind a spin (device_ms_once), each on its own copy of the
    map, as issued from the host and as one captured CUDA graph; the
    medians."""
    import torch
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    from lidar_odometry_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_tpu_torch.utils import lie
    raw = torch.as_tensor(scan, device=DEVICE)
    feat, mask, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=kw["scan_voxel_size"],
                                    stride=1, out_capacity=SCAN_CAP, compact_keys=True)
    T = carry.T_prev
    world = lie.transform_points(T, feat)
    copy = lambda: vm.VoxelMapState(*(t.clone() for t in carry.map_state))
    out = {}
    for name, kf, ev in (("keyframe, eviction scan", True, True),
                         ("keyframe, no eviction scan", True, False),
                         ("non-keyframe (predicated)", False, False)):
        flag = torch.full((), kf, dtype=torch.bool, device=DEVICE)
        evict = torch.full((), ev, dtype=torch.bool, device=DEVICE) & flag
        upd = lambda st: vm.update_map(st, world, mask & flag, T[:3, 3], kw["max_distance"],
                                       voxel_size=cfg.voxel_size,
                                       planarity_threshold=kw["planarity_threshold"],
                                       hierarchy_factor=cfg.hierarchy_factor,
                                       evict_enabled=evict)
        upd(copy())
        times = []
        for _ in range(reps):
            st = copy()
            times.append(device_ms_once(lambda: upd(st)))
        times = sorted(t for t in times if t is not None)
        out[name] = times[len(times) // 2] if times else None
        # the same update captured, as the frame step runs inside a chunk's
        # graph: a replay on a fresh copy of the map each time
        st, cur, side = copy(), torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            upd(copy())
        cur.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with kernels.capturing():
            with torch.cuda.graph(g, stream=side, capture_error_mode="thread_local"):
                upd(st)
        times = []
        for _ in range(reps):
            for dst, src in zip(st, carry.map_state):
                dst.copy_(src)
            times.append(device_ms_once(g.replay))
        times = sorted(t for t in times if t is not None)
        out[name + ", captured"] = times[len(times) // 2] if times else None
        del g, st
    print(f"map update at the surfel shapes (c1 {carry.map_state.c1}, {int(mask.sum())} "
          f"features; device ms, CUDA events, each on its own copy of the map): "
          + "; ".join(f"{k} {fmt_ms(v)}" for k, v in out.items()), flush=True)
    return out


def main_path(scans_np, gt, cfg, consts, kw):
    """make_chunk_runner over chunks of CHUNK frames, eagerly (graph=False)
    and captured (the default): the captured run must be bit-equal to the
    eager one and launch each kernel as often; its launches are the
    path's."""
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp

    chunks = [torch.as_tensor(scans_np[c:c + CHUNK], device=DEVICE)
              for c in range(0, len(scans_np), CHUNK)]
    eager = fp.make_chunk_runner(cfg, consts, graph=False, **kw)
    kernels.reset_counts()
    e_carry, e_out, e_first, e_rest = drive_chunks(
        eager, fp.init_carry(0, C1, device=DEVICE), chunks)
    eager_launches = kernels.counts()
    runner = fp.make_chunk_runner(cfg, consts, **kw)
    kernels.reset_counts()
    carry, out, warm, elapsed = drive_chunks(runner, fp.init_carry(0, C1, device=DEVICE), chunks)
    launches = kernels.counts()
    check_same_run("surfel", (e_carry, e_out), (carry, out))
    if launches != eager_launches:
        fail(f"surfel path: captured launches {launches} differ from the eager run's "
             f"{eager_launches}")
    print(f"surfel path: {len(runner.graphs)} captured chunk graph(s), {runner.replays} "
          f"replays; launches equal to the eager run's", flush=True)
    est = out[0].cpu().numpy()
    if not np.all(np.isfinite(est)) or est.shape != (len(scans_np), 4, 4):
        fail(f"surfel path: poses of shape {est.shape} not all finite")
    ate = ate_rmse(est, gt)
    fps = (len(scans_np) - CHUNK) / elapsed
    print(f"surfel path: {len(scans_np)} frames in chunks of {CHUNK}; captured: first chunk "
          f"{warm:.3f} s, {fps:.1f} scans/s after it (the capture in the second chunk); eager: "
          f"first chunk {e_first:.3f} s, {(len(scans_np) - CHUNK) / e_rest:.1f} scans/s after "
          f"it; ATE {ate:.4f} m; keyframes {int(carry.kf_count)}; "
          f"n_l0 {int(carry.map_state.n_l0)}; n_l1 {int(carry.map_state.n_l1)}; "
          f"n_dropped {int(carry.map_state.n_dropped)}", flush=True)
    check_launches("surfel", launches, SURFEL_KERNELS, ("grid_knn", "plane_fit_5nn"))
    if not ate < 0.5:
        fail(f"surfel path ATE {ate:.4f} m >= 0.5 m")
    costs = update_costs(carry, scans_np[-1], cfg, kw)
    windows = chunk_windows("surfel", lambda: eager(e_carry, chunks[-1]),
                            lambda: runner(carry, chunks[-1]), runner)
    busy = windows["captured"]["busy_ms"]
    noop = costs["non-keyframe (predicated), captured"]
    n_kf = int(out[1].sum())
    if busy is not None and noop is not None:
        share = noop * (len(scans_np) - n_kf) / (len(chunks) * busy)
        print(f"surfel path: the non-keyframe updates of a chunk ({len(scans_np) - n_kf} of "
              f"{len(scans_np)} frames are non-keyframes) take {100 * share:.1f} % of a "
              f"captured chunk's device time ({noop:.4f} ms each as captured, {busy:.3f} ms "
              f"busy a chunk)", flush=True)
    if PROFILE:
        profile_window(lambda: runner(carry, chunks[-1]),
                       f"the surfel path, one captured chunk of {chunks[-1].shape[0]} frames")
    return launches, dict(scans_per_s=fps, ate_m=ate, frames=len(scans_np),
                          keyframes=int(carry.kf_count),
                          keyframes_lane_frames=int(out[1][:LANE_FRAMES].sum()))


# ---------------------------------------------------------------------------
# phase 5: the mid360 path
# ---------------------------------------------------------------------------

def mid360_path(scans, gt, sysc):
    """The PLY player over the indoor scans written as PLY files, at the
    mid360 configuration."""
    import numpy as np
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.io.ply import PLYPlayer, save_ply

    data = ROOT / "build" / "mid360_smoke"
    shutil.rmtree(data, ignore_errors=True)
    for i, s in enumerate(scans):
        save_ply(str(data / sysc.seq / f"{i:06d}.ply"), s)
    cfg = sysc.replace(data_directory=str(data), output_directory=str(data / "out"),
                       trajectory_format="tum")
    player = PLYPlayer(cfg, device=DEVICE)
    sync()
    kernels.reset_counts()
    res = player.run()
    launches = kernels.counts()
    est = player.estimator
    traj = est.trajectory()
    n = len(scans)
    if (res.frames_processed != n or res.frames_failed or traj.shape != (n, 4, 4)
            or not np.all(np.isfinite(traj))):
        fail(f"mid360 path: {res.frames_processed} frames ({res.frames_failed} failed), poses "
             f"of shape {traj.shape}")
    tum = np.loadtxt(res.trajectory_path)
    if tum.shape != (n, 8):
        fail(f"mid360 path: the TUM trajectory has shape {tum.shape}")
    ate = ate_rmse(traj, gt)
    ms = est.map_state
    n_chunks = n // MID_CHUNK
    print(f"mid360 path: {n} frames through the PLY player ({n_chunks} chunks of {MID_CHUNK}, "
          f"a per-frame tail of {n - n_chunks * MID_CHUNK}); {res.fps:.1f} scans/s "
          f"({res.total_time_s:.3f} s); ATE {ate:.4f} m; keyframes {est.get_keyframe_count()}; "
          f"n_l0 {int(ms.n_l0)}; n_l1 {int(ms.n_l1)}; n_dropped {int(ms.n_dropped)}",
          flush=True)
    check_launches("mid360", launches, MID_KERNELS, MID_NEVER)
    check_captured("mid360", est)
    if not ate < 0.5:
        fail(f"mid360 path ATE {ate:.4f} m >= 0.5 m")
    shutil.rmtree(data, ignore_errors=True)
    return launches, dict(scans_per_s=res.fps, ate_m=ate, frames=n,
                          keyframes=est.get_keyframe_count())


# ---------------------------------------------------------------------------
# phase 6: the loops path
# ---------------------------------------------------------------------------

def _run_chunks(est, scans) -> float:
    """Wall seconds of the scans in chunks and finalize_loops."""
    sync()
    t0 = time.perf_counter()
    for c in range(0, len(scans), LOOP_CHUNK):
        est.process_chunk(scans[c:c + LOOP_CHUNK])
    est.finalize_loops()
    sync()
    return time.perf_counter() - t0


def loops_path(scans, gt, cfg):
    """config/kitti.yaml with loops on through Estimator(sync_loop=True) in
    chunks of LOOP_CHUNK, then finalize_loops; then the same scans with
    loops off."""
    import numpy as np
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models.estimator import Estimator

    print(f"loops path: config/kitti.yaml (loops on, pgo_backend {cfg.pgo_backend}, "
          f"loop_prealign {cfg.loop_prealign}, keyframe_capacity {cfg.keyframe_capacity}, "
          f"gates: gap {cfg.min_keyframe_gap}, distance {cfg.max_search_distance} m, "
          f"similarity {cfg.similarity_threshold}); cut: point_stride 8 -> 1 and scans of "
          f"{LOOP_POINTS} returns at {LOOP_RANGE} m range (with 16384 returns both the JAX "
          f"estimator and the port lose track at the circuit's first corner: "
          f"tools/loop_scan_density.py)", flush=True)
    est = Estimator(cfg, sync_loop=True, device=DEVICE)
    est.warm_loop_programs()
    est.reset()
    kernels.reset_counts()
    wall = _run_chunks(est, scans)
    launches = kernels.counts()
    traj = est.trajectory()
    n = len(scans)
    if traj.shape != (n, 4, 4) or not np.all(np.isfinite(traj)):
        fail(f"loops path: poses of shape {traj.shape} not all finite")
    ate = ate_rmse(traj, gt)
    stages = est.loop_stage_snapshot()
    ms = est.map_state
    print(f"loops path: {n} frames in chunks of {LOOP_CHUNK}, sync_loop; {n / wall:.1f} scans/s "
          f"({wall:.3f} s); ATE {ate:.4f} m; keyframes {est.get_keyframe_count()}; "
          f"loop queries {est.loop_detector.total_queries}, loop ICP attempts "
          f"{est.loop_icp_attempts}, loop constraints {est.get_loop_closure_count()}, rehashes "
          f"{est.rehash_count}, loop errors {est.loop_errors}; n_l0 {int(ms.n_l0)}; n_l1 "
          f"{int(ms.n_l1)}; n_dropped {int(ms.n_dropped)}", flush=True)
    print("loop stages (ms, cumulative): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)
    check_launches("loops", launches, LOOPS_PATH_KERNELS, ("grid_knn",) + PGO_KERNELS)
    check_captured("loops", est)
    if est.get_loop_closure_count() < 1:
        fail("the loops path accepted no loop")
    if est.rehash_count < 1:
        fail("the loops path ran no map rehash")
    if est.loop_errors:
        fail(f"the loops path logged {est.loop_errors} loop errors")
    if not ate <= 0.5:
        fail(f"loops path ATE {ate:.4f} m > 0.5 m")
    loops = dict(scans_per_s=n / wall, ate_m=ate, loops=est.get_loop_closure_count(),
                 rehashes=est.rehash_count, stages_ms=stages)
    manual = dict(traj=traj, loop=loop_of(est))
    if PROFILE:
        profile_loop(est)
    del est

    # the same scans with the distributed pose-graph backend (K10a-K10d)
    est = Estimator(cfg.replace(pgo_backend="distributed"), sync_loop=True, device=DEVICE)
    est.warm_loop_programs()
    est.reset()
    kernels.reset_counts()
    wall_d = _run_chunks(est, scans)
    launches_d = kernels.counts()
    traj_d = est.trajectory()
    if traj_d.shape != (n, 4, 4) or not np.all(np.isfinite(traj_d)):
        fail(f"loops path (distributed): poses of shape {traj_d.shape} not all finite")
    ate_d = ate_rmse(traj_d, gt)
    stages_d = est.loop_stage_snapshot()
    dist = dict(scans_per_s=n / wall_d, ate_m=ate_d, loops=est.get_loop_closure_count(),
                rehashes=est.rehash_count, loop_errors=est.loop_errors, stages_ms=stages_d)
    print(f"loops path, pgo_backend distributed: {n / wall_d:.1f} scans/s ({wall_d:.3f} s); ATE "
          f"{ate_d:.4f} m (manual {ate:.4f} m); loop constraints {dist['loops']} (manual "
          f"{loops['loops']}), rehashes {dist['rehashes']} (manual {loops['rehashes']}), loop "
          f"errors {est.loop_errors}; pgo_solve {stages_d.get('pgo_solve', 0.0):.3f} ms against "
          f"the manual backend's {stages.get('pgo_solve', 0.0):.3f} ms", flush=True)
    check_launches("loops (distributed)", launches_d, LOOPS_PATH_KERNELS + PGO_KERNELS,
                   ("grid_knn",))
    check_captured("loops (distributed)", est)
    if (dist["loops"], dist["rehashes"]) != (loops["loops"], loops["rehashes"]):
        fail(f"loops path (distributed): {dist['loops']} loops and {dist['rehashes']} rehashes "
             f"against the manual backend's {loops['loops']} and {loops['rehashes']}")
    if est.loop_errors:
        fail(f"loops path (distributed): {est.loop_errors} loop errors")
    if not abs(ate_d - ate) <= 1e-3:
        fail(f"loops path (distributed): ATE {ate_d:.5f} m, the manual backend's {ate:.5f} m")
    del est

    off = Estimator(cfg.replace(enable_loop_detection=False), device=DEVICE)
    wall_off = _run_chunks(off, scans)
    ate_off = ate_rmse(off.trajectory(), gt)
    print(f"loops off on the same scans: {n / wall_off:.1f} scans/s ({wall_off:.3f} s); "
          f"ATE {ate_off:.4f} m; keyframes {off.get_keyframe_count()}", flush=True)
    print("loops path summary: " + json.dumps(dict(
        loops, scans_per_s_loops_off=n / wall_off, ate_m_loops_off=ate_off,
        distributed=dist)), flush=True)
    return launches, launches_d, traj_d, ate, manual


def loop_of(est):
    """(matched keyframe id, query keyframe id, the query keyframe's frame)
    of the estimator's first loop factor, or None."""
    keys = est.pose_graph.export_factors()["between_keys"]
    pairs = keys[keys[:, 1] - keys[:, 0] != 1]
    if not len(pairs):
        return None
    m_kf, q_kf = est.keyframes[int(pairs[0][0])], est.keyframes[int(pairs[0][1])]
    return m_kf.kf_id, q_kf.kf_id, q_kf.frame_index


def profile_loop(est) -> None:
    """The accepted loop's solve again, then a rehash of the final map,
    under the profiler (the estimator's own state, nothing changed)."""
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch.ops import icp
    keys = est.pose_graph.export_factors()["between_keys"]
    pair = keys[keys[:, 1] - keys[:, 0] != 1][0]
    m_kf, q_kf = est.keyframes[int(pair[0])], est.keyframes[int(pair[1])]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=DEVICE)

    def solve_and_rehash():
        icp.loop_closure_solve(
            t(q_kf.feature_cloud[::2]), t(q_kf.feature_mask[::2]), t(q_kf.stored_pose),
            t(m_kf.feature_cloud), t(m_kf.feature_mask), t(m_kf.stored_pose),
            torch.zeros((), device=DEVICE), est.pko_consts, est.icp_cfg, bucket_width=8,
            max_loop_iterations=30).cpu()
        est.backend.rehash(est.map_state, np.eye(4, dtype=np.float32))
    solve_and_rehash()
    profile_window(solve_and_rehash, f"the loop solve {int(pair[1])} <-> {int(pair[0])} and a "
                   f"rehash of the map", "loops_")


# ---------------------------------------------------------------------------
# phase 6c: checkpoint and resume, then the viewer
# ---------------------------------------------------------------------------

def checkpoint_path(scans, cfg, manual):
    """The loops path's run again, saved at the chunk boundary before the
    last one before the frame whose keyframe closes the loop (so that the
    restored run's second chunk, which closes it, replays a captured
    graph), restored into a fresh Estimator on the card and run to the end
    with finalize_loops: the same loop, a rehash, and the uninterrupted
    run's poses within 1e-3 m on every frame; both runs' chunks captured. Then LiveViewer.update (its JSON fetched over 127.0.0.1),
    export_state and save_map_to_ply on the restored estimator."""
    import urllib.request
    import numpy as np
    from lidar_odometry_tpu_torch import checkpoint, kernels, viewer
    from lidar_odometry_tpu_torch.models.estimator import Estimator

    if manual["loop"] is None:
        fail("checkpoint path: the loops path accepted no loop to resume before")
    m_id, q_id, q_frame = manual["loop"]
    cut = (q_frame // LOOP_CHUNK - 1) * LOOP_CHUNK
    out = ROOT / "build" / "viewer_smoke"
    shutil.rmtree(out, ignore_errors=True)
    archive = out / "checkpoint.npz"
    sync()
    kernels.reset_counts()
    est = Estimator(cfg, sync_loop=True, device=DEVICE)
    for c in range(0, cut, LOOP_CHUNK):
        est.process_chunk(scans[c:c + LOOP_CHUNK])
    if est.get_loop_closure_count():
        fail(f"checkpoint path: a loop was accepted before frame {cut}")
    check_captured("checkpoint (before the save)", est)
    sync()
    t0 = time.perf_counter()
    checkpoint.save(str(archive), est)
    save_ms = (time.perf_counter() - t0) * 1e3
    n_kf = est.get_keyframe_count()
    del est
    t0 = time.perf_counter()
    est = checkpoint.restore(str(archive), cfg, sync_loop=True, device=DEVICE)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    for c in range(cut, len(scans), LOOP_CHUNK):
        est.process_chunk(scans[c:c + LOOP_CHUNK])
    est.finalize_loops()
    traj = est.trajectory()
    launches = kernels.counts()
    check_captured("checkpoint (restored)", est)
    gap = float(np.abs(traj[:, :3, 3] - manual["traj"][:, :3, 3]).max())
    loop = loop_of(est)
    mb = archive.stat().st_size / 2**20
    print(f"checkpoint path: saved after frame {cut} ({n_kf} keyframes; the loops path closes "
          f"{q_id} <-> {m_id} at frame {q_frame}) in {save_ms:.1f} ms, {mb:.2f} MB; restored "
          f"on {DEVICE} in {restore_ms:.1f} ms; resumed to frame {len(traj)}: loop constraints "
          f"{est.get_loop_closure_count()} ({loop[1] if loop else None} <-> "
          f"{loop[0] if loop else None}), rehashes {est.rehash_count}, loop errors "
          f"{est.loop_errors}; largest position gap to the uninterrupted run {gap:.3e} m",
          flush=True)
    if traj.shape != manual["traj"].shape or not np.all(np.isfinite(traj)):
        fail(f"checkpoint path: poses of shape {traj.shape} not all finite")
    if loop is None or loop[:2] != (m_id, q_id) or est.rehash_count < 1 or est.loop_errors:
        fail(f"checkpoint path: loop {loop}, {est.rehash_count} rehashes, {est.loop_errors} "
             f"loop errors after the restore (the loops path: {manual['loop']})")
    if not gap <= 1e-3:
        fail(f"checkpoint path: the resumed run is {gap:.3e} m from the uninterrupted run")

    lv = viewer.LiveViewer(port=0)
    try:
        t0 = time.perf_counter()
        lv.update(est)
        update_ms = (time.perf_counter() - t0) * 1e3
        state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{lv.port}/state.json",
                                                  timeout=30).read())
    finally:
        lv.close()
    n_map = len(est.map_points())
    if state["n_map"] != n_map or state["frame"] != len(scans) or state["loops"] != 1:
        fail(f"checkpoint path: the viewer's state.json has n_map {state['n_map']} (the map "
             f"{n_map}), frame {state['frame']}, loops {state['loops']}")
    t0 = time.perf_counter()
    viewer.export_state(str(out), est)
    if not est.save_map_to_ply(str(out / "map_acc.ply")):
        fail("checkpoint path: save_map_to_ply wrote nothing")
    export_ms = (time.perf_counter() - t0) * 1e3
    files = sorted(p.name for p in out.iterdir())
    need = {"map.ply", "trajectory_xyz.csv", "keyframes_xyz.csv", "surfels.csv", "map_acc.ply"}
    if not need <= set(files):
        fail(f"checkpoint path: export_state wrote {files}")
    snapshot = "written" if "snapshot.png" in files else "skipped: no matplotlib"
    print(f"checkpoint path: viewer update {update_ms:.1f} ms (n_map {state['n_map']}, "
          f"{len(state['surfels'])} surfels); export_state and save_map_to_ply {export_ms:.1f} "
          f"ms: {files} (snapshot.png {snapshot})", flush=True)
    check_launches("checkpoint", launches, LOOPS_PATH_KERNELS, ("grid_knn",) + PGO_KERNELS)
    del est
    return launches


# ---------------------------------------------------------------------------
# phase 6b: the KITTI player
# ---------------------------------------------------------------------------

def write_kitti_sequence(scans, gt, root: Path) -> None:
    """The scans (NaN rows dropped, a zero intensity column) as
    root/sequences/00/velodyne/%06d.bin, and gt as root/gt/00.txt in the
    camera frame."""
    import numpy as np
    from lidar_odometry_tpu_torch.io.kitti import pose_to_kitti_string
    velo = root / "sequences" / "00" / "velodyne"
    velo.mkdir(parents=True)
    for i, s in enumerate(scans):
        s = s[np.isfinite(s).all(1)]
        rows = np.zeros((len(s), 4), np.float32)
        rows[:, :3] = s
        rows.tofile(velo / f"{i:06d}.bin")
    (root / "gt").mkdir()
    (root / "gt" / "00.txt").write_text("".join(pose_to_kitti_string(p) + "\n" for p in gt))


def kitti_path(scans, gt, cfg, loops_ate: float):
    """The loops path's circuit written as a KITTI sequence through
    KittiPlayer: chunks of LOOP_CHUNK with loops on and sync_loop, then
    the first KITTI_PER_FRAME frames frame by frame (the native
    Prefetcher). Each run's launches are counted on their own: the
    chunked run's and the per-frame run's."""
    import numpy as np
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.io.kitti import KittiPlayer
    from lidar_odometry_tpu_torch.runtime import native_io

    root = ROOT / "build" / "kitti_smoke"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_kitti_sequence(scans, gt, root)
    kcfg = cfg.replace(data_directory=str(root), ground_truth_directory=str(root / "gt"),
                       output_directory=str(root / "out"), seq="00")
    loader = native_io.loader_name()
    print(f"kitti path: {len(scans)} .bin files and 00.txt written in "
          f"{time.perf_counter() - t0:.1f} s; loader {loader} ({native_io.library_path()})",
          flush=True)
    if loader != "native":
        fail("kitti path: the native loader did not build or load (the numpy path is in use)")
    sync()
    kernels.reset_counts()
    player = KittiPlayer(kcfg, device=DEVICE)
    res = player.run(sync_loop=True, chunk_frames=LOOP_CHUNK)
    launches = kernels.counts()
    est = player.estimator
    traj = est.trajectory()
    n = len(scans)
    if (res.frames_processed != n or res.frames_failed or traj.shape != (n, 4, 4)
            or not np.all(np.isfinite(traj))):
        fail(f"kitti path: {res.frames_processed} frames ({res.frames_failed} failed), poses "
             f"of shape {traj.shape}")
    ate = ate_rmse(traj, gt)
    rows = np.loadtxt(res.trajectory_path)
    s = res.error_stats
    print(f"kitti path: {n} frames in chunks of {LOOP_CHUNK}, sync_loop; {res.fps:.1f} scans/s "
          f"({res.total_time_s:.3f} s, steady {res.steady_fps:.1f}); ATE {ate:.4f} m (the loops "
          f"path's {loops_ate:.4f} m; the evaluator's camera-frame ATE {s.ate_rmse:.4f} m, scale "
          f"{s.scale_factor:.6f}); keyframes {est.get_keyframe_count()}; loop constraints "
          f"{est.get_loop_closure_count()}, rehashes {est.rehash_count}, loop errors "
          f"{est.loop_errors}; trajectory {rows.shape}; statistics {res.statistics_path}",
          flush=True)
    if rows.shape != (n, 12):
        fail(f"kitti path: the KITTI trajectory file has shape {rows.shape}")
    if not Path(res.statistics_path).is_file():
        fail("kitti path: no statistics file")
    if not ate < 0.5 or not abs(ate - loops_ate) <= 0.02:
        fail(f"kitti path: ATE {ate:.4f} m, the loops path's {loops_ate:.4f} m")
    if est.loop_errors:
        fail(f"kitti path: {est.loop_errors} loop errors")
    check_captured("kitti", est)
    del est, player
    check_launches("kitti", launches, LOOPS_PATH_KERNELS, ("grid_knn",) + PGO_KERNELS)
    sync()
    kernels.reset_counts()
    res = KittiPlayer(kcfg, device=DEVICE).run(sync_loop=True, chunk_frames=0,
                                               end=KITTI_PER_FRAME)
    frame_launches = kernels.counts()
    print(f"kitti path, frame by frame (the native Prefetcher): {res.frames_processed} frames "
          f"({res.frames_failed} failed), {res.fps:.1f} scans/s; ATE of the camera-frame "
          f"evaluator {res.error_stats.ate_rmse:.4f} m", flush=True)
    if res.frames_processed != KITTI_PER_FRAME or res.frames_failed:
        fail(f"kitti path, frame by frame: {res.frames_processed} frames "
             f"({res.frames_failed} failed)")
    # its 40 frames make 20 keyframes, and a keyframe's loop query waits
    # for kitti.yaml's min_keyframe_gap of 50: the front door's kernels
    check_launches("kitti_frames", frame_launches, SURFEL_KERNELS, ("grid_knn",) + PGO_KERNELS)
    if PROFILE:
        profile_window(lambda: KittiPlayer(kcfg, device=DEVICE).run(
            sync_loop=True, chunk_frames=LOOP_CHUNK, end=2 * LOOP_CHUNK),
            f"the KITTI player over {2 * LOOP_CHUNK} frames in chunks of {LOOP_CHUNK}, set-up "
            f"and its loop programs' warm-up included", "kitti_")
    shutil.rmtree(root, ignore_errors=True)
    return launches, frame_launches


# ---------------------------------------------------------------------------
# phase 7: the PGO path
# ---------------------------------------------------------------------------

def pgo_path(graph):
    """gn_optimize_device, the distributed backend's entry point, on the
    KITTI-00-sized graph: converged, iterations, partitions; the poses
    against the port's manual backend (host scipy) and the plain twins (on
    the CPU); two calls bit-equal; device ms of the GN iterations (CUDA
    events, the card's queue filled first) beside the manual backend's
    host wall ms; launches and host syncs of one call."""
    import numpy as np
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo

    init, priors, betweens, true = graph
    args = (init, priors, betweens)
    manual = import_graph(graph, backend="manual")
    t0 = time.perf_counter()
    ok_m = manual._optimize(max_iterations=10, convergence_threshold=1e-6)
    manual_ms = (time.perf_counter() - t0) * 1e3
    opt = manual.get_all_optimized_poses()
    ref = np.stack([opt[i] for i in range(PGO_N)])
    t0 = time.perf_counter()
    plain, ok_p = dpgo.gn_optimize_device(*args, device="cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3

    sync()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out, ok = dpgo.gn_optimize_device(*args, device=DEVICE)
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.counts()
    holder = {}
    syncs = count_syncs(lambda: holder.update(r=dpgo.gn_optimize_device(*args, device=DEVICE)))
    out2, ok2 = holder["r"]

    pk = dpgo.pack_graph(np.asarray(init, np.float64), priors, betweens)
    g = dpgo.upload(pk, DEVICE)
    device_ms = device_ms_once(lambda: dpgo.gn_iterations(g, 10, 1e-6))
    it, dxn, ok_st, _ = g["st"].cpu().tolist()
    d_manual = float(np.abs(out - ref).max())
    d_plain = float(np.abs(out - plain).max())
    err0, err1 = ate_rmse(init, true), ate_rmse(out, true)
    summary = dict(keyframes=PGO_N, n_pad=pk.n_pad, loops=PGO_LOOPS, D=pk.D, max_m=pk.max_m,
                   converged=bool(ok), iterations=int(it), dx_norm=dxn,
                   max_diff_manual=d_manual, max_diff_plain=d_plain,
                   bit_equal=bool(np.array_equal(out, out2)),
                   device_ms=device_ms, call_ms=call_ms,
                   manual_host_ms=manual_ms, plain_cpu_ms=plain_ms,
                   launches={k: launches[k] for k in PGO_KERNELS},
                   host_syncs=syncs, ate_before_m=err0, ate_after_m=err1)
    print(f"pgo path: {PGO_N} keyframes (n_pad {pk.n_pad}, {PGO_LOOPS} loops, D {pk.D}, max_m "
          f"{pk.max_m}): converged {ok} in {int(it)} iterations (|dx| {dxn:.3e}); max pose "
          f"difference {d_manual:.3e} to the manual backend, {d_plain:.3e} to the plain twins; "
          f"two calls bit-equal {summary['bit_equal']}; GN iterations on the device "
          f"{device_ms} ms, a whole call {call_ms:.3f} ms, the manual backend {manual_ms:.3f} ms (host wall); "
          f"{syncs} host sync(s) a call; ATE to the true poses {err0:.3f} m -> {err1:.3f} m",
          flush=True)
    print("pgo path summary: " + json.dumps(summary), flush=True)
    check_launches("pgo", launches, PGO_KERNELS)
    if not (ok and ok2 and ok_m and ok_p and ok_st):
        fail(f"pgo path: not converged (device {ok}/{ok2}, manual {ok_m}, plain {ok_p})")
    if not d_manual <= 1e-6:
        fail(f"pgo path: {d_manual} from the manual backend (> 1e-6)")
    if not d_plain <= 1e-9:
        fail(f"pgo path: {d_plain} from the plain twins (> 1e-9)")
    if not summary["bit_equal"]:
        fail("pgo path: two calls on the same graph differ")
    if syncs > 1:
        fail(f"pgo path: {syncs} host syncs in one call (at most 1: the poses' download)")
    return launches, dict(manual=ref, device=out, manual_ms=manual_ms, call_ms=call_ms,
                          device_ms=device_ms)


# ---------------------------------------------------------------------------
# phase 7b: the Schur path
# ---------------------------------------------------------------------------

def import_graph(graph, backend="distributed"):
    """A PoseGraphOptimizer holding `graph` (make_pgo_graph's tuple), on
    DEVICE."""
    import numpy as np
    from lidar_odometry_tpu_torch.models.pose_graph import PoseGraphOptimizer
    init, priors, betweens, _ = graph
    pg = PoseGraphOptimizer(backend=backend, device=DEVICE)
    pg.import_factors(dict(
        keyframe_ids=np.arange(len(init)), poses=init,
        prior_keys=np.array([p[0] for p in priors]),
        prior_measured=np.stack([p[1] for p in priors]),
        prior_sqrt_info=np.stack([p[2] for p in priors]),
        between_keys=np.array([(b[0], b[1]) for b in betweens]),
        between_measured=np.stack([b[2] for b in betweens]),
        between_sqrt_info=np.stack([b[3] for b in betweens]),
        counts=np.array([len(init) - 1, 0])))
    return pg


def dense_system(diag, off, loop_edges=(), loop_blocks=()):
    """The (6n)^2 float64 matrix of the block-tridiagonal system with its
    loop blocks (duplicate edges add), assembled on DEVICE."""
    import torch
    n = diag.shape[0]
    H = torch.zeros((6 * n, 6 * n), dtype=torch.float64, device=DEVICE)
    H4 = H.view(n, 6, n, 6)
    i = torch.arange(n, device=DEVICE)
    H4[i, :, i, :] = diag
    H4[i[:-1], :, i[1:], :] = off[: n - 1]
    H4[i[1:], :, i[:-1], :] = off[: n - 1].mT
    for (a, b), (Baa, Bab, Bbb) in zip(loop_edges, loop_blocks):
        H4[a, :, a, :] += torch.as_tensor(Baa, device=DEVICE)
        H4[a, :, b, :] += torch.as_tensor(Bab, device=DEVICE)
        H4[b, :, a, :] += torch.as_tensor(Bab, device=DEVICE).mT
        H4[b, :, b, :] += torch.as_tensor(Bbb, device=DEVICE)
    return H


def backward_error(H, x, b) -> float:
    """The normwise backward error |H x - b| / (|H| |x|) in the inf-norm."""
    x = x.reshape(-1)
    return float((H @ x - b.reshape(-1)).abs().max()
                 / (H.abs().sum(1).max() * x.abs().max()))


def schur_path(graph, pgo, group):
    """The distributed backend's host solvers on the KITTI-00-sized graph.
    First K12a and K12b against their plain twins, each fed the first GN
    iteration's system of _solve_distributed: K12a its block-tridiagonal
    part (the 32 loop couplings dropped) in float64 (1e-10 of max|x|, also
    beside torch.linalg.solve of the assembled dense matrix, the library
    time) and float32 (1e-5 of max|x| from the float32 twin; the distance
    from the float64 answer, ~7e-4, is printed only); K12b's S, r, F, G, g
    at 1e-10 of each output's largest magnitude. Then the path, with the
    launch counts reset before and read after: block_tridiag_solve of that
    chain, schur_partitioned_solve of the whole system (held by its normwise
    backward error, kappa_1 beside it), _optimize_distributed_host (it must
    converge within 1e-6 of the manual backend's and gn_optimize_device's
    poses; wall ms beside theirs, split into its steps' linearisation,
    partitioned solve and the rest) and the solve over a ShardGroup of 4
    shards on `group`, bit-equal to no group."""
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    from lidar_odometry_tpu_torch.parallel import mesh

    rows = {}
    n = len(graph[0])
    pg = import_graph(graph)
    diag, off, b, loops, blocks = pg._linearize_distributed(n)
    seps = dpgo.plan_partition(n, min(pg.n_blocks, max(n // 2, 1)), loops)
    N = 6 * n
    eps = float(np.finfo(np.float64).eps)

    def rel(a, c):
        return float((a - c).abs().max() / c.abs().max()), float((a - c).abs().max())

    # ---- K12a on the block-tridiagonal part ----
    dd, oo, bb = (torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                  for a in (diag, off[: n - 1], b))
    xk = dpgo.block_tridiag_solve(dd, oo, bb)
    xp = dpgo.block_tridiag_solve_plain(dd, oo, bb)
    err, err_abs = rel(xk, xp)
    Hc = dense_system(dd, oo)
    xd = torch.linalg.solve(Hc, bb.reshape(-1)).reshape(n, 6)
    vs_dense = rel(xk, xd)[0]
    bwd_chain = backward_error(Hc, xk, bb)
    d32, o32, b32 = dd.float(), oo.float(), bb.float()
    xk32 = dpgo.block_tridiag_solve(d32, o32, b32)
    xp32 = dpgo.block_tridiag_solve_plain(d32, o32, b32)
    err32 = rel(xk32, xp32)[0]
    f32_from_f64 = rel(xk32.double(), xk)[0]
    twin32_from_f64 = rel(xp32.double(), xk)[0]
    print(f"  schur graph: {n} keyframes, {len(loops)} loop edges, D = {len(seps)} "
          f"partitions; K12a float32: {err32:.3e} of max|x| from its twin (tol 1e-05), "
          f"{f32_from_f64:.3e} from the float64 kernel (the float32 twin {twin32_from_f64:.3e})",
          flush=True)
    if not err32 <= 1e-5:
        fail(f"pgo_block_thomas float32 differs from its twin by {err32} of max|x| (> 1e-5)")
    if not bwd_chain <= N * eps:
        fail(f"pgo_block_thomas: backward error {bwd_chain} in the chain system (> N eps)")
    record(rows, "pgo_block_thomas", err, 1e-10, lambda: dpgo.block_tridiag_solve(dd, oo, bb),
           time_ms(lambda: dpgo.block_tridiag_solve_plain(dd, oo, bb), reps=3),
           n * 288 + (n - 1) * 288 + n * 48 + n * 48,
           n * (2 * 216 + 2 * 36 + 125 + 7 * 30 + 7 * 36) + n * 72,
           library=lambda: torch.linalg.solve_ex(Hc, bb.reshape(-1), check_errors=False),
           library_reps=3,
           ops_per_s=FP64_OPS_PER_S,
           note=f"x of the {N} x {N} chain system, float64; err relative to max|x|; "
                f"{vs_dense:.3e} of max|x| from torch.linalg.solve on the dense matrix "
                f"(library: torch.linalg.solve_ex of it, no error check), backward error "
                f"{bwd_chain:.3e}; float32 {err32:.3e} from its twin")
    del Hc
    P = dpgo.thomas_partitions(n)
    ctas = min(16, P)
    m_int = -(-n // P) - 1
    depth = 2 * m_int + 2 * P
    f32_ms = device_ms(lambda: dpgo.block_tridiag_solve(d32, o32, b32))
    rows["pgo_block_thomas"].update(max_abs_err=err_abs, compared_err=err, float32_err=err32,
                                    float32_from_float64=f32_from_f64, dense_rel=vs_dense,
                                    backward_error=bwd_chain, float32_device_ms=f32_ms,
                                    partitions=P, dependent_rows=depth)
    check_one_launch(rows, "pgo_block_thomas", "schur", "block_thomas_kernel",
                     [lambda: dpgo.block_tridiag_solve(dd, oo, bb),
                      lambda: dpgo.block_tridiag_solve(d32, o32, b32)],
                     note=f"one cluster of {ctas} CTAs x {32 * -(-P // ctas)} threads, a warp a "
                          f"partition: {P} partitions of up to {m_int} interior rows, dependent "
                          f"depth {depth} rows (2 x {m_int} interior, 2 x {P} separators; "
                          f"sequential: {2 * n}); float32 {fmt_ms(f32_ms)} on the device")

    # ---- K12b on the packed interiors of the whole system ----
    packed = [torch.from_numpy(a).to(DEVICE) for a in dpgo.pack_interiors(diag, off, b, seps)]
    D, max_m = packed[0].shape[:2]
    n_rows = int(packed[-1].sum())
    el_k = dpgo.eliminate_interior_lu(*packed)
    el_p = dpgo.eliminate_interior_lu_plain(*packed)
    errs = [rel(a, c) for a, c in zip(el_k, el_p)]
    # the bound reads only the valid rows (padded rows' contents are never
    # read: Dt = I, zero right-hand sides) and writes every output in full
    m_d = packed[-1].sum(1)
    n_oint = int((m_d - 1).clamp(min=0).sum())
    isz = packed[0].element_size()
    in_bytes = ((n_rows * (36 + 6 + 36) + n_oint * 36 + 2 * D * 36) * isz
                + packed[-1].numel() * packed[-1].element_size())
    out_bytes = sum(t.numel() * t.element_size() for t in el_k)
    record(rows, "pgo_eliminate_lu", max(e[0] for e in errs), 1e-10,
           lambda: dpgo.eliminate_interior_lu(*packed),
           time_ms(lambda: dpgo.eliminate_interior_lu_plain(*packed), reps=3),
           in_bytes + out_bytes, n_rows * (2 * 468 + 125 + 13 * 66 + 2 * 468) + D * 6 * 66,
           ops_per_s=FP64_OPS_PER_S,
           note=f"{D} partitions x {max_m} rows, {n_rows} valid; S, r, F, G, g; err relative; "
                f"no one PyTorch call computes a partition's Schur blocks and factors")
    packed32 = [t.float() if t.is_floating_point() else t for t in packed]
    errs32 = [rel(a, c)[0] for a, c in zip(dpgo.eliminate_interior_lu(*packed32),
                                           dpgo.eliminate_interior_lu_plain(*packed32))]
    if not max(errs32) <= 1e-5:
        fail(f"pgo_eliminate_lu float32 differs from its twin by {max(errs32)} (> 1e-5)")
    f32_ms = device_ms(lambda: dpgo.eliminate_interior_lu(*packed32))
    rows["pgo_eliminate_lu"].update(max_abs_err=max(e[1] for e in errs),
                                    compared_err=max(e[0] for e in errs),
                                    float32_err=max(errs32), float32_device_ms=f32_ms,
                                    dependent_rows=2 * max_m)
    check_one_launch(rows, "pgo_eliminate_lu", "schur", "eliminate_lu_kernel",
                     [lambda: dpgo.eliminate_interior_lu(*packed),
                      lambda: dpgo.eliminate_interior_lu(*packed32)],
                     note=f"{D} CTAs of one warp, a warp a partition: dependent depth "
                          f"{2 * max_m} rows (2 x max_m); float32 {max(errs32):.1e} from its "
                          f"twin, {fmt_ms(f32_ms)} on the device")
    del packed, packed32, el_k, el_p

    # ---- the path ----
    sg = mesh.make_group(4, device=DEVICE, group=group)
    host = import_graph(graph)
    # the host loop's split: each step's linearisation, the rest of the step
    # (the plan and schur_partitioned_solve) and, outside the steps, the
    # retraction and the convergence test
    spent = dict(linearize=0.0, step=0.0, steps=0)

    def timed(fn, key):
        def call(n_vars):
            t = time.perf_counter()
            out = fn(n_vars)
            spent[key] += time.perf_counter() - t
            spent["steps"] += key == "step"
            return out
        return call

    host._linearize_distributed = timed(host._linearize_distributed, "linearize")
    host._solve_distributed = timed(host._solve_distributed, "step")
    sync()
    kernels.reset_counts()
    x_chain = dpgo.block_tridiag_solve(dd, oo, bb)
    x = dpgo.schur_partitioned_solve(diag, off, b, seps, loops, blocks, device=DEVICE)
    t0 = time.perf_counter()
    ok = host._optimize_distributed_host(max_iterations=10, convergence_threshold=1e-6)
    host_ms = (time.perf_counter() - t0) * 1e3
    x_g = dpgo.schur_partitioned_solve(diag, off, b, seps, loops, blocks, group=sg)
    sync()
    launches = kernels.counts()

    chain_equal = bool(torch.equal(x_chain, xk))
    Hf = dense_system(dd, torch.from_numpy(off).to(DEVICE), loops, blocks)
    xt = torch.from_numpy(x).to(DEVICE)
    bwd = backward_error(Hf, xt, bb)
    kappa = float(torch.linalg.cond(Hf, p=1))
    del Hf
    opt = host.get_all_optimized_poses()
    poses = np.stack([opt[i] for i in range(n)])
    d_manual = float(np.abs(poses - pgo["manual"]).max())
    d_device = float(np.abs(poses - pgo["device"]).max())
    group_equal = bool(np.array_equal(x_g, x))
    split = dict(steps=spent["steps"], linearize_ms=spent["linearize"] * 1e3,
                 solve_ms=(spent["step"] - spent["linearize"]) * 1e3,
                 rest_ms=host_ms - spent["step"] * 1e3)
    summary = dict(keyframes=n, loops=len(loops), D=len(seps), max_m=max_m, N=N,
                   schur_backward_error=bwd, kappa_1=kappa, chain_bit_equal=chain_equal,
                   host_converged=bool(ok), host_ms=host_ms, host_split=split,
                   manual_host_ms=pgo["manual_ms"],
                   device_call_ms=pgo["call_ms"], device_gn_ms=pgo["device_ms"],
                   max_diff_manual=d_manual, max_diff_device=d_device,
                   group_shards=sg.n_shards, group_bit_equal=group_equal,
                   launches={k: launches[k] for k in SCHUR_KERNELS})
    print(f"schur path: {n} keyframes, D {len(seps)}, max_m {max_m}: the partitioned solve's "
          f"backward error {bwd:.3e} in the {N} x {N} system (kappa_1 {kappa:.3e}); host "
          f"iteration converged {ok} in {host_ms:.1f} ms over {split['steps']} steps "
          f"(linearisation {split['linearize_ms']:.1f}, plan and partitioned solve "
          f"{split['solve_ms']:.1f}, the rest {split['rest_ms']:.1f}; manual backend "
          f"{pgo['manual_ms']:.1f} "
          f"ms, gn_optimize_device {pgo['call_ms']:.1f} ms a call), max pose difference "
          f"{d_manual:.3e} to the manual backend, {d_device:.3e} to gn_optimize_device; over "
          f"{sg.n_shards} shards bit-equal {group_equal}", flush=True)
    print("schur path summary: " + json.dumps(summary), flush=True)
    check_launches("schur", launches, SCHUR_KERNELS, PGO_KERNELS)
    if not chain_equal:
        fail("schur path: block_tridiag_solve differs between two calls")
    if not bwd <= N * eps:
        fail(f"schur path: backward error {bwd} of the partitioned solve (> N eps)")
    if not ok:
        fail("schur path: the host iteration did not converge")
    if not (d_manual <= 1e-6 and d_device <= 1e-6):
        fail(f"schur path: {d_manual} from the manual backend, {d_device} from "
             "gn_optimize_device (> 1e-6)")
    if not group_equal:
        fail(f"schur path: the solve over {sg.n_shards} shards differs from no group")
    return launches, rows


# ---------------------------------------------------------------------------
# phase 8: the blocked path
# ---------------------------------------------------------------------------

def make_lane_scans(seed: int):
    """One lane's scans: the bench's world and drive with `seed`, the first
    LANE_FRAMES frames (run in a spawned worker process)."""
    return make_scans(LANE_FRAMES, seed=seed)


def blocked_path(lanes_np, lane_gt, cfg, consts, kw, surfel):
    """make_blocked_runner over LANES lanes and one shared map: a boot chunk
    at block=1, then chunks at block=LANE_BLOCK. `surfel` is the surfel
    path's summary (its scans/s and keyframes over the first LANE_FRAMES
    frames, lane 0's scans)."""
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp

    chunks = [torch.as_tensor(lanes_np[:, c:c + LANE_CHUNK], device=DEVICE)
              for c in range(0, LANE_FRAMES, LANE_CHUNK)]
    runs = {}
    for graph in (False, True):
        boot = fp.make_blocked_runner(cfg, consts, batch=LANES, block=1, graph=graph, **kw)
        blocked = fp.make_blocked_runner(cfg, consts, batch=LANES, block=LANE_BLOCK,
                                         graph=graph, **kw)
        both = lambda carry, ch, boot=boot, blocked=blocked: (
            boot if ch is chunks[0] else blocked)(carry, ch)
        kernels.reset_counts()
        carry, out, warm, elapsed = drive_chunks(
            both, fp.init_blocked_carry(LANES, 0, C1 * LANES, device=DEVICE), chunks, dim=1)
        runs[graph] = (carry, out, warm, elapsed, kernels.counts(), blocked)
    e_carry, e_out, _, e_elapsed, eager_launches, eager_blocked = runs[False]
    carry, out, warm, elapsed, launches, blocked = runs[True]
    check_same_run("blocked", (e_carry, e_out), (carry, out))
    if launches != eager_launches:
        fail(f"blocked path: captured launches {launches} differ from the eager run's "
             f"{eager_launches}")
    print(f"blocked path: {len(blocked.graphs)} captured chunk graph(s) at block="
          f"{LANE_BLOCK}, {blocked.replays} replays (the boot chunk runs once, eagerly); "
          f"launches equal to the eager run's; eager {LANES * (LANE_FRAMES - LANE_CHUNK) / e_elapsed:.1f} "
          f"scans/s aggregate after the boot chunk", flush=True)
    est = out[0].cpu().numpy()
    kf = out[1].sum(1).tolist()
    ms = carry.map_state
    n_l0, n_l1, n_dropped = int(ms.n_l0), int(ms.n_l1), int(ms.n_dropped)
    if est.shape != (LANES, LANE_FRAMES, 4, 4) or not np.all(np.isfinite(est)):
        fail(f"blocked path: poses of shape {est.shape} not all finite")
    ates = [ate_rmse(est[b], lane_gt[b]) for b in range(LANES)]
    thr = LANES * (LANE_FRAMES - LANE_CHUNK) / elapsed
    windows = chunk_windows("blocked", lambda: eager_blocked(e_carry, chunks[-1]),
                            lambda: blocked(carry, chunks[-1]), blocked)
    syncs = windows["captured"]["host_syncs"]
    if PROFILE:
        profile_window(lambda: blocked(carry, chunks[-1]),
                       f"the blocked path, one captured chunk of {LANE_CHUNK} frames x {LANES} "
                       f"lanes", "blocked_")
    n_blocks = LANE_CHUNK + (LANE_FRAMES - LANE_CHUNK) // LANE_BLOCK
    print(f"blocked path: {LANES} lanes x {LANE_FRAMES} frames over one map of {C1 * LANES} "
          f"parents; boot chunk of {LANE_CHUNK} at block=1 {warm:.3f} s, then chunks of "
          f"{LANE_CHUNK} at block={LANE_BLOCK}: {thr:.1f} scans/s aggregate after the boot "
          f"chunk (surfel path, one stream, this call: {surfel['scans_per_s']:.1f}); ATE per "
          f"lane {[round(a, 4) for a in ates]} m; keyframes per lane {kf} (surfel path over "
          f"the same {LANE_FRAMES} frames: {surfel['keyframes_lane_frames']}); n_l0 {n_l0}; "
          f"n_l1 {n_l1}; n_dropped {n_dropped}; host syncs: {syncs} in one chunk of "
          f"{LANE_CHUNK} frames at block={LANE_BLOCK}", flush=True)
    check_launches("blocked", launches, SURFEL_KERNELS, BLOCKED_NEVER)
    if launches["map_scatter_add"] != n_blocks:
        fail(f"blocked path: {launches['map_scatter_add']} map updates (K4b), expected one a "
             f"block, {n_blocks}")
    if launches["voxel_filter"] != LANE_FRAMES:
        fail(f"blocked path: {launches['voxel_filter']} K1 launches, expected one a frame for "
             f"all lanes, {LANE_FRAMES}")
    bad = [b for b in range(LANES) if not ates[b] < 0.5]
    if bad:
        fail(f"blocked path: lanes {bad} have ATE >= 0.5 m ({ates})")
    if abs(kf[0] - surfel["keyframes_lane_frames"]) > 1:
        fail(f"blocked path: lane 0 made {kf[0]} keyframes, the surfel path "
             f"{surfel['keyframes_lane_frames']} over the same frames")
    if syncs:
        fail(f"blocked path: {syncs} host syncs in one captured block={LANE_BLOCK} chunk")
    print("blocked path summary: " + json.dumps(dict(
        scans_per_s_aggregate=thr, scans_per_s_surfel_single=surfel["scans_per_s"],
        ate_m=ates, keyframes=kf, n_l0=n_l0, n_l1=n_l1, n_dropped=n_dropped,
        host_syncs_block_chunk=syncs)), flush=True)
    return launches, ates


# ---------------------------------------------------------------------------
# phase 3 (shards): K11a-d against their plain twins
# ---------------------------------------------------------------------------

def shard_feature_frames(dense, loop_gt, cfg):
    """The dense loop frames' features at kitti.yaml's scan capacity (K1),
    with their true poses: {frame: (feat (16384, 3), mask, pose)}."""
    import torch
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    out = {}
    for i, scan in dense.items():
        raw = torch.as_tensor(scan, device=DEVICE)
        feat, mask, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=cfg.voxel_size, stride=1,
                                        out_capacity=cfg.scan_capacity,
                                        compact_keys=vf.compact_keys_ok(cfg.voxel_size, 200.0))
        out[i] = (feat, mask, torch.as_tensor(loop_gt[i], device=DEVICE))
    return out


def ne_errors(rk, rp, n_alpha: int):
    """K11b's rows (G, ld) against the plain twin's, each block at its own
    scale: the J J^T entries and the J r entries of every alpha, each
    relative to the largest of its block, and the count's absolute gap."""
    import torch
    cols = torch.arange(n_alpha * 42, device=rk.device).view(n_alpha, 42)
    rel = []
    for idx in (cols[:, :36].flatten(), cols[:, 36:].flatten()):
        a, b = rk[:, idx], rp[:, idx]
        rel.append(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    return rel[0], rel[1], float((rk[:, -1] - rp[:, -1]).abs().max())


def check_shard_lanes(frames, icfg, consts, st, g, inv):
    """K11a-d at the step path's shapes: STEP_LANES lanes x g's shards over
    N = SCAN_CAP features, each lane with its own scan (the first SCAN_CAP
    features of one of the last STEP_LANES dense frames), its own guess
    and so its own moments, all against the map `st`. Every output
    against the plain twin (K11a, K11c and K11b's count exactly, K11b's
    blocks within 1e-5 of each block's largest entry and its moments
    within 1e-5 relative, K11d the same alpha and flags and T within
    1e-6), with both lanes live and with each lane done in turn (its rows
    left unwritten); and lane b of every launch bit-equal to a one-lane
    launch on lane b's inputs."""
    import torch
    from lidar_odometry_tpu_torch.ops import icp, pko
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    from lidar_odometry_tpu_torch.parallel import sharded_map as sm
    from lidar_odometry_tpu_torch.utils import lie

    dev, b, s, n = DEVICE, STEP_LANES, g.n_shards, SCAN_CAP
    keys = sorted(frames)[-b:]
    pts = torch.stack([frames[i][0][:n] for i in keys]).contiguous()
    mask = torch.stack([frames[i][1][:n] for i in keys]).contiguous()
    T = torch.stack([frames[i][2] for i in keys]).clone()
    for lane, (dx, dy, yaw) in enumerate(((0.1, 0.0, 0.01), (0.0, -0.08, -0.015))):
        T[lane, :3, :3] = T[lane, :3, :3] @ lie.so3_exp(torch.tensor([0.0, 0.0, yaw], device=dev))
        T[lane, 0, 3] += dx
        T[lane, 1, 3] += dy
    T = T.reshape(b, 16).contiguous()
    cap = so.owned_cap(n, s)
    err = dict(own=0.0, mom=0.0, H=0.0, g=0.0, count=0.0, sample=0.0, T=0.0)
    bad = []

    def inst(x, lane):
        return x[lane * s:(lane + 1) * s]

    def gap(x, y):
        return float((x.float() - y.float()).abs().max())

    for Tx in (T, None):       # the ICP's compaction at a pose, and the update's
        own_k = so.shard_own(pts, mask, Tx, s, 0, s, cap, inv)
        own_p = so.shard_own_plain(pts, mask, Tx, s, 0, s, cap, inv)
        err["own"] = max([err["own"]] + [gap(x, y) for x, y in zip(own_k, own_p)])
        for lane in range(b):
            one = so.shard_own(pts[lane:lane + 1], mask[lane:lane + 1],
                               None if Tx is None else Tx[lane:lane + 1], s, 0, s, cap, inv)
            if not all(torch.equal(inst(x, lane), y) for x, y in zip(own_k, one)):
                bad.append(f"K11a lane {lane}{'' if Tx is None else ' at a pose'}")
    # K11a's times at the step path's shape (one cluster a lane)
    own_lanes = dict(
        lanes_ms=time_ms(lambda: so.shard_own(pts, mask, T, s, 0, s, cap, inv)),
        lanes_device_ms=device_ms(lambda: so.shard_own(pts, mask, T, s, 0, s, cap, inv)),
        lanes_device_ms_without_T=device_ms(lambda: so.shard_own(pts, mask, None, s, 0, s, cap,
                                                                 inv)),
        lanes_bound_ms=bound_ms(b * (n * 13 + 64) + b * s * (cap * 17 + 4), 0.0)[0],
        lanes_shape=f"{b} lanes x {s} shards, N {n}, cap {cap}")
    p_own, ok = so.shard_own(pts, mask, T, s, 0, s, cap, inv)[:2]
    live = torch.zeros((b, 3), dtype=torch.int32, device=dev)
    corr = [icp.icp_correspond(p_own[i], ok[i], T[i // s], live[i // s],
                               sm.local_view(st, i % s), icfg) for i in range(b * s)]
    nrm, r, valid = (torch.stack(c).contiguous() for c in zip(*corr))
    # K2a's one launch over the b x s instances, the lanes sharing st's
    # shards: bit-equal to the per-instance launches above
    views = [[sm.local_view(st, k) for k in range(s)] for _ in range(b)]
    batched = icp.icp_correspond_instances(p_own, ok, T, live, views, icfg)
    if not all(torch.equal(x, y) for x, y in zip(batched, (nrm, r, valid))):
        bad.append("K2a's batched launch differs from its per-instance launches")
    mk = so.shard_alpha_normal_eq(p_own, nrm, r, valid, T, live, None, None, icfg, n_local=s,
                                  moments=True)
    mp = so.shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T, live, None, None, icfg,
                                        n_local=s, moments=True)
    err["mom"] = float(((mk - mp).abs() / mp.abs().clamp(min=1.0)).max())
    for lane in range(b):
        one = so.shard_alpha_normal_eq(inst(p_own, lane), inst(nrm, lane), inst(r, lane),
                                       inst(valid, lane), T[lane:lane + 1], live[lane:lane + 1],
                                       None, None, icfg, n_local=s, moments=True)
        if not torch.equal(inst(mk, lane), one):
            bad.append(f"K11b moments lane {lane}")
    mom = mk.view(b, s, 3).contiguous()
    if torch.equal(mom[0], mom[1]):
        fail("shard lanes: the two lanes have the same moments")
    u, pick = (torch.as_tensor(a, device=dev) for a in pko.shard_draws(s))
    q, n_alpha = u.shape[1], consts.alphas.shape[0]
    off, ld = n_alpha * 42, so.buffer_width(n_alpha, s, q)
    alpha = []
    for done in (None, 0, 1):
        flags = torch.zeros((b, 3), dtype=torch.int32, device=dev)
        if done is not None:
            flags[done] = torch.tensor([1, 0, 77], dtype=torch.int32, device=dev)
        rk = torch.full((b * s, ld), -7.0, device=dev)
        rp = rk.clone()
        # the step path's route: K11b with K11c's sample in its launch
        so.shard_alpha_normal_eq_sample(p_own, nrm, r, valid, T, flags, mom, consts.alphas, u,
                                        icfg, first=0, n_local=s, off=off, out=rk)
        alone = rk.clone()
        so.shard_sample(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=alone)
        if not torch.equal(alone, rk):
            bad.append(f"K11c alone differs from K11c in K11b's launch (done {done})")
        so.shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T, flags, mom, consts.alphas, icfg,
                                       n_local=s, out=rp)
        so.shard_sample_plain(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=rp)
        rel_h, rel_g, e_cnt = ne_errors(rk, rp, n_alpha)
        err["H"], err["g"] = max(err["H"], rel_h), max(err["g"], rel_g)
        err["count"] = max(err["count"], e_cnt)
        err["sample"] = max(err["sample"], gap(rk[:, off:-1], rp[:, off:-1]))
        if done is not None and not bool((inst(rk, done) == -7.0).all()):
            bad.append(f"K11b/K11c wrote done lane {done}")
        for lane in range(b):
            one = torch.full((s, ld), -7.0, device=dev)
            so.shard_alpha_normal_eq_sample(inst(p_own, lane), inst(nrm, lane), inst(r, lane),
                                            inst(valid, lane), T[lane:lane + 1],
                                            flags[lane:lane + 1], mom[lane:lane + 1],
                                            consts.alphas, u, icfg, first=0, n_local=s, off=off,
                                            out=one)
            if not torch.equal(one, inst(rk, lane)):
                bad.append(f"K11b/K11c lane {lane} (done {done})")
        buf = rk.view(b, s, ld)
        sk = so.shard_gn_select(buf, T, flags, consts, pick, icfg, n_alpha=n_alpha, quota=q,
                                use_pko=True)
        sp = so.shard_gn_select_plain(buf, T, flags, consts, pick, icfg, n_alpha=n_alpha,
                                      quota=q, use_pko=True)
        if not (torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2])):
            bad.append(f"K11d flags or alpha (done {done}): {sk[2].tolist()} vs {sp[2].tolist()}")
        err["T"] = max(err["T"], gap(sk[0], sp[0]))
        for lane in range(b):
            one = so.shard_gn_select(buf[lane:lane + 1], T[lane:lane + 1], flags[lane:lane + 1],
                                     consts, pick, icfg, n_alpha=n_alpha, quota=q, use_pko=True)
            if not all(torch.equal(x[lane], y[0]) for x, y in zip(sk, one)):
                bad.append(f"K11d lane {lane} (done {done})")
        alpha.append(sk[2][:, 0].tolist())
    sync()
    print(f"  shard lanes: {b} lanes x {s} shards, N {n}, cap {cap}, valid per lane "
          f"{[int(inst(valid, i).sum()) for i in range(b)]}, moments per lane "
          f"{[[round(float(v), 2) for v in mom[i].sum(0)] for i in range(b)]}; K11a "
          f"{err['own']:.1e} (exact), K11b moments rel {err['mom']:.1e}, J J^T block "
          f"{err['H']:.1e} rel, J r block {err['g']:.1e} rel, count {err['count']:.0e}, K11c "
          f"{err['sample']:.1e} (exact), K11d T {err['T']:.1e}, alpha per lane (live, lane 0 "
          f"done, lane 1 done) {alpha}; lanes bit-equal to one-lane launches: "
          f"{'yes' if not bad else bad}", flush=True)
    if bad:
        fail(f"shard lanes: {bad}")
    if (err["own"] != 0.0 or err["sample"] != 0.0 or err["count"] != 0.0 or err["mom"] > 1e-5
            or err["H"] > 1e-5 or err["g"] > 1e-5 or err["T"] > 1e-6):
        fail(f"shard lanes: a kernel differs from its plain version: {err}")
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
    print(f"  shard_own at the step path's shape ({own_lanes['lanes_shape']}): "
          f"{own_lanes['lanes_ms']:.4f} ms as issued, "
          f"{fmt(own_lanes['lanes_device_ms'])} on the device at the lanes' poses, "
          f"{fmt(own_lanes['lanes_device_ms_without_T'])} without T, bound "
          f"{own_lanes['lanes_bound_ms']:.5f} ms (bytes)", flush=True)
    return own_lanes


def check_shard_kernels(frames, cfg, rows):
    """K11a-d at kitti.yaml's width (N = 16384 features, A = 101 alphas, a
    map of 65536 parents split over S shards) for S in SHARD_CHECK: a map
    built by the sharded update from the dense frames before the last, the
    last frame's features as the ICP scan from a guess 0.1 m and 0.01 rad
    off. K11a and K11c exactly; K11b's count exactly and its J J^T and
    J r blocks each within 1e-5 of that block's largest entry; K11d the
    same alpha and T within 1e-6; instance k of an S-instance launch
    bit-equal to a one-instance launch. At S = SHARDS, the sharded path's
    count, the lanes as the step path launches them (check_shard_lanes),
    and the times and bounds into rows."""
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch.ops import icp, pko
    from lidar_odometry_tpu_torch.parallel import mesh
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    from lidar_odometry_tpu_torch.parallel import sharded_map as sm
    from lidar_odometry_tpu_torch.utils import lie

    dev = DEVICE
    icfg = icp.ICPConfig(max_iterations=cfg.max_iterations, voxel_size=cfg.map_voxel_size,
                         min_correspondence_points=cfg.min_correspondence_points)
    consts = pko.make_pko_constants(cfg.min_scale_factor, cfg.max_scale_factor,
                                    cfg.num_alpha_segments, cfg.truncated_threshold,
                                    cfg.pko_kernel_type, cfg.gmm_components,
                                    cfg.gmm_sample_size, device=dev)
    n_alpha = consts.alphas.shape[0]
    keys = sorted(frames)
    feat, mask, pose = frames[keys[-2]]
    guess = pose.clone()
    guess[:3, :3] = guess[:3, :3] @ lie.so3_exp(torch.tensor([0.0, 0.0, 0.01], device=dev))
    guess[0, 3] += 0.1
    T1 = guess.reshape(1, 16).contiguous()
    n = feat.shape[0]
    inv = so.owner_inv(cfg.map_voxel_size, 3)
    args = (feat[None].contiguous(), mask[None].contiguous(), T1)
    by_shards, own_by_shards = {}, {}
    for s in SHARD_CHECK:
        g = mesh.make_group(s, device=dev)
        st = sm.sharded_empty_map(0, C1, g)
        for i in keys[:-2]:
            f, m, p = frames[i]
            sm.sharded_update_map(st, lie.transform_points(p, f).contiguous(), m, p[:3, 3],
                                  cfg.max_range * 1.2, g, voxel_size=cfg.map_voxel_size,
                                  planarity_threshold=cfg.surfel_planarity_threshold)
        cap = so.owned_cap(n, s)
        own_k = so.shard_own(*args, s, 0, s, cap, inv)
        own_p = so.shard_own_plain(*args, s, 0, s, cap, inv)
        err_own = max(float((a.float() - b.float()).abs().max()) for a, b in zip(own_k, own_p))
        own_by_shards[s] = dict(device_ms=device_ms(lambda: so.shard_own(*args, s, 0, s, cap,
                                                                          inv)),
                                device_ms_without_T=device_ms(lambda: so.shard_own(
                                    *args[:2], None, s, 0, s, cap, inv)),
                                cap=cap, over=own_k[3].tolist())
        ones = [so.shard_own(*args, s, k, 1, cap, inv) for k in range(s)]
        eq_own = all(torch.equal(a[0], b[k]) for k in range(s) for a, b in zip(ones[k], own_k))
        p_own, ok = own_k[0], own_k[1]
        flags = torch.zeros((1, 3), dtype=torch.int32, device=dev)
        corr = [icp.icp_correspond(p_own[k], ok[k], T1[0], flags[0], sm.local_view(st, k), icfg)
                for k in range(s)]
        nrm, r, valid = (torch.stack(c).contiguous() for c in zip(*corr))
        views = sm.local_views(st)
        batched = icp.icp_correspond_instances(p_own, ok, T1, flags, views, icfg)
        eq_k2a = all(torch.equal(x, y) for x, y in zip(batched, (nrm, r, valid)))
        if s == SHARDS:
            k2a_ms = (time_ms(lambda: icp.icp_correspond_instances(p_own, ok, T1, flags, views,
                                                                   icfg)),
                      device_ms(lambda: icp.icp_correspond_instances(p_own, ok, T1, flags,
                                                                     views, icfg)),
                      time_ms(lambda: icp.icp_correspond(p_own[0], ok[0], T1[0], flags[0],
                                                         views[0][0], icfg)),
                      device_ms(lambda: icp.icp_correspond(p_own[0], ok[0], T1[0], flags[0],
                                                           views[0][0], icfg)))
        mk = so.shard_alpha_normal_eq(p_own, nrm, r, valid, T1, flags, None, None, icfg,
                                      n_local=s, moments=True)
        mp = so.shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T1, flags, None, None, icfg,
                                            n_local=s, moments=True)
        err_mom = float(((mk - mp).abs() / mp.abs().clamp(min=1.0)).max())
        mom = mk.view(1, s, 3)
        u, pick = (torch.as_tensor(a, device=dev) for a in pko.shard_draws(s))
        q = u.shape[1]
        off = n_alpha * 42
        ld = so.buffer_width(n_alpha, s, q)
        rk, rp = (torch.zeros((s, ld), device=dev) for _ in range(2))

        def ne_k(out=rk):
            return so.shard_alpha_normal_eq(p_own, nrm, r, valid, T1, flags, mom, consts.alphas,
                                            icfg, n_local=s, out=out)

        def ne_p():
            return so.shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T1, flags, mom,
                                                  consts.alphas, icfg, n_local=s, out=rp)

        def sample_k(out=rk):
            return so.shard_sample(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=out)

        def sample_p():
            return so.shard_sample_plain(r, valid, flags, mom, u, first=0, n_local=s, off=off,
                                         out=rp)

        rf = torch.zeros((s, ld), device=dev)

        def fused_k(out=rf):   # the ICP round's one launch: K11b with K11c's sample slice
            return so.shard_alpha_normal_eq_sample(p_own, nrm, r, valid, T1, flags, mom,
                                                   consts.alphas, u, icfg, first=0, n_local=s,
                                                   off=off, out=out)

        ne_k(), ne_p(), sample_k(), sample_p(), fused_k()
        first = rk.clone()
        ne_k()
        twice = torch.equal(first, rk)
        rel_h, rel_g, err_cnt = ne_errors(rk, rp, n_alpha)
        scale_ne = float(rp[:, :off].abs().max())
        err_ne = float((rk[:, :off] - rp[:, :off]).abs().max())
        # K11c alone and inside K11b's launch, exactly; K11b's part of the
        # fused row bit-equal to K11b alone
        err_smp = max(float((rk[:, off:-1] - rp[:, off:-1]).abs().max()),
                      float((rf[:, off:-1] - rp[:, off:-1]).abs().max()))
        eq_fused = torch.equal(rf[:, :off], rk[:, :off]) and torch.equal(rf[:, -1], rk[:, -1])
        eq_rows = True
        for k in range(s):
            one, onef = (torch.zeros((1, ld), device=dev) for _ in range(2))
            so.shard_alpha_normal_eq(p_own[k:k + 1], nrm[k:k + 1], r[k:k + 1], valid[k:k + 1],
                                     T1, flags, mom, consts.alphas, icfg, n_local=1, out=one)
            so.shard_sample(r[k:k + 1], valid[k:k + 1], flags, mom, u, first=k, n_local=1,
                            off=off, out=one)
            so.shard_alpha_normal_eq_sample(p_own[k:k + 1], nrm[k:k + 1], r[k:k + 1],
                                            valid[k:k + 1], T1, flags, mom, consts.alphas, u,
                                            icfg, first=k, n_local=1, off=off, out=onef)
            eq_rows &= torch.equal(one[0], rk[k]) and torch.equal(onef[0], rf[k])
        buf = rk[None].contiguous()

        def sel_k(b=buf):
            return so.shard_gn_select(b, T1, flags, consts, pick, icfg, n_alpha=n_alpha,
                                      quota=q, use_pko=True)

        def sel_p():
            return so.shard_gn_select_plain(buf, T1, flags, consts, pick, icfg,
                                            n_alpha=n_alpha, quota=q, use_pko=True)

        sk, sp = sel_k(), sel_p()
        err_sel = float((sk[0] - sp[0]).abs().max())
        # K11b's time and bound at this S (the sharded path's is S = SHARDS)
        n_valid = int(valid.sum())
        b_ne = bound_ms(s * cap * (12 + 12 + 4 + 1) + s * ld * 4 + 64, n_valid * n_alpha * 54)
        by_shards[s] = dict(ms=time_ms(ne_k), device_ms=device_ms(ne_k), bound_ms=b_ne[0],
                            bound_by=b_ne[1], max_abs_err=err_ne, scale=scale_ne, rows=s * cap,
                            valid_rows=n_valid, two_calls_bit_equal=twice,
                            with_sample_ms=time_ms(fused_k),
                            with_sample_device_ms=device_ms(fused_k),
                            sample_alone_ms=time_ms(sample_k),
                            sample_alone_device_ms=device_ms(sample_k))
        lanes2 = so.shard_gn_select(torch.cat([buf, buf]), torch.cat([T1, T1]),
                                    torch.cat([flags, flags]), consts, pick, icfg,
                                    n_alpha=n_alpha, quota=q, use_pko=True)
        eq_sel = all(torch.equal(a[1], b[0]) for a, b in zip(lanes2, sk))
        sync()
        fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
        print(f"  shards S={s}: K11a max_abs_err {err_own:.1e} (exact; over {own_k[3].tolist()}; "
              f"{fmt(own_by_shards[s]['device_ms'])} ms on the device, "
              f"{fmt(own_by_shards[s]['device_ms_without_T'])} without T), "
              f"K11b {fmt(by_shards[s]['device_ms'])} ms on the device "
              f"({by_shards[s]['ms']:.4f} as issued, bound {b_ne[0]:.5f}), with K11c's sample "
              f"in its launch {fmt(by_shards[s]['with_sample_device_ms'])} "
              f"({by_shards[s]['with_sample_ms']:.4f}), K11c alone "
              f"{fmt(by_shards[s]['sample_alone_device_ms'])} "
              f"({by_shards[s]['sample_alone_ms']:.4f}); two calls bit-equal "
              f"{twice}, moments rel {err_mom:.1e}, systems {err_ne:.2e} of {scale_ne:.3e}: "
              f"J J^T block {rel_h:.1e} rel, J r block {rel_g:.1e} rel, count {err_cnt:.0e}, "
              f"K11c {err_smp:.1e} (exact, alone and in K11b's launch; K11b's part of that "
              f"launch bit-equal to K11b alone {eq_fused}), "
              f"K11d alpha {int(sk[2][0, 0])} vs {int(sp[2][0, 0])}, T {err_sel:.1e}; "
              f"instances bit-equal to one-instance launches: K11a {eq_own}, K11b/K11c "
              f"{eq_rows}, K11d lanes {eq_sel}, K2a's one launch over the {s} shards {eq_k2a}; "
              f"{n_valid} valid correspondences", flush=True)
        if err_own != 0.0 or err_smp != 0.0:
            fail(f"shards S={s}: K11a or K11c differs from its plain version")
        if not eq_fused:
            fail(f"shards S={s}: K11b's part of the fused launch differs from K11b alone")
        if err_mom > 1e-5 or rel_h > 1e-5 or rel_g > 1e-5 or err_cnt != 0.0:
            fail(f"shards S={s}: K11b differs from its plain version")
        if not torch.equal(sk[2], sp[2]) or not torch.equal(sk[1], sp[1]) or err_sel > 1e-6:
            fail(f"shards S={s}: K11d differs from its plain version")
        if not (eq_own and eq_rows and eq_sel and eq_k2a):
            fail(f"shards S={s}: an instance differs from its one-instance launch")
        if not twice:
            fail(f"shards S={s}: two K11b calls differ")
        if s != SHARDS:
            continue
        ms4, dev4, ms1, dev1 = k2a_ms
        print(f"  icp_correspond over {s} shard instances in one launch: {ms4:.4f} ms "
              f"(device {fmt(dev4)} ms) against one instance {ms1:.4f} ms (device {fmt(dev1)} "
              f"ms)", flush=True)
        rows["icp_correspond"].update(instances=s, instances_ms=ms4, instances_device_ms=dev4,
                                      one_instance_ms=ms1, one_instance_device_ms=dev1)
        own_lanes = check_shard_lanes(frames, icfg, consts, st, g, inv)
        # times at the sharded path's count; bounds from this run's inputs
        g_inst = s * cap
        rows_n = [int(v) for v in valid.sum(1)]
        pts_b = n * 12 + n + 64
        record(rows, "shard_own", err_own, 0.0, lambda: so.shard_own(*args, s, 0, s, cap, inv),
               time_ms(lambda: so.shard_own_plain(*args, s, 0, s, cap, inv), reps=5),
               pts_b + g_inst * (12 + 1 + 4) + 4 * s, 0.0,
               note=f"N {n}, S {s}, cap {cap}")
        rows["shard_own"].update(own_lanes)
        check_one_launch(rows, "shard_own", "shard", "own_compact_kernel",
                         [lambda: so.shard_own(*args, s, 0, s, cap, inv)])
        W = torch.stack([icp.robust_weights(
            (r[k].abs() / torch.clamp(so.scale_from_moments(mom), min=1e-6))[None, :],
            consts.alphas[:, None], icfg.loss_type) * valid[k] for k in range(s)])
        Rm = T1.view(4, 4)[:3, :3]
        an = nrm @ Rm
        J = torch.cat([an, torch.linalg.cross(p_own, an)], -1)
        Z = torch.cat([(J[..., :, None] * J[..., None, :]).flatten(-2), J * r[..., None]], -1)
        record(rows, "shard_alpha_normal_eq", err_ne, 1e-5 * scale_ne, ne_k, time_ms(ne_p, reps=5),
               g_inst * (12 + 12 + 4 + 1) + s * ld * 4 + 64, sum(rows_n) * n_alpha * 2 * 27,
               library=lambda: torch.bmm(W, Z), note=f"A {n_alpha}, {sum(rows_n)} valid of {g_inst}; library: "
                                    f"torch.bmm of the materialised (S, A, cap) weights by Z")
        check_one_launch(rows, "shard_alpha_normal_eq", "shard", "alpha_ne_kernel", [ne_k],
                         so.shard_alpha_normal_eq_shape())
        n_mom, ops_mom = launches_of(lambda: so.shard_alpha_normal_eq(
            p_own, nrm, r, valid, T1, flags, None, None, icfg, n_local=s, moments=True),
            "shard_alpha_normal_eq")
        if n_mom != 1 or ops_mom:
            fail(f"shard_alpha_normal_eq (moments): {n_mom} launches beside {ops_mom}")
        # K11c's bytes: the flags, the q residuals it draws and its row slots
        record(rows, "shard_sample", err_smp, 0.0, sample_k, time_ms(sample_p, reps=5),
               g_inst + s * q * 4 + s * 2 * s * q * 4 + s * 12 + s * q * 4, 0.0,
               note=f"quota {q}; alone (K11b's kernel with the sample slice only); on the "
                    f"paths it runs inside K11b's launch")
        check_one_launch(rows, "shard_sample", "shard", "alpha_ne_kernel", [sample_k],
                         so.shard_alpha_normal_eq_shape(),
                         note="K11b's kernel, the sample slice alone")
        n_f, ops_f = launches_of(fused_k, "shard_alpha_normal_eq")
        if n_f != 1 or ops_f:
            fail(f"shard_alpha_normal_eq with the sample: {n_f} launches beside {ops_f}")
        record(rows, "shard_gn_select", err_sel, 1e-6, sel_k, time_ms(sel_p, reps=3),
               s * ld * 4 + (n_alpha * 100 + 100) * 4 + 64 + 12, 0.0,
               note=f"alpha {int(sk[2][0, 0])} (plain {int(sp[2][0, 0])})")
        del st
    rows["shard_alpha_normal_eq"]["by_shards"] = by_shards
    rows["shard_sample"]["by_shards"] = {
        s: dict(device_ms=v["sample_alone_device_ms"], ms=v["sample_alone_ms"],
                k11b_with_sample_device_ms=v["with_sample_device_ms"],
                k11b_alone_device_ms=v["device_ms"]) for s, v in by_shards.items()}
    rows["shard_own"]["by_shards"] = own_by_shards
    return rows


# ---------------------------------------------------------------------------
# phase 9: the sharded path and the data x map step
# ---------------------------------------------------------------------------

def one_rank_nccl_group():
    """A one-rank NCCL process group on a free local port."""
    import socket
    import torch
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, device_id=torch.device(DEVICE, 0))
    one = torch.ones((1,), device=DEVICE)
    dist.all_reduce(one)
    sync()
    print(f"process group: NCCL, world size {dist.get_world_size()}, all_reduce of 1 -> "
          f"{float(one[0])}", flush=True)
    return dist.group.WORLD


def sharded_path(scans, gt, cfg, traj_dist, group):
    """config/kitti.yaml with the distributed pose graph through
    Estimator(sync_loop=True, map_backend=ShardedMapBackend) and
    process_frame, the map over SHARDS shards on this card's one rank;
    `traj_dist` the loops path's distributed run on the same scans."""
    import numpy as np
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.models.map_backend import ShardedMapBackend
    from lidar_odometry_tpu_torch.parallel import mesh

    g = mesh.make_group(SHARDS, device=DEVICE, group=group)
    est = Estimator(cfg, sync_loop=True, device=DEVICE, map_backend=ShardedMapBackend(cfg, g))
    print(f"sharded path: config/kitti.yaml (pgo_backend {cfg.pgo_backend}, loops on, prealign "
          f"{cfg.loop_prealign}), the map of {cfg.map_l1_capacity} parents over {g.n_shards} "
          f"shards ({g.world_size} rank x {g.n_local}, NCCL), process_frame over the loops "
          f"path's {len(scans)} scans", flush=True)
    est.warm_loop_programs()
    est.reset()
    sync()
    kernels.reset_counts()
    t0 = time.perf_counter()
    for s in scans:
        est.process_frame(s)
    est.finalize_loops()
    sync()
    wall = time.perf_counter() - t0
    launches, fused = kernels.counts(), kernels.fused_counts()
    traj = est.trajectory()
    n = len(scans)
    if traj.shape != (n, 4, 4) or not np.all(np.isfinite(traj)):
        fail(f"sharded path: poses of shape {traj.shape} not all finite")
    ate = ate_rmse(traj, gt)
    mutual = ate_rmse(traj, traj_dist)
    stages = est.loop_stage_snapshot()
    counts = est.map_counts()
    over = int(est.backend.owned_overflow)
    per_frame = sum(launches.values()) / n
    syncs = count_syncs(lambda: est.process_frame(scans[-1]))
    print(f"sharded path: {n} frames, sync_loop; {n / wall:.1f} scans/s ({wall:.3f} s); ATE "
          f"{ate:.4f} m, {mutual:.4f} m from the loops path's distributed run; keyframes "
          f"{est.get_keyframe_count()}; loop constraints {est.get_loop_closure_count()}, rehashes "
          f"{est.rehash_count}, loop errors {est.loop_errors}; {per_frame:.1f} launches of the "
          f"port's kernels a frame; "
          f"{syncs} host syncs in one more frame; n_l0 {counts['n_l0']}, n_l1 {counts['n_l1']}, "
          f"n_dropped {counts['n_dropped']}, owned points past the shard caps {over}", flush=True)
    print("sharded loop stages (ms, cumulative): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)
    check_launches("sharded", launches, LOOPS_PATH_KERNELS + PGO_KERNELS + SHARD_PATH_KERNELS,
                   ("grid_knn", "shard_sample"))
    check_sample_in_k11b("sharded", launches, fused)
    check_one_k2a_an_iteration("sharded", launches)
    if est.get_loop_closure_count() < 1:
        fail("the sharded path accepted no loop")
    if est.rehash_count < 1:
        fail("the sharded path ran no sharded rehash")
    if est.loop_errors:
        fail(f"the sharded path logged {est.loop_errors} loop errors")
    if not ate < 0.5:
        fail(f"sharded path ATE {ate:.4f} m >= 0.5 m")
    if not mutual < 0.02:
        fail(f"sharded path: {mutual:.4f} m from the loops path's distributed run (>= 0.02 m)")
    print("sharded path summary: " + json.dumps(dict(
        scans_per_s=n / wall, ate_m=ate, mutual_ate_m=mutual, loops=est.get_loop_closure_count(),
        rehashes=est.rehash_count, launches_per_frame=per_frame, host_syncs_per_frame=syncs,
        n_dropped=counts["n_dropped"], owned_overflow=over, stages_ms=stages)), flush=True)
    if PROFILE:
        prof = Estimator(cfg.replace(enable_loop_detection=False), sync_loop=True, device=DEVICE,
                         map_backend=ShardedMapBackend(cfg, g))
        for s in scans[:20]:
            prof.process_frame(s)

        def window():
            for s in scans[20:40]:
                prof.process_frame(s)
        profile_window(window, "the sharded path, 20 frames of process_frame", "sharded_")
    return launches, fused


def step_path(lanes_np, lane_gt, cfg, consts, blocked_ates, group):
    """multichip_odometry_step at STEP_LANES lanes x SHARDS shards over the
    blocked path's first STEP_LANES lanes: features by K1, the pose guess
    by constant velocity and the keyframe flags by the bench's rule (1 m,
    0.3 rad from the last keyframe) on the guess, on the host: one host
    read a frame (the new poses)."""
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.ops import voxel_filter as vf
    from lidar_odometry_tpu_torch.parallel import mesh, pipeline

    g = mesh.make_group(SHARDS, device=DEVICE, group=group)
    b = STEP_LANES
    step = pipeline.multichip_odometry_step(g, cfg, update_max_distance=120.0,
                                            planarity_threshold=0.1, pko_consts=consts)
    scans = torch.as_tensor(lanes_np[:b], device=DEVICE)

    def drive(state, frames, host):
        """The step over `frames`, the host's guesses and keyframe flags
        carried in `host`; returns the map state."""
        for f in frames:
            feat, mask, _ = vf.voxel_filter(scans[:, f], scans.shape[2], voxel_size=0.5,
                                            stride=1, out_capacity=SCAN_CAP,
                                            compact_keys=vf.compact_keys_ok(0.5, 200.0))
            T_prev, last_kf = host["T_prev"], host["last_kf"]
            guess = T_prev @ host["vel"]
            kf = []
            for i in range(b):
                d = float(np.linalg.norm(guess[i, :3, 3] - last_kf[i, :3, 3]))
                c = np.clip((np.trace(last_kf[i, :3, :3].T @ guess[i, :3, :3]) - 1.0) * 0.5,
                            -1, 1)
                kf.append(f == 0 or d > 1.0 or float(np.arccos(c)) > 0.3)
            T_new, state = step(state, feat, mask, torch.as_tensor(guess, device=DEVICE),
                                torch.as_tensor(kf, device=DEVICE))
            T_host = T_new.cpu().numpy()
            host["vel"] = np.linalg.inv(T_prev) @ T_host
            for i in range(b):
                if kf[i]:
                    last_kf[i] = T_host[i]
                    host["n_kf"][i] += 1
            host["T_prev"] = T_host
            host["poses"][:, f] = T_host
        return state

    def fresh():
        eye = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        return dict(T_prev=eye, vel=eye.copy(), last_kf=eye.copy(), n_kf=[0] * b,
                    poses=np.zeros((b, LANE_FRAMES, 4, 4), np.float32))

    state = pipeline.batched_sharded_map_state(b, 0, C1, g)
    host = fresh()
    sync()
    kernels.reset_counts()
    t0 = time.perf_counter()
    state = drive(state, range(LANE_FRAMES), host)
    sync()
    wall = time.perf_counter() - t0
    launches, fused = kernels.counts(), kernels.fused_counts()
    poses, n_kf = host["poses"], host["n_kf"]
    if not np.all(np.isfinite(poses)):
        fail("step path: poses not all finite")
    ates = [ate_rmse(poses[i], lane_gt[i]) for i in range(b)]
    n_l0 = [int(state.n_l0[i].sum()) for i in range(b)]
    print(f"step path: multichip_odometry_step, {b} lanes x {g.n_shards} shards, {LANE_FRAMES} "
          f"frames a lane; {b * LANE_FRAMES / wall:.1f} scans/s aggregate ({wall:.3f} s, one "
          f"host read a frame); ATE per lane {[round(a, 4) for a in ates]} m (blocked path: "
          f"{[round(a, 4) for a in blocked_ates[:b]]} m); keyframes {n_kf}; n_l0 per lane "
          f"{n_l0}; {sum(launches.values()) / LANE_FRAMES:.1f} launches of the port's kernels a "
          f"frame", flush=True)
    check_launches("step", launches, SHARD_PATH_KERNELS + ("voxel_filter", "icp_correspond",
                                                           "map_scatter_add"),
                   ("grid_knn", "plane_fit_5nn", "pko_alpha", "icp_normal_eq", "shard_sample")
                   + LOOP_KERNELS)
    check_sample_in_k11b("step", launches, fused)
    check_one_k2a_an_iteration("step", launches)
    bad = [i for i in range(b) if not ates[i] < 0.5]
    if bad:
        fail(f"step path: lanes {bad} have ATE >= 0.5 m ({ates})")
    print("step path summary: " + json.dumps(dict(
        scans_per_s_aggregate=b * LANE_FRAMES / wall, ate_m=ates, blocked_ate_m=blocked_ates[:b],
        keyframes=n_kf, n_l0=n_l0, host_reads_per_frame=1)), flush=True)
    if PROFILE:
        prof_host = fresh()
        prof_state = drive(pipeline.batched_sharded_map_state(b, 0, C1, g), range(20),
                           prof_host)
        profile_window(lambda: drive(prof_state, range(20, 40), prof_host),
                       f"the step path, 20 frames x {b} lanes", "step_")
    return launches, fused


def check_one_k2a_an_iteration(path: str, launches: dict) -> None:
    """The sharded ICP launches K2a once an iteration for all its lanes and
    shards: as many K2a launches as K11d's, one an iteration."""
    k2a, k11d = launches["icp_correspond"], launches["shard_gn_select"]
    print(f"{path} path: {k2a} K2a launches for {k11d} ICP iterations (K11d launches)",
          flush=True)
    if k2a != k11d:
        fail(f"{path} path: {k2a} K2a launches for {k11d} ICP iterations (one each expected)")


def count_syncs(fn, where: str = "") -> int:
    """Synchronising CUDA calls the host makes in fn(), as torch.cuda's sync
    debug mode reports them (one warning each); with `where`, each one's
    innermost Python frames are printed."""
    import traceback
    import warnings
    import torch
    sync()
    caught = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *a, **k: caught.append(
            (str(message), [f for f in traceback.extract_stack()
                            if Path(f.filename).name != "warnings.py"][:-1]))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # only the sync warning itself: the first switch to "warn" in a process
    # also warns once that the mode is a prototype ("... synchronizing
    # operations"), which is no sync
    found = [st for msg, st in caught if "called a synchronizing CUDA operation" in msg]
    if where:
        for st in found:
            frames = " <- ".join(f"{Path(f.filename).parent.name}/{Path(f.filename).name}:"
                                 f"{f.lineno}" for f in reversed(st[-4:]))
            print(f"{where}: a host sync at {frames}", flush=True)
    return len(found)


def device_busy_us(prof):
    """The device's busy time in a profiled window: the durations of its
    activity records (kernels, memcpy, memset), each counted once; GPU-side
    user annotations, which span other records, are left out. Returns
    (microseconds, records)."""
    from torch.autograd import DeviceType
    recs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sum(e.time_range.elapsed_us() for e in recs), len(recs)


HOST_KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                        "cudaLaunchKernelExC")
HOST_GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def profile_stats(fn, tries: int = 3) -> dict:
    """One call of fn under torch.profiler: its wall ms, device busy ms
    (device_busy_us), records, busy share, and the kernel and graph
    launches the host made. A window with no device record is one CUPTI
    missed (as in device_records): up to `tries` windows; busy_ms and
    busy_share are None where all were empty."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        dev_us, n_records = device_busy_us(prof)
        if n_records:
            break
    events = prof.key_averages()
    launched = lambda names: sum(e.count for e in events if e.key in names)
    busy = dev_us / 1e3 if n_records else None
    return dict(prof=prof, events=events, wall_ms=wall, busy_ms=busy, records=n_records,
                busy_share=None if busy is None else busy / wall,
                kernel_launches=launched(HOST_KERNEL_LAUNCHES),
                graph_launches=launched(HOST_GRAPH_LAUNCHES))


def profile_window(fn, label: str, prefix: str = "") -> None:
    """One call of fn under torch.profiler (profile_stats): device busy
    share, time by kernel, and the Chrome trace, written to PROFILE_DIR
    (file names start with `prefix`)."""
    out = ROOT / PROFILE_DIR
    out.mkdir(parents=True, exist_ok=True)
    st = profile_stats(fn)
    events = st["events"]
    busy = ("no device record" if st["busy_ms"] is None else
            f"{st['busy_ms']:.3f} ms ({100 * st['busy_share']:.1f} %; {st['records']} kernel, "
            f"memcpy and memset records)")
    print(f"profile: {label}, wall {st['wall_ms']:.3f} ms, device busy {busy}, "
          f"{st['kernel_launches']} kernel launches, {st['graph_launches']} graph launches",
          flush=True)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    (out / f"{prefix}profile_device.txt").write_text(table)
    (out / f"{prefix}profile_host.txt").write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=40))
    st["prof"].export_chrome_trace(str(out / f"{prefix}profile_trace.json"))
    for line in table.splitlines()[:24]:
        print("  " + line[:180], flush=True)


def profile_mid360(scans, sysc) -> None:
    """The mid360 path's second chunk of 20 frames under the profiler, the
    first one run before it as warm-up (a fresh Estimator)."""
    import numpy as np
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    stride = sysc.point_stride
    chunks = np.full((2, MID_CHUNK, MID_RAW // stride, 3), np.nan, np.float32)
    for i in range(2 * MID_CHUNK):
        s = scans[i][::stride]
        chunks[i // MID_CHUNK, i % MID_CHUNK, :len(s)] = s
    est = Estimator(sysc.replace(point_stride=1), device=DEVICE)
    est.process_chunk(chunks[0])
    profile_window(lambda: est.process_chunk(chunks[1]),
                   f"the mid360 path, one chunk of {MID_CHUNK} frames", "mid360_")


def main() -> None:
    import numpy as np
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on the card only")
    if not (ROOT / "lidar_odometry_tpu_torch" / "csrc").is_dir():
        fail("run from the root of a checkout: lidar_odometry_tpu_torch/ is missing")
    sys.path.insert(0, str(ROOT))
    # lanes 1..LANES-1 of the blocked path, made in spawned workers while
    # this process makes the other scans
    pool = ProcessPoolExecutor(max_workers=LANES - 1,
                               mp_context=multiprocessing.get_context("spawn"))
    lane_jobs = [pool.submit(make_lane_scans, 11 + b) for b in range(1, LANES)]

    # ---- phase 1: device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 2: build ----
    from lidar_odometry_tpu_torch import kernels
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items()) or 'up to date'})",
          flush=True)
    for log in sorted(kernels.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem[3:].rsplit('_', 1)[0]}: {line.strip()}")

    cfg, consts, kw = setup()
    t0 = time.perf_counter()
    scans_np, gt = make_scans(N_FRAMES)
    print(f"scans: {N_FRAMES} x {RAW_N} points, strided by {STRIDE}, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    indoor, indoor_gt = make_indoor_scans(MID_FRAMES)
    print(f"indoor scans: {MID_FRAMES} x 40 rings x 720 azimuths "
          f"({min(map(len, indoor))}-{max(map(len, indoor))} returns), "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    sysc = mid360_config()
    t0 = time.perf_counter()
    loop_scans, loop_gt = make_loop_scans()
    print(f"loop scans: {LOOP_FRAMES} x {LOOP_POINTS} points on a circuit that revisits its "
          f"start, made in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dense = make_dense_loop_frames()
    print(f"dense loop frames: {len(dense)} x {DENSE_POINTS} points, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lanes = [(scans_np[:LANE_FRAMES], gt[:LANE_FRAMES])] + [j.result() for j in lane_jobs]
    pool.shutdown()
    lanes_np = np.stack([sc for sc, _ in lanes])
    lane_gt = [g for _, g in lanes]
    print(f"lane scans: {LANES} lanes x {LANE_FRAMES} frames (worlds of seeds "
          f"{list(range(11, 11 + LANES))}; lane 0 the surfel path's first {LANE_FRAMES}), "
          f"waited {time.perf_counter() - t0:.1f} s for the workers", flush=True)

    # ---- phase 3: kernels against their plain versions ----
    print("kernels against their plain PyTorch versions (CUDA events):", flush=True)
    rows, surfel_map = check_kernels(scans_np, cfg, consts, kw)
    rows.update(check_kd_kernels(indoor, sysc))
    kitti = kitti_config()
    rows.update(check_loop_kernels(dense, loop_gt, kitti, surfel_map, rows))
    del surfel_map
    check_lane_kernels(lanes_np, cfg, consts, kw, rows)
    t0 = time.perf_counter()
    pgo_graph = make_pgo_graph()
    print(f"  pgo graph made in {time.perf_counter() - t0:.1f} s", flush=True)
    rows.update(check_pgo_kernels(pgo_graph))
    check_shard_kernels(shard_feature_frames(dense, loop_gt, kitti), kitti, rows)
    del dense

    # ---- phase 4: the surfel path ----
    launches, surfel = main_path(scans_np, gt, cfg, consts, kw)
    by_path = {"surfel": launches}

    # ---- phase 5: the mid360 path ----
    by_path["mid360"] = mid360_path(indoor, indoor_gt, sysc)[0]
    if PROFILE:
        profile_mid360(indoor, sysc)

    # ---- phase 6: the loops path, manual then distributed pose graph ----
    by_path["loops"], by_path["loops_distributed"], traj_dist, loops_ate, manual = loops_path(
        loop_scans, loop_gt, kitti)

    # ---- phase 6c: checkpoint and resume, then the viewer, on the card ----
    by_path["checkpoint"] = checkpoint_path(loop_scans, kitti, manual)

    # ---- phase 6b: the KITTI player ----
    by_path["kitti"], by_path["kitti_frames"] = kitti_path(loop_scans, loop_gt, kitti,
                                                          loops_ate)

    # ---- phase 7: the PGO path ----
    by_path["pgo"], pgo = pgo_path(pgo_graph)

    import torch.distributed as dist
    group = one_rank_nccl_group()
    try:
        # ---- phase 7b: the Schur path ----
        by_path["schur"], schur_rows = schur_path(pgo_graph, pgo, group)
        rows.update(schur_rows)

        # ---- phase 8: the blocked path ----
        by_path["blocked"], blocked_ates = blocked_path(lanes_np, lane_gt, cfg, consts, kw,
                                                        surfel)

        # ---- phase 9: the sharded path and the data x map step ----
        fused_by_path = {}
        by_path["sharded"], fused_by_path["sharded"] = sharded_path(
            loop_scans, loop_gt, kitti.replace(pgo_backend="distributed"), traj_dist, group)
        by_path["step"], fused_by_path["step"] = step_path(lanes_np, lane_gt, cfg, consts,
                                                           blocked_ates, group)
    finally:
        dist.destroy_process_group()

    # ---- phase 10: report ----
    # a kernel whose work runs inside another's launch (K11c in K11b's) counts
    # those runs too, beside its own launches (the other paths run no such launch)
    out = []
    for name, k in kernels.KERNELS.items():
        per = {path: counts[name] for path, counts in by_path.items()}
        inside = {path: f[name] for path, f in fused_by_path.items() if f[name]}
        extra = (dict(fused_launches_by_path=inside, in_launch_of="shard_alpha_normal_eq")
                 if inside else {})
        out.append(dict(name=name, route="cuda",
                        source=f"lidar_odometry_tpu_torch/csrc/{k.source}.cu",
                        replaces=k.replaces, launches=sum(per.values()) + sum(inside.values()),
                        launches_by_path=per, **extra, **rows[name]))
    print("kernels: " + " | ".join(
        f"{o['name']} launches={o['launches_by_path']}"
        f"{' + ' + str(o['fused_launches_by_path']) + ' in K11b' if 'in_launch_of' in o else ''}"
        f" err={o['max_abs_err']:.2e} "
        f"ms={o['ms']:.4f} plain_ms={o['plain_ms']:.4f}" for o in out), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
