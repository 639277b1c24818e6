#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile [DIR]
        # also a torch.profiler window over one chunk of the main path; its
        # tables and Chrome trace go to DIR (default build/profile)

Phases, each of which exits nonzero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel source of lidar_odometry_tpu_torch/csrc with nvcc
     (sm_90a, one process per source, in parallel) into build/kernels/;
  3. every kernel against its plain PyTorch twin on the card, at the main
     path's shapes (131072-point synthetic KITTI-like scans strided by 8,
     scan capacity 14336, a map of 65536 parents built by the port's own
     first keyframes): max abs error against a stated tolerance, kernel and
     plain times by CUDA events, the time of one PyTorch library call that
     computes the same function where there is one, and the least time the
     card could take (bytes over 3.35 TB/s or fp32 operations over
     67 TFLOP/s, whichever is larger);
  4. the main path: make_chunk_runner over chunks of 20 frames, with every
     kernel's launch count set to 0 just before and read just after (each
     must have launched); scans/s after the first chunk, ATE against the
     synthetic ground truth (must stay below 0.5 m), keyframes, map size;
  5. one JSON line of kernels, then the device line, then the result line.

It imports nothing of JAX. It needs torch with CUDA and a CUDA toolkit.
"""
import json
import subprocess
import sys
import time
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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

    def row(name, err, tol, ms, plain_ms, nbytes, ops, library_ms=None, note=""):
        b, by = bound_ms(nbytes, ops)
        ok = err <= tol
        print(f"  {name:22s} max_abs_err {err:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}"
              f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.5f} ms ({by})"
              + (f", library {library_ms:.4f} ms" if library_ms is not None else "")
              + (f" | {note}" if note else ""), flush=True)
        if not ok:
            fail(f"kernel {name} disagrees with its plain version: {err} > {tol}")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                          bound_by=by, library_ms=library_ms)

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
        time_ms(lambda: vf.voxel_segments(key_s, perm, raw, SCAN_CAP, inv, vox)),
        time_ms(lambda: vf.voxel_segments_plain(key_s, perm, raw, SCAN_CAP, inv, vox)),
        n * (8 + 8 + 12) + SCAN_CAP * 13 + 4, n * 10,
        library_ms=time_ms(lambda: lib_out.index_add_(0, seg_c, p_rel)),
        note=f"{nv} voxels from {int(valid.sum())} points")

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
        time_ms(lambda: icp.icp_correspond(feat, mask, T, flags, state, cfg)),
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
    row("pko_alpha", err, 1e-5,
        time_ms(lambda: pko.pko_alpha_index(r_k, v_k, flags, scale, True, consts)),
        time_ms(lambda: pko.pko_alpha_index_plain(r_k, v_k, scale.reshape(()), True, consts)),
        N * 5 + n_a * n_g * 4 + (n_a + n_g + 100) * 4 + 12, N * 4 + n_a * n_g * 12,
        note=f"alpha index {int(aux_k[1])}; err is relative, of the scale")

    Tk, fk, hgk = icp.icp_normal_eq(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k, consts, cfg)
    Tp, fp_, hgp = icp.icp_normal_eq_plain(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k,
                                           consts, cfg)
    if not torch.equal(fk, fp_):
        fail(f"icp_normal_eq: flags {fk.tolist()} vs plain {fp_.tolist()}")
    hg_rel = float(((hgk - hgp).abs() / hgp.abs().clamp(min=1.0)).max())
    err = float((Tk - Tp).abs().max())
    nvld = int(v_k.sum())
    row("icp_normal_eq", err, 1e-5,
        time_ms(lambda: icp.icp_normal_eq(feat, nrm_k, r_k, v_k, T, s_k, flags, aux_k,
                                          consts, cfg)),
        time_ms(lambda: icp.icp_normal_eq_plain(feat, nrm_k, r_k, v_k, T, s_k, flags,
                                                aux_k, consts, cfg)),
        N * (12 + 12 + 4 + 1) + 64 + 28 + 64 + 12 + 108, nvld * 90,
        note=f"H,g relative err {hg_rel:.2e}")

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
        time_ms(lambda: vm.map_evict_scan(l0, C1, sensors, maxd2, on)),
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
    tgt = torch.where(firstk & hit[s_idx] & valid_s, slot[s_idx] * 27 + off[s_idx], nrows)
    l0k, l0p = l0.clone(), l0.clone()
    vm.map_scatter_add(l0k, world, s_idx, firstk, valid_s, tgt)
    vm.map_scatter_add_plain(l0p, world, s_idx, firstk, valid_s, tgt)
    err = float((l0k[:nrows] - l0p[:nrows]).abs().max())
    lead = firstk & (tgt < nrows)
    tgt_pt = torch.where(hit & mask, slot * 27 + off, nrows)
    data4 = torch.cat([mask.float()[:, None], torch.where(mask[:, None], world, 0.0)], 1)
    l0_lib = l0.clone()
    row("map_scatter_add", err, 1e-6,
        time_ms(lambda: vm.map_scatter_add(l0k, world, s_idx, firstk, valid_s, tgt)),
        time_ms(lambda: vm.map_scatter_add_plain(l0p, world, s_idx, firstk, valid_s, tgt)),
        N * (12 + 8 + 1 + 1 + 8) + int(lead.sum()) * 32, N * 4,
        library_ms=time_ms(lambda: l0_lib.index_add_(0, tgt_pt, data4)),
        note=f"{int(lead.sum())} voxel rows")

    # ---- K4c surfel recompute of every parent with enough children ----
    r_n = min(SCAN_CAP, C1)
    live_par = torch.nonzero(state.l1_meta[:C1, 2] >= vm.MIN_OCCUPIED_CHILDREN).flatten()[:r_n]
    r_slot = torch.full((r_n,), -1, dtype=torch.int64, device=dev)
    r_slot[:live_par.numel()] = live_par
    sk, nk, kk = vm.map_surfel_recompute(l0, r_slot, C1, K.f32(0.1))
    sp, np_, kp = vm.map_surfel_recompute_plain(l0, r_slot, C1, K.f32(0.1))
    if not torch.equal(kk, kp):
        fail("map_surfel_recompute: live-child masks differ")
    # normals are defined only where the two smallest eigenvalues are apart
    rows_ix = (torch.clamp(r_slot, 0, C1 - 1)[:, None] * 27
               + torch.arange(27, device=dev)[None, :]).reshape(-1)
    blk = torch.where((r_slot >= 0)[:, None, None], l0[rows_ix].view(-1, 27, 4), 0.0)
    _c, _m, cov, _ok = vm._block_stats(blk)
    lam = torch.linalg.eigvalsh(cov.double())
    well = (lam[:, 1] - lam[:, 0]) > 1e-4 * (lam[:, 2] + 1e-6)
    err = max(float((sk[:, 3:] - sp[:, 3:]).abs().max()),
              float((sk[well, :3] - sp[well, :3]).abs().max()))
    near = (sp[:, 6] - 0.1).abs() < 1e-5
    flips = int(((nk != np_) & ~near).sum())
    if flips:
        fail(f"map_surfel_recompute: {flips} non-planar verdicts differ")
    n_live = int(live_par.numel())
    row("map_surfel_recompute", err, 1e-4,
        time_ms(lambda: vm.map_surfel_recompute(l0, r_slot, C1, K.f32(0.1))),
        time_ms(lambda: vm.map_surfel_recompute_plain(l0, r_slot, C1, K.f32(0.1))),
        r_n * 8 + n_live * 27 * 16 + r_n * (32 + 1 + 4), n_live * (27 * 30 + 200),
        note=f"{n_live} parents, {int((~well[:n_live]).sum())} with an ill-conditioned "
             f"normal left out of the normal comparison")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(scans_np, gt, cfg, consts, kw):
    import numpy as np
    import torch
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp

    runner = fp.make_chunk_runner(cfg, consts, **kw)
    chunks = [torch.as_tensor(scans_np[c:c + CHUNK], device=DEVICE)
              for c in range(0, len(scans_np), CHUNK)]
    carry = fp.init_carry(0, C1, device=DEVICE)
    sync()
    kernels.reset_counts()
    t0 = time.perf_counter()
    carry, out = runner(carry, chunks[0])
    poses = [out[0]]
    sync()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for ch in chunks[1:]:
        carry, out = runner(carry, ch)
        poses.append(out[0])
    sync()
    elapsed = time.perf_counter() - t0
    launches = kernels.counts()
    syncs = count_syncs(runner, carry, chunks[-1])
    print(f"host syncs: {syncs} in one chunk of {chunks[-1].shape[0]} frames", flush=True)
    if PROFILE:
        profile_chunk(runner, carry, chunks[-1])
    est = torch.cat(poses).cpu().numpy()
    if not np.all(np.isfinite(est)) or est.shape != (len(scans_np), 4, 4):
        fail(f"main path: poses of shape {est.shape} not all finite")
    ate = ate_rmse(est, gt)
    fps = (len(scans_np) - CHUNK) / elapsed
    print(f"main path: {len(scans_np)} frames in chunks of {CHUNK}; first chunk {warm:.3f} s; "
          f"{fps:.1f} scans/s after it; ATE {ate:.4f} m; keyframes {int(carry.kf_count)}; "
          f"n_l0 {int(carry.map_state.n_l0)}; n_l1 {int(carry.map_state.n_l1)}; "
          f"n_dropped {int(carry.map_state.n_dropped)}", flush=True)
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path never launched: {missing}")
    if not ate < 0.5:
        fail(f"main path ATE {ate:.4f} m >= 0.5 m")
    return launches, dict(scans_per_s=fps, ate_m=ate, frames=len(scans_np),
                          keyframes=int(carry.kf_count))


def count_syncs(runner, carry, scans) -> int:
    """Synchronising CUDA calls the host makes over one chunk, as
    torch.cuda's sync debug mode reports them (one warning each)."""
    import warnings
    import torch
    sync()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner(carry, scans)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_chunk(runner, carry, scans) -> None:
    """One more chunk under torch.profiler: device busy share, time by
    kernel, and the Chrome trace, written to PROFILE_DIR."""
    from torch.profiler import ProfilerActivity, profile
    out = ROOT / PROFILE_DIR
    out.mkdir(parents=True, exist_ok=True)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner(carry, scans)
        sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"profile: one chunk of {scans.shape[0]} frames, wall {wall * 1e3:.3f} ms, "
          f"device busy {dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / (wall * 1e3):.1f} %)",
          flush=True)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    (out / "profile_device.txt").write_text(table)
    (out / "profile_host.txt").write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / "profile_trace.json"))
    for line in table.splitlines()[:24]:
        print("  " + line[:180], flush=True)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on the card only")
    if not (ROOT / "lidar_odometry_tpu_torch" / "csrc").is_dir():
        fail("run from the root of a checkout: lidar_odometry_tpu_torch/ is missing")
    sys.path.insert(0, str(ROOT))

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
                print(f"  ptxas {log.stem.split('_')[0][3:]}: {line.strip()}")

    cfg, consts, kw = setup()
    t0 = time.perf_counter()
    scans_np, gt = make_scans(N_FRAMES)
    print(f"scans: {N_FRAMES} x {RAW_N} points, strided by {STRIDE}, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3: kernels against their plain versions ----
    print("kernels against their plain PyTorch versions (CUDA events):", flush=True)
    rows = check_kernels(scans_np, cfg, consts, kw)

    # ---- phase 4: main path ----
    launches, _summary = main_path(scans_np, gt, cfg, consts, kw)

    # ---- phase 5: report ----
    out = []
    for name, k in kernels.KERNELS.items():
        r = rows[name]
        out.append(dict(name=name, route="cuda",
                        source=f"lidar_odometry_tpu_torch/csrc/{k.source}.cu",
                        replaces=k.replaces, launches=launches[name], **r))
    print("kernels: " + " | ".join(
        f"{o['name']} launches={o['launches']} err={o['max_abs_err']:.2e} "
        f"ms={o['ms']:.4f} plain_ms={o['plain_ms']:.4f}" for o in out), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
