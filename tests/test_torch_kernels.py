"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

These need an NVIDIA GPU and nvcc; they are marked `cuda` and skip where
there is no card (a CUDA kernel has no CPU mode). On the card (these
tests need no jax, so tests/conftest.py, which imports it, is left out):

    python -m pytest tests/test_torch_kernels.py -q --noconftest -o addopts=""
"""
import numpy as np
import pytest
import torch

from lidar_odometry_tpu_torch import kernels
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.models import fast_pipeline as fp
from lidar_odometry_tpu_torch.ops import icp, pko
from lidar_odometry_tpu_torch.ops import voxel_filter as vf
from lidar_odometry_tpu_torch.ops import voxel_map as vm
from lidar_odometry_tpu_torch.utils import keys as K
from lidar_odometry_tpu_torch.utils import lie

pytestmark = pytest.mark.cuda

KW = dict(scan_voxel_size=0.5, point_stride=1, scan_capacity=8192,
          keyframe_distance=1.0, keyframe_rotation=0.3, max_distance=120.0,
          planarity_threshold=0.1)
ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return "cuda"


@pytest.fixture(scope="module")
def scene(dev):
    world = synthetic.make_world(seed=5, extent=60.0, n_buildings=14)
    poses = synthetic.straight_trajectory(6, step=0.4)
    rng = np.random.default_rng(5)
    scans = np.full((6, 8000, 3), np.nan, np.float32)
    for i in range(6):
        s = synthetic.sample_scan(world, poses[i], 8000, rng, max_range=50.0, noise=0.01)
        scans[i, :len(s)] = s
    cfg = icp.ICPConfig()
    consts = pko.make_pko_constants(*ARGS, device=dev)
    carry = fp.init_carry(0, 8192, device=dev)
    carry, _ = fp.make_chunk_runner(cfg, consts, **KW)(carry, torch.tensor(scans[:5], device=dev))
    raw = torch.tensor(scans[5], device=dev)
    feat, mask, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=0.5, stride=1,
                                    out_capacity=8192, compact_keys=True)
    T = (carry.T_prev @ carry.velocity).reshape(16).contiguous()
    return dict(carry=carry, raw=raw, feat=feat, mask=mask, T=T, cfg=cfg, consts=consts,
                raws=torch.tensor(scans[4:], device=dev))


def test_voxel_filter_kernel(scene):
    raw = scene["raw"]
    coords = torch.floor(torch.nan_to_num(raw, 0.0, 0.0, 0.0) * 2.0).to(torch.int32)
    key, ok = K.compact_key(coords)
    key = torch.where(ok & torch.all(torch.isfinite(raw), -1), key, K.INVALID_SORT_KEY)
    key_s, perm = torch.sort(key, stable=True)
    n0 = kernels.KERNELS["voxel_filter"].launches
    ck, mk, nk = vf.voxel_segments(key_s, perm, raw, 8192, 2.0, 0.5)
    cp, mp, n_p = vf.voxel_segments_plain(key_s, perm, raw, 8192, 2.0, 0.5)
    torch.cuda.synchronize()
    assert kernels.KERNELS["voxel_filter"].launches == n0 + 1
    assert int(nk) == int(n_p) and torch.equal(mk, mp)
    assert float((ck - cp).abs().max()) <= 1e-5


def test_icp_kernels(scene):
    st, cfg, consts = scene["carry"].map_state, scene["cfg"], scene["consts"]
    feat, mask, T = scene["feat"], scene["mask"], scene["T"]
    flags = torch.zeros((3,), dtype=torch.int32, device="cuda")
    nk, rk, vk = icp.icp_correspond(feat, mask, T, flags, st, cfg)
    np_, rp, vp = icp.icp_correspond_plain(feat, mask, T, st, cfg)
    assert int((vk != vp).sum()) <= 2
    both = vk & vp
    assert float((rk - rp)[both].abs().max()) <= 1e-4
    scale = torch.ones((1,), device="cuda")
    aux, s = pko.pko_alpha_index(rk, vk, flags, scale, True, consts)
    a_p, c_p, s_p = pko.pko_alpha_index_plain(rk, vk, scale.reshape(()), True, consts)
    assert int(aux[1]) == int(a_p) and int(aux[0]) == int(c_p)
    assert abs(float(s[0]) - float(s_p)) <= 1e-5 * float(s_p)
    Tk, fk, hk = icp.icp_normal_eq(feat, nk, rk, vk, T, s, flags, aux, consts, cfg)
    Tp, fp_, hp = icp.icp_normal_eq_plain(feat, nk, rk, vk, T, s, flags, aux, consts, cfg)
    assert torch.equal(fk, fp_)
    assert float((Tk - Tp).abs().max()) <= 1e-5
    assert float(((hk - hp).abs() / hp.abs().clamp(min=1.0)).max()) <= 1e-4


def test_map_kernels(scene):
    st, T, feat, mask = scene["carry"].map_state, scene["T"], scene["feat"], scene["mask"]
    c1 = st.c1
    sensors = T.view(4, 4)[:3, 3].reshape(1, 3).contiguous()
    on = torch.ones((), dtype=torch.bool, device="cuda")
    for enabled in (on, ~on):
        assert torch.equal(vm.map_evict_scan(st.l0_data, c1, sensors, 400.0, enabled),
                           vm.map_evict_scan_plain(st.l0_data, c1, sensors, 400.0, enabled))
    world = lie.transform_points(T.view(4, 4), feat)
    pc = K.voxel_coords(world, 2.0)
    slot, hit, _, _ = vm.bucket_find(st.l1_index, *K.pack_key(torch.div(pc, 3, rounding_mode="floor")))
    kkey = torch.where(mask, K.sort_key(*K.pack_key(pc)), K.INVALID_SORT_KEY)
    s_key, s_idx = torch.sort(kkey, stable=True)
    firstk = torch.ones_like(mask)
    firstk[1:] = s_key[1:] != s_key[:-1]
    valid_s = mask[s_idx]
    nrows = c1 * 27
    off = vm._child_offset_of(pc)
    placed = hit & mask
    a, b = st.l0_data.clone(), st.l0_data.clone()
    vm.map_scatter_add(a, world, s_idx, firstk, valid_s, placed, slot, off)
    vm.map_scatter_add_plain(b, world, s_idx, firstk, valid_s, placed, slot, off)
    assert float((a[:nrows] - b[:nrows]).abs().max()) <= 1e-6
    r_slot = torch.nonzero(st.l1_meta[:c1, 2] >= 5).flatten()
    r_slot = torch.cat([r_slot, torch.full((7,), -1, dtype=torch.int64, device="cuda")])
    sk, nk, kk = vm.map_surfel_recompute(st.l0_data, r_slot, c1, K.f32(0.1))
    sp, np_, kp = vm.map_surfel_recompute_plain(st.l0_data, r_slot, c1, K.f32(0.1))
    assert torch.equal(kk, kp) and torch.equal(nk, np_)
    assert float((sk[:, 3:] - sp[:, 3:]).abs().max()) <= 1e-4
    dots = (sk[:, :3] * sp[:, :3]).sum(1).abs()
    assert float((dots > 1 - 1e-4).float().mean()) > 0.99


def _well_conditioned(cand, cand_ok, sel):
    """Rows whose 5-point covariance keeps its two smallest eigenvalues
    more than 1e-2 of the largest apart: there the float32 normal is
    fixed to ~1e-5 (float64 reference)."""
    nb = torch.gather(cand, 1, sel.long()[..., None].expand(-1, -1, 3)).double()
    m = torch.gather(cand_ok, 1, sel.long())[..., None].double()
    cnt = m.sum(1).clamp(min=1.0)
    d = (nb - ((nb * m).sum(1) / cnt)[:, None]) * m
    lam = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", d, d) / cnt[..., None])
    return (lam[:, 1] - lam[:, 0]) > 1e-2 * (lam[:, 2] + 1e-6)


def test_kd_tree_kernels(scene):
    st, T, feat, mask = scene["carry"].map_state, scene["T"], scene["feat"], scene["mask"]
    p_world = lie.transform_points(T.view(4, 4), feat).contiguous()
    cfg = icp.ICPConfig(use_surfel_correspondence=False)
    for radius in (1, 2):
        n0 = kernels.KERNELS["grid_knn"].launches
        ck, okk = vm.grid_knn_neighbors(st, p_world, voxel_size=0.5, radius=radius)
        cp, okp = vm.grid_knn_neighbors_plain(st, p_world, voxel_size=0.5, radius=radius)
        torch.cuda.synchronize()
        assert kernels.KERNELS["grid_knn"].launches == n0 + 1
        assert torch.equal(okk, okp) and torch.equal(ck, cp)
    cand_ok = okk & mask[:, None]
    for gate in (True, False):
        fk = icp.plane_fit_5nn(p_world, ck, cand_ok, mask, cfg, gate)
        fp_ = icp.plane_fit_5nn_plain(p_world, ck, cand_ok, mask, cfg, gate)
        assert torch.equal(fk.sel, fp_.sel) and torch.equal(fk.nearest, fp_.nearest)
        assert float((fk.centroid - fp_.centroid).abs().max()) <= 1e-5
        well = _well_conditioned(ck, cand_ok, fp_.sel)
        assert float(well.float().mean()) > 0.5
        assert int((fk.valid != fp_.valid)[well].sum()) == 0
        # the kernel's eigh3 contracts into FMAs where torch does not
        assert float((fk.dist - fp_.dist)[well].abs().max()) <= 1e-4
        assert float((fk.resid.abs() - fp_.resid.abs())[well].abs().max()) <= 1e-4
        assert float((fk.normal * fp_.normal).sum(1).abs()[well].min()) > 1 - 1e-5


def test_kd_tree_icp_on_the_card(scene):
    """KD-tree ICP through its kernels lands where its plain path does."""
    st, T, feat, mask = scene["carry"].map_state, scene["T"], scene["feat"], scene["mask"]
    cfg, consts = icp.ICPConfig(use_surfel_correspondence=False), scene["consts"]
    counts = kernels.counts()
    Tk, okk, nk = icp.icp_optimize(st, feat, mask, T.view(4, 4), consts, cfg)
    after = kernels.counts()
    assert all(after[k] > counts[k] for k in ("grid_knn", "plane_fit_5nn", "pko_alpha",
                                              "icp_normal_eq"))
    assert after["icp_correspond"] == counts["icp_correspond"]
    cpu = lambda x: x.cpu()
    st_cpu = vm.VoxelMapState(*map(cpu, st))
    consts_cpu = pko.make_pko_constants(*ARGS, device="cpu")
    Tp, okp, n_p = icp.icp_optimize(st_cpu, feat.cpu(), mask.cpu(), T.view(4, 4).cpu(),
                                    consts_cpu, cfg)
    assert bool(okk) == bool(okp) is True
    assert float((Tk.cpu() - Tp)[:3, 3].abs().max()) <= 1e-3


def _k1_keys(raw):
    """The filter's compact keys of raw (..., n, 3) at voxel 0.5, sorted:
    (key_s, perm)."""
    coords = torch.floor(torch.nan_to_num(raw, 0.0, 0.0, 0.0) * 2.0).to(torch.int32)
    key, ok = K.compact_key(coords)
    key = torch.where(ok & torch.all(torch.isfinite(raw), -1), key, K.INVALID_SORT_KEY)
    return torch.sort(key, dim=-1, stable=True)


# K1's edges (its tile is 512 sorted entries): (run lengths, invalid rows, cap)
K1_CASES = {
    "runs_cross_tile_boundaries": ([3] * 700, 0, 8192),
    "run_longer_than_a_tile": ([2] * 300 + [1500] + [1] * 200, 0, 8192),
    "n_not_a_multiple_of_the_tile": ([1, 2, 5] * 333, 7, 8192),
    "all_keys_invalid": ([], 1000, 256),
    "more_voxels_than_cap": ([2] * 900 + [1] * 900, 0, 1000),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_voxel_filter_kernel_edges(dev, case):
    """K1 on sorted runs of known lengths: centroids within 1e-5 of the
    plain twin, mask and count equal (the count reports every voxel, past
    cap too), and a second call bit-equal to the first (each launch leaves
    its look-back scratch zeroed for the next)."""
    counts, n_invalid, cap = K1_CASES[case]
    raw = torch.tensor(synthetic.voxel_runs(counts, n_invalid, seed=len(counts)), device=dev)
    key_s, perm = _k1_keys(raw)
    n0 = kernels.KERNELS["voxel_filter"].launches
    ck, mk, nk = vf.voxel_segments(key_s, perm, raw, cap, 2.0, 0.5)
    ck2, mk2, nk2 = vf.voxel_segments(key_s, perm, raw, cap, 2.0, 0.5)
    cp, mp, n_p = vf.voxel_segments_plain(key_s, perm, raw, cap, 2.0, 0.5)
    torch.cuda.synchronize()
    assert kernels.KERNELS["voxel_filter"].launches == n0 + 2
    assert int(nk) == int(n_p) == len(counts) and torch.equal(mk, mp)
    assert float((ck - cp).abs().max()) <= 1e-5
    assert torch.equal(ck, ck2) and torch.equal(mk, mk2) and torch.equal(nk, nk2)


def test_voxel_filter_kernel_edges_as_lanes(dev):
    """The first four edge cases as the B = 4 lanes of one launch (padded
    with NaN rows to one n): each lane bit-equal to a one-lane launch on
    its inputs and within 1e-5 of the plain twin."""
    cases = [K1_CASES[c] for c in sorted(K1_CASES)][:4]
    pts = [synthetic.voxel_runs(c, i, seed=len(c)) for c, i, _ in cases]
    n = max(len(p) for p in pts)
    raw = np.full((4, n, 3), np.nan, np.float32)
    for lane, p in enumerate(pts):
        raw[lane, :len(p)] = p
    raw = torch.tensor(raw, device=dev)
    key_s, perm = _k1_keys(raw)
    ck, mk, nk = vf.voxel_segments(key_s, perm, raw, 4096, 2.0, 0.5)
    for lane in range(4):
        one = [t[lane].contiguous() for t in (key_s, perm, raw)]
        c1, m1, n1 = vf.voxel_segments(*one, 4096, 2.0, 0.5)
        assert torch.equal(ck[lane], c1) and torch.equal(mk[lane], m1)
        assert torch.equal(nk[lane], n1)
        cp, mp, n_p = vf.voxel_segments_plain(*one, 4096, 2.0, 0.5)
        assert int(nk[lane]) == int(n_p) == len(cases[lane][0]) and torch.equal(mk[lane], mp)
        assert float((ck[lane] - cp).abs().max()) <= 1e-5


def test_voxel_filter_kernel_with_more_ctas_than_the_card_holds(dev):
    """Four lanes of 160000 sorted entries: 313 tiles a lane, 1252 CTAs,
    more than twice the 528 that an H100 holds at once at 512 threads, so
    a look-back waits on tiles whose CTAs started earlier while later ones
    have not started. Each lane equals a one-lane launch bit for bit and
    the plain twin within 1e-5."""
    raw = np.full((4, 160000, 3), np.nan, np.float32)
    for lane in range(4):
        counts = np.random.default_rng(lane).integers(1, 4, 90000)
        counts = counts[np.cumsum(counts) <= 160000 - 50 * lane]
        p = synthetic.voxel_runs(counts, 0, seed=lane)
        raw[lane, :len(p)] = p
    raw = torch.tensor(raw, device=dev)
    key_s, perm = _k1_keys(raw)
    ck, mk, nk = vf.voxel_segments(key_s, perm, raw, 90000, 2.0, 0.5)
    for lane in range(4):
        one = [t[lane].contiguous() for t in (key_s, perm, raw)]
        c1, m1, n1 = vf.voxel_segments(*one, 90000, 2.0, 0.5)
        assert torch.equal(ck[lane], c1) and torch.equal(mk[lane], m1)
        assert torch.equal(nk[lane], n1)
        cp, mp, n_p = vf.voxel_segments_plain(*one, 90000, 2.0, 0.5)
        assert int(nk[lane]) == int(n_p) and torch.equal(mk[lane], mp)
        assert float((ck[lane] - cp).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# lanes: K1, K2a, K3 and K2b with B = 4 (the blocked runner's launches)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lane_scene(scene):
    """Four scans near the scene's last pose, as four lanes over the scene's
    map, each with its own pose guess."""
    world = synthetic.make_world(seed=5, extent=60.0, n_buildings=14)
    pose = synthetic.straight_trajectory(6, step=0.4)[5]
    rng = np.random.default_rng(55)
    raws = np.full((4, 8000, 3), np.nan, np.float32)
    for b in range(4):
        s = synthetic.sample_scan(world, pose, 8000 - 500 * b, rng, max_range=50.0, noise=0.01)
        raws[b, :len(s)] = s
    raw = torch.tensor(raws, device="cuda")
    feat, mask, _ = vf.voxel_filter(raw, 8000, voxel_size=0.5, stride=1, out_capacity=8192,
                                    compact_keys=True)
    T = scene["T"].view(4, 4).repeat(4, 1, 1)
    T[:, 0, 3] += torch.arange(4, device="cuda", dtype=torch.float32) * 0.05
    return dict(raw=raw, feat=feat, mask=mask, T=T.reshape(4, 16).contiguous())


def test_lane_kernels_equal_one_lane_launches(scene, lane_scene):
    """Each lane of a B = 4 launch is bit-identical to a B = 1 launch on its
    inputs, and within the one-lane tolerances of the plain versions. Lane
    2's solve is done: K2a, K3 and K2b pass it through while lanes 0, 1 and
    3 work."""
    st, cfg, consts = scene["carry"].map_state, scene["cfg"], scene["consts"]
    raw, feat, mask, T = (lane_scene[k] for k in ("raw", "feat", "mask", "T"))
    one = lambda t, b: t[b].contiguous()

    coords = torch.floor(torch.nan_to_num(raw, 0.0, 0.0, 0.0) * 2.0).to(torch.int32)
    key, ok = K.compact_key(coords)
    key = torch.where(ok & torch.all(torch.isfinite(raw), -1), key, K.INVALID_SORT_KEY)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    n0 = kernels.KERNELS["voxel_filter"].launches
    ck, mk, nk = vf.voxel_segments(key_s, perm, raw, 8192, 2.0, 0.5)
    torch.cuda.synchronize()
    assert kernels.KERNELS["voxel_filter"].launches == n0 + 1
    for b in range(4):
        c1, m1, n1 = vf.voxel_segments(one(key_s, b), one(perm, b), one(raw, b), 8192, 2.0, 0.5)
        assert torch.equal(ck[b], c1) and torch.equal(mk[b], m1) and torch.equal(nk[b], n1)
        cp, mp, n_p = vf.voxel_segments_plain(key_s[b], perm[b], raw[b], 8192, 2.0, 0.5)
        assert int(nk[b]) == int(n_p) and torch.equal(mk[b], mp)
        assert float((ck[b] - cp).abs().max()) <= 1e-5

    live = (0, 1, 3)
    flags = torch.zeros((4, 3), dtype=torch.int32, device="cuda")
    flags[2, 0] = 1
    nrm, r, v = icp.icp_correspond(feat, mask, T, flags, st, cfg)
    for b in live:
        n1, r1, v1 = icp.icp_correspond(one(feat, b), one(mask, b), one(T, b), one(flags, b),
                                        st, cfg)
        assert torch.equal(nrm[b], n1) and torch.equal(r[b], r1) and torch.equal(v[b], v1)
        _, rp, vp = icp.icp_correspond_plain(feat[b], mask[b], T[b], st, cfg)
        assert int((v[b] != vp).sum()) <= 2
        assert float((r[b] - rp)[v[b] & vp].abs().max()) <= 1e-4

    scale = torch.full((4, 1), 0.5, device="cuda")
    aux, s = pko.pko_alpha_index(r, v, flags, scale, True, consts)
    assert aux[2].tolist() == [0, 0] and float(s[2, 0]) == 0.5
    for b in range(4):
        a1, s1 = pko.pko_alpha_index(one(r, b), one(v, b), one(flags, b), one(scale, b), True,
                                     consts)
        assert torch.equal(aux[b], a1) and torch.equal(s[b], s1)
    for b in live:
        a_p, c_p, s_p = pko.pko_alpha_index_plain(r[b], v[b], scale[b].reshape(()), True, consts)
        assert int(aux[b, 1]) == int(a_p) and int(aux[b, 0]) == int(c_p)
        assert abs(float(s[b, 0]) - float(s_p)) <= 1e-5 * float(s_p)

    Tk, fk, hk = icp.icp_normal_eq(feat, nrm, r, v, T, s, flags, aux, consts, cfg)
    assert torch.equal(Tk[2], T[2]) and torch.equal(fk[2], flags[2])
    for b in range(4):
        T1, f1, h1 = icp.icp_normal_eq(one(feat, b), one(nrm, b), one(r, b), one(v, b), one(T, b),
                                       one(s, b), one(flags, b), one(aux, b), consts, cfg)
        assert torch.equal(Tk[b], T1) and torch.equal(fk[b], f1)
        if b in live:
            assert torch.equal(hk[b], h1)
    for b in live:
        Tp, fp_, hp = icp.icp_normal_eq_plain(feat[b], nrm[b], r[b], v[b], T[b], s[b], flags[b],
                                              aux[b], consts, cfg)
        assert torch.equal(fk[b], fp_)
        assert float((Tk[b] - Tp).abs().max()) <= 1e-5
        assert float(((hk[b] - hp).abs() / hp.abs().clamp(min=1.0)).max()) <= 1e-4


def test_lane_icp_solve_with_an_early_finish(scene, lane_scene):
    """icp_optimize over four lanes, one of them with no valid point (it
    fails at iteration 0 and stays frozen while the others iterate): each
    lane equals its one-lane solve exactly."""
    st, cfg, consts = scene["carry"].map_state, scene["cfg"], scene["consts"]
    feat, mask = lane_scene["feat"], lane_scene["mask"].clone()
    mask[1] = False
    T0 = lane_scene["T"].view(4, 4, 4)
    T, ok, nc = icp.icp_optimize(st, feat, mask, T0, consts, cfg)
    assert ok.tolist() == [True, False, True, True] and torch.equal(T[1], T0[1])
    for b in range(4):
        T1, ok1, nc1 = icp.icp_optimize(st, feat[b].contiguous(), mask[b].contiguous(),
                                        T0[b].contiguous(), consts, cfg)
        assert torch.equal(T[b], T1) and torch.equal(ok[b], ok1) and torch.equal(nc[b], nc1)


def test_wrappers_refuse_what_the_kernels_do_not_take(scene):
    raw = scene["raw"]
    key = torch.zeros(raw.shape[0], dtype=torch.int32, device="cuda")
    perm = torch.zeros(raw.shape[0], dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        vf.voxel_segments(key, perm, raw, 16, 2.0, 0.5)
    with pytest.raises(ValueError):
        vf.voxel_segments(key.long(), perm, raw[:, :2].contiguous(), 16, 2.0, 0.5)


# ---------------------------------------------------------------------------
# the loop-closure kernels (K6a, K6b, K7, K7c, K8a-c, K8g, K9a, K9b, K2b's
# weight residual)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_scene(scene):
    feat, mask = scene["feat"], scene["mask"]
    T = scene["T"].view(4, 4)
    world = lie.transform_points(T, feat).contiguous()
    drift = torch.eye(4, device="cuda")
    drift[:3, 3] = torch.tensor([0.6, -0.4, 0.0], device="cuda")
    return dict(world=world, mask=mask, q=feat[::2].contiguous(), q_mask=mask[::2].contiguous(),
                T=T, T_q=(drift @ T).contiguous())


def test_point_table_kernels(loop_scene):
    from lidar_odometry_tpu_torch.ops import knn
    world, mask = loop_scene["world"], loop_scene["mask"]
    for bin_size, fits in ((2.0, True), (0.1, False)):
        t = knn.build_point_table(world, mask, bin_size=bin_size)
        g, m = knn.point_grid_plain(t.key, t.pts, t.inv)
        assert torch.equal(t.grid, g) and torch.equal(t.meta, m) and bool(t.fits) == fits
        q = lie.transform_points(loop_scene["T_q"], loop_scene["q"]).contiguous()
        for k, radius, width in ((5, 1, 8), (5, 2, 8), (5, 1, 4), (1, 1, 8)):
            nk, ok_k, dk = knn.knn_query(t, q, k=k, radius=radius, bucket_width=width)
            np_, ok_p, dp = knn.knn_query_plain(t, q, k=k, radius=radius, bucket_width=width)
            assert torch.equal(ok_k, ok_p) and torch.equal(nk[ok_k], np_[ok_p])
            fin = torch.isfinite(dp)
            assert torch.equal(torch.isfinite(dk), fin)
            assert float((dk[fin] - dp[fin]).abs().max()) <= 1e-5


def test_bev_and_loop_solve_kernels(loop_scene, scene):
    from lidar_odometry_tpu_torch.ops import bev_align
    q, q_mask, world, mask = (loop_scene[k] for k in ("q", "q_mask", "world", "mask"))
    T16 = loop_scene["T_q"].reshape(16).contiguous()
    center = loop_scene["T"][:3, 3].contiguous()
    ik = bev_align.bev_raster(q, q_mask, T16, world, mask, center)
    ip = bev_align.bev_raster_plain(q, q_mask, T16, world, mask, center)
    assert ik.dtype == torch.complex64 and int((ik != ip).sum()) == 0
    # the whole loop solve through the kernels lands where its plain path does
    cfg, consts = scene["cfg"], scene["consts"]
    local = scene["feat"]
    args = (q, q_mask, loop_scene["T_q"], local, mask, loop_scene["T"],
            torch.tensor(0.0, device="cuda"), consts, cfg)
    counts = kernels.counts()
    pk = icp.loop_closure_solve(*args, bucket_width=8, max_loop_iterations=30)
    after = kernels.counts()
    assert all(after[k] > counts[k] for k in ("point_grid", "point_knn", "point_nn1",
                                              "bev_raster", "plane_fit_5nn", "icp_normal_eq"))
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    cpu[7] = pko.make_pko_constants(*ARGS, device="cpu")
    pp = icp.loop_closure_solve(*cpu, bucket_width=8, max_loop_iterations=30)
    pk = pk.cpu()
    assert (pk[16] > 0.5) == (pp[16] > 0.5)
    assert float((pk[:16] - pp[:16]).abs().max()) <= 1e-3


def test_bev_raster_cell_edges(dev):
    """K7 on points that lie exactly on cell edges
    after the transform (a yaw of 90 degrees and a whole-metre shift move
    integer coordinates onto integers), next to them by one float32 step,
    masked out, off the grid and on its last row and column: bit-equal to
    the twin, every cell written (a NaN-filled output buffer leaves none
    behind), the imaginary parts 0."""
    from lidar_odometry_tpu_torch.ops import bev_align
    g = np.random.default_rng(3)
    edge = g.integers(-70, 70, size=(3000, 3)).astype(np.float32)
    toward = (np.sign(g.normal(size=(1000, 3))) * np.inf).astype(np.float32)
    near = np.nextafter(edge[:1000], toward)
    a = np.concatenate([edge, near,
                        g.uniform(-80, 80, size=(4000, 3)).astype(np.float32)])
    b = np.concatenate([edge[::-1] + np.float32(0.5), g.uniform(-70, 70, (5000, 3))
                        .astype(np.float32), [[63.0, 63.0, 0.0], [-64.0, -64.0, 0.0]]])
    T = np.array([[0, -1, 0, 3], [1, 0, 0, -2], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    pa, pb = t(a.astype(np.float32)), t(b.astype(np.float32))
    ma = t(g.random(len(a)) < 0.9)
    mb = g.random(len(b)) < 0.9
    mb[-2:] = True
    mb = t(mb)
    center = t(np.array([0.0, 0.0, 1.0], np.float32))
    # the caching allocator hands this NaN-filled block to the kernel's output
    junk = torch.full((2, 128, 128), float("nan"), dtype=torch.complex64, device=dev)
    del junk
    ik = bev_align.bev_raster(pa, ma, t(T.reshape(16)), pb, mb, center)
    ip = bev_align.bev_raster_plain(pa, ma, t(T.reshape(16)), pb, mb, center)
    torch.cuda.synchronize()
    bits = lambda x: torch.view_as_real(x).view(torch.int32)
    assert torch.equal(bits(ik), bits(ip))
    assert bool((ik.imag == 0).all()) and int(ik.real.sum()) > 1000
    assert float(ik.real[0, 127].sum() + ik.real[1, 127].sum()) > 0


def test_iris_kernels(loop_scene):
    from lidar_odometry_tpu_torch.ops import iris
    clouds = torch.stack([loop_scene["q"], loop_scene["q"].flip(0)]).contiguous()
    masks = torch.stack([loop_scene["q_mask"], loop_scene["q_mask"].flip(0)]).contiguous()
    bk = iris.iris_bits(clouds, masks)
    bp = iris._iris_bits_plain(clouds, masks)
    assert int((bk != bp).sum()) <= 2
    filters = torch.as_tensor(iris.log_gabor_filters(), device="cuda")
    resp = iris._responses(bk.float(), filters).contiguous()
    Tk, Mk = iris.iris_encode(resp)
    Tp, Mp = iris.iris_encode_plain(resp)
    assert torch.equal(Tk, Tp) and torch.equal(Mk, Mp)
    cand = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device="cuda")
    valid = torch.tensor([True, True, True, False], device="cuda")
    shifts = iris.phase_shifts(bk[0].float(), bk[cand.long()].float())
    hk = iris.iris_hamming(Tk, Mk, 0, cand, shifts, valid)
    hp = iris.iris_hamming_plain(Tk, Mk, 0, cand, shifts, valid)
    assert torch.equal(hk[:, 1], hp[:, 1]) and torch.isinf(hk[3, 0])
    assert float((hk[:3, 0] - hp[:3, 0]).abs().max()) <= 1e-6 and float(hk[0, 0]) == 0.0


def test_spectrum_kernels(loop_scene):
    """K7c cross_power at the prealign's and the Iris query's shapes, and
    K8g gabor_product, against their plain twins: within 1e-6 of the
    unit-magnitude spectra, the Gabor products bit for bit, and the phase
    correlations' shifts equal."""
    from lidar_odometry_tpu_torch.ops import bev_align, iris
    g = torch.Generator(device="cuda").manual_seed(3)
    bits = lambda t: torch.view_as_real(t).view(torch.int32)
    for b, n in ((1, 128 * 128), (8, iris.ROWS * iris.COLS)):
        x = torch.randn((b, n), dtype=torch.complex64, device="cuda", generator=g)
        y = torch.randn((n,), dtype=torch.complex64, device="cuda", generator=g)
        y[:7] = 0
        ck, cp = bev_align.cross_power(x, y), bev_align.cross_power_plain(x, y)
        assert float((ck - cp).abs().max()) <= 1e-6
        assert torch.equal(bits(ck), bits(cp))
    # the two-tensor form (x's rows, then x2's; row chunks cut across the
    # two), an odd N (8-byte loads and stores), and a misaligned x refused
    for b1, b2, n in ((3, 3, iris.ROWS * iris.COLS), (1, 6, 63), (5, 0, 17)):
        x = torch.randn((b1, n), dtype=torch.complex64, device="cuda", generator=g)
        x2 = torch.randn((b2, n), dtype=torch.complex64, device="cuda", generator=g)
        y = torch.randn((n,), dtype=torch.complex64, device="cuda", generator=g)
        y[1] = 0
        ck = bev_align.cross_power(x, y, x2 if b2 else None)
        assert torch.equal(bits(ck), bits(bev_align.cross_power_plain(x, y, x2)))
        assert torch.equal(bits(ck), bits(bev_align.cross_power(torch.cat([x, x2]), y)))
    # magnitudes over the float range: elements past the fast reciprocal's
    # range (2^125 and up, some infinite, some NaN), clamped ones (1e-12)
    n = 4096
    scale = lambda: 10.0 ** torch.empty(n, device="cuda").uniform_(-15.0, 19.5, generator=g)
    x = torch.randn((3, n), dtype=torch.complex64, device="cuda", generator=g) * scale()
    y = torch.randn((n,), dtype=torch.complex64, device="cuda", generator=g) * scale()
    ck, cp = bev_align.cross_power(x, y), bev_align.cross_power_plain(x, y)
    nan = torch.isnan(torch.view_as_real(ck))
    assert torch.equal(nan, torch.isnan(torch.view_as_real(cp)))
    assert torch.equal(bits(ck)[~nan], bits(cp)[~nan])
    mag = torch.hypot(*torch.view_as_real(x * torch.conj(y)[None]).unbind(-1))
    assert bool((mag >= 2.0 ** 125).any()) and bool((mag < 1e-12).any())
    shifted = torch.empty(2 * 64 + 1, dtype=torch.complex64, device="cuda")[1:].view(2, 64)
    with pytest.raises(kernels.KernelInputError):
        bev_align.cross_power(shifted, torch.zeros(64, dtype=torch.complex64, device="cuda"))
    clouds = torch.stack([loop_scene["q"], loop_scene["q"].flip(0)]).contiguous()
    masks = torch.stack([loop_scene["q_mask"], loop_scene["q_mask"].flip(0)]).contiguous()
    img = iris.iris_bits(clouds, masks).float()
    spec = torch.fft.fft(img.to(torch.complex64), dim=-1)
    filters = torch.as_tensor(iris.log_gabor_filters(), device="cuda")
    assert torch.equal(iris.gabor_product(spec, filters), iris.gabor_product_plain(spec, filters))
    before = kernels.counts()["cross_power"]
    sk = iris.phase_shifts(img[0], img)
    assert kernels.counts()["cross_power"] == before + 1
    # the same shifts through the plain cross-power spectrum
    qf = torch.fft.fft2(img[0].to(torch.complex64))
    fd = torch.fft.fft2(img.to(torch.complex64))
    fdx = torch.fft.fft2(torch.roll(img, 180, -1).to(torch.complex64))
    cross = bev_align.cross_power_plain(torch.cat([fd, fdx]).reshape(4, -1), qf.reshape(-1))
    corr = torch.real(torch.fft.ifft2(cross.view(4, iris.ROWS, iris.COLS)))
    dx = torch.argmax(corr.reshape(4, -1), 1) % iris.COLS
    dx = torch.where(dx >= iris.COLS // 2, dx - iris.COLS, dx).view(2, 2).T
    assert torch.equal(sk, dx.to(torch.int32)) and int(sk[0, 0]) == 0


def test_bulk_index_kernel(scene):
    """K9a against its plain twin on the rehash of a map: the same index
    and meta rows, bit for bit, and the same count of placed parents."""
    st = scene["carry"].map_state
    T = torch.eye(4, device="cuda")
    T[:3, 3] = torch.tensor([1.3, -0.7, 0.2], device="cuda")
    cen, cnt, live, cap, _ = vm.rehash_records(st, T)
    plan = vm.bulk_plan(cen, cnt, live, cap, st.c1, voxel_size=0.5)
    args = vm.bulk_parents(plan.s_key, plan.first, cap, st.c1, plan.fresh.n_buckets)
    a, b = vm.empty_map(0, st.c1, device="cuda"), vm.empty_map(0, st.c1, device="cuda")
    na = vm.map_bulk_index(*args, a.l1_index, a.l1_meta, st.c1)
    nb = vm.map_bulk_index_plain(*args, b.l1_index, b.l1_meta, st.c1)
    assert int(na) == int(nb) > 100
    assert torch.equal(a.l1_index, b.l1_index) and torch.equal(a.l1_meta, b.l1_meta)
    # fewer slots than parents: the ones past the top are not placed
    a, b = vm.empty_map(0, st.c1, device="cuda"), vm.empty_map(0, st.c1, device="cuda")
    na = vm.map_bulk_index(*args, a.l1_index, a.l1_meta, 50)
    nb = vm.map_bulk_index_plain(*args, b.l1_index, b.l1_meta, 50)
    assert int(na) == int(nb) == 50
    assert torch.equal(a.l1_index, b.l1_index) and torch.equal(a.l1_meta, b.l1_meta)


def test_rehash_kernel(scene):
    st = scene["carry"].map_state
    T = torch.eye(4, device="cuda")
    T[:3, :3] = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                             device="cuda")
    T[:3, 3] = torch.tensor([3.0, -2.0, 0.5], device="cuda")
    cen, cnt, live, cap, nd = vm.rehash_records(st, T)
    plan = vm.bulk_plan(cen, cnt, live, cap, st.c1, voxel_size=0.5)
    a, b = plan.fresh.l0_data.clone(), plan.fresh.l0_data.clone()
    pa = vm.map_bulk_merge(a, plan.s_key, plan.s_idx, plan.first, plan.counts, plan.centroids,
                           plan.fresh.l1_index)
    pb = vm.map_bulk_merge_plain(b, plan.s_key, plan.s_idx, plan.first, plan.counts,
                                 plan.centroids, plan.fresh.l1_index)
    assert torch.equal(pa, pb) and int(pa[0]) > 1000
    assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) <= 1e-5
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # the whole rehash on the card against its plain path on the host
    rk = vm.transform_and_rehash(st, T, voxel_size=0.5, planarity_threshold=0.1)
    cpu = vm.VoxelMapState(*(x.cpu() for x in st))
    rp = vm.transform_and_rehash(cpu, T.cpu(), voxel_size=0.5, planarity_threshold=0.1)
    for name in ("l1_index", "l1_meta", "l1_free_top", "n_l0", "n_l1", "n_dropped"):
        assert torch.equal(getattr(rk, name).cpu(), getattr(rp, name)), name


def test_bulk_merge_kernel_edges(dev):
    """K9b against its twin on records (synthetic.merge_records) whose
    runs of equal keys cross the kernel's 32-record tiles, one longer than
    a tile and its window of 8 records after it (the serial loop), M not a
    multiple of 32, dead records between live ones, some parents left out
    of the index; and on an all-dead record set. The rows bit for bit,
    the placed and dropped counts equal, and equal again on a second call
    (the kernel leaves its scratch zeroed); and the same live records
    padded with dead ones past 2^24 records (a sharded map's rehash at
    27 x map_l1_capacity >= 2^24): the same rows and counts."""
    for n_live, n_dead in ((3000, 333), (0, 500)):
        cen, cnt, live = (torch.as_tensor(a, device=dev)
                          for a in synthetic.merge_records(n_live, n_dead, seed=3))
        plan = vm.bulk_plan(cen, cnt, live, cen.shape[0], 256, voxel_size=0.5)
        args = (plan.s_key, plan.s_idx, plan.first, plan.counts, plan.centroids,
                plan.fresh.l1_index)
        a, b = plan.fresh.l0_data.clone(), plan.fresh.l0_data.clone()
        pa, pb = vm.map_bulk_merge(a, *args), vm.map_bulk_merge_plain(b, *args)
        assert torch.equal(pa, pb) and torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(vm.map_bulk_merge(a, *args), pa)
        if n_live:
            assert int(pa[0]) > 100 and int(pa[1]) > 0
            run = torch.unique_consecutive(plan.s_key, return_counts=True)[1]
            assert int(run[:-1].max()) > 32 + 8
            pad = (1 << 24) + 37 - plan.s_key.shape[0]
            z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
            big = (torch.cat([plan.s_key, z(pad, dtype=torch.int64) + K.INVALID_SORT_KEY]),
                   torch.cat([plan.s_idx, z(pad, dtype=torch.int64)]),
                   torch.cat([plan.first, z(pad, dtype=torch.bool)]),
                   torch.cat([plan.counts, z(pad)]), torch.cat([plan.centroids, z(pad, 3)]),
                   plan.fresh.l1_index)
            c = plan.fresh.l0_data.clone()
            assert torch.equal(vm.map_bulk_merge(c, *big), pa)
            assert torch.equal(c.view(torch.int32), a.view(torch.int32))
        else:
            assert pa.tolist() == [0, 0] and not bool(a.any())


def test_weight_residual_kernel(scene):
    st, cfg, consts = scene["carry"].map_state, scene["cfg"], scene["consts"]
    feat, mask, T = scene["feat"], scene["mask"], scene["T"]
    flags = torch.zeros((3,), dtype=torch.int32, device="cuda")
    nk, rk, vk = icp.icp_correspond(feat, mask, T, flags, st, cfg)
    aux, s = pko.pko_alpha_index(rk, vk, flags, torch.ones((1,), device="cuda"), True, consts)
    rw = (rk.abs() * 1.5).contiguous()
    Tk, fk, hk = icp.icp_normal_eq(feat, nk, rk, vk, T, s, flags, aux, consts, cfg, rw=rw)
    Tp, fp_, hp = icp.icp_normal_eq_plain(feat, nk, rk, vk, T, s, flags, aux, consts, cfg, rw=rw)
    assert torch.equal(fk, fp_) and float((Tk - Tp).abs().max()) <= 1e-5
    T0, _, h0 = icp.icp_normal_eq(feat, nk, rk, vk, T, s, flags, aux, consts, cfg)
    assert not torch.equal(h0, hk)


def test_loop_worker_on_its_own_stream(dev):
    """The loops-on estimator on the card with the loop worker thread (its
    own CUDA stream, an event per query) and inline, and the worker with
    the distributed pose-graph backend (the PGO kernels on the worker's
    stream): each closes the circuit's loop, rehashes the map and logs no
    loop error."""
    from lidar_odometry_tpu_torch.config import SystemConfig
    from lidar_odometry_tpu_torch.eval import ate_rmse
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    world = synthetic.make_world(seed=9, extent=60.0, n_buildings=18)
    poses = synthetic.circuit_trajectory(220, length=30.0, radius=10.0, step=0.6)
    rng = np.random.default_rng(9)
    scans = np.full((220, 6000, 3), np.nan, np.float32)
    for i, p in enumerate(poses):
        s = synthetic.sample_scan(world, p, 6000, rng, max_range=45.0, noise=0.02)
        scans[i, :len(s)] = s
    cfg = SystemConfig(scan_capacity=8192, map_l0_capacity=131072, map_l1_capacity=32768,
                       keyframe_capacity=256, point_stride=1, enable_loop_detection=True,
                       min_keyframe_gap=25, max_search_distance=8.0, similarity_threshold=0.4,
                       enable_console_statistics=False)
    for sync_loop, backend in ((False, "manual"), (True, "manual"), (False, "distributed")):
        est = Estimator(cfg.replace(pgo_backend=backend), sync_loop=sync_loop, device=dev)
        for c in range(0, 220, 20):
            est.process_chunk(scans[c:c + 20])
        est.finalize_loops()
        torch.cuda.synchronize()
        assert est.loop_errors == 0 and est.get_loop_closure_count() >= 1
        assert est.rehash_count >= 1
        assert ate_rmse(est.trajectory(), poses) < 0.1
        est.reset()
        assert est.loop_detector._db_n == 0



# ---------------------------------------------------------------------------
# the pose-graph kernels (K10a-K10d)
# ---------------------------------------------------------------------------

def _pgo_graph(n, dev):
    """n keyframes on a circuit revisited every lap, 4 loop edges, on the card."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    length, radius, gap = (3.0, 1.0, 4) if n < 50 else (40.0, 10.0, 50)
    init, priors, betweens, _ = synthetic.revisit_pose_graph(n, 4, seed=n, length=length,
                                                             radius=radius, min_gap=gap)
    return dpgo.upload(dpgo.pack_graph(init, priors, betweens), dev), (init, priors, betweens)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


@pytest.mark.parametrize("n", [17, 300])
def test_pgo_kernels(dev, n):
    """K10a-K10d each against its plain twin on the same inputs, one
    iteration: 1e-10 of each output's largest magnitude, 1e-9 m on the
    retracted poses."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    g, _ = _pgo_graph(n, dev)
    poses = g["poses"]
    n0 = kernels.counts()
    lin_k = dpgo.linearize(g, poses)
    lin_p = dpgo.linearize_plain(poses, *[g[k] for k in dpgo.LIN_KEYS])
    for a, b in zip(lin_k, lin_p):
        assert _rel(a, b) <= 1e-10
    el_k = dpgo.eliminate(g, *lin_p[:3])
    el_p = dpgo.eliminate_plain(*lin_p[:3], *[g[k] for k in dpgo.PLAN_KEYS])
    for a, b in zip(el_k, el_p):
        assert _rel(a, b) <= 1e-10
    xs_k = dpgo.reduced_solve(g, *lin_p, *el_p[:2])
    xs_p = dpgo.reduced_solve_plain(*lin_p, *el_p[:2], *[g[k] for k in dpgo.RED_KEYS])[0]
    assert _rel(xs_k, xs_p) <= 1e-10
    p_p, dxn, ok = dpgo.backsub_retract_plain(poses, xs_p, *el_p[2:],
                                              *[g[k] for k in dpgo.BACK_KEYS], g["real_mask"])
    p_k = poses.clone()
    dpgo.backsub_retract(g, p_k, xs_p, *el_p[2:], 10, 1e-6)
    assert float((p_k - p_p).abs().max()) <= 1e-9
    st = g["st"].cpu()
    assert st[0] == 1 and st[2] == 1 and bool(ok) and st[3] == 1
    assert abs(float(st[1]) - float(dxn)) <= 1e-12 * float(dxn)
    counts = kernels.counts()
    for name in ("pgo_linearize", "pgo_eliminate", "pgo_reduced_solve", "pgo_backsub_retract"):
        assert counts[name] == n0[name] + 1


def test_pgo_optimize_on_the_card_is_deterministic_and_matches_the_cpu(dev):
    """Two calls of gn_optimize_device on the card give the same poses bit
    for bit (the kernels sum in a fixed order), within 1e-9 of the plain
    twins on the CPU, with the same ok and iteration-for-iteration loop."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    _, (init, priors, betweens) = _pgo_graph(300, dev)
    a, ok_a = dpgo.gn_optimize_device(init, priors, betweens, device=dev)
    b, ok_b = dpgo.gn_optimize_device(init, priors, betweens, device=dev)
    c, ok_c = dpgo.gn_optimize_device(init, priors, betweens, device="cpu")
    assert ok_a and ok_b and ok_c
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, c, atol=1e-9, rtol=0)


def test_pgo_kernels_raise_and_do_not_fall_back(dev):
    """A plan tensor left on the CPU is refused on the card, by the wrapper
    and through PoseGraphOptimizer's device solve alike: no route to the
    plain twins."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    g, _ = _pgo_graph(17, dev)
    diag, off, b, _ = dpgo.linearize(g, g["poses"])
    g["int_idx"] = g["int_idx"].cpu()
    with pytest.raises(ValueError, match="int_idx"):
        dpgo.eliminate(g, diag, off, b)
    g, _ = _pgo_graph(17, dev)
    g["st"] = g["st"].float()
    with pytest.raises(ValueError, match="st"):
        dpgo.linearize(g, g["poses"])


# tests/test_torch_kernel_edges.py's K10b plans: (n_pad, separators)
K10B_CASES = {
    "one_row_each": (8, [1, 2, 4, 5, 7]),
    "edges": (64, [3, 4, 6, 30, 31, 63]),
    "long_chain": (256, [200, 255]),
}


@pytest.mark.parametrize("case", sorted(K10B_CASES))
def test_eliminate_kernel_edges(dev, case):
    """K10b against its plain twin at 1e-10 of each output's largest
    magnitude, two calls bit-equal, on plans whose partitions have one
    valid row, none, no left separator, and chains longer than the
    kernel's 16-row staging ring."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    n_pad, seps = K10B_CASES[case]
    c = {k: torch.tensor(v, device=dev)
         for k, v in synthetic.chain_system(n_pad, seed=n_pad).items()}
    plan = dpgo.make_plan(n_pad, seps)
    g = {k: torch.tensor(plan[k].astype(np.int32), device=dev) for k in dpgo.PLAN_KEYS}
    g["st"] = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64, device=dev)
    args = [c[k] for k in ("diag", "off", "b")]
    n0 = kernels.KERNELS["pgo_eliminate"].launches
    got = dpgo.eliminate(g, *args)
    again = dpgo.eliminate(g, *args)
    ref = dpgo.eliminate_plain(*args, *[g[k] for k in dpgo.PLAN_KEYS])
    torch.cuda.synchronize()
    assert kernels.KERNELS["pgo_eliminate"].launches == n0 + 2
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert _rel(a, r) <= 1e-10


def _separator_case(D, seed, dev, spd=True):
    """K10c's inputs for D separators (synthetic.separator_system, 6 loop
    blocks), an active loop state in g["st"]."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    c = {k: torch.tensor(v, device=dev)
         for k, v in synthetic.separator_system(D, 6, seed, spd).items()}
    g = {k: c[k] for k in dpgo.RED_KEYS}
    g["st"] = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64, device=dev)
    return g, [c[k] for k in ("diag", "off", "b", "lb", "S", "r")]


@pytest.mark.parametrize("D", [1, 5, 7, 200])
def test_reduced_solve_kernel_sizes(dev, D):
    """K10c against its plain twin at D = 1, at D not a multiple of its
    4-separator panel, and at D = 200, whose 1200 x 1200 system (11.5 MB)
    is larger than the cluster's shared memory: normwise backward error in
    the twin's system at most 1e-13, xs within 1e-10 of the twin's (these
    systems are well conditioned), two calls bit-equal."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    g, args = _separator_case(D, D, dev)
    n0 = kernels.KERNELS["pgo_reduced_solve"].launches
    xs_k = dpgo.reduced_solve(g, *args)
    xs_k2 = dpgo.reduced_solve(g, *args)
    xs_p, Hs, bs = dpgo.reduced_solve_plain(*args, *[g[k] for k in dpgo.RED_KEYS])
    torch.cuda.synchronize()
    assert kernels.KERNELS["pgo_reduced_solve"].launches == n0 + 2
    x = xs_k.reshape(-1)
    backward = float((Hs @ x - bs).abs().max() / (Hs.abs().sum(1).max() * x.abs().max()))
    assert backward <= 1e-13
    assert _rel(xs_k, xs_p) <= 1e-10
    assert torch.equal(xs_k, xs_k2)
    shape = dpgo.reduced_solve_shape()
    assert shape["cluster"] >= 8 and shape["panel"] == 24


def test_reduced_solve_kernel_inactive_and_not_spd(dev):
    """With the loop state inactive K10c writes nothing (xs keeps what it
    held); a system that is not positive definite gives NaN in every entry
    of xs, as the twin does."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    g, args = _separator_case(9, 3, dev)
    g["st"][3] = 0.0
    xs = torch.full((9, 6), 7.0, dtype=torch.float64, device=dev)
    dpgo._reduced_launch(g, *args, xs)
    torch.cuda.synchronize()
    assert torch.equal(xs, torch.full_like(xs, 7.0))
    g, args = _separator_case(9, 3, dev, spd=False)
    xs_k = dpgo.reduced_solve(g, *args)
    xs_p = dpgo.reduced_solve_plain(*args, *[g[k] for k in dpgo.RED_KEYS])[0]
    assert bool(torch.isnan(xs_k).all()) and bool(torch.isnan(xs_p).all())


def _chain_system(n, seed):
    """A random well-conditioned block-tridiagonal system (the JAX parallel
    tests' chain): diag (n,6,6), off (n-1,6,6), b (n,6)."""
    rng = np.random.default_rng(seed)
    off = rng.standard_normal((max(n - 1, 0), 6, 6)) * 0.3
    diag = np.eye(6) * 8.0 + rng.standard_normal((n, 6, 6)) * 0.1
    return (diag + diag.swapaxes(1, 2)) / 2, off, rng.standard_normal((n, 6))


def _graph_system(n):
    """The first Gauss-Newton system of a revisit pose graph of n keyframes
    as PoseGraphOptimizer._solve_distributed builds it, and its plan."""
    from lidar_odometry_tpu_torch.models.pose_graph import BetweenFactor, PoseGraphOptimizer
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    init, priors, betweens, _ = synthetic.revisit_pose_graph(n, 4, seed=n, length=40.0,
                                                             radius=10.0, min_gap=50)
    pg = PoseGraphOptimizer(backend="distributed", device="cpu")
    pg.add_first_keyframe(0, init[0])
    for i in range(1, n):
        pg.add_keyframe_with_odom(i - 1, i, init[i], betweens[i - 1][2], 0.1, 0.01)
    for i, j, rel, sq in betweens[n - 1:]:
        pg._betweens.append(BetweenFactor(i, j, rel, sq))
    diag, off, b, loops, blocks = pg._linearize_distributed(n)
    return diag, off, b, dpgo.plan_partition(n, 8, loops)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_schur_kernels(dev, dtype):
    """K12a (block-Thomas) and K12b (LU interior elimination) against their
    plain twins on the card, in float64 (1e-10 of each output's largest
    magnitude) and float32 (1e-5 of it: the same float32 algorithm in
    another order; each float32 result's distance from the float64 answer
    is larger, set by the conditioning, and is not held here); n = 1,
    max_m = 1 and an empty interior among them; each launch counted once
    and two launches bit-equal."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    dt = getattr(torch, dtype)
    f64 = dtype == "float64"
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    diag, off, b, seps = _graph_system(300)
    tol = 1e-10 if f64 else 1e-5
    chains = [_chain_system(n, n) for n in (1, 2, 300)] + [(diag, off, b)]
    for d_, o_, b_ in chains:
        args = [to(d_), to(o_), to(b_)]
        n0 = kernels.KERNELS["pgo_block_thomas"].launches
        xk = dpgo.block_tridiag_solve(*args)
        assert kernels.KERNELS["pgo_block_thomas"].launches == n0 + 1
        xp = dpgo.block_tridiag_solve_plain(*args)
        assert xk.dtype == dt and _rel(xk, xp) <= tol, (len(d_), _rel(xk, xp))
        assert torch.equal(xk, dpgo.block_tridiag_solve(*args))
    packings = [dpgo.pack_interiors(diag, off, b, seps)]
    d_, o_, b_ = _chain_system(7, 7)
    packings.append(dpgo.pack_interiors(d_, o_, b_, [1, 2, 3, 5, 6]))   # max_m = 1
    assert packings[1][0].shape[1] == 1
    for packed in packings:
        args = [to(a) for a in packed[:-1]] + [torch.from_numpy(packed[-1]).to(dev)]
        n0 = kernels.KERNELS["pgo_eliminate_lu"].launches
        outs = dpgo.eliminate_interior_lu(*args)
        assert kernels.KERNELS["pgo_eliminate_lu"].launches == n0 + 1
        for name, a, c in zip(("S", "r", "F", "G", "g"), outs,
                              dpgo.eliminate_interior_lu_plain(*args)):
            assert a.dtype == dt and a.shape == c.shape
            assert _rel(a, c) <= tol, (name, _rel(a, c))
        for a, c in zip(outs, dpgo.eliminate_interior_lu(*args)):
            assert torch.equal(a, c)


def test_schur_solve_on_the_card_matches_the_cpu(dev):
    """schur_partitioned_solve on the card within 1e-9 of the same solve on
    the CPU (the plain twins), bit-equal over a one-process ShardGroup of 4
    shards where the partitions split."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    from lidar_odometry_tpu_torch.parallel import mesh
    d_, o_, b_ = _chain_system(40, 8)
    loops = [(0, 30), (12, 30)]
    blocks = [(np.eye(6) * 2.0, -np.eye(6), np.eye(6) * 2.0)] * 2
    seps = dpgo.plan_partition(40, 6, loops)
    while len(seps) % 4:
        seps = dpgo.plan_partition(40, len(seps) + 1, loops)
    x = dpgo.schur_partitioned_solve(d_, o_, b_, seps, loops, blocks, device=dev)
    xc = dpgo.schur_partitioned_solve(d_, o_, b_, seps, loops, blocks, device="cpu")
    xg = dpgo.schur_partitioned_solve(d_, o_, b_, seps, loops, blocks,
                                      group=mesh.make_group(4, device=dev))
    assert x.dtype == np.float64
    np.testing.assert_allclose(x, xc, atol=1e-9, rtol=0)
    np.testing.assert_array_equal(xg, x)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_schur_kernel_edges(dev, dtype):
    """K12a and K12b against their plain twins at the tolerances of
    test_schur_kernels, at the edges of their launch shapes. K12a: n = 1, 2
    and 5 (more partitions than n / 2, empty interiors), n = 7 P - 1 and
    7 P + 1 (97, 99: 14 partitions of uneven size), 43 P - 1 and 43 P + 1
    (3697, 3699: 86 partitions, not a multiple of a CTA's 6 warps) and
    16000 (the 128-partition cap, and factors past a CTA's shared memory,
    in the global scratch). K12b: D = 5 partitions, three of them all
    padding; max_m = 800 (a partition's factors past its shared memory, in
    a global scratch); and D = 8 launched as four quarters, bit-equal
    to one launch over all D. Every call bit-equal to a second one."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    dt = getattr(torch, dtype)
    tol = 1e-10 if dtype == "float64" else 1e-5
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    for n in (1, 2, 5, 97, 99, 3697, 3699, 16000):
        args = [to(a) for a in _chain_system(n, n)]
        xk = dpgo.block_tridiag_solve(*args)
        xp = dpgo.block_tridiag_solve_plain(*args)
        assert _rel(xk, xp) <= tol, (n, _rel(xk, xp))
        assert torch.equal(xk, dpgo.block_tridiag_solve(*args)), n
    assert dpgo.thomas_partitions(16000) == dpgo.THOMAS_MAX_PARTITIONS

    def packed(n, seps):
        d_, o_, b_ = _chain_system(n, n)
        pk = dpgo.pack_interiors(d_, o_, b_, seps)
        return [to(a) for a in pk[:-1]] + [torch.from_numpy(pk[-1]).to(dev)]

    cases = [packed(40, [0, 1, 10, 11, 39]), packed(1602, [800, 1601])]
    assert int((~cases[0][-1].any(1)).sum()) == 3 and cases[1][0].shape[1] == 800
    for args in cases:
        outs = dpgo.eliminate_interior_lu(*args)
        for name, a, c in zip(("S", "r", "F", "G", "g"), outs,
                              dpgo.eliminate_interior_lu_plain(*args)):
            assert a.shape == c.shape and _rel(a, c) <= tol, (name, _rel(a, c))
        for a, c in zip(outs, dpgo.eliminate_interior_lu(*args)):
            assert torch.equal(a, c)
    seps = dpgo.plan_partition(100, 8, [])
    assert len(seps) == 8
    args = packed(100, seps)
    whole = dpgo.eliminate_interior_lu(*args)
    parts = [dpgo.eliminate_interior_lu(*[a[q:q + 2].contiguous() for a in args])
             for q in range(0, 8, 2)]
    for i, a in enumerate(whole):
        assert torch.equal(a, torch.cat([p[i] for p in parts]))


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_shard_kernels(scene, n_shards):
    """K11a-d against their plain twins on the card, on a map of the
    scene's voxels sharded over n_shards shards; instance k of an
    n-instance launch bit-equal to a one-instance launch of instance k."""
    from lidar_odometry_tpu_torch.parallel import mesh
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    from lidar_odometry_tpu_torch.parallel import sharded_map as sm
    cfg, consts = scene["cfg"], scene["consts"]
    feat, mask, T = scene["feat"], scene["mask"], scene["T"]
    g = mesh.make_group(n_shards, device="cuda")
    pts, live = vm.l0_points(scene["carry"].map_state)
    st = sm.sharded_empty_map(0, 8192 * n_shards, g)
    sm.sharded_update_map(st, pts.contiguous(), live.contiguous(), T.view(4, 4)[:3, 3], 1e4, g,
                          voxel_size=0.5, planarity_threshold=0.1)
    n = feat.shape[0]
    cap = so.owned_cap(n, n_shards)
    inv = so.owner_inv(0.5, 3)
    args = (feat[None].contiguous(), mask[None].contiguous(), T[None].contiguous())
    own_k = so.shard_own(*args, n_shards, 0, n_shards, cap, inv)
    own_p = so.shard_own_plain(*args, n_shards, 0, n_shards, cap, inv)
    assert all(torch.equal(a, b) for a, b in zip(own_k, own_p))
    for k in range(n_shards):
        one = so.shard_own(*args, n_shards, k, 1, cap, inv)
        assert all(torch.equal(a[0], b[k]) for a, b in zip(one, own_k))
    assert torch.equal(so.shard_owner(pts.contiguous(), n_shards, inv),
                       so.shard_owner_plain(pts.contiguous(), n_shards, inv))
    p_own, ok = own_k[0], own_k[1]
    flags = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    corr = [icp.icp_correspond(p_own[k], ok[k], T, flags[0], sm.local_view(st, k), cfg)
            for k in range(n_shards)]
    nrm, r, valid = (torch.stack(c).contiguous() for c in zip(*corr))
    T1 = T[None].contiguous()
    mk = so.shard_alpha_normal_eq(p_own, nrm, r, valid, T1, flags, None, None, cfg,
                                  n_local=n_shards, moments=True)
    mp = so.shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T1, flags, None, None, cfg,
                                        n_local=n_shards, moments=True)
    assert float(((mk - mp).abs() / mp.abs().clamp(min=1.0)).max()) <= 1e-5
    mom = mk.view(1, n_shards, 3)
    u, pick = (torch.as_tensor(a, device="cuda") for a in pko.shard_draws(n_shards))
    q = u.shape[1]
    ld = so.buffer_width(101, n_shards, q)
    rk, rp = (torch.zeros((n_shards, ld), device="cuda") for _ in range(2))
    for fn, out in ((so.shard_alpha_normal_eq, rk), (so.shard_alpha_normal_eq_plain, rp)):
        fn(p_own, nrm, r, valid, T1, flags, mom, consts.alphas, cfg, n_local=n_shards, out=out)
    _assert_systems_close(rk, rp, 101)
    so.shard_sample(r, valid, flags, mom, u, first=0, n_local=n_shards, off=101 * 42, out=rk)
    so.shard_sample_plain(r, valid, flags, mom, u, first=0, n_local=n_shards, off=101 * 42,
                          out=rp)
    assert torch.equal(rk[:, 101 * 42:-1], rp[:, 101 * 42:-1])
    for k in range(n_shards):
        one = torch.zeros((1, ld), device="cuda")
        so.shard_alpha_normal_eq(p_own[k:k + 1], nrm[k:k + 1], r[k:k + 1], valid[k:k + 1], T1,
                                 flags, mom, consts.alphas, cfg, n_local=1, out=one)
        so.shard_sample(r[k:k + 1], valid[k:k + 1], flags, mom, u, first=k, n_local=1,
                        off=101 * 42, out=one)
        assert torch.equal(one[0], rk[k])
    sel_k = so.shard_gn_select(rk[None], T1, flags, consts, pick, cfg, n_alpha=101, quota=q,
                               use_pko=True)
    sel_p = so.shard_gn_select_plain(rk[None], T1, flags, consts, pick, cfg, n_alpha=101,
                                     quota=q, use_pko=True)
    assert torch.equal(sel_k[2], sel_p[2]) and torch.equal(sel_k[1], sel_p[1])
    assert float((sel_k[0] - sel_p[0]).abs().max()) <= 1e-6
    torch.cuda.synchronize()


def _assert_systems_close(rk, rp, n_alpha):
    """K11b's rows against the twin's, each block at its own scale: the
    J J^T entries and the J r entries within 1e-5 of their block's
    largest, the count exactly."""
    cols = torch.arange(n_alpha * 42, device=rk.device).view(n_alpha, 42)
    for idx in (cols[:, :36].flatten(), cols[:, 36:].flatten()):
        assert float((rk[:, idx] - rp[:, idx]).abs().max()) <= 1e-5 * float(rp[:, idx].abs().max())
    assert torch.equal(rk[:, -1], rp[:, -1])


def test_shard_kernels_lanes(scene):
    """K11a-d at the step path's shapes (2 lanes x 4 shards, N = 14336),
    the lanes with their own scans, guesses and moments: every output
    against the plain twin with both lanes live and with each lane done
    in turn (its rows left unwritten), and lane b of each launch bit-equal
    to a one-lane launch on lane b's inputs."""
    from lidar_odometry_tpu_torch.parallel import mesh
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    from lidar_odometry_tpu_torch.parallel import sharded_map as sm
    cfg, consts = scene["cfg"], scene["consts"]
    b, s, n = 2, 4, 14336
    g = mesh.make_group(s, device="cuda")
    pts, live = vm.l0_points(scene["carry"].map_state)
    st = sm.sharded_empty_map(0, 8192 * s, g)
    sm.sharded_update_map(st, pts.contiguous(), live.contiguous(), scene["T"].view(4, 4)[:3, 3],
                          1e4, g, voxel_size=0.5, planarity_threshold=0.1)
    feats = [vf.voxel_filter(raw, raw.shape[0], voxel_size=0.5, stride=1, out_capacity=n,
                             compact_keys=True)[:2] for raw in scene["raws"]]
    feat = torch.stack([f for f, _ in feats]).contiguous()
    mask = torch.stack([m for _, m in feats]).contiguous()
    T = scene["T"].view(1, 16).repeat(b, 1)
    T[0, 3] -= 0.4                 # frame 4's guess, one step back
    T[1, 7] += 0.05
    T = T.contiguous()
    cap, inv = so.owned_cap(n, s), so.owner_inv(0.5, 3)

    def inst(x, lane):
        return x[lane * s:(lane + 1) * s]

    for Tx in (T, None):
        own_k = so.shard_own(feat, mask, Tx, s, 0, s, cap, inv)
        own_p = so.shard_own_plain(feat, mask, Tx, s, 0, s, cap, inv)
        assert all(torch.equal(x, y) for x, y in zip(own_k, own_p))
        for lane in range(b):
            one = so.shard_own(feat[lane:lane + 1], mask[lane:lane + 1],
                               None if Tx is None else Tx[lane:lane + 1], s, 0, s, cap, inv)
            assert all(torch.equal(inst(x, lane), y) for x, y in zip(own_k, one))
    p_own, ok = so.shard_own(feat, mask, T, s, 0, s, cap, inv)[:2]
    zero = torch.zeros((b, 3), dtype=torch.int32, device="cuda")
    corr = [icp.icp_correspond(p_own[i], ok[i], T[i // s], zero[i // s],
                               sm.local_view(st, i % s), cfg) for i in range(b * s)]
    nrm, r, valid = (torch.stack(c).contiguous() for c in zip(*corr))
    args = (p_own, nrm, r, valid)
    mk = so.shard_alpha_normal_eq(*args, T, zero, None, None, cfg, n_local=s, moments=True)
    mp = so.shard_alpha_normal_eq_plain(*args, T, zero, None, None, cfg, n_local=s, moments=True)
    assert float(((mk - mp).abs() / mp.abs().clamp(min=1.0)).max()) <= 1e-5
    mom = mk.view(b, s, 3).contiguous()
    assert not torch.equal(mom[0], mom[1])
    u, pick = (torch.as_tensor(a, device="cuda") for a in pko.shard_draws(s))
    q = u.shape[1]
    off, ld = 101 * 42, so.buffer_width(101, s, q)
    for done in (None, 0, 1):
        flags = zero.clone()
        if done is not None:
            flags[done] = torch.tensor([1, 0, 77], dtype=torch.int32, device="cuda")
        rk = torch.full((b * s, ld), -7.0, device="cuda")
        rp = rk.clone()
        for ne, smp, out in ((so.shard_alpha_normal_eq, so.shard_sample, rk),
                             (so.shard_alpha_normal_eq_plain, so.shard_sample_plain, rp)):
            ne(*args, T, flags, mom, consts.alphas, cfg, n_local=s, out=out)
            smp(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=out)
        _assert_systems_close(rk, rp, 101)
        assert torch.equal(rk[:, off:-1], rp[:, off:-1])
        if done is not None:
            assert bool((inst(rk, done) == -7.0).all())
        for lane in range(b):
            one = torch.full((s, ld), -7.0, device="cuda")
            so.shard_alpha_normal_eq(*(inst(a, lane) for a in args), T[lane:lane + 1],
                                     flags[lane:lane + 1], mom[lane:lane + 1], consts.alphas,
                                     cfg, n_local=s, out=one)
            so.shard_sample(inst(r, lane), inst(valid, lane), flags[lane:lane + 1],
                            mom[lane:lane + 1], u, first=0, n_local=s, off=off, out=one)
            assert torch.equal(one, inst(rk, lane))
        buf = rk.view(b, s, ld)
        sk = so.shard_gn_select(buf, T, flags, consts, pick, cfg, n_alpha=101, quota=q,
                                use_pko=True)
        sp = so.shard_gn_select_plain(buf, T, flags, consts, pick, cfg, n_alpha=101, quota=q,
                                      use_pko=True)
        assert torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2])
        assert float((sk[0] - sp[0]).abs().max()) <= 1e-6
        for lane in range(b):
            one = so.shard_gn_select(buf[lane:lane + 1], T[lane:lane + 1], flags[lane:lane + 1],
                                     consts, pick, cfg, n_alpha=101, quota=q, use_pko=True)
            assert all(torch.equal(x[lane], y[0]) for x, y in zip(sk, one))
    torch.cuda.synchronize()


# K3's edge cases (tests/test_torch_kernel_edges.py holds the twin on the
# same inputs against JAX): (n, kind, seed, n_valid or None for ~80 %)
K3_CASES = {
    "n_not_a_multiple_of_32": (14339, "mixture", 2, None),
    "fewer_than_100_valid": (14336, "wide", 3, 37),
    "one_valid": (14336, "wide", 4, 1),
    "none_valid": (14336, "wide", 5, 0),
    "em_stops_early": (14336, "mixture", 1, None),
    "em_runs_to_the_cap": (14336, "mixture", 0, None),
}


def _k3_case(case, dev):
    r, valid = synthetic.pko_residuals(*K3_CASES[case])
    return torch.as_tensor(r, device=dev), torch.as_tensor(valid, device=dev)


def _em_rounds(r, valid, consts_cpu):
    """The plain fit's EM rounds on the CPU for these residuals (iteration 0)."""
    r, valid = r.cpu(), valid.cpu()
    s = pko.norm_scale_from(r.abs(), valid)
    smp = pko.stratified_sample(r.abs() / torch.clamp(s, min=1e-6), valid, consts_cpu.u)
    return pko.fit_gmm(smp, consts_cpu.pick, rounds=True)[3][1]


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_pko_kernel_edges(dev, case):
    """K3 against its twin on the card, at iteration 0 (the scale taken
    here) and at a later iteration (the scale given): the count and alpha
    index exactly, the scale within 1e-5 relative."""
    consts = pko.make_pko_constants(*ARGS, device=dev)
    r, valid = _k3_case(case, dev)
    flags = torch.zeros((3,), dtype=torch.int32, device=dev)
    for first, scale in ((True, torch.ones((1,), device=dev)),
                         (False, torch.full((1,), 0.05, device=dev))):
        aux, s = pko.pko_alpha_index(r, valid, flags, scale, first, consts)
        a_p, c_p, s_p = pko.pko_alpha_index_plain(r, valid, scale.reshape(()), first, consts)
        assert int(aux[0]) == int(c_p) == int(valid.sum())
        assert int(aux[1]) == int(a_p)
        assert abs(float(s[0]) - float(s_p)) <= 1e-5 * abs(float(s_p))
    em = _em_rounds(r, valid, pko.make_pko_constants(*ARGS, device="cpu"))
    if case == "em_stops_early":
        assert em < 100
    if case == "em_runs_to_the_cap":
        assert em == 100
    torch.cuda.synchronize()


def test_pko_kernel_done_lane_and_lanes(dev):
    """A done lane writes its scale through with a zero count and index;
    4 lanes (one done) each bit-equal to a one-lane launch, the live ones
    equal to the twin."""
    consts = pko.make_pko_constants(*ARGS, device=dev)
    cases = ("fewer_than_100_valid", "em_stops_early", "em_runs_to_the_cap", "one_valid")
    r, valid = (torch.stack(x).contiguous() for x in zip(*[_k3_case(c, dev) for c in cases]))
    flags = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    flags[1] = torch.tensor([1, 0, 50], dtype=torch.int32, device=dev)
    for first in (True, False):
        scale = torch.tensor([[1.0], [0.25], [0.05], [0.5]], device=dev)
        aux, s = pko.pko_alpha_index(r, valid, flags, scale, first, consts)
        assert aux[1].tolist() == [0, 0] and float(s[1, 0]) == 0.25
        for b in range(4):
            one = pko.pko_alpha_index(r[b], valid[b], flags[b], scale[b], first, consts)
            assert torch.equal(aux[b], one[0]) and torch.equal(s[b], one[1])
            if b == 1:
                continue
            a_p, c_p, s_p = pko.pko_alpha_index_plain(r[b], valid[b], scale[b].reshape(()),
                                                      first, consts)
            assert aux[b].tolist() == [int(c_p), int(a_p)]
            assert abs(float(s[b, 0]) - float(s_p)) <= 1e-5 * abs(float(s_p))
    torch.cuda.synchronize()


def test_shard_select_kernel_over_104_merged_samples(dev):
    """K11d at 8 shards (m = 8 x 13 = 104 samples, two slots empty and
    filled with the mean) on synthetic per-alpha systems: alpha index,
    count and flags exactly, T within 1e-6 of the twin; 2 lanes, the
    second done, each bit-equal to a one-lane launch."""
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    consts = pko.make_pko_constants(*ARGS, device=dev)
    cfg = icp.ICPConfig()
    s, n_alpha = 8, 101
    u, pick = pko.shard_draws(s)
    q = u.shape[1]
    m, ld = s * q, so.buffer_width(n_alpha, s, q)
    off_s, off_o = n_alpha * 42, n_alpha * 42 + m
    rng = np.random.default_rng(104)
    A = rng.standard_normal((6, 6))
    H = (A @ A.T + 6 * np.eye(6))[None] * (1.0 + np.arange(n_alpha) / 100.0)[:, None, None]
    g = rng.standard_normal((n_alpha, 6)) * 0.1
    systems = np.concatenate([H.reshape(n_alpha, 36), g], 1)
    share = rng.dirichlet(np.ones(s))
    rows = np.zeros((s, ld), np.float32)
    rows[:, :off_s] = (share[:, None, None] * systems[None]).reshape(s, -1)
    r, valid = synthetic.pko_residuals(400, "mixture", 104)
    samples = np.abs(r[valid][:m]) / 0.05
    for j in range(m):
        if j in (5, 77):
            continue
        rows[j // q, off_s + j] = samples[j]
        rows[j // q, off_o + j] = 1.0
    rows[:, ld - 1] = 60.0
    buf = torch.as_tensor(rows, device=dev)[None].contiguous()
    T = torch.eye(4, device=dev).reshape(1, 16).contiguous()
    flags = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    pick_t = torch.as_tensor(pick, device=dev)
    sk = so.shard_gn_select(buf, T, flags, consts, pick_t, cfg, n_alpha=n_alpha, quota=q,
                            use_pko=True)
    sp = so.shard_gn_select_plain(buf, T, flags, consts, pick_t, cfg, n_alpha=n_alpha, quota=q,
                                  use_pko=True)
    assert torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2])
    assert int(sk[2][0, 1]) == 480
    assert float((sk[0] - sp[0]).abs().max()) <= 1e-6
    flags2 = torch.tensor([[0, 0, 0], [1, 0, 9]], dtype=torch.int32, device=dev)
    two = so.shard_gn_select(torch.cat([buf, buf]).contiguous(), torch.cat([T, T]), flags2,
                             consts, pick_t, cfg, n_alpha=n_alpha, quota=q, use_pko=True)
    for lane in range(2):
        one = so.shard_gn_select(buf, T, flags2[lane:lane + 1].contiguous(), consts, pick_t, cfg,
                                 n_alpha=n_alpha, quota=q, use_pko=True)
        assert all(torch.equal(x[lane], y[0]) for x, y in zip(two, one))
    assert all(torch.equal(x[0], y[0]) for x, y in zip(two, sk))
    torch.cuda.synchronize()


@pytest.mark.parametrize("b", [1, 5, 16])
def test_gabor_product_kernel(dev, b):
    """K8g bit-equal to its twin at b = 1 (the loops path), an odd b and
    b = 16 (phase 3's shape); a misaligned spectrum is refused."""
    from lidar_odometry_tpu_torch.ops import iris
    g = torch.Generator(device=dev).manual_seed(b)
    spec = torch.randn((b, 80, 360), dtype=torch.complex64, device=dev, generator=g)
    filters = torch.as_tensor(iris.log_gabor_filters(), device=dev)
    got = iris.gabor_product(spec, filters)
    assert got.shape == (b, 4, 80, 360)
    assert torch.equal(got, iris.gabor_product_plain(spec, filters))
    flat = torch.zeros((b * 80 * 360 + 1,), dtype=torch.complex64, device=dev)
    shifted = flat[1:].view(b, 80, 360)
    shifted.copy_(spec)
    with pytest.raises(RuntimeError):
        iris.gabor_product(shifted, filters)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K2a's instance axis
# ---------------------------------------------------------------------------

def test_correspond_instances_equal_per_instance_launches(dev):
    """One K2a launch over 1 lane x 4 shards, over 2 lanes x 4 shards (each
    lane its own sharded map, the data x map step's batched state) and over
    2 lanes sharing one map is bit-equal to one launch an instance; a lane
    whose solve is done leaves its instances' outputs unwritten."""
    from lidar_odometry_tpu_torch.parallel import mesh
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    from lidar_odometry_tpu_torch.parallel import sharded_map as sm
    world = synthetic.make_world(seed=4, extent=40.0, n_buildings=8)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 1.8
    pts = synthetic.sample_scan(world, pose, 6000, np.random.default_rng(4), max_range=40.0,
                                noise=0.01).astype(np.float32)
    grp = mesh.make_group(4, device=dev)
    maps = []
    for shift in (0.0, 0.7):
        st = sm.sharded_empty_map(0, 4096, grp)
        moved = torch.tensor(pts + np.float32([shift, 0.0, 0.0]), device=dev)
        sm.sharded_update_map(st, moved, torch.ones(len(pts), dtype=torch.bool, device=dev),
                              torch.zeros(3, device=dev), 100.0, grp, voxel_size=0.5,
                              planarity_threshold=0.1)
        maps.append(st)
    batched = vm.VoxelMapState(*[torch.stack([a, b]) for a, b in zip(*maps)])
    cfg = icp.ICPConfig()
    n, s = 2000, 4
    for lanes, views in ((1, sm.local_views(maps[0])), (2, sm.local_views(batched, 2)),
                         (2, sm.local_views(maps[0]) * 2)):
        T = torch.eye(4, device=dev).expand(lanes, 4, 4).reshape(lanes, 16).contiguous()
        T[:, 3] += 0.05
        scan = torch.tensor(pts[:n], device=dev).expand(lanes, n, 3).contiguous()
        ok0 = torch.ones((lanes, n), dtype=torch.bool, device=dev)
        p_own, ok, _, _ = so.shard_own(scan, ok0, T, s, 0, s, so.owned_cap(n, s),
                                       so.owner_inv(0.5, 3))
        for done in ((None,) if lanes == 1 else (None, 1)):
            flags = torch.zeros((lanes, 3), dtype=torch.int32, device=dev)
            if done is not None:
                flags[done, 0] = 1
            n0 = kernels.KERNELS["icp_correspond"].launches
            out = tuple(torch.full_like(x, 7) for x in (p_own, p_own[..., 0], ok))
            icp.icp_correspond_instances(p_own, ok, T, flags, views, cfg, out=out)
            assert kernels.KERNELS["icp_correspond"].launches == n0 + 1
            for g in range(lanes * s):
                one = tuple(torch.full_like(x[g], 7) for x in out)
                icp.icp_correspond(p_own[g], ok[g], T[g // s], flags[g // s],
                                   views[g // s][g % s], cfg, out=one)
                assert all(torch.equal(a[g], b) for a, b in zip(out, one))
                if g // s == done:
                    assert bool((out[1][g] == 7).all())
            assert int(out[2].sum()) > 100


# K2b's and K11b's edge cases (tests/test_torch_kernel_edges.py holds the
# twins on the same inputs against JAX): synthetic.normal_eq_rows
# arguments, with the loss and min_correspondence_points where they differ
# from ICPConfig's; K11b's lanes x shards, rows a shard, alphas, loss,
# robust loss, a shard with no valid row and a done lane
K2B_CASES = {
    "n_not_a_multiple_of_the_cluster": dict(n=14339, seed=1),
    "n_below_a_warp": dict(n=20, seed=2, min_corr=5),
    "no_valid_point": dict(n=1000, seed=3, n_valid=0),
    "count_below_min": dict(n=1000, seed=4, n_valid=30),
    "pivot_rows_swap": dict(n=2000, seed=5, flat_x=True),
    "step_below_small_angle": dict(n=3000, seed=6, step=(1e-6, -5e-7, 2e-7, 2e-7, -1.5e-7, 1e-7)),
    "step_above_small_angle": dict(n=3000, seed=7, step=(2e-4, -1e-4, 5e-5, 2e-6, -1.5e-6, 1e-6)),
    "non_finite_step": dict(n=3000, seed=8, nan_residual=True),
    "cauchy": dict(n=5000, seed=9, loss="cauchy"),
}
K11B_CASES = {
    "rows_not_a_multiple_of_the_chunk": dict(lanes=1, shards=4, n=1013, n_alpha=101),
    "one_alpha": dict(lanes=1, shards=4, n=700, n_alpha=1),
    "alphas_101_cauchy": dict(lanes=1, shards=4, n=2048, n_alpha=101, loss="cauchy"),
    "a_shard_without_valid_rows": dict(lanes=1, shards=4, n=700, n_alpha=101, empty=2),
    "done_lane": dict(lanes=2, shards=2, n=700, n_alpha=101, done=1),
    "robust_loss_off": dict(lanes=1, shards=4, n=700, n_alpha=101, robust=False),
}


def _k2b_args(case, dev):
    """K2b's wrapper arguments for a case on the card (scale 0.05, alpha
    index 40, the count of valid rows) and its config."""
    kw = dict(K2B_CASES[case])
    cfg = icp.ICPConfig(loss_type=kw.pop("loss", "huber"),
                        min_correspondence_points=kw.pop("min_corr", 50))
    p, nrm, r, valid, T = synthetic.normal_eq_rows(**kw)
    tt = lambda x: torch.as_tensor(x, device=dev)
    aux = torch.tensor([int(valid.sum()), 40], dtype=torch.int32, device=dev)
    return (tt(p), tt(nrm), tt(r), tt(valid), tt(T).reshape(16).contiguous(),
            torch.full((1,), 0.05, device=dev), torch.zeros((3,), dtype=torch.int32, device=dev),
            aux, pko.make_pko_constants(*ARGS, device=dev), cfg)


def _assert_k2b_close(got, ref):
    """K2b against its twin: T within 1e-5, flags exactly, hg within 1e-5
    of its largest entry (the twin's H carries the 1e-8 floor), NaN where
    the twin's is NaN."""
    assert torch.equal(got[1], ref[1])
    assert float((got[0] - ref[0]).abs().max()) <= 1e-5
    hk, hp = got[2], ref[2]
    fin = torch.isfinite(hp)
    assert torch.equal(fin, torch.isfinite(hk))
    if bool(fin.any()):
        scale = float(hp[fin].abs().max())
        assert float((hk[fin] - hp[fin]).abs().max()) <= 1e-5 * scale + 1e-8


@pytest.mark.parametrize("case", sorted(K2B_CASES))
def test_normal_eq_kernel_edges(dev, case):
    """K2b against its twin on the card on each edge case, two calls
    bit-equal; a non-finite step leaves T as it was."""
    args = _k2b_args(case, dev)
    got = icp.icp_normal_eq(*args)
    _assert_k2b_close(got, icp.icp_normal_eq_plain(*args))
    assert all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
               for a, b in zip(got, icp.icp_normal_eq(*args)))
    if case in ("non_finite_step", "no_valid_point", "count_below_min"):
        assert torch.equal(got[0], args[4])
    torch.cuda.synchronize()


def test_normal_eq_kernel_lanes(dev):
    """Four lanes of the 3000-row cases, lane 3 done: each lane bit-equal to
    a one-lane launch, the live ones within the twin's tolerances, the done
    lane passing T and its flags through, two calls bit-equal."""
    cases = ("step_below_small_angle", "step_above_small_angle", "non_finite_step",
             "step_above_small_angle")
    per = [_k2b_args(c, dev) for c in cases]
    consts, cfg = per[0][8], per[0][9]
    lanes = [torch.stack([a[i] for a in per]).contiguous() for i in range(8)]
    lanes[6][3] = torch.tensor([1, 0, 77], dtype=torch.int32, device=dev)
    got = icp.icp_normal_eq(*lanes, consts, cfg)
    again = icp.icp_normal_eq(*lanes, consts, cfg)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # hg: NaN in lane 2's g (the NaN residual); lane 3's left unwritten
    assert torch.equal(got[2][:3].nan_to_num(7.0), again[2][:3].nan_to_num(7.0))
    assert torch.equal(got[0][3], lanes[4][3]) and torch.equal(got[1][3], lanes[6][3])
    for b in range(4):
        one = icp.icp_normal_eq(*[x[b].contiguous() for x in lanes], consts, cfg)
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])
        if b < 3:
            assert torch.equal(got[2][b].nan_to_num(7.0), one[2].nan_to_num(7.0))
            _assert_k2b_close(tuple(x[b] for x in got),
                              icp.icp_normal_eq_plain(*[x[b] for x in lanes], consts, cfg))
    torch.cuda.synchronize()


def _k11b_args(case, dev):
    """K11b's wrapper arguments for a case on the card (p, nrm, r, valid,
    T, flags, mom, alphas), its config and shards a lane."""
    c = K11B_CASES[case]
    p, nrm, r, valid, T, mom = synthetic.normal_eq_shards(c["lanes"], c["shards"], c["n"],
                                                          seed=len(case), empty=c.get("empty"))
    cfg = icp.ICPConfig(loss_type=c.get("loss", "huber"), use_robust_loss=c.get("robust", True))
    flags = torch.zeros((c["lanes"], 3), dtype=torch.int32, device=dev)
    if "done" in c:
        flags[c["done"]] = torch.tensor([1, 0, 77], dtype=torch.int32, device=dev)
    alphas = (pko.make_pko_constants(*ARGS, device=dev).alphas if c["n_alpha"] > 1
              else torch.full((1,), cfg.robust_loss_delta, device=dev))
    tt = lambda x: torch.as_tensor(x, device=dev)
    T16 = tt(T).reshape(1, 16).repeat(c["lanes"], 1).contiguous()
    return (tt(p), tt(nrm), tt(r), tt(valid), T16, flags, tt(mom), alphas), cfg, c["shards"]


@pytest.mark.parametrize("case", sorted(K11B_CASES))
def test_alpha_normal_eq_kernel_edges(dev, case):
    """K11b against its twin on the card on each edge case (each block
    within 1e-5 of its largest entry, the count exactly, a done lane's rows
    unwritten), each instance bit-equal to a one-instance launch, two calls
    bit-equal; the moments mode against its twin and zero for a done lane."""
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    args, cfg, n_local = _k11b_args(case, dev)
    g, a = args[0].shape[0], args[7].shape[0]
    ld = so.buffer_width(a, n_local, 25)
    rk, rp = (torch.full((g, ld), -7.0, device=dev) for _ in range(2))
    so.shard_alpha_normal_eq(*args, cfg, n_local=n_local, out=rk)
    so.shard_alpha_normal_eq_plain(*args, cfg, n_local=n_local, out=rp)
    live = [i for i in range(g) if not bool(args[5][i // n_local, 0])]
    done = [i for i in range(g) if i not in live]
    assert all(bool((rk[i] == -7.0).all()) for i in done)
    _assert_systems_close(rk[live], rp[live], a)
    again = rk.clone()
    so.shard_alpha_normal_eq(*args, cfg, n_local=n_local, out=again)
    assert torch.equal(again, rk)
    for i in range(g):
        lane = i // n_local
        one = torch.full((1, ld), -7.0, device=dev)
        so.shard_alpha_normal_eq(*[x[i:i + 1] for x in args[:4]], args[4][lane:lane + 1],
                                 args[5][lane:lane + 1], args[6][lane:lane + 1], args[7], cfg,
                                 n_local=1, out=one)
        assert torch.equal(one[0], rk[i])
    mk = so.shard_alpha_normal_eq(*args[:6], None, None, cfg, n_local=n_local, moments=True)
    mp = so.shard_alpha_normal_eq_plain(*args[:6], None, None, cfg, n_local=n_local,
                                        moments=True)
    assert float(((mk - mp).abs() / mp.abs().clamp(min=1.0)).max()) <= 1e-5
    assert all(bool((mk[i] == 0.0).all()) for i in done)
    torch.cuda.synchronize()


def test_normal_eq_kernels_launch_once_without_a_stack(dev):
    """K2b and K11b (both modes) launch their kernel once a call with no
    torch op beside it that launches device work (no zero fill: such an op
    shows in torch.profiler's op events), and ptxas gave neither kernel a
    stack frame."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    args = _k2b_args("cauchy", dev)
    k11, cfg, n_local = _k11b_args("alphas_101_cauchy", dev)
    out = torch.zeros((4, so.buffer_width(101, 4, 25)), device=dev)
    calls = [("icp_normal_eq", lambda: icp.icp_normal_eq(*args)),
             ("shard_alpha_normal_eq",
              lambda: so.shard_alpha_normal_eq(*k11, cfg, n_local=n_local, out=out)),
             ("shard_alpha_normal_eq",
              lambda: so.shard_alpha_normal_eq(*k11[:6], None, None, cfg, n_local=n_local,
                                               moments=True))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"}, ops
    for src, fn in (("icp", "normal_eq_kernel"), ("shard", "alpha_ne_kernel")):
        assert kernels.ptxas_info(src, fn)["stack"] == 0


# K4c's edges (a warp a parent, 8 parents a block; tests/test_torch_kernel_edges.py
# holds the twin on the same inputs against JAX): (children of each parent,
# lattice, rows)
K4C_CASES = {
    "all_rows_dead": ([8] * 64, False, "dead"),
    "dead_rows_between_live": (list(range(5, 28)) * 26, False, "odd_dead"),
    "children_1_5_27": ([1, 5, 27] * 200, False, "all"),
    "equal_eigenvalues": ([27, 9] * 100, True, "all"),
    "r_not_a_multiple_of_the_block": ([5 + i % 23 for i in range(1237)], False, "all"),
    "rehash_every_slot": ([(7 * i) % 28 if i % 3 == 0 else 0 for i in range(4096)], False, "all"),
}


def _k4c_case(case, dev):
    """(l0 (c1 * 27 + 1, 4), r_slot (R,) int64, c1) of a K4c case on the card."""
    children, lattice, rows = K4C_CASES[case]
    c1 = len(children)
    l0 = torch.as_tensor(synthetic.surfel_blocks(children, seed=len(case), lattice=lattice),
                         device=dev)
    slots = torch.arange(c1, device=dev)
    if rows == "dead":
        slots = torch.full((1000,), -1, dtype=torch.int64, device=dev)
    elif rows == "odd_dead":
        slots = torch.stack([slots, torch.full_like(slots, -1)], 1).reshape(-1)
    return l0, slots, c1


@pytest.mark.parametrize("case", sorted(K4C_CASES))
def test_surfel_recompute_kernel_edges(dev, case):
    """K4c against its twin on the card: live-child masks equal, means,
    planarities and flags within 1e-4, normals within 1e-4 where the two
    smallest eigenvalues are apart, no non-planar verdict different outside
    the 1e-5 band around the threshold, a dead row the twin's constant row,
    two calls bit-equal, one launch a call."""
    l0, r_slot, c1 = _k4c_case(case, dev)
    thr = 0.1
    n0 = kernels.KERNELS["map_surfel_recompute"].launches
    sk, nk, kk = vm.map_surfel_recompute(l0, r_slot, c1, thr)
    again = vm.map_surfel_recompute(l0, r_slot, c1, thr)
    sp, np_, kp = vm.map_surfel_recompute_plain(l0, r_slot, c1, thr)
    torch.cuda.synchronize()
    assert kernels.KERNELS["map_surfel_recompute"].launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(again, (sk, nk, kk)))
    assert torch.equal(kk, kp)
    assert float((sk[:, 3:] - sp[:, 3:]).abs().max()) <= 1e-4
    rows = (torch.clamp(r_slot, 0, c1 - 1)[:, None] * 27
            + torch.arange(27, device=dev)[None, :]).reshape(-1)
    blk = torch.where((r_slot >= 0)[:, None, None], l0[rows].view(-1, 27, 4), 0.0)
    lam = torch.linalg.eigvalsh(vm._block_stats(blk)[2].double())
    well = (lam[:, 1] - lam[:, 0]) > 1e-4 * (lam[:, 2] + 1e-6)
    if bool(well.any()):
        assert float((sk[well, :3] - sp[well, :3]).abs().max()) <= 1e-4
    band = (sp[:, 6] - thr).abs() < 1e-5
    assert not bool(((nk != np_) & ~band).any())
    dead = r_slot < 0
    const = torch.tensor([0.0, 0, 1, 0, 0, 0, 0, 1], device=dev)
    assert bool((sk[dead] == const).all()) and not bool(nk[dead].any())
    assert not bool(kk[dead].any())


K11A_CASES = {
    "every_point_in_one_shard": dict(lanes=1, n=5000, shards=4, one_cell=True),
    "no_point_owned": dict(lanes=1, n=5000, shards=4, masked=True),
    "n_not_a_multiple_of_the_tile": dict(lanes=1, n=16384 + 1029, shards=2),
    "shards_1_2_of_4": dict(lanes=1, n=9000, shards=4, first=1, n_local=2),
    "one_shard": dict(lanes=1, n=7000, shards=1),
    "eight_shards": dict(lanes=1, n=16384, shards=8),
    "two_lanes_at_two_poses": dict(lanes=2, n=14336, shards=4, pose=True),
}


def _k11a_case(case, dev):
    """K11a's wrapper arguments (pts, mask, T, S, first, n_local, cap,
    inv) of a case on the card (its cluster covers 8 x 2048 points a
    tile)."""
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    c = K11A_CASES[case]
    pts, mask = synthetic.shard_points(c["lanes"], c["n"], seed=len(case),
                                       one_cell=c.get("one_cell", False),
                                       masked=c.get("masked", False))
    T = None
    if c.get("pose"):
        T = np.tile(np.eye(4, dtype=np.float32), (c["lanes"], 1, 1))
        for lane in range(c["lanes"]):
            a = 0.3 + 0.2 * lane
            T[lane, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            T[lane, :3, 3] = (1.3 - lane, -0.4, 0.2)
        T = torch.as_tensor(T.reshape(c["lanes"], 16), device=dev)
    s = c["shards"]
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(mask, device=dev), T, s,
            c.get("first", 0), c.get("n_local", s), so.owned_cap(c["n"], s),
            so.owner_inv(0.5, 3))


@pytest.mark.parametrize("case", sorted(K11A_CASES))
def test_shard_own_kernel_edges(dev, case):
    """K11a's four outputs equal to the twin's on the card; each local
    shard of a launch bit-equal to a one-shard launch (first + k,
    n_local 1) and each lane to a one-lane launch; the same without T."""
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    pts, mask, T, s, first, n_local, cap, inv = _k11a_case(case, dev)
    lanes = pts.shape[0]
    for Tx in ((T, None) if T is not None else (None,)):
        got = so.shard_own(pts, mask, Tx, s, first, n_local, cap, inv)
        ref = so.shard_own_plain(pts, mask, Tx, s, first, n_local, cap, inv)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        for lane in range(lanes):
            Tl = None if Tx is None else Tx[lane:lane + 1]
            one = so.shard_own(pts[lane:lane + 1], mask[lane:lane + 1], Tl, s, first, n_local,
                               cap, inv)
            assert all(torch.equal(a[lane * n_local:(lane + 1) * n_local], b)
                       for a, b in zip(got, one))
            for k in range(n_local):
                single = so.shard_own(pts[lane:lane + 1], mask[lane:lane + 1], Tl, s, first + k,
                                      1, cap, inv)
                assert all(torch.equal(a[lane * n_local + k], b[0]) for a, b in zip(got, single))
    if case == "every_point_in_one_shard":
        assert int(got[3].max()) > 0
    torch.cuda.synchronize()


def test_map_and_shard_kernels_launch_once_without_a_stack(dev):
    """K4c and K11a (compaction) launch their kernel once a call with no
    torch op beside it that launches device work, and ptxas gave neither
    kernel a stack frame."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    l0, r_slot, c1 = _k4c_case("children_1_5_27", dev)
    own = _k11a_case("two_lanes_at_two_poses", dev)
    calls = [("map_surfel_recompute", lambda: vm.map_surfel_recompute(l0, r_slot, c1, 0.1)),
             ("shard_own", lambda: so.shard_own(*own))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"}, ops
    for src, fn in (("voxel_map", "surfel_recompute_kernel"), ("shard", "own_compact_kernel")):
        assert kernels.ptxas_info(src, fn)["stack"] == 0


# K6b's edges (a warp a query, 8 queries a block; tests/test_torch_kernel_edges.py
# holds the twin on the same inputs against JAX): knn_cloud's options, k, r,
# W and the query count
K6B_CASES = {
    "queries_not_a_multiple_of_the_block": dict(k=5, r=1, w=8, n_q=613),
    "radius_2": dict(k=5, r=2, w=8),
    "width_4": dict(k=5, r=1, w=4),
    "width_5": dict(k=5, r=1, w=5),
    "width_16": dict(k=5, r=1, w=16),
    "binary_search_r1": dict(k=5, r=1, w=4, wide=True),
    "binary_search_r2": dict(k=5, r=2, w=8, wide=True),
    "ties_across_and_within_bins": dict(k=5, r=1, w=8, ties=True),
    "ties_radius_2_width_16": dict(k=5, r=2, w=16, ties=True),
    "valid_table_short_last_bin": dict(k=5, r=1, w=8, all_valid=True),
    "k_1": dict(k=1, r=1, w=8),
    "k_1_radius_2_binary_search": dict(k=1, r=2, w=8, wide=True),
}


def _k6b_case(case, dev):
    """(point table, queries, k, r, W) of a K6b case on the card (the table
    built by K6a)."""
    from lidar_odometry_tpu_torch.ops import knn
    c = K6B_CASES[case]
    pts, mask, q = synthetic.knn_cloud(3000, seed=len(case), n_queries=c.get("n_q", 600),
                                       wide=c.get("wide", False), ties=c.get("ties", False),
                                       all_valid=c.get("all_valid", False))
    table = knn.build_point_table(torch.as_tensor(pts, device=dev),
                                  torch.as_tensor(mask, device=dev),
                                  bin_size=0.5 if c.get("wide") else 2.0)
    assert bool(table.fits) != bool(c.get("wide"))
    return table, torch.as_tensor(q, device=dev), c["k"], c["r"], c["w"]


@pytest.mark.parametrize("case", sorted(K6B_CASES))
def test_point_knn_kernel_edges(dev, case):
    """K6b against its twin on the card: the neighbours of every slot (not
    ok ones too) and the ok flags equal, the distances within 1e-5 and
    infinite where the twin's are, two calls bit-equal, one launch a call."""
    from lidar_odometry_tpu_torch.ops import knn
    table, q, k, r, w = _k6b_case(case, dev)
    name = "point_knn" if k == 5 else "point_nn1"
    n0 = kernels.KERNELS[name].launches
    got = knn.knn_query(table, q, k=k, radius=r, bucket_width=w)
    again = knn.knn_query(table, q, k=k, radius=r, bucket_width=w)
    nb, ok, d = knn.knn_query_plain(table, q, k=k, radius=r, bucket_width=w)
    torch.cuda.synchronize()
    assert kernels.KERNELS[name].launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1], ok) and torch.equal(got[0], nb)
    fin = torch.isfinite(d)
    assert torch.equal(torch.isfinite(got[2]), fin)
    assert float((got[2][fin] - d[fin]).abs().max()) <= 1e-5
    n_ok = ok.sum(1)
    assert bool((n_ok == 0).any()) and bool((n_ok == k).any())


# K5b's edges (a group of 8 lanes a point for k <= 8, else 16; 4 or 8 points
# a warp): (rows, candidates a row, gate)
K5B_CASES = {
    "k_5": (613, 5, True),
    "k_5_ungated": (613, 5, False),
    "k_8": (402, 8, True),
    "k_9": (402, 9, False),
    "k_27": (613, 27, True),
    "k_125": (613, 125, True),
    "k_125_ungated": (301, 125, False),
}


def _k5b_case(case, dev):
    n, k, gate = K5B_CASES[case]
    p, cand, ok, mask = (torch.as_tensor(x, device=dev)
                         for x in synthetic.plane_candidates(n, k, seed=len(case)))
    return p, cand, ok, mask, gate


@pytest.mark.parametrize("case", sorted(K5B_CASES))
def test_plane_fit_kernel_edges(dev, case):
    """K5b against its twin on the card: the selection and nearest point
    equal on every row, the centroid within 1e-5; where the covariance is
    well conditioned the validity flags equal, the distance and |residual|
    within 1e-4 and the normal within 1e-5; no all-masked row valid; two
    calls bit-equal, one launch a call."""
    p, cand, ok, mask, gate = _k5b_case(case, dev)
    cfg = icp.ICPConfig(max_correspondence_distance=0.1, plane_fit_planarity=0.1)
    n0 = kernels.KERNELS["plane_fit_5nn"].launches
    fk = icp.plane_fit_5nn(p, cand, ok, mask, cfg, gate)
    again = icp.plane_fit_5nn(p, cand, ok, mask, cfg, gate)
    fp_ = icp.plane_fit_5nn_plain(p, cand, ok, mask, cfg, gate)
    torch.cuda.synchronize()
    assert kernels.KERNELS["plane_fit_5nn"].launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(fk, again))
    assert torch.equal(fk.sel, fp_.sel) and torch.equal(fk.nearest, fp_.nearest)
    assert float((fk.centroid - fp_.centroid).abs().max()) <= 1e-5
    well = _well_conditioned(cand, ok, fp_.sel)
    assert bool(well.any())
    assert int((fk.valid != fp_.valid)[well].sum()) == 0
    assert float((fk.dist - fp_.dist)[well].abs().max()) <= 1e-4
    assert float((fk.resid.abs() - fp_.resid.abs())[well].abs().max()) <= 1e-4
    assert float((fk.normal * fp_.normal).sum(1).abs()[well].min()) > 1 - 1e-5
    tenth = p.shape[0] // 10
    assert not bool(fk.valid[3 * tenth:4 * tenth].any())


def test_knn_and_plane_fit_kernels_launch_once_without_a_stack(dev):
    """K6b (coarse, polish and 1-NN shapes, and a finished solve's launch)
    and K5b (groups of 8 and of 16 lanes a point) launch their kernel once
    a call with no torch op beside it that launches device work, and ptxas
    gave no instantiation of either kernel a stack frame."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.ops import knn
    table, q, _, _, _ = _k6b_case("radius_2", dev)
    done = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)
    cfg = icp.ICPConfig()
    fit5, fit125 = _k5b_case("k_5", dev), _k5b_case("k_125", dev)
    calls = [("point_knn", lambda: knn.knn_query(table, q, k=5, radius=1, bucket_width=8)),
             ("point_knn", lambda: knn.knn_query(table, q, k=5, radius=1, bucket_width=4)),
             ("point_knn", lambda: knn.knn_query(table, q, k=5, radius=2, bucket_width=16,
                                                 flags=done)),
             ("point_nn1", lambda: knn.knn_query(table, q, k=1, radius=1, bucket_width=8)),
             ("plane_fit_5nn", lambda: icp.plane_fit_5nn(*fit5[:4], cfg, True)),
             ("plane_fit_5nn", lambda: icp.plane_fit_5nn(*fit125[:4], cfg, True, flags=done))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"}, ops
    for src, fn, n in (("knn", "point_knn_kernel", 4), ("grid_knn", "plane_fit_kernel", 2)):
        entries = kernels.ptxas_entries(src, fn)
        assert len(entries) == n and all(e["stack"] == 0 for e in entries.values()), entries


# K11c's edges (one CTA an instance in K11b's grid, the flags 16 to a load
# from the row's 16-byte aligned start, tiles of 1024 loads;
# tests/test_torch_kernel_edges.py holds the twin on the same inputs
# against JAX): lanes, shards a lane, n, and the instances with few or no
# valid rows, or a done lane
K11C_CASES = {
    "s1_two_lanes_rows_not_a_multiple_of_16": dict(lanes=2, shards=1, n=1013),
    "s2_fewer_valid_than_quota": dict(lanes=1, shards=2, n=1200, few=(1, 20)),
    "s4_no_valid_row": dict(lanes=1, shards=4, n=700, empty=2),
    "s4_two_tiles": dict(lanes=1, shards=4, n=20011),
    "s8_two_lanes_one_done": dict(lanes=2, shards=8, n=613, done=0),
}


def _k11c_args(case, dev):
    """K11b's wrapper arguments (p, nrm, r, valid, T, flags, mom, alphas)
    of a K11c case on the card, its config, shards a lane and the shards'
    uniforms."""
    c = K11C_CASES[case]
    p, nrm, r, valid, T, mom = synthetic.normal_eq_shards(c["lanes"], c["shards"], c["n"],
                                                          seed=len(case), empty=c.get("empty"))
    if "few" in c:
        valid[c["few"][0], c["few"][1]:] = False
    flags = torch.zeros((c["lanes"], 3), dtype=torch.int32, device=dev)
    if "done" in c:
        flags[c["done"]] = torch.tensor([1, 0, 77], dtype=torch.int32, device=dev)
    tt = lambda x: torch.as_tensor(x, device=dev)
    T16 = tt(T).reshape(1, 16).repeat(c["lanes"], 1).contiguous()
    alphas = pko.make_pko_constants(*ARGS, device=dev).alphas
    u = tt(pko.shard_draws(c["shards"])[0])
    return ((tt(p), tt(nrm), tt(r), tt(valid), T16, flags, tt(mom), alphas), icp.ICPConfig(),
            c["shards"], u)


@pytest.mark.parametrize("case", sorted(K11C_CASES))
def test_shard_sample_kernel_edges(dev, case):
    """K11c alone and inside K11b's launch against its twin on the card,
    exactly (a done lane's rows unwritten); K11b's part of the fused row
    bit-equal to K11b launched alone; each instance bit-equal to a
    one-instance launch; the fused launch counted once for K11b and once
    in K11c's `fused`."""
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    args, cfg, s, u = _k11c_args(case, dev)
    r, valid, flags, mom = args[2], args[3], args[5], args[6]
    g, q, a = r.shape[0], u.shape[1], args[7].shape[0]
    off, ld = a * 42, so.buffer_width(a, s, q)
    rk, rp, rf, rn = (torch.full((g, ld), -7.0, device=dev) for _ in range(4))
    n0, f0 = kernels.counts(), kernels.fused_counts()
    so.shard_sample(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=rk)
    so.shard_alpha_normal_eq_sample(*args, u, cfg, first=0, n_local=s, off=off, out=rf)
    torch.cuda.synchronize()
    n1, f1 = kernels.counts(), kernels.fused_counts()
    assert n1["shard_sample"] == n0["shard_sample"] + 1
    assert n1["shard_alpha_normal_eq"] == n0["shard_alpha_normal_eq"] + 1
    assert f1["shard_sample"] == f0["shard_sample"] + 1
    so.shard_sample_plain(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=rp)
    so.shard_alpha_normal_eq(*args, cfg, n_local=s, out=rn)
    assert torch.equal(rk, rp)
    assert torch.equal(rf[:, off:-1], rp[:, off:-1])
    assert torch.equal(rf[:, :off], rn[:, :off]) and torch.equal(rf[:, -1], rn[:, -1])
    done = [i for i in range(g) if bool(flags[i // s, 0])]
    assert all(bool((rf[i] == -7.0).all()) for i in done)
    if "few" in K11C_CASES[case] or "empty" in K11C_CASES[case]:
        assert bool((rk[:, off + s * q:off + 2 * s * q] == 0.0).any())   # ok = 0 slots
    for i in range(g):
        lane, k = i // s, i % s
        one = torch.full((1, ld), -7.0, device=dev)
        so.shard_alpha_normal_eq_sample(*[x[i:i + 1] for x in args[:4]], args[4][lane:lane + 1],
                                        flags[lane:lane + 1], mom[lane:lane + 1], args[7], u,
                                        cfg, first=k, n_local=1, off=off, out=one)
        assert torch.equal(one[0], rf[i])


# K5a's edges (4 points a warp, a tail warp's narrow stores, the row mask
# in the kernel, a scaled quotient below 2^-126): radius, rows (None:
# the scene's 8192), row mask, done flag, tiny and infinite sums
K5A_CASES = {
    "radius_1": dict(r=1),
    "radius_2": dict(r=2),
    "radius_1_rows_not_a_multiple_of_4_masked": dict(r=1, n=8189, mask=True),
    "radius_2_rows_not_a_multiple_of_4_masked": dict(r=2, n=8189, mask=True),
    "tail_warp_only": dict(r=2, n=3, mask=True),
    "done_flag": dict(r=2, done=True),
    "subnormal_and_infinite_sums": dict(r=2, tiny=True),
}


def _k5a_case(case, scene):
    """(map state, points, radius, mask or None, flags or None) of a K5a
    case on the card: the scene's map and next features at its guess."""
    c = K5A_CASES[case]
    st, T, feat, mask = scene["carry"].map_state, scene["T"], scene["feat"], scene["mask"]
    n = c.get("n", feat.shape[0])
    p = lie.transform_points(T.view(4, 4), feat)
    if n < 4:   # a lone tail warp: rows with live candidates, one of them masked out
        live = vm.grid_knn_neighbors_plain(st, p, voxel_size=0.5, radius=c["r"])[1].any(1)
        rows = torch.cat([torch.nonzero(live & mask).flatten()[:n - 1],
                          torch.nonzero(live & ~mask).flatten()[:1]])
        p, mask = p[rows], mask[rows]
    p, mask = p[:n].contiguous(), mask[:n].contiguous()
    if c.get("tiny"):
        # live rows whose sums give quotients below 2^-126 (subnormal sums, and
        # normal ones divided down), and one infinite sum
        l0 = st.l0_data.clone()
        live = torch.nonzero(l0[:-1, 0] > 0).flatten()
        gen = torch.Generator().manual_seed(5)
        ints = torch.randint(1, 1 << 22, (live.numel(), 3), generator=gen).to(l0.device)
        sub = ints.float() * 2.0 ** -149 * torch.where(ints % 2 == 0, 1.0, -1.0)
        l0[live[0::3], 1:4] = sub[0::3]
        small = ((ints[1::3] % 16) + 1).float() * 2.0 ** -126   # normal, below 17 x 2^-126
        l0[live[1::3], 1:4] = small * torch.where(ints[1::3] % 3 == 0, 1.0, -1.0)
        l0[live[1::3], 0] = torch.clamp(l0[live[1::3], 0], min=3.0)
        l0[live[5], 1] = float("inf")
        st = st._replace(l0_data=l0)
    flags = torch.tensor([1, 0, 0], dtype=torch.int32, device="cuda") if c.get("done") else None
    return st, p, c["r"], mask if c.get("mask") else None, flags


@pytest.mark.parametrize("case", sorted(K5A_CASES))
def test_grid_knn_kernel_edges(scene, case):
    """K5a against its twin on the card, exactly: centroids and flags (with
    a row mask, the twin's flags ANDed with it), including empty and
    count-1 rows; a done flag launches and returns at once; one launch a
    call."""
    st, p, r, mask, flags = _k5a_case(case, scene)
    n0 = kernels.KERNELS["grid_knn"].launches
    ck, okk = vm.grid_knn_neighbors(st, p, voxel_size=0.5, radius=r, flags=flags, mask=mask)
    torch.cuda.synchronize()
    assert kernels.KERNELS["grid_knn"].launches == n0 + 1
    m = (2 * r + 1) ** 3
    assert ck.shape == (p.shape[0], m, 3) and okk.shape == (p.shape[0], m)
    if flags is not None:
        return
    cp, okp = vm.grid_knn_neighbors_plain(st, p, voxel_size=0.5, radius=r)
    if mask is not None:
        okp = okp & mask[:, None]
        assert bool(okp.any()) and not bool(okp[~mask].any())
    assert torch.equal(okk, okp)
    assert torch.equal(ck, cp)                     # inf equal; no NaN in these sums
    # the map holds empty (count 0) and count-1 rows beside fuller ones
    cnt = st.l0_data[:, 0]
    assert {0.0, 1.0} <= set(torch.unique(cnt[cnt <= 1.0]).tolist())
    if K5A_CASES[case].get("tiny"):
        sub = (ck != 0) & (ck.abs() < 2.0 ** -126)
        assert bool(sub.any()) and bool(torch.isinf(ck).any())


def test_grid_knn_and_shard_sample_launch_once_without_a_stack(dev, scene):
    """K5a (r = 1 and 2, with a row mask) and K11c (alone and inside K11b's
    launch) launch their kernel once a call with no torch op beside it
    that launches device work, and ptxas gave neither kernel a stack
    frame."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.parallel import shard_ops as so
    st, p, _, mask, _ = _k5a_case("radius_2_rows_not_a_multiple_of_4_masked", scene)
    args, cfg, s, u = _k11c_args("s8_two_lanes_one_done", dev)
    a, q = args[7].shape[0], u.shape[1]
    out = torch.zeros((args[2].shape[0], so.buffer_width(a, s, q)), device=dev)
    calls = [("grid_knn", lambda: vm.grid_knn_neighbors(st, p, voxel_size=0.5, radius=1)),
             ("grid_knn", lambda: vm.grid_knn_neighbors(st, p, voxel_size=0.5, radius=2,
                                                        mask=mask)),
             ("shard_sample", lambda: so.shard_sample(args[2], args[3], args[5], args[6], u,
                                                      first=0, n_local=s, off=a * 42, out=out)),
             ("shard_alpha_normal_eq", lambda: so.shard_alpha_normal_eq_sample(
                 *args, u, cfg, first=0, n_local=s, off=a * 42, out=out))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"}, ops
    for src, fn, n in (("grid_knn", "grid_knn_kernel", 2), ("shard", "alpha_ne_kernel", 1)):
        entries = kernels.ptxas_entries(src, fn)
        assert len(entries) == n and all(e["stack"] == 0 for e in entries.values()), entries


# ---------------------------------------------------------------------------
# K4b and K10d on their edges (tests/test_torch_kernel_edges.py holds the
# twins on the same inputs against JAX and numpy float64)
# ---------------------------------------------------------------------------

# (run lengths, invalid rows, every n-th parent unplaced)
K4B_CASES = {
    "runs_of_1_2_and_300": ([1, 2, 300] * 4 + [1] * 50, 0, 0),
    "run_across_two_block_ends": ([3] * 60 + [700] + [2] * 40, 0, 0),
    "invalid_tail_run": ([1, 2, 3, 4] * 60, 2000, 0),
    "unplaced_leaders": ([1 + i % 5 for i in range(400)], 37, 3),
    "p_not_a_multiple_of_256": ([2, 1, 3] * 150 + [13], 100, 7),
}
K4B_KEYS = ("pts", "s_idx", "firstk", "valid_s", "placed", "pslot", "ch_off")


def _k4b_case(case, dev):
    counts, n_invalid, every = K4B_CASES[case]
    d, c1 = synthetic.scatter_add_inputs(counts, n_invalid, seed=len(case),
                                         unplaced_every=every)
    return {k: torch.as_tensor(v, device=dev) for k, v in d.items()}, c1


@pytest.mark.parametrize("case", sorted(K4B_CASES))
def test_scatter_add_kernel_edges(dev, case):
    """K4b against its twin within 1e-6 (the twin's index_add_ adds with
    atomics on the card), the sink row untouched, two calls bit-equal."""
    t, c1 = _k4b_case(case, dev)
    nrows = c1 * 27
    args = [t[k] for k in K4B_KEYS]
    a, b, c = t["l0"].clone(), t["l0"].clone(), t["l0"].clone()
    vm.map_scatter_add(a, *args)
    vm.map_scatter_add(c, *args)
    vm.map_scatter_add_plain(b, *args)
    assert float((a[:nrows] - b[:nrows]).abs().max()) <= 1e-6 * float(b.abs().max())
    assert torch.equal(a, c) and bool((a[nrows] == 0.0).all())
    cpu = vm.map_scatter_add_plain(t["l0"].cpu().clone(), *[x.cpu() for x in args])
    assert torch.equal(a.cpu(), cpu)      # the CPU twin adds in the kernel's order


# (n_pad, partitions, real_mask zero rows, NaN, inactive)
K10D_CASES = {
    "n_pad_17": (17, 3, 0, False, False),
    "n_pad_300_zero_mask_rows": (300, 8, 45, False, False),
    "n_pad_4096_one_cluster": (4096, 73, 396, False, False),
    "n_pad_8192_past_one_cluster": (8192, 60, 100, False, False),
    "nan_in_dx": (300, 8, 0, True, False),
    "inactive": (300, 8, 0, False, True),
}


def _k10d_case(case, dev):
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    n_pad, parts, zero, nan, inactive = K10D_CASES[case]
    a, _ = synthetic.backsub_system(n_pad, parts, seed=n_pad + zero, zero_rows=zero)
    if nan:
        a["g"][1, -1, 2] = np.nan
    g = {k: torch.as_tensor(a[k], device=dev) for k in ("real_mask", "pose_row",
                                                        *dpgo.BACK_KEYS)}
    g["st"] = torch.tensor([2.0, 0.5, 1.0, 0.0 if inactive else 1.0], dtype=torch.float64,
                           device=dev)
    return (g, torch.as_tensor(a["poses"], device=dev),
            *(torch.as_tensor(a[k], device=dev) for k in ("xs", "F", "G", "g")))


@pytest.mark.parametrize("case", sorted(K10D_CASES))
def test_backsub_retract_kernel_edges(dev, case):
    """K10d against its twin: poses within 1e-9, |dx| within 1e-12
    relative, the loop state's it, ok and active equal; two calls
    bit-equal; a NaN in dx or an inactive state leaves the poses as they
    were."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    g, poses, xs, F, G, gv = _k10d_case(case, dev)
    st0 = g["st"].clone()
    p_k, p_2 = poses.clone(), poses.clone()
    dpgo.backsub_retract(g, p_k, xs, F, G, gv, 10, 1e-6)
    st_k = g["st"].clone()
    g["st"].copy_(st0)
    dpgo.backsub_retract(g, p_2, xs, F, G, gv, 10, 1e-6)
    bits = lambda t: t.view(torch.int64)      # NaN's bits compare equal
    assert torch.equal(p_k, p_2) and torch.equal(bits(st_k), bits(g["st"]))
    g_cpu = {k: v.cpu() for k, v in g.items()}
    g_cpu["st"] = st0.cpu()
    p_p = poses.cpu()
    dpgo.backsub_retract(g_cpu, p_p, xs.cpu(), F.cpu(), G.cpu(), gv.cpu(), 10, 1e-6)
    assert float((p_k.cpu() - p_p).abs().max()) <= 1e-9
    st_k, st_p = st_k.cpu(), g_cpu["st"]
    assert st_k[0] == st_p[0] and st_k[2] == st_p[2] and st_k[3] == st_p[3]
    if K10D_CASES[case][3] or K10D_CASES[case][4]:
        assert torch.equal(p_k, poses)
    if K10D_CASES[case][4]:
        assert torch.equal(st_k, st0.cpu())
    elif K10D_CASES[case][3]:
        assert st_k[2] == 0 and st_k[3] == 0 and not bool(torch.isfinite(st_k[1]))
    else:
        assert abs(float(st_k[1]) - float(st_p[1])) <= 1e-12 * float(st_p[1])


def test_scatter_add_and_backsub_launch_once_without_a_stack(dev):
    """K4b and K10d launch their kernel once a call with no torch op beside
    it that launches device work (K10d: no zero fill of a ticket counter),
    K10d as one cluster of 16 CTAs where the card holds one, and ptxas
    gave K4b no stack frame (K10d's is printed: the double sin and cos keep
    a slow-path argument reduction in local memory)."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    t, _ = _k4b_case("run_across_two_block_ends", dev)
    l0 = t["l0"].clone()
    g, poses, xs, F, G, gv = _k10d_case("n_pad_4096_one_cluster", dev)
    g["st"][3] = 1.0
    calls = [("map_scatter_add", lambda: vm.map_scatter_add(l0, *[t[k] for k in K4B_KEYS])),
             ("pgo_backsub_retract",
              lambda: dpgo.backsub_retract(g, poses, xs, F, G, gv, 1 << 30, 0.0))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"}, ops
    assert kernels.ptxas_info("voxel_map", "scatter_add_kernel")["stack"] == 0
    print("K10d ptxas:", kernels.ptxas_info("pgo", "backsub_kernel"))


# ---------------------------------------------------------------------------
# K10a on edge graphs, K8b on responses at its magnitude threshold
# ---------------------------------------------------------------------------

def _se3(rng, scale=1.0):
    T = np.eye(4)
    T[:3, :3] = synthetic._so3_exp_np(rng.normal(0.0, 0.3 * scale, 3))
    T[:3, 3] = rng.normal(0.0, 2.0 * scale, 3)
    return T


def _k10a_graph(case, dev):
    """(uploaded graph, poses) of an edge graph: random poses, information
    from random sqrt factors; "no_loops" a chain with a prior; "reversed"
    chain factors given as (i + 1, i) and three loop edges, one of them
    reversed, M and L padded with invalid slots; "isolated" poses 10 and
    11 with no incident factor; "priors_only" no between factor, two
    priors on pose 0."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    rng = np.random.default_rng(len(case))
    n = {"no_loops": 20, "reversed": 13, "isolated": 12, "priors_only": 8}[case]
    poses = np.stack([_se3(rng, 3.0) for _ in range(n)])
    sq = lambda: np.triu(rng.normal(0.0, 1.0, (6, 6))) + np.eye(6) * 5.0
    priors = [(0, _se3(rng), sq())]
    betweens = []
    if case == "priors_only":
        priors += [(0, _se3(rng), sq())] + [(i, _se3(rng), sq()) for i in range(2, n)]
    else:
        last = 10 if case == "isolated" else n
        for i in range(last - 1):
            f, t = (i + 1, i) if case == "reversed" and i % 2 else (i, i + 1)
            betweens.append((f, t, _se3(rng, 0.2), sq()))
    if case == "reversed":
        betweens += [(f, t, _se3(rng), sq()) for f, t in ((1, 9), (12, 4), (2, 11))]
    g = dpgo.upload(dpgo.pack_graph(poses, priors, betweens), dev)
    return g, g["poses"]


@pytest.mark.parametrize("case", ["no_loops", "reversed", "isolated", "priors_only"])
def test_linearize_kernel_edges(dev, case):
    """K10a against its twin at 1e-10 of each output's largest magnitude,
    two calls bit-equal, one launch a call."""
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    g, poses = _k10a_graph(case, dev)
    n0 = kernels.KERNELS["pgo_linearize"].launches
    a = dpgo.linearize(g, poses)
    b = dpgo.linearize(g, poses)
    p = dpgo.linearize_plain(poses, *[g[k] for k in dpgo.LIN_KEYS])
    assert kernels.KERNELS["pgo_linearize"].launches == n0 + 2
    for x, y, z in zip(a, b, p):
        assert torch.equal(x, y)
        assert _rel(x, z) <= 1e-10
    if case == "priors_only":
        assert not bool(a[1].any()) and not bool(a[3].any())


@pytest.mark.parametrize("b", [1, 3])
def test_iris_encode_kernel_at_its_threshold(dev, b):
    """K8b on responses whose scaled squared magnitudes sit on and beside
    its threshold, with NaN, +-inf and +-0: every T and M word equal to
    the twin's on the card and on the CPU."""
    from lidar_odometry_tpu_torch.ops import iris
    z, s = synthetic.iris_threshold_responses(b, iris.MAG_SQ_THRESHOLD, seed=b)
    resp = torch.as_tensor(z, device=dev)
    Tk, Mk = iris.iris_encode(resp)
    Tp, Mp = iris.iris_encode_plain(resp)
    Tc, Mc = iris.iris_encode_plain(resp.cpu())
    assert torch.equal(Tk, Tp) and torch.equal(Mk, Mp)
    assert torch.equal(Tk.cpu(), Tc) and torch.equal(Mk.cpu(), Mc)
    assert bool((torch.as_tensor(s) == iris.MAG_SQ_THRESHOLD).any())


def test_linearize_and_encode_launch_once_without_a_stack(dev):
    """K10a and K8b launch their kernel once a call with no torch op
    beside it that launches device work (K10a: no scratch, no second
    kernel); ptxas gave K8b no stack frame (K10a's is printed: the double
    acos, sin and tan keep a slow-path argument reduction in local
    memory)."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.ops import iris
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    g, poses = _k10a_graph("reversed", dev)
    resp = torch.as_tensor(synthetic.iris_threshold_responses(2, iris.MAG_SQ_THRESHOLD)[0],
                           device=dev)
    calls = [("pgo_linearize", lambda: dpgo.linearize(g, poses)),
             ("iris_encode", lambda: iris.iris_encode(resp))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"}, ops
    assert kernels.ptxas_info("iris", "iris_encode_kernel")["stack"] == 0
    print("K10a ptxas:", kernels.ptxas_info("pgo", "linearize_kernel"))


# ---------------------------------------------------------------------------
# K8a on keyframe clouds and bin edges, K9a on edge key sets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def iris_clouds(dev):
    """16 keyframe clouds of 10000 returns at 45 m (the loops path's scans),
    padded to the kitti.yaml feature capacity of 16384 with masked rows."""
    world = synthetic.make_world(seed=7, extent=60.0, n_buildings=14)
    poses = synthetic.circuit_trajectory(16, length=60.0, radius=10.0, step=4.0)
    rng = np.random.default_rng(7)
    clouds = np.zeros((16, 16384, 3), np.float32)
    masks = np.zeros((16, 16384), bool)
    for i, pose in enumerate(poses):
        s = synthetic.sample_scan(world, pose, 10000, rng, max_range=45.0, noise=0.01)
        clouds[i, :len(s)] = s
        masks[i, :len(s)] = True
    return torch.as_tensor(clouds, device=dev), torch.as_tensor(masks, device=dev)


def _iris_case(case, clouds, masks, dev):
    if case == "b1":
        return clouds[:1].contiguous(), masks[:1].contiguous()
    if case == "b16":
        return clouds, masks
    if case == "all_masked":
        return clouds[:3].contiguous(), torch.zeros_like(masks[:3])
    if case == "ragged":           # n not a multiple of a block's threads
        return clouds[:5, :16384 - 13].contiguous(), masks[:5, :16384 - 13].contiguous()
    if case == "fewer_points_than_a_block":
        return clouds[:2, :5].contiguous(), masks[:2, :5].contiguous()
    pts, m, _ = synthetic.iris_edge_clouds(4, 5000, seed=len(case))
    return torch.as_tensor(pts, device=dev), torch.as_tensor(m, device=dev)


@pytest.mark.parametrize("case", ["b1", "b16", "all_masked", "ragged",
                                  "fewer_points_than_a_block", "bin_edges"])
def test_iris_image_kernel_edges(dev, iris_clouds, case):
    """K8a against its twin on the card, pixel for pixel: b = 1 and b = 16
    keyframe clouds, every point masked, n not a multiple of a block's
    threads, fewer points than a block's threads, and
    synthetic.iris_edge_clouds (points on and beside the ring, height and
    yaw edges, NaN and +-inf). The output's memory is dirtied first, so
    that a pixel the wrapper's zero fill missed would show."""
    from lidar_odometry_tpu_torch.ops import iris
    pts, m = _iris_case(case, *iris_clouds, dev)
    junk = torch.full((pts.shape[0], iris.ROWS, iris.COLS), -1, dtype=torch.int32, device=dev)
    del junk
    n0 = kernels.KERNELS["iris_image"].launches
    got = iris.iris_bits(pts, m)
    assert kernels.KERNELS["iris_image"].launches == n0 + 1
    ref = iris._iris_bits_plain(pts, m)
    assert torch.equal(got, ref)
    assert torch.equal(got, iris.iris_bits(pts, m))
    if case == "all_masked":
        assert not bool(got.any())
    if case in ("b1", "b16"):
        assert int((got > 0).sum()) > 1000 * pts.shape[0]


def _bulk_case(case, dev):
    """(b_s, i_s, hi, lo, n, slot_from_top) of a K9a edge case, from
    synthetic.bulk_index_keys hashed and stably sorted as bulk_parents
    gives them."""
    n, n_dead, crowd, top = {
        "all_dead": (4096, 4096, 0, 4096), "overflow": (4096, 100, 40, 4096),
        "slots_below_placed": (4096, 10, 12, 50), "one": (1, 0, 0, 1),
        "ragged": (20003, 300, 20, 20003), "round_top": (65536, 500, 30, None),
        "past_a_round": (65537, 500, 30, None),
        "sharded_shard": (16384, 40, 12, None), "many_tiles": (200003, 1000, 30, None)}[case]
    nb = vm._n_buckets(n)
    hi, lo, live = synthetic.bulk_index_keys(n, nb, seed=n + crowd, n_dead=n_dead, crowd=crowd)
    hi64 = torch.as_tensor(hi.astype(np.int64), device=dev)
    lo64 = torch.as_tensor(lo.astype(np.int64), device=dev)
    b = torch.where(torch.as_tensor(live, device=dev), vm.hash_bucket(hi64, lo64, nb - 1), nb)
    b_s, i_s = torch.sort(b.to(torch.int64), stable=True)
    return b_s, i_s, K.to_i32(hi64), K.to_i32(lo64), n, n if top is None else top


@pytest.mark.parametrize("case", ["all_dead", "overflow", "slots_below_placed", "one", "ragged",
                                  "round_top", "past_a_round", "sharded_shard", "many_tiles"])
def test_bulk_index_kernel_edges(dev, case):
    """K9a against its twin on the card, bit for bit (index, meta, count):
    every key dead, a bucket holding more than its 8 cells, fewer slots
    than placed keys, n = 1, n not a multiple of the cluster's threads,
    both sides of one round of the cluster (65536 indices: the surfel and
    loops paths' c1, and one more), the sharded path's per-shard c1 and a
    map of 200003 parents (many rounds)."""
    b_s, i_s, hi, lo, n, top = _bulk_case(case, dev)
    a, p = vm.empty_map(0, n, device=dev), vm.empty_map(0, n, device=dev)
    n0 = kernels.KERNELS["map_bulk_index"].launches
    na = vm.map_bulk_index(b_s, i_s, hi, lo, a.l1_index, a.l1_meta, top)
    assert kernels.KERNELS["map_bulk_index"].launches == n0 + 1
    npl = vm.map_bulk_index_plain(b_s, i_s, hi, lo, p.l1_index, p.l1_meta, top)
    assert int(na) == int(npl)
    # the twin writes its sink rows; the kernel never touches them
    assert torch.equal(a.l1_index, p.l1_index) and torch.equal(a.l1_meta, p.l1_meta)
    if case == "all_dead":
        assert int(na) == 0
    elif case == "slots_below_placed":
        assert int(na) == 50
    elif case != "one":
        assert 0 < int(na) < n


def test_iris_image_and_bulk_index_launch_once_without_a_stack(dev, iris_clouds):
    """K8a and K9a launch their kernel once a call with no torch op beside
    it that launches device work but K8a's zero fill of the image, K9a as
    one cluster of 16 CTAs x 1024 threads (as built) on both sides of one
    round, and ptxas gave every entry function of both no stack frame."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.ops import iris
    clouds, masks = iris_clouds
    small, big = _bulk_case("round_top", dev), _bulk_case("past_a_round", dev)
    fa, fb = vm.empty_map(0, small[4], device=dev), vm.empty_map(0, big[4], device=dev)
    calls = [("iris_image", lambda: iris.iris_bits(clouds, masks)),
             ("iris_image", lambda: iris.iris_bits(clouds[:1], masks[:1])),
             ("map_bulk_index", lambda: vm.map_bulk_index(*small[:4], fa.l1_index, fa.l1_meta,
                                                          small[5])),
             ("map_bulk_index", lambda: vm.map_bulk_index(*big[:4], fb.l1_index, fb.l1_meta,
                                                          big[5]))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        fill = {"aten::zeros", "aten::zero_", "aten::fill_"} if name == "iris_image" else set()
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"} | fill, ops
    assert kernels.KERNELS["map_bulk_index"].launch_shape() == dict(vm.BULK_INDEX_SHAPE, grid=16)
    for src, fn in (("iris", "iris_image_kernel"), ("rehash", "bulk_index_kernel")):
        for name, info in kernels.ptxas_entries(src, fn).items():
            print(f"{name}: {info}")
            assert info["stack"] == 0, (name, info)


@pytest.fixture(scope="module")
def loops_scene(dev, iris_clouds):
    """The loops scene's Iris code DB (iris_clouds' 16 keyframes) and its
    first keyframe in the world frame (the loop solve's matched cloud)."""
    from lidar_odometry_tpu_torch.ops import iris
    clouds, masks = iris_clouds
    img = iris.iris_bits(clouds, masks).to(torch.float32)
    T, M = iris.features(img, torch.as_tensor(iris.log_gabor_filters(), device=dev))
    return dict(img=img, T=T, M=M, world=clouds[0] + torch.tensor([31.0, -12.0, 1.5], device=dev),
                mask=masks[0])


def _hamming_calls(case, scene, dev):
    """[(dbT, dbM, qidx, cand, shifts, valid)] of a K8c case: an edge case
    of synthetic.iris_hamming_case, or the loops scene at K = 1, 2, 4 (the
    loops path's; 1, 2 and 3 valid) and 32 (30 valid)."""
    from lidar_odometry_tpu_torch.ops import iris
    if case != "loops_scene":
        return [tuple(torch.as_tensor(x, device=dev) if isinstance(x, np.ndarray) else x
                      for x in synthetic.iris_hamming_case(case, seed=len(case)))]
    out = []
    for k, n_valid in ((1, 1), (2, 2), (4, 3), (32, 30)):
        cand = ((torch.arange(k, device=dev) + 1) % 16).to(torch.int32)
        shifts = iris.phase_shifts(scene["img"][0], scene["img"][cand.long()])
        out.append((scene["T"], scene["M"], 0, cand, shifts, torch.arange(k, device=dev) < n_valid))
    return out


@pytest.mark.parametrize("case", synthetic.IRIS_HAMMING_CASES + ("loops_scene",))
def test_iris_hamming_kernel_edges(dev, loops_scene, case):
    """K8c against its twin on the card, distances and biases bit for bit:
    the CPU edge cases (K = 1, 2, 32 with padding, shifts at +-180 and
    across the wrap, the query as a candidate, an all-masked candidate,
    ties across shifts and across orientations) and the loops scene at
    the loops path's K and at 32; one launch a call."""
    from lidar_odometry_tpu_torch.ops import iris
    for args in _hamming_calls(case, loops_scene, dev):
        n0 = kernels.KERNELS["iris_hamming"].launches
        out = iris.iris_hamming(*args)
        assert kernels.KERNELS["iris_hamming"].launches == n0 + 1
        twin = iris.iris_hamming_plain(*args)
        assert torch.equal(out.view(torch.int32), twin.view(torch.int32)), (out, twin)
        cpu = iris.iris_hamming(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        assert torch.equal(out.cpu().view(torch.int32), cpu.view(torch.int32))


def _grid_case(case, scene, dev):
    """[(key_s, pts_s, inv)] of a K6a case: an edge case of
    synthetic.point_grid_cloud, or the loops scene's matched cloud at the
    loop solve's 2 m and 0.5 m bins."""
    if case == "loops_scene":
        pts, mask, sizes = scene["world"], scene["mask"], (2.0, 0.5)
    else:
        p, m, b = synthetic.point_grid_cloud(case, seed=len(case))
        pts, mask, sizes = torch.as_tensor(p, device=dev), torch.as_tensor(m, device=dev), (b,)
    out = []
    for b in sizes:
        inv = K.f32(1.0 / K.f32(b))
        key = torch.where(mask, K.sort_key(*K.pack_key(K.voxel_coords(pts, inv))),
                          K.INVALID_SORT_KEY)
        key_s, idx = torch.sort(key, stable=True)
        out.append((key_s, pts[idx].contiguous(), inv))
    return out


@pytest.mark.parametrize("case", synthetic.POINT_GRID_CASES + ("loops_scene",))
def test_point_grid_kernel_edges(dev, loops_scene, case):
    """K6a against its twin on the card, grid and meta bit for bit: the CPU
    edge cases (a fitting cloud, one bin too wide in x, y or z, no valid
    row, one valid row, c not a multiple of the CTA and past one round of
    the cluster, the window's last bin, duplicate keys) and the loops
    scene's matched cloud at 2 m (fits) and 0.5 m (does not); one launch
    a call; a launch into a grid of other values gives the same grid (the
    fill is the kernel's)."""
    from lidar_odometry_tpu_torch.ops import knn
    for key_s, pts_s, inv in _grid_case(case, loops_scene, dev):
        n0 = kernels.KERNELS["point_grid"].launches
        grid, meta = knn.point_grid(key_s, pts_s, inv)
        assert kernels.KERNELS["point_grid"].launches == n0 + 1
        gp, mp = knn.point_grid_plain(key_s, pts_s, inv)
        assert torch.equal(grid, gp) and torch.equal(meta, mp), (meta, mp)
        gc, mc = knn.point_grid_plain(key_s.cpu(), pts_s.cpu(), inv)
        assert torch.equal(grid.cpu(), gc) and torch.equal(meta.cpu(), mc)
        if case == "loops_scene":
            assert bool(meta[3]) == (1.0 / inv == 2.0)
    grid.fill_(-7)                  # a dirty allocation: the kernel writes every entry
    torch.cuda.synchronize()
    kernels.KERNELS["point_grid"].launch(key_s.data_ptr(), pts_s.data_ptr(), key_s.shape[0],
                                         inv, grid.data_ptr(), meta.data_ptr())
    assert torch.equal(grid, gp) and torch.equal(meta, mp)


def test_hamming_and_point_grid_launch_once_without_a_stack(dev, loops_scene):
    """K8c and K6a launch their kernel once a call with no torch op beside
    it that launches device work (K6a's grid is filled in the kernel), K8c
    as a cluster of 8 CTAs x 256 threads a candidate and K6a as 16 clusters
    of 8 x 512 (as built), and ptxas gave both no stack frame."""
    from torch.profiler import ProfilerActivity, profile
    from lidar_odometry_tpu_torch.ops import iris, knn
    calls = [("iris_hamming", lambda a=a: iris.iris_hamming(*a))
             for a in _hamming_calls("loops_scene", loops_scene, dev)]
    calls += [("point_grid", lambda a=a: knn.point_grid(*a))
              for a in _grid_case("loops_scene", loops_scene, dev)]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        n0 = kernels.KERNELS[name].launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        assert kernels.KERNELS[name].launches == n0 + 1
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::slice", "aten::view", "aten::as_strided"}, ops
    assert kernels.KERNELS["iris_hamming"].launch_shape() == dict(iris.HAMMING_SHAPE, grid=8)
    assert kernels.KERNELS["point_grid"].launch_shape() == knn.POINT_GRID_SHAPE
    for src, fn in (("iris", "iris_hamming_kernel"), ("knn", "point_grid_kernel")):
        for name, info in kernels.ptxas_entries(src, fn).items():
            print(f"{name}: {info}")
            assert info["stack"] == 0, (name, info)
