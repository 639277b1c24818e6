"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

These need an NVIDIA GPU and nvcc; they are marked `cuda` and skip where
there is no card (a CUDA kernel has no CPU mode). On the card:

    python -m pytest tests/test_torch_kernels.py -q -n 0
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
    return dict(carry=carry, raw=raw, feat=feat, mask=mask, T=T, cfg=cfg, consts=consts)


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
    tgt = torch.where(firstk & hit[s_idx] & valid_s, slot[s_idx] * 27 + off[s_idx], nrows)
    a, b = st.l0_data.clone(), st.l0_data.clone()
    vm.map_scatter_add(a, world, s_idx, firstk, valid_s, tgt)
    vm.map_scatter_add_plain(b, world, s_idx, firstk, valid_s, tgt)
    assert float((a[:nrows] - b[:nrows]).abs().max()) <= 1e-6
    r_slot = torch.nonzero(st.l1_meta[:c1, 2] >= 5).flatten()
    r_slot = torch.cat([r_slot, torch.full((7,), -1, dtype=torch.int64, device="cuda")])
    sk, nk, kk = vm.map_surfel_recompute(st.l0_data, r_slot, c1, K.f32(0.1))
    sp, np_, kp = vm.map_surfel_recompute_plain(st.l0_data, r_slot, c1, K.f32(0.1))
    assert torch.equal(kk, kp) and torch.equal(nk, np_)
    assert float((sk[:, 3:] - sp[:, 3:]).abs().max()) <= 1e-4
    dots = (sk[:, :3] * sp[:, :3]).sum(1).abs()
    assert float((dots > 1 - 1e-4).float().mean()) > 0.99


def test_wrappers_refuse_what_the_kernels_do_not_take(scene):
    raw = scene["raw"]
    key = torch.zeros(raw.shape[0], dtype=torch.int32, device="cuda")
    perm = torch.zeros(raw.shape[0], dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        vf.voxel_segments(key, perm, raw, 16, 2.0, 0.5)
    with pytest.raises(ValueError):
        vf.voxel_segments(key.long(), perm, raw[:, :2].contiguous(), 16, 2.0, 0.5)
