"""The sharded map's kernels K11a-d (parallel/shard_ops.py, their plain
twins on the CPU) and the committed per-shard draws, against the JAX
package's parallel/sharded_map.py and ops/pko.py on the same numpy inputs.

  * K11a: owners and the compaction (sel, ok, the gathered points)
    exactly equal to owner_of_points and _compact_owned at S in {1, 2, 4,
    8}, every shard; with a pose, the owners of the moved points equal on
    all but 1e-3 of them (the two sides round R p + t in different
    orders); _owned_cap equal over a grid of (N, S);
  * the draws: every shard's uniforms and the k-means start over the
    merged samples bit-equal to jax.random's, for each committed count;
  * K11b: the per-alpha systems and count within 1e-5 relative of JAX's
    _robust_weights(...) @ Z, the moments within 1e-5 relative;
  * K11c: the sample and ok slots exactly equal to JAX's stratified_sample
    with fold_in(PRNGKey(42), shard) written into the shard's slice;
  * K11d: the same alpha as pko_alpha_index_from_samples on the merged
    samples, T within 1e-6 of the JAX solve and retract, the flag rules;
  * ShardGroup at one rank: all_gather is the identity, psum adds the
    shards in order (the gloo ranks are in test_torch_sharded_ranks.py);
  * K2a's instance axis: icp_correspond_instances over 1 lane x 4 shards
    and 2 lanes x 4 shards (each lane its own sharded map) equals the
    per-instance calls, and its lane and shard strides are read from the
    map views (lanes may share a map; a view off the grid is refused).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_tpu.ops import icp as jicp
from lidar_odometry_tpu.ops import pko as jpko
from lidar_odometry_tpu.parallel import sharded_map as jsm
from lidar_odometry_tpu.utils import lie as jlie
from lidar_odometry_tpu_torch import kernels
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import icp, pko
from lidar_odometry_tpu_torch.ops import voxel_map as vm
from lidar_odometry_tpu_torch.parallel import mesh
from lidar_odometry_tpu_torch.parallel import shard_ops as so
from lidar_odometry_tpu_torch.parallel import sharded_map as sm

PKO_ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)
INV = so.owner_inv(0.5, 3)


@pytest.fixture(scope="module")
def cloud():
    world = synthetic.make_world(seed=4, extent=40.0, n_buildings=8)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 1.8
    pts = synthetic.sample_scan(world, pose, 6000, np.random.default_rng(4), max_range=40.0,
                                noise=0.01).astype(np.float32)
    mask = np.random.default_rng(5).random(len(pts)) > 0.1
    return pts, mask


def _pose():
    a = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    T[:3, 3] = (1.3, -0.4, 0.2)
    return T


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_own_matches_jax(cloud, n_shards):
    pts, mask = cloud
    n = len(pts)
    cap = so.owned_cap(n, n_shards)
    owner_j = np.asarray(jsm.owner_of_points(jnp.asarray(pts), n_shards, voxel_size=0.5))
    np.testing.assert_array_equal(so.shard_owner(torch.as_tensor(pts), n_shards, INV).numpy(),
                                  owner_j)
    p_own, ok, sel, over = so.shard_own(torch.as_tensor(pts)[None], torch.as_tensor(mask)[None],
                                        None, n_shards, 0, n_shards, cap, INV)
    compact = jax.jit(jsm._compact_owned, static_argnums=4)
    for me in range(n_shards):
        jp, jok, jsel = compact(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(owner_j),
                                jnp.int32(me), cap)
        np.testing.assert_array_equal(sel[me].numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(ok[me].numpy(), np.asarray(jok))
        np.testing.assert_array_equal(p_own[me].numpy(), np.asarray(jp))
        owned = int((mask & (owner_j == me)).sum())
        assert int(over[me]) == max(owned - cap, 0)
    assert int(ok.sum()) + int(over.sum()) == int(mask.sum())


def test_shard_own_with_pose_matches_jax(cloud):
    pts, mask = cloud
    T = _pose()
    R, t = jlie.se3_rt(jnp.asarray(T))
    ref = np.asarray(jsm.owner_of_points(jnp.asarray(pts) @ R.T + t[None, :], 4, voxel_size=0.5))
    got = so.shard_owner_plain(so._transform_plain(torch.as_tensor(T).reshape(1, 16),
                                                   torch.as_tensor(pts)[None]), 4, INV)[0].numpy()
    assert (got != ref).sum() <= 1e-3 * len(pts)
    # the compaction keeps body points, in index order
    p_own, ok, sel, _ = so.shard_own(torch.as_tensor(pts)[None], torch.as_tensor(mask)[None],
                                     torch.as_tensor(T).reshape(1, 16), 4, 0, 4,
                                     so.owned_cap(len(pts), 4), INV)
    for me in range(4):
        idx = np.nonzero(mask & (got == me))[0]
        np.testing.assert_array_equal(sel[me].numpy()[:len(idx)], idx)
        np.testing.assert_array_equal(p_own[me].numpy()[:len(idx)], pts[idx])


def test_owned_cap_matches_jax():
    for n in (256, 1000, 4096, 6000, 14336, 16384, 131072):
        for s in range(1, 9):
            assert so.owned_cap(n, s) == jsm._owned_cap(n, s), (n, s)


def test_committed_shard_draws_equal_jax():
    key = jax.random.PRNGKey(42)
    for s in pko.SHARD_COUNTS:
        u, pick = pko.shard_draws(s)
        q = -(-100 // s)
        assert u.shape == (s, q) and q == pko.shard_quota(s)
        for me in range(s):
            ref = np.asarray(jax.random.uniform(jax.random.fold_in(key, me), (q,)))
            np.testing.assert_array_equal(u[me].view(np.uint32), ref.view(np.uint32))
        np.testing.assert_array_equal(pick, np.asarray(jax.random.randint(key, (3,), 0, s * q)))
    with pytest.raises(ValueError, match="1, 2, 4, 8"):
        pko.shard_draws(3)


def _correspondences(seed, g, n):
    """Stand-in per-shard correspondences: body points, unit normals,
    residuals with a far outlier mode, validity."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (g, n, 3)).astype(np.float32)
    nrm = rng.standard_normal((g, n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    r = np.where(rng.random((g, n)) < 0.8, rng.standard_normal((g, n)) * 0.02,
                 0.4 + rng.standard_normal((g, n)) * 0.2).astype(np.float32)
    valid = rng.random((g, n)) > 0.15
    return p, nrm.astype(np.float32), r, valid


@pytest.mark.parametrize("loss", ["huber", "cauchy"])
def test_alpha_normal_eq_matches_jax(loss):
    g, n = 4, 700
    p, nrm, r, valid = _correspondences(1, g, n)
    T = _pose()
    cfg = icp.ICPConfig(loss_type=loss)
    consts = pko.make_pko_constants(*PKO_ARGS, device="cpu")
    tt = torch.as_tensor
    flags = torch.zeros((1, 3), dtype=torch.int32)
    mom = so.shard_alpha_normal_eq(tt(p), tt(nrm), tt(r), tt(valid), tt(T).reshape(1, 16), flags,
                                   None, None, cfg, n_local=g, moments=True)
    w = valid.astype(np.float32)
    ra = np.abs(r)
    ref_mom = np.stack([w.sum(1), (ra * w).sum(1), (ra * ra * w).sum(1)], 1)
    np.testing.assert_allclose(mom.numpy(), ref_mom, rtol=1e-5)
    ld = so.buffer_width(101, g, 25)
    out = torch.zeros((g, ld))
    so.shard_alpha_normal_eq(tt(p), tt(nrm), tt(r), tt(valid), tt(T).reshape(1, 16), flags,
                             mom.view(1, g, 3), consts.alphas, cfg, n_local=g, out=out)
    # JAX: moments -> scale (sharded_map.py:380-386), then gn_round's W @ Z
    m = ref_mom.sum(0)
    n0 = max(m[0], 1.0)
    scale = np.sqrt(max(m[2] / n0 - (m[1] / n0) ** 2, 0.0)) / 6.0
    R = jnp.asarray(T[:3, :3])
    alphas = jnp.asarray(consts.alphas.numpy())
    for i in range(g):
        a = jnp.asarray(nrm[i]) @ R
        J = jnp.concatenate([a, jnp.cross(jnp.asarray(p[i]), a)], axis=-1)
        Z = jnp.concatenate([(J[:, :, None] * J[:, None, :]).reshape(-1, 36),
                             J * jnp.asarray(r[i])[:, None]], axis=1)
        W = jicp._robust_weights(jnp.abs(jnp.asarray(r[i]))[None, :] / max(scale, 1e-6),
                                 alphas[:, None], loss) * jnp.asarray(w[i])[None, :]
        ref = np.asarray(W @ Z).reshape(-1)
        got = out[i, :101 * 42].numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        assert float(out[i, -1]) == w[i].sum()


def test_shard_sample_matches_jax():
    g, n = 4, 900
    _, _, r, valid = _correspondences(2, g, n)
    valid[3, 10:] = False          # a shard with fewer valid residuals than its quota
    u, _ = pko.shard_draws(g)
    q = u.shape[1]
    mom = torch.as_tensor(np.array([[[900.0, 40.0, 9.0]] * g], np.float32))
    ld = so.buffer_width(101, g, q)
    out = torch.full((g, ld), 7.0)
    off = 101 * 42
    so.shard_sample(torch.as_tensor(r), torch.as_tensor(valid), torch.zeros((1, 3), dtype=torch.int32),
                    mom, torch.as_tensor(u), first=0, n_local=g, off=off, out=out)
    scale = float(so.scale_from_moments(mom)[0])
    key = jax.random.PRNGKey(42)
    for me in range(g):
        nr = jnp.abs(jnp.asarray(r[me])) / jnp.maximum(jnp.float32(scale), 1e-6)
        samp, sok = jpko.stratified_sample(nr, jnp.asarray(valid[me]), q,
                                           jax.random.fold_in(key, me))
        sokf = np.asarray(sok, np.float32)
        ref_s = np.zeros(g * q, np.float32)
        ref_o = np.zeros(g * q, np.float32)
        ref_s[me * q:(me + 1) * q] = np.asarray(samp) * sokf
        ref_o[me * q:(me + 1) * q] = sokf
        np.testing.assert_array_equal(out[me, off:off + g * q].numpy(), ref_s)
        np.testing.assert_array_equal(out[me, off + g * q:off + 2 * g * q].numpy(), ref_o)
    assert float(out[3, off + 2 * g * q - 1]) == 0.0    # shard 3's empty slots


def _buffer(seed, n_shards, q, count):
    """Gathered rows: per-alpha SPD systems, shard-sliced samples (one
    shard short of valid residuals), counts."""
    rng = np.random.default_rng(seed)
    ld = so.buffer_width(101, n_shards, q)
    rows = np.zeros((n_shards, ld), np.float32)
    for s in range(n_shards):
        for a in range(101):
            J = rng.standard_normal((40, 6)) * (1.0 + 0.01 * a)
            H = J.T @ J
            rows[s, a * 42:a * 42 + 36] = H.reshape(-1)
            rows[s, a * 42 + 36:a * 42 + 42] = rng.standard_normal(6) * 0.1
        nv = q if s else q // 2
        samples = np.abs(np.where(rng.random(q) < 0.8, rng.standard_normal(q) * 0.8,
                                  3.0 + rng.standard_normal(q)))
        ok = (np.arange(q) < nv).astype(np.float32)
        off = 101 * 42
        rows[s, off + s * q:off + (s + 1) * q] = samples * ok
        rows[s, off + n_shards * q + s * q:off + n_shards * q + (s + 1) * q] = ok
        rows[s, -1] = count / n_shards
    return rows


@pytest.mark.parametrize("n_shards", [2, 8])
def test_gn_select_matches_jax(n_shards):
    q = pko.shard_quota(n_shards)
    consts = pko.make_pko_constants(*PKO_ARGS, device="cpu")
    jconsts = jpko.make_pko_constants(*PKO_ARGS)
    _, pick = pko.shard_draws(n_shards)
    cfg = icp.ICPConfig()
    T = _pose()
    rows = _buffer(3, n_shards, q, 400.0)
    T_out, f_out, info = so.shard_gn_select(
        torch.as_tensor(rows)[None], torch.as_tensor(T).reshape(1, 16),
        torch.zeros((1, 3), dtype=torch.int32), consts, torch.as_tensor(pick), cfg, n_alpha=101,
        quota=q, use_pko=True)
    # JAX gn_round after the psum (sharded_map.py:346-372)
    buf = jnp.asarray(rows.sum(0))
    m = n_shards * q
    s_all, o_all = buf[4242:4242 + m], buf[4242 + m:4242 + 2 * m]
    meanv = jnp.sum(s_all) / jnp.maximum(jnp.sum(o_all), 1.0)
    best = int(jpko.pko_alpha_index_from_samples(jnp.where(o_all > 0.5, s_all, meanv), jconsts))
    assert int(info[0, 0]) == best
    HG = buf[best * 42:best * 42 + 42]
    dx = jnp.linalg.solve(HG[:36].reshape(6, 6) + jnp.eye(6) * 1e-8, -HG[36:42])
    T_ref = np.asarray(jnp.asarray(T) @ jlie.se3_from_exp_rt(dx[:3], dx[3:]))
    np.testing.assert_allclose(T_out.view(4, 4).numpy(), T_ref, atol=1e-6)
    conv = bool(np.linalg.norm(dx[:3]) < 0.005) and bool(np.linalg.norm(dx[3:]) < 0.005)
    assert f_out[0].tolist() == [int(conv), 0, 400]
    assert int(info[0, 1]) == 400


def test_gn_select_state_rules():
    consts = pko.make_pko_constants(*PKO_ARGS, device="cpu")
    _, pick = pko.shard_draws(4)
    cfg = icp.ICPConfig()
    T = torch.as_tensor(_pose()).reshape(1, 16)
    few = torch.as_tensor(_buffer(4, 4, 25, 20.0))[None]      # 20 < 50 correspondences
    T_out, f_out, _ = so.shard_gn_select(few, T, torch.tensor([[0, 0, 33]], dtype=torch.int32),
                                         consts, torch.as_tensor(pick), cfg, n_alpha=101,
                                         quota=25, use_pko=True)
    assert f_out[0].tolist() == [1, 1, 33]              # insufficient: done, failed, kept
    np.testing.assert_array_equal(T_out.numpy(), T.numpy())
    done = torch.tensor([[1, 0, 77]], dtype=torch.int32)
    T_out, f_out, info = so.shard_gn_select(torch.as_tensor(_buffer(4, 4, 25, 400.0))[None], T,
                                            done, consts, torch.as_tensor(pick), cfg,
                                            n_alpha=101, quota=25, use_pko=True)
    assert f_out[0].tolist() == [1, 0, 77] and info[0].tolist() == [0, 0]
    np.testing.assert_array_equal(T_out.numpy(), T.numpy())


def test_shard_group_one_rank():
    g = mesh.make_group(3, device="cpu")
    assert (g.world_size, g.rank, g.n_shards, list(g.local_ids)) == (1, 0, 3, [0, 1, 2])
    x = torch.arange(12, dtype=torch.float32).view(3, 4) * 0.1
    assert g.all_gather(x) is x
    np.testing.assert_array_equal(g.psum(x).numpy(), ((x[0] + x[1]) + x[2]).numpy())
    y = torch.arange(24, dtype=torch.float32).view(2, 3, 4)
    np.testing.assert_array_equal(g.psum(y, dim=1).numpy(),
                                  ((y[:, 0] + y[:, 1]) + y[:, 2]).numpy())


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_fused_normal_eq_and_sample_match_the_two_twins(n_shards):
    """shard_alpha_normal_eq_sample (K11b with K11c in its launch) writes,
    on the CPU, the row of shard_alpha_normal_eq then shard_sample, at 2
    lanes x S shards with lane 1 done, a shard with fewer valid entries
    than its quota and one with none; its sample slots exactly JAX's
    stratified_sample of each live shard."""
    b, s, n = 2, n_shards, 310
    p, nrm, r, valid = (torch.as_tensor(a) for a in _correspondences(11 + s, b * s, n))
    valid[0, 7:] = False                                 # nv < quota
    if s > 1:
        valid[1] = False                                 # nv = 0
    T = torch.as_tensor(np.stack([_pose(), np.eye(4, dtype=np.float32)])).reshape(b, 16)
    flags = torch.zeros((b, 3), dtype=torch.int32)
    flags[1] = torch.tensor([1, 0, 77], dtype=torch.int32)
    cfg = icp.ICPConfig()
    consts = pko.make_pko_constants(*PKO_ARGS, device="cpu")
    u = torch.as_tensor(pko.shard_draws(s)[0])
    q = u.shape[1]
    off, ld = 101 * 42, so.buffer_width(101, s, q)
    mom = so.shard_alpha_normal_eq(p, nrm, r, valid, T, torch.zeros_like(flags), None, None, cfg,
                                   n_local=s, moments=True).view(b, s, 3)
    fused, two = torch.full((b * s, ld), -7.0), torch.full((b * s, ld), -7.0)
    so.shard_alpha_normal_eq_sample(p, nrm, r, valid, T, flags, mom, consts.alphas, u, cfg,
                                    first=0, n_local=s, off=off, out=fused)
    so.shard_alpha_normal_eq(p, nrm, r, valid, T, flags, mom, consts.alphas, cfg, n_local=s,
                             out=two)
    so.shard_sample(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=two)
    assert torch.equal(fused, two)
    assert bool((fused[s:] == -7.0).all())               # the done lane's rows
    scale = float(so.scale_from_moments(mom)[0])
    key = jax.random.PRNGKey(42)
    for me in range(s):
        nr = jnp.abs(jnp.asarray(r[me].numpy())) / jnp.maximum(jnp.float32(scale), 1e-6)
        samp, sok = jpko.stratified_sample(nr, jnp.asarray(valid[me].numpy()), q,
                                           jax.random.fold_in(key, me))
        sokf = np.asarray(sok, np.float32)
        got = fused[me, off:off + 2 * s * q].numpy()
        np.testing.assert_array_equal(got[me * q:(me + 1) * q], np.asarray(samp) * sokf)
        np.testing.assert_array_equal(got[s * q + me * q:s * q + (me + 1) * q], sokf)
        others = np.ones(2 * s * q, bool)
        others[me * q:(me + 1) * q] = others[s * q + me * q:s * q + (me + 1) * q] = False
        assert not got[others].any()
    nv = int(valid[0].sum())
    assert 0 < nv < q and int(fused[0, off + s * q:off + s * q + q].sum()) == nv


def test_twins_lane_axis():
    """The plain twins over 2 lanes x 4 shards, the lanes with their own
    points, poses and moments: lane b of each call equals a one-lane call
    on lane b's inputs, and a done lane's rows are left unwritten (its
    moments zero), as the kernels leave them."""
    b, s, n = 2, 4, 500
    p, nrm, r, valid = (torch.as_tensor(a) for a in _correspondences(6, b * s, n))
    T = torch.as_tensor(np.stack([_pose(), np.eye(4, dtype=np.float32)])).reshape(b, 16)
    cfg = icp.ICPConfig()
    consts = pko.make_pko_constants(*PKO_ARGS, device="cpu")
    u, pick = (torch.as_tensor(a) for a in pko.shard_draws(s))
    q = u.shape[1]
    off, ld = 101 * 42, so.buffer_width(101, s, q)
    inst = lambda x, lane: x[lane * s:(lane + 1) * s]
    pts = p[::s].contiguous()                                  # (b, n, 3) scans
    mask = valid[::s].contiguous()
    own = so.shard_own(pts, mask, T, s, 0, s, so.owned_cap(n, s), INV)
    for lane in range(b):
        one = so.shard_own(pts[lane:lane + 1], mask[lane:lane + 1], T[lane:lane + 1], s, 0, s,
                           so.owned_cap(n, s), INV)
        assert all(torch.equal(inst(x, lane), y) for x, y in zip(own, one))
    for done in (None, 0, 1):
        flags = torch.zeros((b, 3), dtype=torch.int32)
        if done is not None:
            flags[done] = torch.tensor([1, 0, 77], dtype=torch.int32)
        mom = so.shard_alpha_normal_eq(p, nrm, r, valid, T, flags, None, None, cfg, n_local=s,
                                       moments=True)
        if done is not None:
            assert not bool(inst(mom, done).any())
        mom = so.shard_alpha_normal_eq(p, nrm, r, valid, T, torch.zeros_like(flags), None, None,
                                       cfg, n_local=s, moments=True).view(b, s, 3)
        rows = torch.full((b * s, ld), -7.0)
        so.shard_alpha_normal_eq(p, nrm, r, valid, T, flags, mom, consts.alphas, cfg, n_local=s,
                                 out=rows)
        so.shard_sample(r, valid, flags, mom, u, first=0, n_local=s, off=off, out=rows)
        for lane in range(b):
            one = torch.full((s, ld), -7.0)
            args = [inst(a, lane) for a in (p, nrm, r, valid)]
            so.shard_alpha_normal_eq(*args, T[lane:lane + 1], flags[lane:lane + 1],
                                     mom[lane:lane + 1], consts.alphas, cfg, n_local=s, out=one)
            so.shard_sample(args[2], args[3], flags[lane:lane + 1], mom[lane:lane + 1], u,
                            first=0, n_local=s, off=off, out=one)
            assert torch.equal(one, inst(rows, lane))
            assert bool((one == -7.0).all()) == (lane == done)
        sel = so.shard_gn_select(rows.view(b, s, ld), T, flags, consts, pick, cfg, n_alpha=101,
                                 quota=q, use_pko=True)
        for lane in range(b):
            one = so.shard_gn_select(rows.view(b, s, ld)[lane:lane + 1], T[lane:lane + 1],
                                     flags[lane:lane + 1], consts, pick, cfg, n_alpha=101,
                                     quota=q, use_pko=True)
            assert all(torch.equal(x[lane], y[0]) for x, y in zip(sel, one))


@pytest.fixture(scope="module")
def lane_maps(cloud):
    """Two sharded maps of 4 shards (4096 parents), each built by the
    sharded update from the cloud (lane 1's moved 0.7 m), and the two
    stacked as the data x map step's batched state."""
    pts, mask = cloud
    g = mesh.make_group(4, device="cpu")
    maps = []
    for shift in (0.0, 0.7):
        st = sm.sharded_empty_map(0, 4096, g)
        moved = torch.as_tensor(pts + np.float32([shift, 0.0, 0.0]))
        sm.sharded_update_map(st, moved, torch.as_tensor(mask), torch.zeros(3), 100.0, g,
                              voxel_size=0.5, planarity_threshold=0.1)
        maps.append(st)
    batched = vm.VoxelMapState(*[torch.stack([a, b]) for a, b in zip(*maps)])
    return maps[0], batched


@pytest.mark.parametrize("lanes", [1, 2])
def test_correspond_instances_equal_per_instance_calls(cloud, lane_maps, lanes):
    pts, mask = cloud
    single, batched = lane_maps
    maps = sm.local_views(single) if lanes == 1 else sm.local_views(batched, lanes)
    s, n = 4, 2000
    T = torch.as_tensor(np.stack([_pose(), np.eye(4, dtype=np.float32)])[:lanes]).reshape(
        lanes, 16)
    T[:, 3] += 0.05
    scan = torch.as_tensor(pts[:n]).expand(lanes, n, 3).contiguous()
    p_own, ok, _, _ = so.shard_own(scan, torch.as_tensor(mask[:n]).expand(lanes, n).contiguous(),
                                   T, s, 0, s, so.owned_cap(n, s), INV)
    flags = torch.zeros((lanes, 3), dtype=torch.int32)
    cfg = icp.ICPConfig()
    got = icp.icp_correspond_instances(p_own, ok, T, flags, maps, cfg)
    out = tuple(torch.full_like(x, 7) for x in got)
    icp.icp_correspond_instances(p_own, ok, T, flags, maps, cfg, out=out)
    for g in range(lanes * s):
        one = icp.icp_correspond(p_own[g], ok[g], T[g // s], flags[g // s], maps[g // s][g % s],
                                 cfg)
        for a, b, c in zip(got, out, one):
            assert torch.equal(a[g], c) and torch.equal(b[g], c)
    assert int(got[2].sum()) > 100


def test_correspond_instance_strides(lane_maps):
    single, batched = lane_maps
    one, two = sm.local_views(single), sm.local_views(batched, 2)
    idx = lambda maps: [m.l1_index for row in maps for m in row]
    step = one[0][0].l1_index.numel()
    assert icp._instance_strides(idx(one), 4, "l1_index") == (0, step)
    assert icp._instance_strides(idx(two), 4, "l1_index") == (4 * step, step)
    assert icp._instance_strides(idx([one[0], one[0]]), 4, "l1_index") == (0, step)
    sf = one[0][0].l1_surfel.numel()
    assert icp._instance_strides([m.l1_surfel for row in two for m in row], 4,
                                 "l1_surfel") == (4 * sf, sf)
    off_grid = [one[0][0], one[0][1], two[1][2], one[0][3]]
    with pytest.raises(ValueError, match="not at lane"):
        icp._instance_strides([m.l1_index for m in off_grid], 4, "l1_index")
    flat = torch.zeros(step + 1, dtype=torch.int32)
    shifted = flat[1:].view(one[0][0].l1_index.shape)     # 4 bytes off a 16-byte boundary
    with pytest.raises(kernels.KernelInputError, match="16-byte"):
        icp._instance_strides([shifted], 1, "l1_index")
