"""The port's sharded surfel map (parallel/sharded_map.py, parallel/pipeline.py:
K11a-d, K2a and K4a-c through their plain twins on the CPU) against the
JAX package's on the same numpy inputs: 4 shards, JAX on the conftest's
virtual 8-device mesh (Mesh over 4 devices, axis "map"), the port on one
process holding the 4 shards (ShardGroup with 4 local shards).

The scene is tests/test_parallel.py's _build_both (seed 2): three 8000-
point scans of a 40 m world inserted into a map of 4 x 8192 parents.
Tolerances:
  * the map after the updates, after the eviction drain (the far-sensor
    radius eviction of tests/test_parallel.py:70, six updates) and after
    the rehash by a quarter turn (a correction whose products are exact):
    every shard's integer state identical (index, meta, free stack,
    last counts, n_l0, n_l1, n_dropped), child rows [count | sum] within
    1e-5 relative, surfel centroids within 1e-5, surfel normals within
    1e-4 except on cells whose two smallest covariance eigenvalues are
    within 1e-4 of the largest (the normal is not fixed by the data;
    counted and kept under 1 %);
  * lookups: the same hits, normals and centroids within 1e-5;
  * sharded_icp_step: T within 1e-4 after each of 3 steps;
  * sharded_icp_optimize with PKO (8 iterations): the same success and
    correspondence count, T within 1e-4; at every iteration the alpha
    that K11d's twin picks equals JAX's pko_alpha_index_from_samples on
    the same merged samples; within 5e-3 of the port's single-device
    icp_optimize on a single map of the same scans (the bound of
    tests/test_parallel.py:268), and within 2 cm of the true pose;
  * the insufficient-correspondence fallback: the guess back, success
    False, 0 correspondences (tests/test_parallel.py:272);
  * multichip_odometry_step, B = 2 lanes x 4 shards, 3 steps with the
    keyframe flags given: T within 1e-4 at every step and every lane's
    map with the integer state identical.

The JAX side runs in a fresh subprocess (as tests/test_torch_estimator.py
does), every program jitted once.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import icp, pko
from lidar_odometry_tpu_torch.ops import voxel_map as vm
from lidar_odometry_tpu_torch.parallel import mesh, pipeline
from lidar_odometry_tpu_torch.parallel import shard_ops as so
from lidar_odometry_tpu_torch.parallel import sharded_map as sm

from test_torch_voxel_map import _ill_conditioned

ROOT = Path(__file__).resolve().parent.parent
S = 4
C1_TOTAL = 4 * 8192
INT_FIELDS = ("l1_index", "l1_meta", "l1_free", "l1_free_top", "l1_last", "n_l0", "n_l1",
              "n_dropped")
PKO_ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)

_JAX_SIDE = textwrap.dedent("""
    import sys
    from functools import partial
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from lidar_odometry_tpu.ops import icp, pko
    from lidar_odometry_tpu.parallel import pipeline, sharded_map as sm
    inp = dict(np.load(sys.argv[1]))
    S, C1 = int(inp["n_shards"]), int(inp["c1_total"])
    mesh = Mesh(np.array(jax.devices()[:S]), ("map",))
    a = jnp.asarray
    out = {}
    def keep(prefix, st):
        out.update({prefix + k: np.asarray(v) for k, v in sm.gather_state(st)._asdict().items()})
    upd = jax.jit(partial(sm.sharded_update_map, mesh=mesh, voxel_size=0.5,
                          planarity_threshold=0.1))
    st = sm.sharded_empty_map(0, C1, mesh)
    for i in range(inp["upd_pts"].shape[0]):
        st = upd(st, a(inp["upd_pts"][i]), a(inp["upd_mask"][i]), a(inp["upd_sensor"][i]),
                 jnp.float32(120.0))
    keep("built_", st)
    n, c, v = jax.jit(partial(sm.sharded_lookup_surfels, mesh=mesh, voxel_size=0.5))(
        st, a(inp["queries"]))
    out.update(look_n=np.asarray(n), look_c=np.asarray(c), look_v=np.asarray(v))
    step = jax.jit(partial(sm.sharded_icp_step, mesh=mesh, cfg=icp.ICPConfig(voxel_size=0.5)))
    T, steps = a(inp["guess"]), []
    for _ in range(3):
        T, _n = step(st, a(inp["scan"]), a(inp["scan_mask"]), T)
        steps.append(np.asarray(T))
    out["steps"] = np.stack(steps)
    cfg8 = icp.ICPConfig(max_iterations=8, voxel_size=0.5)
    consts = pko.make_pko_constants(*%r)
    To, ok, nc = jax.jit(partial(sm.sharded_icp_optimize, mesh=mesh, cfg=cfg8))(
        st, a(inp["scan"]), a(inp["scan_mask"]), a(inp["guess"]), pko_consts=consts)
    out.update(opt_T=np.asarray(To), opt_ok=np.asarray(ok), opt_n=np.asarray(nc))
    keep("rehash_", jax.jit(partial(sm.sharded_transform_and_rehash, mesh=mesh, voxel_size=0.5,
                                    planarity_threshold=0.1))(st, a(inp["corr"])))
    nanpts = jnp.full(inp["upd_pts"].shape[1:], jnp.nan, jnp.float32)
    nomask = jnp.zeros(inp["upd_pts"].shape[1], bool)
    for _ in range(int(inp["evict_rounds"])):
        st = upd(st, nanpts, nomask, a(inp["far"]), jnp.float32(30.0))
    keep("evict_", st)
    B = inp["lane_pts"].shape[0]
    mesh2 = Mesh(np.array(jax.devices()[:S]).reshape(1, S), ("data", "map"))
    pst = pipeline.batched_sharded_map_state(B, 0, C1, mesh2)
    pstep = pipeline.multichip_odometry_step(mesh2, icp.ICPConfig(max_iterations=4,
                                                                  voxel_size=0.5),
                                             pko_consts=consts)
    Ts = []
    for f in range(inp["lane_pts"].shape[1]):
        Tn, pst = pstep(pst, a(inp["lane_pts"][:, f]), a(inp["lane_mask"][:, f]),
                        a(inp["lane_T"][:, f]), a(inp["lane_kf"][:, f]))
        Ts.append(np.asarray(Tn))
    out["pipe_T"] = np.stack(Ts, 1)
    out.update({"pipe_" + k: np.asarray(v) for k, v in pst._asdict().items()})
    np.savez(sys.argv[2], **out)
""") % (PKO_ARGS,)


def _quarter_turn():
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = (3.0, -2.0, 0.5)
    return T


def _pad(s, n):
    p, m = np.zeros((n, 3), np.float32), np.zeros(n, bool)
    p[:len(s)], m[:len(s)] = s, True
    return p, m


def make_inputs(seed=2):
    """The _build_both scene, its queries and ICP scan, and two lanes of
    three frames for the data x map step."""
    world = synthetic.make_world(seed=seed, extent=40.0, n_buildings=8)
    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 1.8
    up, um, us = [], [], []
    for i in range(3):
        p = pose.copy()
        p[0, 3] += 0.3 * i
        s = synthetic.sample_scan(world, p, 8000, rng, max_range=40.0, noise=0.01)
        a, m = _pad((s @ p[:3, :3].T + p[:3, 3]).astype(np.float32), 8000)
        up.append(a)
        um.append(m)
        us.append(p[:3, 3].astype(np.float32))
    q = synthetic.sample_scan(world, pose, 2000, rng, max_range=40.0, noise=0.01)
    true = pose.copy()
    true[0, 3] += 0.35
    true[1, 3] += 0.1
    scan, scan_mask = _pad(synthetic.sample_scan(world, true, 6000, rng, max_range=40.0,
                                                 noise=0.005).astype(np.float32), 6000)
    guess = true.copy()
    guess[0, 3] += 0.15
    guess[1, 3] -= 0.05
    lp, lm, lT = [], [], []
    for b in range(2):
        w = synthetic.make_world(seed=30 + b, extent=40.0, n_buildings=8)
        r = np.random.default_rng(30 + b)
        poses = synthetic.straight_trajectory(3, step=0.4)
        frames = [_pad(synthetic.sample_scan(w, poses[f], 4000, r, max_range=40.0,
                                             noise=0.01).astype(np.float32), 4000)
                  for f in range(3)]
        lp.append([f[0] for f in frames])
        lm.append([f[1] for f in frames])
        g = poses.astype(np.float32).copy()
        g[1:, 0, 3] += 0.05
        lT.append(g)
    return dict(n_shards=np.int32(S), c1_total=np.int32(C1_TOTAL), upd_pts=np.stack(up),
                upd_mask=np.stack(um), upd_sensor=np.stack(us),
                queries=(q @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32), scan=scan,
                scan_mask=scan_mask, guess=guess, true=true, corr=_quarter_turn(),
                far=np.array([25.0, 0.0, 0.0], np.float32), evict_rounds=np.int32(6),
                lane_pts=np.asarray(lp), lane_mask=np.asarray(lm), lane_T=np.asarray(lT),
                lane_kf=np.array([[True, False, True], [True, True, False]]))


def port_side(inp, device="cpu"):
    """The same calls through the port, on `device`."""
    t = lambda a: torch.as_tensor(a, device=device)
    g = mesh.make_group(int(inp["n_shards"]), device=device)
    out = {}
    st = sm.sharded_empty_map(0, int(inp["c1_total"]), g)
    for i in range(inp["upd_pts"].shape[0]):
        st = sm.sharded_update_map(st, t(inp["upd_pts"][i]), t(inp["upd_mask"][i]),
                                   t(inp["upd_sensor"][i]), 120.0, g, voxel_size=0.5,
                                   planarity_threshold=0.1)
    out.update({"built_" + k: v for k, v in convert.sharded_map_to_numpy(st).items()})
    n, c, v = sm.sharded_lookup_surfels(st, t(inp["queries"]), g, voxel_size=0.5)
    out.update(look_n=n.cpu().numpy(), look_c=c.cpu().numpy(), look_v=v.cpu().numpy())
    T, steps = t(inp["guess"]), []
    for _ in range(3):
        T, _n = sm.sharded_icp_step(st, t(inp["scan"]), t(inp["scan_mask"]), T, g,
                                    icp.ICPConfig(voxel_size=0.5))
        steps.append(T.cpu().numpy())
    out["steps"] = np.stack(steps)
    cfg8 = icp.ICPConfig(max_iterations=8, voxel_size=0.5)
    consts = pko.make_pko_constants(*PKO_ARGS, device=device)
    hist = []
    select = so.shard_gn_select

    def recorded(rows, *args, **kw):
        # each iteration's gathered rows and [alpha, count] as K11d saw them
        out = select(rows, *args, **kw)
        hist.append((rows.clone(), out[2].clone()))
        return out

    so.shard_gn_select = recorded
    try:
        To, ok, nc = sm.sharded_icp_optimize(st, t(inp["scan"]), t(inp["scan_mask"]),
                                             t(inp["guess"]), g, cfg8, consts)
    finally:
        so.shard_gn_select = select
    out.update(opt_T=To.cpu().numpy(), opt_ok=ok.cpu().numpy(), opt_n=nc.cpu().numpy(),
               opt_hist=hist)
    st2 = sm.sharded_transform_and_rehash(st, t(inp["corr"]), g, voxel_size=0.5,
                                          planarity_threshold=0.1)
    out.update({"rehash_" + k: v for k, v in convert.sharded_map_to_numpy(st2).items()})
    nanpts = torch.full(inp["upd_pts"].shape[1:], float("nan"), device=device)
    nomask = torch.zeros(inp["upd_pts"].shape[1], dtype=torch.bool, device=device)
    for _ in range(int(inp["evict_rounds"])):
        st = sm.sharded_update_map(st, nanpts, nomask, t(inp["far"]), 30.0, g, voxel_size=0.5,
                                   planarity_threshold=0.1)
    out.update({"evict_" + k: v for k, v in convert.sharded_map_to_numpy(st).items()})
    lanes = inp["lane_pts"].shape[0]
    pst = pipeline.batched_sharded_map_state(lanes, 0, int(inp["c1_total"]), g)
    step = pipeline.multichip_odometry_step(g, icp.ICPConfig(max_iterations=4, voxel_size=0.5),
                                            pko_consts=consts)
    Ts = []
    for f in range(inp["lane_pts"].shape[1]):
        Tn, pst = step(pst, t(inp["lane_pts"][:, f]), t(inp["lane_mask"][:, f]),
                       t(inp["lane_T"][:, f]), t(inp["lane_kf"][:, f]))
        Ts.append(Tn.cpu().numpy())
    out["pipe_T"] = np.stack(Ts, 1)
    for b in range(lanes):
        lane = vm.VoxelMapState(**{k: v[b] for k, v in pst._asdict().items()})
        out.update({f"pipe{b}_{k}": v for k, v in convert.sharded_map_to_numpy(lane).items()})
    return out


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = make_inputs()
    tmp = tmp_path_factory.mktemp("sharded_map")
    np.savez(tmp / "in.npz", **inp)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"),
                           str(tmp / "jax.npz")], env=env, cwd=str(ROOT), timeout=900,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inp, dict(np.load(tmp / "jax.npz")), port_side(inp)


def _shards(arrays: dict, prefix: str, n: int = S):
    """Shard s's ten fields (JAX layout) of a global-layout dict."""
    out = []
    for s in range(n):
        d = {}
        for k in convert.MAP_FIELDS:
            a = arrays[prefix + k]
            if a.ndim == 1 and a.shape[0] == n:
                d[k] = a[s]
            else:
                d[k] = a.reshape((n, a.shape[0] // n) + a.shape[1:])[s]
        out.append(d)
    return out


def _assert_same_map(port: dict, ref: dict, prefix: str, ref_prefix: str = None):
    ref_prefix = prefix if ref_prefix is None else ref_prefix
    live_total = 0
    for s, (a, b) in enumerate(zip(_shards(ref, ref_prefix), _shards(port, prefix))):
        where = f"{prefix} shard {s}"
        for k in INT_FIELDS:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{k} {where}")
        c1 = a["l1_meta"].shape[0]
        np.testing.assert_allclose(b["l0_data"], a["l0_data"], rtol=1e-5, atol=1e-5,
                                   err_msg=where)
        has = a["l1_surfel"][:, 7] > 0
        np.testing.assert_allclose(b["l1_surfel"][has, 3:6], a["l1_surfel"][has, 3:6], atol=1e-5,
                                   err_msg=where)
        ill = _ill_conditioned(a["l0_data"], c1) & has
        assert ill.sum() <= 0.01 * max(int(has.sum()), 1), where
        ok = has & ~ill
        np.testing.assert_allclose(b["l1_surfel"][ok, :3], a["l1_surfel"][ok, :3], atol=1e-4,
                                   err_msg=where)
        live_total += int(a["n_l0"])
    assert live_total > 1000


def test_sharded_update_matches_jax(runs):
    _, jo, po = runs
    _assert_same_map(po, jo, "built_")


def test_sharded_eviction_matches_jax(runs):
    _, jo, po = runs
    _assert_same_map(po, jo, "evict_")
    assert po["evict_n_l0"].sum() < po["built_n_l0"].sum()    # something was evicted


def test_sharded_rehash_matches_jax(runs):
    _, jo, po = runs
    _assert_same_map(po, jo, "rehash_")


def test_sharded_lookup_matches_jax(runs):
    _, jo, po = runs
    np.testing.assert_array_equal(po["look_v"], jo["look_v"])
    m = jo["look_v"]
    assert m.sum() > 100
    np.testing.assert_allclose(po["look_n"][m], jo["look_n"][m], atol=1e-5)
    np.testing.assert_allclose(po["look_c"][m], jo["look_c"][m], atol=1e-5)


def test_sharded_icp_step_matches_jax(runs):
    _, jo, po = runs
    np.testing.assert_allclose(po["steps"], jo["steps"], atol=1e-4)


def test_sharded_icp_optimize_matches_jax(runs):
    import jax.numpy as jnp
    from lidar_odometry_tpu.ops import pko as jpko
    inp, jo, po = runs
    assert bool(po["opt_ok"]) and bool(jo["opt_ok"])
    assert int(po["opt_n"]) == int(jo["opt_n"])
    np.testing.assert_allclose(po["opt_T"], jo["opt_T"], atol=1e-4)
    np.testing.assert_allclose(po["opt_T"][:3, 3], inp["true"][:3, 3], atol=0.02)
    # the alpha of every iteration that stepped, against JAX's pick on the
    # same merged samples
    jconsts = jpko.make_pko_constants(*PKO_ARGS)
    a42, m = 101 * 42, S * pko.shard_quota(S)
    stepped = 0
    for rows, info in po["opt_hist"]:
        if int(info[0, 1]) == 0:
            continue       # a done iteration
        tot = rows[0].sum(0).numpy()
        s_all, o_all = tot[a42:a42 + m], tot[a42 + m:a42 + 2 * m]
        s_fin = np.where(o_all > 0.5, s_all, s_all.sum() / max(o_all.sum(), 1.0))
        ref = int(jpko.pko_alpha_index_from_samples(jnp.asarray(s_fin, jnp.float32), jconsts))
        assert int(info[0, 0]) == ref
        stepped += 1
    assert stepped >= 2


def test_sharded_icp_optimize_near_single_device(runs):
    """The port's sharded ICP against its single-device ICP on one map of
    the same scans (tests/test_parallel.py:229)."""
    inp, _, po = runs
    single = vm.empty_map(0, int(inp["c1_total"]), device="cpu")
    for i in range(inp["upd_pts"].shape[0]):
        single = vm.update_map(single, torch.as_tensor(inp["upd_pts"][i]),
                               torch.as_tensor(inp["upd_mask"][i]),
                               torch.as_tensor(inp["upd_sensor"][i]), 120.0, voxel_size=0.5,
                               planarity_threshold=0.1)
    T, ok, _ = icp.icp_optimize(single, torch.as_tensor(inp["scan"]),
                                torch.as_tensor(inp["scan_mask"]), torch.as_tensor(inp["guess"]),
                                pko.make_pko_constants(*PKO_ARGS, device="cpu"),
                                icp.ICPConfig(max_iterations=8, voxel_size=0.5))
    assert bool(ok)
    np.testing.assert_allclose(po["opt_T"], T.numpy(), atol=5e-3)


def test_sharded_icp_insufficient_falls_back_to_guess():
    g = mesh.make_group(S, device="cpu")
    empty = sm.sharded_empty_map(0, C1_TOTAL, g)
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-10, 10, (512, 3)).astype(np.float32))
    guess = torch.eye(4)
    guess[0, 3] = 0.25
    T, ok, n = sm.sharded_icp_optimize(empty, pts, torch.ones(512, dtype=torch.bool), guess, g,
                                       icp.ICPConfig(max_iterations=4, voxel_size=0.5),
                                       pko.make_pko_constants(*PKO_ARGS, device="cpu"))
    assert not bool(ok)
    assert int(n) == 0
    np.testing.assert_array_equal(T.numpy(), guess.numpy())


def test_multichip_step_matches_jax(runs):
    _, jo, po = runs
    np.testing.assert_allclose(po["pipe_T"], jo["pipe_T"], atol=1e-4)
    for b in range(po["pipe_T"].shape[0]):
        ref = {"lane_" + k: jo["pipe_" + k][b] for k in convert.MAP_FIELDS}
        _assert_same_map(po, ref, f"pipe{b}_", "lane_")


def test_sharded_map_from_numpy(runs):
    """JAX's sharded map carried across (convert.sharded_map_from_numpy):
    the round trip is exact, a rank's subset holds its shards, and the
    port's lookups on the carried map give JAX's answers."""
    inp, jo, _ = runs
    arrays = {k: jo["built_" + k] for k in convert.MAP_FIELDS}
    st = convert.sharded_map_from_numpy(arrays, S, device="cpu")
    back = convert.sharded_map_to_numpy(st)
    for k in convert.MAP_FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    half = convert.sharded_map_to_numpy(
        convert.sharded_map_from_numpy(arrays, S, device="cpu", shards=[2, 3]))
    for k in convert.MAP_FIELDS:
        ref = arrays[k][2:] if k in sm.SCALARS else arrays[k][arrays[k].shape[0] // 2:]
        np.testing.assert_array_equal(half[k], ref, err_msg=k)
    n, c, v = sm.sharded_lookup_surfels(st, torch.as_tensor(inp["queries"]),
                                        mesh.make_group(S, device="cpu"), voxel_size=0.5)
    np.testing.assert_array_equal(v.numpy(), jo["look_v"])
    m = jo["look_v"]
    np.testing.assert_allclose(n.numpy()[m], jo["look_n"][m], atol=1e-5)
