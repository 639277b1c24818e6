"""The sharded map over two processes: 2 gloo ranks x 2 local shards
against 1 process x 4 local shards, on the scene of
tests/test_torch_sharded_map.py (CPU).

Each rank runs in a fresh subprocess that joins a gloo group through a
file under the test's tmp_path. The two layouts must agree: the psum and
all_gather orders of ShardGroup, the keyframe updates, the PKO ICP
(sharded_icp_optimize: T within 1e-6, the same success and count), the
rehash, with both maps' integer state identical and their float tables
equal (every cross-shard sum is taken over gathered rows in shard order,
so the layouts add the same numbers in the same order), and the
partitioned Schur solve of the pose graph (bit-equal). A rank of
a multi-rank group refuses an Estimator with the loop worker
(sync_loop=False)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.config import SystemConfig
from lidar_odometry_tpu_torch.ops import icp, pko
from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
from lidar_odometry_tpu_torch.parallel import mesh
from lidar_odometry_tpu_torch.parallel import sharded_map as sm

ROOT = Path(__file__).resolve().parent.parent
PKO_ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)


def _schur_system():
    """A 40-keyframe chain system with two loop edges (one to keyframe 0)
    and separators in a multiple of 4 partitions."""
    rng = np.random.default_rng(8)
    n = 40
    off = rng.standard_normal((n - 1, 6, 6)) * 0.3
    diag = np.eye(6) * 8.0 + rng.standard_normal((n, 6, 6)) * 0.1
    diag = (diag + diag.swapaxes(1, 2)) / 2
    b = rng.standard_normal((n, 6))
    loops = [(0, 30), (12, 30)]
    blocks = [(np.eye(6) * 2.0, -np.eye(6), np.eye(6) * 2.0)] * 2
    seps = dpgo.plan_partition(n, 6, loops)
    while len(seps) % 4:
        seps = dpgo.plan_partition(n, len(seps) + 1, loops)
    return diag, off, b, seps, loops, blocks


def _run_layout(inp: dict, group) -> dict:
    """Update, PKO ICP and rehash on `group`, the maps gathered in global
    shard order; and a partitioned Schur solve over the group."""
    t = torch.as_tensor
    st = sm.sharded_empty_map(0, int(inp["c1_total"]), group)
    for i in range(inp["upd_pts"].shape[0]):
        st = sm.sharded_update_map(st, t(inp["upd_pts"][i]), t(inp["upd_mask"][i]),
                                   t(inp["upd_sensor"][i]), 120.0, group, voxel_size=0.5,
                                   planarity_threshold=0.1)
    T, ok, n = sm.sharded_icp_optimize(st, t(inp["scan"]), t(inp["scan_mask"]), t(inp["guess"]),
                                       group, icp.ICPConfig(max_iterations=8, voxel_size=0.5),
                                       pko.make_pko_constants(*PKO_ARGS, device="cpu"))
    st2 = sm.sharded_transform_and_rehash(st, t(inp["corr"]), group, voxel_size=0.5,
                                          planarity_threshold=0.1)
    out = dict(T=T.numpy(), ok=ok.numpy(), n=n.numpy(),
               schur_x=dpgo.schur_partitioned_solve(*_schur_system(), group=group))
    out.update({"built_" + k: v for k, v in
                convert.sharded_map_to_numpy(sm.gather_state(st, group)).items()})
    out.update({"rehash_" + k: v for k, v in
                convert.sharded_map_to_numpy(sm.gather_state(st2, group)).items()})
    return out


def _rank_main(rank: int, world: int, init: str, inp_path: str, out_path: str) -> None:
    """One rank of the gloo group (run in a subprocess)."""
    torch.set_num_threads(1)
    mesh.initialize_multihost(init, world, rank, backend="gloo")
    group = mesh.make_group(2, device="cpu")
    x = torch.arange(8, dtype=torch.float32).view(2, 4) + 10.0 * rank
    out = _run_layout(dict(np.load(inp_path)), group)
    out.update(gathered=group.all_gather(x).numpy(), summed=group.psum(x).numpy(),
               ids=np.array(list(group.local_ids)))
    from lidar_odometry_tpu_torch.models.estimator import Estimator
    from lidar_odometry_tpu_torch.models.map_backend import ShardedMapBackend
    cfg = SystemConfig(scan_capacity=1024, map_l0_capacity=4 * 2048 * 27,
                       map_l1_capacity=4 * 2048, keyframe_capacity=16,
                       enable_console_statistics=False)
    try:
        Estimator(cfg, sync_loop=False, device="cpu", map_backend=ShardedMapBackend(cfg, group))
        refused = ""
    except ValueError as e:
        refused = str(e)
    out["refused"] = np.array(refused)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    from test_torch_sharded_map import make_inputs
    tmp = tmp_path_factory.mktemp("ranks")
    inp = make_inputs()
    np.savez(tmp / "in.npz", **inp)
    init = f"file://{tmp / 'pg'}"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from test_torch_sharded_ranks import _rank_main; "
            "_rank_main(int(sys.argv[2]), 2, sys.argv[3], sys.argv[4], sys.argv[5])")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(ROOT / "tests"), str(r), init,
                               str(tmp / "in.npz"), str(tmp / f"rank{r}.npz")],
                              env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = _run_layout(inp, mesh.make_group(4, device="cpu"))
    finally:
        torch.set_num_threads(n)
    return one, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_collective_orders_under_gloo(layouts):
    _, ranks = layouts
    x = [torch.arange(8, dtype=torch.float32).view(2, 4) + 10.0 * r for r in range(2)]
    every = torch.cat(x)
    for r, ro in enumerate(ranks):
        np.testing.assert_array_equal(ro["ids"], [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(ro["gathered"], every.numpy())
        np.testing.assert_array_equal(ro["summed"],
                                      (((every[0] + every[1]) + every[2]) + every[3]).numpy())


@pytest.mark.parametrize("what", ["built_", "rehash_"])
def test_two_ranks_build_the_one_rank_map(layouts, what):
    one, ranks = layouts
    for ro in ranks:
        for k in convert.MAP_FIELDS:
            np.testing.assert_array_equal(ro[what + k], one[what + k], err_msg=what + k)
    assert one[what + "n_l0"].sum() > 1000


def test_two_ranks_icp_matches_one_rank(layouts):
    one, ranks = layouts
    assert bool(one["ok"])
    for ro in ranks:
        assert bool(ro["ok"]) and int(ro["n"]) == int(one["n"])
        np.testing.assert_allclose(ro["T"], one["T"], atol=1e-6, rtol=0)


def test_two_ranks_schur_solve_equals_one_rank(layouts):
    """Each rank eliminates its shards' partitions and gathers the rest:
    the solve is bit-equal to one rank x 4 shards and within 1e-10 of the
    dense solve."""
    one, ranks = layouts
    diag, off, b, seps, loops, blocks = _schur_system()
    assert len(seps) % 4 == 0 and 0 in seps
    for ro in ranks:
        np.testing.assert_array_equal(ro["schur_x"], one["schur_x"])
    np.testing.assert_allclose(one["schur_x"], dpgo.dense_solve(diag, off, b, loops, blocks),
                               atol=1e-10, rtol=0)


def test_multi_rank_refuses_the_loop_worker(layouts):
    _, ranks = layouts
    for ro in ranks:
        assert "sync_loop=True" in str(ro["refused"])
