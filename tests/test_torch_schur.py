"""The host solvers of the port's "distributed" pose-graph backend
(parallel/distributed_pgo.py: block_tridiag_solve, K12a's twin, which
solves the chain in partitions;
eliminate_interior_lu, K12b's twin; schur_partitioned_solve around it)
against the JAX package's on the same numpy inputs (CPU).

The JAX side runs under jax.enable_x64, so that it computes in float64 as
the port does; nothing in it changes. Tolerances: float64 results within
1e-10 absolute of JAX (the same LU solves in another order; the systems
are well conditioned); float32 inputs within 1e-5 of JAX's default
float32 path. Without x64 the JAX functions cast float64 inputs to
float32: two cases record that difference, the second on revisit graphs
up to the KITTI-00 size (run it with -s for its readings)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_tpu.models import pose_graph as jpg
from lidar_odometry_tpu.parallel import distributed_pgo as J
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.models import pose_graph as tpg
from lidar_odometry_tpu_torch.parallel import distributed_pgo as T
from lidar_odometry_tpu_torch.parallel import mesh
from test_parallel import _random_chain


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# n = 1, 2 and 5: more partitions than n / 2 (empty interiors); 97 and 300:
# several partitions of uneven size (14 of 6-7 rows, 24 of 12-13)
@pytest.mark.parametrize("n", [1, 2, 5, 12, 32, 97, 300])
def test_block_tridiag_solve_matches_jax(n):
    diag, off, b = _random_chain(n, np.random.default_rng(n))
    P = T.thomas_partitions(n)
    sizes = np.diff([-1] + [(k + 1) * n // P - 1 for k in range(P)])
    assert (P > n / 2) == (n <= 5) and (n not in (97, 300) or len(set(sizes)) > 1)
    with jax.enable_x64():
        ref = np.asarray(J.block_tridiag_solve(*map(jnp.asarray, (diag, off, b))))
    x = T.block_tridiag_solve(*_t(diag, off, b))
    assert x.dtype == torch.float64 and x.shape == (n, 6)
    np.testing.assert_allclose(x.numpy(), ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(x.numpy(), J.dense_solve(diag, off, b), atol=1e-10, rtol=0)
    assert torch.equal(x, T.block_tridiag_solve_plain(*_t(diag, off, b)))
    x32 = T.block_tridiag_solve(*_t(diag.astype(np.float32), off.astype(np.float32),
                                    b.astype(np.float32)))
    assert x32.dtype == torch.float32
    np.testing.assert_allclose(x32.numpy(), ref, atol=1e-5, rtol=0)


def _system(n, seed, loops):
    """A random chain with loop blocks on `loops`, its dense solution."""
    diag, off, b = _random_chain(n, np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 100)
    blocks = []
    for _ in loops:
        A = rng.standard_normal((6, 6)) * 0.2
        blocks.append((np.eye(6) + A @ A.T, -0.5 * np.eye(6) + 0.05 * rng.standard_normal((6, 6)),
                       np.eye(6) * 1.5))
    return diag, off, b, blocks, J.dense_solve(diag, off, b, loops, blocks)


# (n, separators, loops): an empty interior from consecutive separators, a
# loop to keyframe 0; a graph whose longest interior is one row (max_m = 1)
PACKINGS = {"empty_interior": (20, [0, 6, 7, 13, 19], [(0, 13), (7, 19)]),
            "max_m_1": (7, [1, 2, 3, 5, 6], [(1, 5)])}


@pytest.mark.parametrize("case", sorted(PACKINGS))
def test_eliminate_interior_lu_matches_jax(case):
    n, seps, loops = PACKINGS[case]
    diag, off, b, _, _ = _system(n, 3, loops)
    packed = T.pack_interiors(diag, off, b, seps)
    assert packed[0].shape[1] == (1 if case == "max_m_1" else 5)
    assert (~packed[-1].any(1)).sum() >= 1   # an empty interior
    with jax.enable_x64():
        (S_ll, S_lr, S_rl, S_rr, r_l, r_r), (F, G, g) = jax.vmap(J._eliminate_interior)(
            *map(jnp.asarray, packed))
        ref = dict(S_ll=S_ll, S_lr=S_lr, S_rl=S_rl, S_rr=S_rr, r_l=r_l, r_r=r_r, F=F, G=G, g=g)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    S, r, Fp, Gp, gp = T.eliminate_interior_lu_plain(*_t(*packed))
    got = dict(S_ll=S[:, 0], S_lr=S[:, 1], S_rl=S[:, 2], S_rr=S[:, 3], r_l=r[:, 0],
               r_r=r[:, 1], F=Fp, G=Gp, g=gp)
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-10, rtol=0, err_msg=k)
    for a, c in zip(T.eliminate_interior_lu(*_t(*packed)), (S, r, Fp, Gp, gp)):
        assert torch.equal(a, c)


LOOPS = [(0, 24), (10, 24), (10, 24)]   # a loop to keyframe 0, a duplicate edge


def _separators(n):
    seps = sorted(set(J.plan_partition(n, 4, LOOPS)) | {11})   # 10, 11: consecutive
    assert any(b == a + 1 for a, b in zip(seps, seps[1:])) and 0 in seps
    return seps


def test_schur_partitioned_solve_matches_jax_and_the_dense_solve():
    n = 32
    diag, off, b, blocks, dense = _system(n, 1, LOOPS)
    seps = _separators(n)
    with jax.enable_x64():
        ref = J.schur_partitioned_solve(diag, off, b, seps, LOOPS, blocks)
    x = T.schur_partitioned_solve(diag, off, b, seps, LOOPS, blocks, device="cpu")
    assert x.dtype == np.float64 and x.shape == (n, 6)
    np.testing.assert_allclose(x, ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(x, dense, atol=1e-10, rtol=0)


def test_schur_partitioned_solve_float32_matches_jax_default_path():
    n = 32
    diag, off, b, blocks, dense = _system(n, 2, LOOPS)
    f32 = [a.astype(np.float32) for a in (diag, off, b)]
    seps = _separators(n)
    ref = J.schur_partitioned_solve(*f32, seps, LOOPS, blocks)
    x = T.schur_partitioned_solve(*f32, seps, LOOPS, blocks, device="cpu")
    assert x.dtype == np.float32 and np.asarray(ref).dtype == np.float32
    np.testing.assert_allclose(x, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(x, dense, atol=1e-5, rtol=0)


def test_float64_inputs_stay_float64_where_jax_casts_to_float32():
    """The reference fault, recorded: without x64 (the JAX package's
    default) the JAX solve computes and returns float32 for float64 inputs.
    The port computes in the inputs' dtype and keeps the float64 answer."""
    n = 32
    diag, off, b, blocks, dense = _system(n, 4, LOOPS)
    seps = _separators(n)
    ref = np.asarray(J.schur_partitioned_solve(diag, off, b, seps, LOOPS, blocks))
    x = T.schur_partitioned_solve(diag, off, b, seps, LOOPS, blocks, device="cpu")
    assert ref.dtype == np.float32      # the JAX package's cast
    assert x.dtype == np.float64
    np.testing.assert_allclose(x, dense, atol=1e-10, rtol=0)
    np.testing.assert_allclose(ref, dense, atol=1e-5, rtol=0)   # a float32 answer
    assert np.abs(x - dense).max() < np.abs(ref - dense).max()


def _load(module, graph, backend, **kw):
    """synthetic.revisit_pose_graph's factors in a `module`.PoseGraphOptimizer."""
    init, priors, betweens, _ = graph
    g = module.PoseGraphOptimizer(backend=backend, n_blocks=8, **kw)
    g._keyframe_ids = list(range(len(init)))
    g._kf_to_index = {i: i for i in range(len(init))}
    g._poses = dict(enumerate(np.asarray(init, np.float64)))
    g._priors = [module.PriorFactor(k, m, s) for k, m, s in priors]
    g._betweens = [module.BetweenFactor(i, j, m, s) for i, j, m, s in betweens]
    return g


def _poses(g):
    return np.stack([g._poses[k] for k in g._keyframe_ids])


@pytest.mark.parametrize("n, loops", [(1200, 8), (3700, 32)])
def test_float32_cast_costs_the_jax_host_loop_its_accuracy(n, loops, monkeypatch):
    """The reference fault on the distributed backend's host Gauss-Newton
    loop (reached in JAX by making its device program raise): on a revisit
    graph (3700 keyframes and 32 loops is the KITTI-00 size) JAX under x64
    and the port, which keeps float64, converge within 1e-9 of JAX's manual
    backend; JAX's default path, float32, lands further off. Prints one
    JSON line a loop: converged, and the largest pose-entry difference from
    the manual backend."""
    def device_fails(*a, **k):
        raise RuntimeError("device program disabled: run the host iteration")

    monkeypatch.setattr(J, "gn_optimize_device", device_fails)
    graph = synthetic.revisit_pose_graph(n, loops, seed=0)
    manual = _load(jpg, graph, "manual")
    assert manual._optimize(10, 1e-6)
    ref = _poses(manual)
    out = {}
    for name in ("jax_default", "jax_x64", "port"):
        if name == "port":
            g = _load(tpg, graph, "distributed", device="cpu")
            ok = g._optimize_distributed_host(10, 1e-6)
        else:
            g = _load(jpg, graph, "distributed")
            if name == "jax_x64":
                with jax.enable_x64():
                    ok = g._optimize(10, 1e-6)
            else:
                ok = g._optimize(10, 1e-6)
        out[name] = (bool(ok), float(np.abs(_poses(g) - ref).max()))
        print(json.dumps(dict(keyframes=n, loops=loops, loop=name, converged=out[name][0],
                              max_diff_manual=out[name][1])))
    assert out["jax_x64"][0] and out["jax_x64"][1] <= 1e-9
    assert out["port"][0] and out["port"][1] <= 1e-9
    assert out["jax_default"][1] > out["port"][1]


def test_solve_over_a_shard_group_equals_one_device():
    """One rank with 4 local shards eliminates its 8 partitions in one
    launch, exactly as with no group; a partition count that does not split
    over the shards is refused, as shard_map refuses it."""
    n = 32
    diag, off, b, blocks, _ = _system(n, 5, LOOPS)
    seps = _separators(n)
    assert len(seps) == 8
    x = T.schur_partitioned_solve(diag, off, b, seps, LOOPS, blocks, device="cpu")
    xg = T.schur_partitioned_solve(diag, off, b, seps, LOOPS, blocks,
                                   group=mesh.make_group(4, device="cpu"))
    np.testing.assert_array_equal(xg, x)
    with pytest.raises(ValueError, match="split evenly"):
        T.schur_partitioned_solve(diag, off, b, seps, LOOPS, blocks,
                                  group=mesh.make_group(3, device="cpu"))


def test_separators_are_checked():
    diag, off, b = _random_chain(8, np.random.default_rng(0))
    with pytest.raises(ValueError, match="end at n - 1"):
        T.schur_partitioned_solve(diag, off, b, [3, 6], device="cpu")
