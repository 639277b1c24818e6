"""The port's "distributed" pose-graph backend (parallel/distributed_pgo.py)
against the JAX package's on the same numpy inputs (CPU; the JAX side
under jax.enable_x64, as its backend runs).

Tolerances: the partition plans are compared exactly; the linearisation
and the interior elimination at 1e-10 of each output's largest magnitude
(the same float64 math, summed in another order: the blocks reach ~1e4,
so an absolute bound would say nothing about the small entries); the
optimised poses at 1e-9 absolute (the JAX test holds the device solve to
1e-8 against the host one)."""
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


def _pose(x=0.0, y=0.0):
    P = np.eye(4)
    P[:2, 3] = x, y
    return P


def _padding_graph(n):
    """The JAX padding test's graph (tests/test_pose_graph.py:157): a noisy
    chain, a prior at 0 and one loop 2 <-> n-1."""
    rng = np.random.default_rng(n)
    true = [_pose(float(i), 0.1 * (i % 3)) for i in range(n)]
    noisy = [np.eye(4)]
    priors = [(0, noisy[0], np.sqrt(jpg.make_information(1e-2, 1e-2)))]
    betweens = []
    for i in range(1, n):
        rel = np.linalg.inv(true[i - 1]) @ true[i]
        rel[:3, 3] += rng.normal(0, 0.02, 3)
        noisy.append(noisy[-1] @ rel)
        betweens.append((i - 1, i, rel, np.sqrt(jpg.make_information(1.0, 1.0))))
    betweens.append((2, n - 1, np.linalg.inv(true[2]) @ true[n - 1],
                     np.sqrt(jpg.make_information(0.5, 0.5))))
    return np.stack(noisy), priors, betweens


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("n, n_blocks, loops", [
    (6, 8, []),
    (16, 8, [(2, 15)]),
    (17, 4, [(0, 16)]),                       # a loop to keyframe 0
    (37, 8, [(2, 36), (5, 30), (5, 30)]),     # a duplicate loop edge
    (100, 8, [(0, 99), (10, 60), (61, 62)]),  # two adjacent separators
])
def test_partition_plans_equal(n, n_blocks, loops):
    seps = T.plan_partition(n, n_blocks, loops)
    assert seps == J.plan_partition(n, n_blocks, loops)
    n_pad = T._pow2(n, 8)
    seps = sorted(set(seps + [n_pad - 1]))
    tp, jp = T.make_plan(n_pad, seps), J.make_plan(n_pad, seps)
    assert tp.keys() == jp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


@pytest.fixture(scope="module")
def revisit_graph():
    """64 keyframes on a circuit revisited every 24, 4 loop edges (one
    duplicated by chance or not), packed once for both sides."""
    init, priors, betweens, _ = synthetic.revisit_pose_graph(
        64, 4, seed=3, length=6.0, radius=1.9, min_gap=10)
    return T.pack_graph(init, priors, betweens)


_LIN = T.LIN_KEYS
_FLAGS = ("prior_valid", "bt_valid", "loop_valid", "valid", "ovalid", "has_left", "ur_valid")


def _np(pk, k):
    """A packed array as the JAX functions take it (flags as bool)."""
    a = pk.f64[k] if k in pk.f64 else pk.i32[k]
    return a.astype(bool) if k in _FLAGS else a


def test_linearize_matches_jax(revisit_graph):
    pk = revisit_graph
    args = [_np(pk, k) for k in _LIN]
    with jax.enable_x64():
        ref = J._linearize_device(jnp.asarray(pk.f64["poses"]), *map(jnp.asarray, args[:11]),
                                  jnp.asarray(args[11]), None, jnp.asarray(args[12]))
        ref = [np.asarray(r) for r in ref]
    g = T.upload(pk, "cpu")
    out = T.linearize_plain(g["poses"], *[g[k] for k in _LIN])
    for name, o, r in zip(("diag", "off", "b", "lb"), out, ref):
        assert o.shape == r.shape, name
        assert _rel_err(o.numpy(), r) <= 1e-10, name
    # the wrapper on CPU tensors is the plain twin
    for o, w in zip(out, T.linearize(g, g["poses"])):
        assert torch.equal(o, w)


def test_eliminate_matches_jax(revisit_graph):
    pk = revisit_graph
    g = T.upload(pk, "cpu")
    diag, off, b, _ = T.linearize_plain(g["poses"], *[g[k] for k in _LIN])
    S, r, F, G, gv = T.eliminate(g, diag, off, b)
    # the JAX side: _gn_device's interior packing, then the vmapped elimination
    p = {k: _np(pk, k) for k in T.PLAN_KEYS}
    d, o, bb = diag.numpy(), off.numpy(), b.numpy()
    D, max_m = p["int_idx"].shape
    Dint = np.where(p["valid"][..., None, None], d[p["int_idx"]], np.eye(6))
    Oint = np.where(p["ovalid"][..., None, None], o[p["off_idx"]], 0.0)
    Bint = np.where(p["valid"][..., None], bb[p["int_idx"]], 0.0)
    Lleft = np.where(p["has_left"][:, None, None], np.swapaxes(o[p["left_off"]], -1, -2), 0.0)
    Lsep = np.eye(max_m)[p["lsep_row"]][..., None, None] * Lleft[:, None]
    Uright = np.where(p["ur_valid"][:, None, None], o[p["uright_off"]], 0.0)
    with jax.enable_x64():
        (S_ll, S_lr, S_rl, S_rr, r_l, r_r), (Fj, Gj, gj) = jax.vmap(J._eliminate_interior_spd)(
            *map(jnp.asarray, (Dint, Oint, Bint, Lsep, Lleft, Uright, p["valid"])))
        Sj = np.stack([np.asarray(x) for x in (S_ll, S_lr, S_rl, S_rr)], 1)
        rj = np.stack([np.asarray(r_l), np.asarray(r_r)], 1)
        ref = (Sj, rj, np.asarray(Fj), np.asarray(Gj), np.asarray(gj))
    for name, o_, r_ in zip(("S", "r", "F", "G", "g"), (S, r, F, G, gv), ref):
        assert o_.shape == r_.shape, name
        assert _rel_err(o_.numpy(), r_) <= 1e-10, name

    # the partitioned solve (separators, then the interiors back-substituted)
    # is the dense solve of the whole system
    lb = T.linearize_plain(g["poses"], *[g[k] for k in _LIN])[3]
    xs = T.reduced_solve(g, diag, off, b, lb, S, r).numpy()
    seps, i32 = pk.i32["seps"], pk.i32
    x = np.zeros((pk.n_pad, 6))
    x[seps] = xs
    for k, rr in zip(*np.nonzero(p["valid"])):
        xl = xs[i32["xl_idx"][k]] if i32["has_left"][k] else np.zeros(6)
        Fk, Gk, gk = F[k, rr].numpy(), G[k, rr].numpy(), gv[k, rr].numpy()
        x[p["int_idx"][k, rr]] = gk - Fk @ xl - Gk @ xs[k]
    loops = [(seps[a], seps[c]) for a, c, v in zip(i32["loop_a"], i32["loop_b"], i32["loop_valid"])
             if v]
    blocks = [(np.zeros((6, 6)), blk, np.zeros((6, 6))) for blk in lb.numpy()[:len(loops)]]
    dense = T.dense_solve(d, o, bb, loops, blocks)
    assert _rel_err(x, dense) <= 1e-8


@pytest.mark.parametrize("n", [6, 16, 17, 37])
def test_gn_optimize_matches_jax_across_padding_sizes(n):
    poses, priors, betweens = _padding_graph(n)
    with jax.enable_x64():
        ref, ok_ref = J.gn_optimize_device(poses, priors, betweens)
    out, ok = T.gn_optimize_device(poses, priors, betweens, device="cpu")
    assert ok == ok_ref and ok
    assert out.shape == (n, 4, 4) and out.dtype == np.float64
    np.testing.assert_allclose(out, ref, atol=1e-9, rtol=0)


def _graph_with_loop(module, n, **kw):
    """The padding graph in a `module`.PoseGraphOptimizer with the
    distributed backend, its loop factor added without optimising."""
    poses, _, betweens = _padding_graph(n)
    g = module.PoseGraphOptimizer(backend="distributed", **kw)
    g.add_first_keyframe(0, poses[0])
    for i, j, rel, _ in betweens[:-1]:
        g.add_keyframe_with_odom(i, j, poses[j], rel, 1.0, 1.0)
    i, j, rel, sq = betweens[-1]
    g._betweens.append(module.BetweenFactor(i, j, rel, sq))
    return g


def test_no_convergence_is_failure_and_leaves_the_poses():
    n = 17
    poses, priors, betweens = _padding_graph(n)
    with jax.enable_x64():
        _, ok_ref = J.gn_optimize_device(poses, priors, betweens, max_iters=1)
    _, ok = T.gn_optimize_device(poses, priors, betweens, max_iters=1, device="cpu")
    assert ok is False and ok_ref is False
    for module, kw in ((jpg, {}), (tpg, {"device": "cpu"})):
        graph = _graph_with_loop(module, n, **kw)
        before = graph.get_all_optimized_poses()
        assert graph._optimize(max_iterations=1, convergence_threshold=1e-6) is False
        after = graph.get_all_optimized_poses()
        for k in before:
            np.testing.assert_array_equal(after[k], before[k])


def test_non_finite_poses_return_unchanged_and_false():
    poses, priors, betweens = _padding_graph(6)
    poses[3, 0, 3] = np.nan
    with jax.enable_x64():
        ref, ok_ref = J.gn_optimize_device(poses, priors, betweens)
    out, ok = T.gn_optimize_device(poses, priors, betweens, device="cpu")
    assert ok is False and ok_ref is False
    assert out is poses and ref is poses
    empty = np.zeros((0, 4, 4))
    assert T.gn_optimize_device(empty, [], [], device="cpu") == (empty, True)
