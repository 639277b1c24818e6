"""The port's PKO (kernel K3's plain path) against the JAX package, on the
same residuals (CPU)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import icp as jicp
from lidar_odometry_tpu.ops import pko as jpko
from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.ops import pko as tpko

ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)


@pytest.fixture(scope="module")
def consts():
    return jpko.make_pko_constants(*ARGS), tpko.make_pko_constants(*ARGS, device="cpu")


def test_constants_equal(consts):
    jc, tc = consts
    for name in ("alphas", "Z", "r_grid", "Q"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    carried = convert.pko_constants_from_numpy(
        {k: np.asarray(getattr(jc, k)) for k in ("alphas", "Z", "r_grid", "Q")}, device="cpu")
    np.testing.assert_array_equal(carried.Q.numpy(), tc.Q.numpy())


def test_stored_draws_equal_jax_prngkey_42():
    key = jax.random.PRNGKey(42)
    np.testing.assert_array_equal(tpko.STRATA_U, np.asarray(jax.random.uniform(key, (100,))))
    np.testing.assert_array_equal(tpko.KMEANS_PICK,
                                  np.asarray(jax.random.randint(key, (3,), 0, 100)))


def test_other_sample_sizes_refused():
    with pytest.raises(ValueError):
        tpko.make_pko_constants(0.1, 10.0, 100, 10.0, "huber", 3, 50, device="cpu")
    with pytest.raises(ValueError):
        tpko.make_pko_constants(0.1, 10.0, 100, 10.0, "huber", 4, 100, device="cpu")


def _residuals(kind, seed, n=3000):
    rng = np.random.default_rng(seed)
    if kind == "tight":
        r = rng.standard_normal(n) * 0.01
    elif kind == "wide":
        r = rng.standard_normal(n) * 0.3
    else:   # mixture: inliers plus a far outlier mode
        r = np.concatenate([rng.standard_normal(n * 3 // 4) * 0.02,
                            0.5 + rng.standard_normal(n - n * 3 // 4) * 0.2])
        rng.shuffle(r)
    valid = rng.random(n) > 0.2
    return r.astype(np.float32), valid


@pytest.mark.parametrize("kind", ["tight", "wide", "mixture"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alpha_index_equal(consts, kind, seed):
    """ICP iteration 0: the scale std/6, the stratified sample and the GMM
    + JS argmin all as JAX takes them."""
    jc, tc = consts
    r, valid = _residuals(kind, seed)
    r_abs = np.abs(r)
    scale = jicp._norm_scale_from(jnp.asarray(r_abs), jnp.asarray(valid))
    norm = jnp.asarray(r_abs) / jnp.maximum(scale, 1e-6)
    key = jax.random.PRNGKey(42)
    samples, _ = jpko.stratified_sample(norm, jnp.asarray(valid), 100, key)
    ref = int(jpko.pko_alpha_index_from_samples(samples, jc, key=key))
    assert float(jpko.pko_scale_factor(norm, jnp.asarray(valid), jc)) == float(jc.alphas[ref])

    flags = torch.zeros((3,), dtype=torch.int32)
    aux, s = tpko.pko_alpha_index(torch.as_tensor(r), torch.as_tensor(valid), flags,
                                  torch.ones((1,)), True, tc)
    np.testing.assert_allclose(float(s[0]), float(scale), rtol=1e-6)
    t_samples = tpko.stratified_sample(torch.tensor(np.asarray(norm)),
                                       torch.as_tensor(valid), tc.u)
    np.testing.assert_array_equal(t_samples.numpy(), np.asarray(samples))
    assert int(aux[0]) == int(valid.sum())
    assert int(aux[1]) == ref


def test_few_valid_and_none_valid(consts):
    jc, tc = consts
    key = jax.random.PRNGKey(42)
    for n_valid in (0, 1, 37):
        r, _ = _residuals("wide", 9, n=500)
        valid = np.zeros(500, bool)
        valid[np.random.default_rng(n_valid).choice(500, n_valid, replace=False)] = True
        samples, _ = jpko.stratified_sample(jnp.asarray(np.abs(r)), jnp.asarray(valid),
                                            100, key)
        t_samples = tpko.stratified_sample(torch.as_tensor(np.abs(r)),
                                           torch.as_tensor(valid), tc.u)
        np.testing.assert_array_equal(t_samples.numpy(), np.asarray(samples))
        ref = int(jpko.pko_alpha_index_from_samples(samples, jc, key=key))
        assert int(tpko.alpha_index_from_samples(t_samples, tc)) == ref


def test_done_solve_skips_the_choice(consts):
    _, tc = consts
    r, valid = _residuals("wide", 3)
    scale = torch.tensor([0.25])
    aux, s = tpko.pko_alpha_index(torch.as_tensor(r), torch.as_tensor(valid),
                                  torch.tensor([1, 0, 0], dtype=torch.int32), scale,
                                  True, tc)
    assert float(s[0]) == 0.25


def test_lanes_equal_one_lane_each_and_jax_vmap(consts):
    """Lane-batched residuals (one lane's solve already done) give each lane
    exactly its one-lane result; the live lanes pick the alpha that
    jax.vmap of pko_scale_factor picks (every lane the same PRNGKey(42)
    draws)."""
    jc, tc = consts
    sets = [_residuals(kind, seed) for kind, seed in
            (("tight", 4), ("wide", 5), ("mixture", 6), ("wide", 7))]
    r = torch.as_tensor(np.stack([a for a, _ in sets]))
    valid = torch.as_tensor(np.stack([v for _, v in sets]))
    flags = torch.zeros((4, 3), dtype=torch.int32)
    flags[2, 0] = 1
    scale = torch.full((4, 1), 0.25)
    aux, s = tpko.pko_alpha_index(r, valid, flags, scale, True, tc)
    assert aux.shape == (4, 2) and s.shape == (4, 1)
    for b in range(4):
        a1, s1 = tpko.pko_alpha_index(r[b], valid[b], flags[b], scale[b], True, tc)
        assert torch.equal(aux[b], a1) and torch.equal(s[b], s1)
    assert float(s[2, 0]) == 0.25 and aux[2].tolist() == [0, 0]

    r_abs = jnp.abs(jnp.asarray(r.numpy()))
    jv = jnp.asarray(valid.numpy())
    j_scale = jax.vmap(jicp._norm_scale_from)(r_abs, jv)
    norm = r_abs / jnp.maximum(j_scale, 1e-6)[:, None]
    j_alpha = np.asarray(jax.vmap(lambda x, v: jpko.pko_scale_factor(x, v, jc))(norm, jv))
    for b in (0, 1, 3):
        np.testing.assert_allclose(float(s[b, 0]), float(j_scale[b]), rtol=1e-6)
        assert int(aux[b, 0]) == int(valid[b].sum())
        assert float(tc.alphas[int(aux[b, 1])]) == float(j_alpha[b])
