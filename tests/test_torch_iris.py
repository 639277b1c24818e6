"""The port's LiDAR-Iris descriptor (ops/iris.py: K8a, K8b and K8c on
their plain twins on the CPU) against the JAX package's ops/iris.py on the
same numpy clouds.

Tolerances (the codes sit on thresholds):
  * image: a pixel may differ only where a point lies within 1e-4 of a
    range-ring, height or yaw-column edge (atan2 and floor(yaw + 0.5)
    differ by an ulp between XLA and torch); on these clouds none does;
  * codes: a T bit may differ only where its response |re| or |im|, and an
    M bit only where |magnitude - 1e-4|, lies within 4 float32 ulps of the
    image's largest response (float64 reference responses), the roundoff
    of a float32 FFT of that size (pocketfft vs XLA's);
  * comparison, on the JAX test fixtures (tests/test_iris.py): on the
    same (JAX) codes, distances within 1e-6 and equal biases; end to end,
    equal biases and distances apart by at most the share of code bits
    that differ on thresholds; the port's descriptor of a dense cloud
    against JAX's, a Hamming distance of at most 1e-3."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidar_odometry_tpu.ops import iris as ji
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import iris
from test_iris import _ring_cloud

EPS32 = float(np.finfo(np.float32).eps)


def _clouds():
    rng = np.random.default_rng(0)
    ring = _ring_cloud(rng)
    rand = rng.uniform(-40, 40, (8000, 3)).astype(np.float32)
    return {"ring": ring, "rand": rand}


def _near_edge(c, margin=1e-4):
    x, y, z = c[:, 0].astype(np.float64), c[:, 1].astype(np.float64), c[:, 2].astype(np.float64)
    dis = np.sqrt(x * x + y * y)
    yaw = np.degrees(np.arctan2(y, x)) + 180.0 + 0.5
    edge = lambda v: np.abs(v - np.round(v)) < margin
    return edge(dis) | edge(yaw) | edge(z + 5.0)


def _bits(words):
    w = np.asarray(words).astype(np.uint32)
    return ((w[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1).reshape(
        -1, iris.COLS).astype(bool)


@pytest.mark.parametrize("name", ["ring", "rand"])
def test_iris_image_matches_jax(name):
    c = _clouds()[name]
    m = np.ones(len(c), bool)
    m[::7] = False
    jimg = np.asarray(ji.iris_image(jnp.asarray(c), jnp.asarray(m)))
    pimg = iris.iris_image(torch.as_tensor(c), torch.as_tensor(m)).numpy()
    diff = jimg != pimg
    near = _near_edge(c) & m
    dis = np.clip(np.floor(np.hypot(c[:, 0], c[:, 1])).astype(int), 0, 79)
    touched = np.zeros_like(diff)
    touched[dis[near], :] = True      # a near-edge point may move within its ring's row
    assert not (diff & ~touched).any()
    assert diff.sum() <= near.sum()
    assert (pimg > 0).sum() > 100


def test_iris_image_binning_fixture():
    pts = np.array([[10.0, 0.0, 0.0], [0.0, 20.0, -5.0]], np.float32)
    img = iris.iris_image(torch.as_tensor(pts), torch.ones(2, dtype=torch.bool)).numpy()
    assert img[10, 180] == 32.0 and img[20, 270] == 1.0 and img.sum() == 33.0


def _near_ring_or_yaw(c, margin=1e-4):
    """Points within `margin` of a range-ring or yaw-column edge (float64):
    where XLA's fused x * x + y * y and atan2 * deg + 180 may bin a point
    apart from the unfused arithmetic of the twin and the kernel."""
    with np.errstate(invalid="ignore"):
        x, y = c[:, 0].astype(np.float64), c[:, 1].astype(np.float64)
        dis = np.sqrt(x * x + y * y)
        yaw = np.degrees(np.arctan2(y, x)) + 180.0 + 0.5
        edge = lambda v: np.abs(v - np.round(v)) < margin
        return edge(dis) | edge(yaw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iris_image_twin_on_bin_edges(seed):
    """K8a's twin against JAX iris_image on synthetic.iris_edge_clouds:
    points on and a few float32 steps beside the ring, height and yaw
    edges, NaN and +-inf coordinates, points past every clamp, masked
    points. Away from the ring and yaw edges (XLA fuses the products and
    sums there) the images are equal pixel for pixel, the height edges,
    clamps and non-finite points included (XLA and the kernel send NaN to
    bin 0 and a value past an end to that end); the points near a ring or
    yaw edge move a pixel at most within their ring's rows."""
    pts, masks, kind = synthetic.iris_edge_clouds(2, 3000, seed)
    twin = iris._iris_bits_plain(torch.as_tensor(pts), torch.as_tensor(masks)).numpy()
    for k in range(2):
        c, m = pts[k], masks[k]
        near = _near_ring_or_yaw(c) & m
        far = m & ~near
        assert (kind[k][near] % 2 == 1).mean() > 0.99 and near.sum() > 500
        assert {0, 2, 4} <= set(kind[k][far].tolist())
        jimg = np.asarray(ji.iris_image(jnp.asarray(c), jnp.asarray(far)))
        pimg = iris._iris_bits_plain(torch.as_tensor(c[None]), torch.as_tensor(far[None]))[0]
        np.testing.assert_array_equal(pimg.numpy(), jimg.astype(np.int32))
        diff = np.asarray(ji.iris_image(jnp.asarray(c), jnp.asarray(m))).astype(np.int32) != twin[k]
        with np.errstate(invalid="ignore"):
            ring = np.floor(np.hypot(c[near, 0].astype(np.float64), c[near, 1]))
        rows = np.zeros(iris.ROWS, bool)
        for r in np.clip(ring[np.isfinite(ring)].astype(int), 0, iris.ROWS - 1):
            rows[max(r - 1, 0):r + 2] = True
        assert not diff[~rows].any()
        assert diff.sum() <= 2 * near.sum()
        assert (twin[k] > 0).sum() > 1000


@pytest.mark.parametrize("name", ["ring", "rand"])
def test_iris_codes_match_jax(name):
    c = _clouds()[name]
    jimg = np.asarray(ji.iris_image(jnp.asarray(c), jnp.ones(len(c), bool)))
    _, jT, jM = ji.iris_feature(jnp.asarray(jimg))
    _, pT, pM = iris.iris_feature(torch.as_tensor(np.array(jimg)))
    # float64 reference responses, scaled as the codes threshold them
    filt = iris.log_gabor_filters().astype(np.float64)
    spec = np.fft.fft(jimg.astype(np.float64), axis=1)
    resp = np.fft.ifft(spec[None] * filt[:, None], axis=2) * iris.COLS
    tval = np.concatenate([resp.real, resp.imag]).reshape(-1, iris.COLS)
    mval = np.concatenate([np.abs(resp)] * 2).reshape(-1, iris.COLS)
    margin = 4 * EPS32 * np.abs(tval).max()
    dT = _bits(jT) != _bits(iris.to_uint32(pT.numpy()))
    dM = _bits(jM) != _bits(iris.to_uint32(pM.numpy()))
    assert (np.abs(tval[dT]) < margin).all()
    assert (np.abs(mval[dM] - 1e-4) < margin).all()
    assert dT.sum() <= (np.abs(tval) < margin).sum()
    assert dT.sum() + dM.sum() < 0.01 * dT.size


def test_magnitude_threshold_is_exact():
    """K8b tests |z| < 1e-4 as re^2 + im^2 < MAG_SQ_THRESHOLD: x0 is the
    least float32 whose square root is >= 1e-4, and on responses whose
    squared magnitudes sit on and beside x0 (with NaN, +-inf and +-0) the
    twin's M words are exactly those of s < x0, s the squared magnitudes
    rounded in float32, and its T words those of the signs."""
    x0 = np.float32(iris.MAG_SQ_THRESHOLD)
    t = np.float32(1e-4)
    assert float(x0) == iris.MAG_SQ_THRESHOLD
    assert np.sqrt(x0) >= t and np.sqrt(np.nextafter(x0, np.float32(0.0))) < t
    z, s = synthetic.iris_threshold_responses(2, float(x0), seed=3)
    below = np.nextafter(x0, np.float32(0.0))
    assert (s == x0).any() and (s == below).any() and np.isnan(s).any() and (s == 0).any()
    T, M = iris.iris_encode_plain(torch.as_tensor(z))
    m = torch.as_tensor(s < x0)
    want = iris._pack_rows(torch.cat([m, m], 1).reshape(2, iris.STACK_ROWS, iris.COLS))
    assert torch.equal(M, want)
    c = np.float32(iris.COLS)
    re, im = torch.as_tensor(z.real * c), torch.as_tensor(z.imag * c)
    bits = torch.cat([re > 0, im > 0], 1).reshape(2, iris.STACK_ROWS, iris.COLS)
    assert torch.equal(T, iris._pack_rows(bits))


def _features_both(c):
    m = np.ones(len(c), bool)
    jf = ji.iris_feature(ji.iris_image(jnp.asarray(c), jnp.asarray(m)))
    pf = iris.iris_feature(iris.iris_image(torch.as_tensor(c), torch.as_tensor(m)))
    return jf, pf


def _pair(case):
    rng = np.random.default_rng({"identical": 0, "rotated": 1, "different": 2, "masked": 3}[case])
    c1 = _ring_cloud(rng)
    if case == "rotated":
        yaw = np.radians(90)
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                      [0, 0, 1]], np.float32)
        c2 = c1 @ R.T
    elif case == "different":
        c2 = rng.uniform(-40, 40, (4000, 3)).astype(np.float32)
    else:
        c2 = c1
    return c1, c2, np.array([True, case != "masked"])


def _jax_compare(q, d, valid):
    dist, bias = ji.compare_batch(q[0], q[1], q[2], jnp.stack([d[0]] * 2), jnp.stack([d[1]] * 2),
                                  jnp.stack([d[2]] * 2), jnp.asarray(valid))
    return np.asarray(dist), np.asarray(bias)


def _port_compare(q, d, valid):
    dist, bias = iris.compare_batch(q[0], q[1], q[2], torch.stack([d[0]] * 2),
                                    torch.stack([d[1]] * 2), torch.stack([d[2]] * 2),
                                    torch.as_tensor(valid))
    return dist.numpy(), bias.numpy()


def _as_port(f):
    return (torch.as_tensor(np.array(f[0])), torch.as_tensor(np.array(f[1]).view(np.int32)),
            torch.as_tensor(np.array(f[2]).view(np.int32)))


def test_phase_shifts_two_tensor_spectra_match_jax():
    """K7c's two-tensor form as iris.phase_shifts calls it (the forward and
    flipped candidate spectra passed apart, no concatenation) against
    JAX's _phase_corr_shift of the same images: every shift equal."""
    rng = np.random.default_rng(5)
    clouds = [_ring_cloud(rng), _clouds()["rand"], _ring_cloud(rng)[::2]]
    yaw = np.radians(37.0)
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]],
                 np.float32)
    clouds.append(clouds[0] @ R.T)
    imgs = np.stack([np.asarray(ji.iris_image(jnp.asarray(c), jnp.ones(len(c), bool)))
                     for c in clouds]).astype(np.float32)
    q, cand = imgs[0], imgs[1:]
    shifts = iris.phase_shifts(torch.as_tensor(q), torch.as_tensor(cand)).numpy()
    qf_conj = jnp.conj(jnp.fft.fft2(jnp.asarray(q).astype(jnp.complex64)))
    for k in range(cand.shape[0]):
        for o, d in enumerate((cand[k], np.roll(cand[k], 180, -1))):
            fd = jnp.fft.fft2(jnp.asarray(d).astype(jnp.complex64))
            assert int(shifts[k, o]) == int(ji._phase_corr_shift(fd, qf_conj)), (k, o)
    assert abs(int(shifts[2, 0])) in (36, 37, 38)     # the cloud turned by 37 degrees


@pytest.mark.parametrize("case", ["identical", "rotated", "different", "masked"])
def test_compare_matches_jax_on_the_same_codes(case):
    """The comparison alone (phase shifts, K8c's twin) on JAX's descriptors:
    equal biases, distances within 1e-6."""
    c1, c2, valid = _pair(case)
    jq, jc = (ji.iris_feature(ji.iris_image(jnp.asarray(c), jnp.ones(len(c), bool)))
              for c in (c1, c2))
    jdist, jbias = _jax_compare(jq, jc, valid)
    pdist, pbias = _port_compare(_as_port(jq), _as_port(jc), valid)
    np.testing.assert_array_equal(np.isinf(pdist), np.isinf(jdist))
    fin = np.isfinite(jdist)
    np.testing.assert_allclose(pdist[fin], jdist[fin], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pbias, jbias)
    if case == "identical":
        assert pdist[0] < 0.05 and int(pbias[0]) % 360 in (0, 359, 1)
    if case == "rotated":
        assert pdist[0] < 0.15
    if case == "different":
        assert pdist[0] > 0.1
    if case == "masked":
        assert np.isinf(pdist[1])


@pytest.mark.parametrize("case", ["identical", "rotated", "different"])
def test_compare_end_to_end_matches_jax(case):
    """Each side on its own descriptors: equal biases, and distances apart
    by at most the share of code bits that differ on thresholds (at most
    1e-3 on the dense cloud below; the sparse ring clouds have more
    responses at roundoff level)."""
    c1, c2, valid = _pair(case)
    jq, pq = _features_both(c1)
    jc, pc = _features_both(c2)
    jdist, jbias = _jax_compare(jq, jc, valid)
    pdist, pbias = _port_compare(pq, pc, valid)
    n_diff = sum(int((_bits(a) != _bits(iris.to_uint32(b.numpy()))).sum())
                 for a, b in ((jq[1], pq[1]), (jq[2], pq[2]), (jc[1], pc[1]), (jc[2], pc[2])))
    np.testing.assert_array_equal(pbias, jbias)
    np.testing.assert_allclose(pdist, jdist, atol=n_diff / (iris.STACK_ROWS * iris.COLS) + 1e-6,
                               rtol=0)


def test_port_and_jax_descriptors_of_one_cloud_are_near():
    """The port's codes against JAX's codes of the same cloud, through the
    JAX comparison: a Hamming distance of at most 1e-3."""
    c = _clouds()["rand"]
    jf, pf = _features_both(c)
    pT = jnp.asarray(iris.to_uint32(pf[1].numpy()))[None]
    pM = jnp.asarray(iris.to_uint32(pf[2].numpy()))[None]
    d, b = ji.compare_batch(jf[0], jf[1], jf[2], jnp.asarray(pf[0].numpy())[None], pT, pM,
                            jnp.ones(1, bool))
    assert float(d[0]) <= 1e-3 and int(b[0]) == 0
