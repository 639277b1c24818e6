"""The port's map update (kernels K4a-c through their plain path) against
the JAX update_map, keyframe by keyframe on the same inputs (CPU).

The integer state must come out identical: the port keeps the JAX layout
and its sort-rank bucket claim. Float tables agree within 1e-4, except the
normal of a cell whose two smallest covariance eigenvalues lie within
rounding of each other (children on a line): that normal is not fixed by
the data, and any two float32 evaluations may pick different directions
in its eigenplane. Such cells are counted and kept rare."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import voxel_map as jvm
from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import voxel_map as tvm

C1 = 8192
VOX, THR = 0.5, 0.1
INT_FIELDS = ("l1_index", "l1_meta", "l1_free", "l1_free_top", "l1_last", "n_l0",
              "n_l1", "n_dropped")


def _frames(n=5, seed=21, n_points=7000):
    """Per-frame world points on a straight drive (a voxel filter's worth of
    structure without the filter: raw sampled points, padded to 8192)."""
    world = synthetic.make_world(seed=seed, extent=60.0, n_buildings=14)
    poses = synthetic.straight_trajectory(n, step=1.5)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = synthetic.sample_scan(world, poses[i], n_points, rng, max_range=45.0, noise=0.01)
        pts = np.zeros((8192, 3), np.float32)
        mask = np.zeros(8192, bool)
        pts[:len(s)] = s + poses[i][:3, 3]
        mask[:len(s)] = True
        out.append((pts, mask, poses[i][:3, 3].astype(np.float32)))
    return out


def _jax_update(state, pts, mask, sensor, max_d, evict=True):
    return jvm.update_map(state, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(sensor),
                          max_d, voxel_size=VOX, planarity_threshold=THR,
                          evict_enabled=jnp.bool_(evict))


def _port_update(state, pts, mask, sensor, max_d, evict=True):
    return tvm.update_map(state, torch.as_tensor(pts), torch.as_tensor(mask),
                          torch.as_tensor(sensor), max_d, voxel_size=VOX,
                          planarity_threshold=THR, evict_enabled=torch.tensor(evict))


def _ill_conditioned(l0_data, c1):
    """Cells whose children's covariance has its two smallest eigenvalues
    within 1e-4 of the largest (float64, from the JAX child table)."""
    blk = l0_data.reshape(c1, 27, 4).astype(np.float64)
    ok = blk[..., 0] > 0
    cen = blk[..., 1:4] / np.maximum(blk[..., 0:1], 1.0)
    cnt = np.maximum(ok.sum(1), 1)[:, None]
    mean = (cen * ok[..., None]).sum(1) / cnt
    d = (cen - mean[:, None]) * ok[..., None]
    cov = np.einsum("aki,akj->aij", d, d) / cnt[..., None]
    lam = np.linalg.eigvalsh(cov)
    return (lam[:, 1] - lam[:, 0]) <= 1e-4 * (lam[:, 2] + 1e-6)


def _assert_same(js, ts, where=""):
    a = {k: np.asarray(v) for k, v in js._asdict().items()}
    b = convert.map_state_to_numpy(ts)
    for k in INT_FIELDS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{k} {where}")
    np.testing.assert_allclose(b["l0_data"], a["l0_data"], atol=1e-4, err_msg=where)
    np.testing.assert_allclose(b["l1_surfel"][:, 3:], a["l1_surfel"][:, 3:], atol=1e-4,
                               err_msg=where)
    ill = _ill_conditioned(a["l0_data"], C1) & (a["l1_surfel"][:, 7] > 0)
    assert ill.sum() <= 0.01 * max(int((a["l1_surfel"][:, 7] > 0).sum()), 1), where
    np.testing.assert_allclose(b["l1_surfel"][~ill, :3], a["l1_surfel"][~ill, :3], atol=1e-4,
                               err_msg=where)
    return a, b


@pytest.fixture(scope="module")
def frames():
    return _frames()


def test_update_sequence_matches_jax(frames, monkeypatch):
    """A bulk first keyframe, a small-tier repeat, a revisit-tier subset,
    an update that evicts and more bulk keyframes: identical integer state
    after each, and the same surfel lookups."""
    tiers = []
    pick = tvm._pick

    def recording_pick(branch, values):
        tiers.append(int(branch))
        return pick(branch, values)

    monkeypatch.setattr(tvm, "_pick", recording_pick)
    js = jvm.empty_map(0, C1)
    ts = tvm.empty_map(0, C1, device="cpu")
    # (frame, eviction radius, points kept)
    steps = [(0, 120.0, None), (1, 120.0, None), (1, 120.0, None), (1, 120.0, 300),
             (2, 30.0, None), (3, 120.0, None), (4, 120.0, None)]
    for i, (f, max_d, keep) in enumerate(steps):
        pts, mask, sensor = frames[f]
        if keep is not None:
            mask = mask & (np.arange(mask.shape[0]) < keep)
        n_l0_before = int(js.n_l0)
        js = _jax_update(js, pts, mask, sensor, max_d)
        ts = _port_update(ts, pts, mask, sensor, max_d)
        _assert_same(js, ts, where=f"after update {i}")
        if max_d < 100:   # the eviction took live voxels away
            assert int(js.n_l0) < n_l0_before + int(mask.sum()) - 2000
    assert {0, 1, 3} <= set(tiers), tiers        # revisit, small and bulk tiers
    q = frames[4][0][frames[4][1]] + np.float32(0.05)
    _, _, jv = jvm.lookup_surfels(js, jnp.asarray(q), voxel_size=VOX)
    tn, tc, tv = tvm.lookup_surfels(ts, torch.as_tensor(q), voxel_size=VOX)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tv.sum()) > 100


def test_update_on_a_converted_jax_map(frames):
    """A map built by JAX, carried across by convert.py, takes one more
    keyframe (with eviction) exactly as JAX does."""
    js = jvm.empty_map(0, C1)
    for f in range(3):
        pts, mask, sensor = frames[f]
        js = _jax_update(js, pts, mask, sensor, 120.0)
    ts = convert.map_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                      device="cpu")
    _assert_same(js, ts, where="after conversion")
    pts, mask, sensor = frames[3]
    js = _jax_update(js, pts, mask, sensor, 35.0)
    ts = _port_update(ts, pts, mask, sensor, 35.0)
    _assert_same(js, ts, where="after one more keyframe")


def test_eviction_gate_off(frames):
    """evict_enabled=False skips the radius stage entirely."""
    js = jvm.empty_map(0, C1)
    ts = tvm.empty_map(0, C1, device="cpu")
    for f, evict in ((0, True), (3, False)):
        pts, mask, sensor = frames[f]
        js = _jax_update(js, pts, mask, sensor, 20.0, evict=evict)
        ts = _port_update(ts, pts, mask, sensor, 20.0, evict=evict)
        _assert_same(js, ts, where=f"frame {f}")


def test_records_and_surfels_views(frames):
    js = jvm.empty_map(0, C1)
    ts = tvm.empty_map(0, C1, device="cpu")
    pts, mask, sensor = frames[0]
    js = _jax_update(js, pts, mask, sensor, 120.0)
    ts = _port_update(ts, pts, mask, sensor, 120.0)
    jr = [np.asarray(x) for x in jvm.l0_records(js)]
    tr = [x.numpy() for x in tvm.l0_records(ts)]
    live = jr[4]
    np.testing.assert_array_equal(tr[4], live)
    np.testing.assert_array_equal(tr[0][live], jr[0][live].astype(np.int64))
    np.testing.assert_array_equal(tr[1][live], jr[1][live].astype(np.int64))
    np.testing.assert_allclose(tr[3][live], jr[3][live], atol=1e-4)
    js_s = [np.asarray(x) for x in jvm.l1_surfels(js)]
    ts_s = [x.numpy() for x in tvm.l1_surfels(ts)]
    np.testing.assert_array_equal(ts_s[3], js_s[3])
    np.testing.assert_allclose(ts_s[1], js_s[1], atol=1e-4)


def test_convert_roundtrip_is_exact(frames):
    js = jvm.empty_map(0, C1)
    pts, mask, sensor = frames[1]
    js = _jax_update(js, pts, mask, sensor, 120.0)
    a = {k: np.asarray(v) for k, v in js._asdict().items()}
    b = convert.map_state_to_numpy(convert.map_state_from_numpy(a, device="cpu"))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
