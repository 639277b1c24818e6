"""The port's map rehash after a pose-graph correction
(ops/voxel_map.py transform_and_rehash: K9 and K4c on their plain twins on
the CPU, models/map_backend.py rehash) against the JAX package's
transform_and_rehash, from the same JAX-built map carried across by
convert.py.

Tolerances:
  * a correction whose products are exact (a quarter turn about z plus a
    translation): the whole integer state is identical (index, meta,
    last counts, free stack and its top, n_l0, n_l1, n_dropped): the
    port reproduces the JAX sorts stably; child rows within 1e-5 (the
    same sums in the same order), surfel centroids within 1e-4, planarity
    within 1e-3 (the closed-form eigenvalues cancel on thick cells), the
    normals of surfels (has = 1) within 1e-4 where the cell's two smallest
    covariance eigenvalues are apart (elsewhere the normal is not fixed by
    the data); has flags equal away from the planarity threshold (1e-5);
  * a general correction: at key level, the live L0 key sets differ in at
    most 0.1 % of the keys (a centroid within float32 rounding of a voxel
    edge may re-key differently), the shared keys' counts are equal and
    centroids within 1e-4 m; n_l0 and n_l1 within that share too;
  * a map denser than 4 children a parent slot, so that the compaction's
    overflow reaches n_dropped: the integer state identical under the exact
    correction, and n_dropped grown by the overflow."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidar_odometry_tpu.ops import voxel_map as jvm
from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.config import SystemConfig
from lidar_odometry_tpu_torch.models.map_backend import SingleChipMapBackend
from lidar_odometry_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_tpu_torch.utils import keys as K
from test_torch_voxel_map import INT_FIELDS, THR, VOX, _frames, _ill_conditioned


def _quarter_turn():
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = (3.0, -2.0, 0.5)
    return T


def _general():
    a, b = 0.07, -0.03
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rz @ Rx
    T[:3, 3] = (0.83, -0.41, 0.07)
    return T


def _jax_map(c1, frames):
    st = jvm.empty_map(0, c1)
    for pts, mask, sensor in frames:
        st = jvm.update_map(st, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(sensor), 120.0,
                            voxel_size=VOX, planarity_threshold=THR)
    return st


def _rehash_both(js, T):
    jr = jvm.transform_and_rehash(js, jnp.asarray(T), voxel_size=VOX, planarity_threshold=THR)
    ps = convert.map_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                      device="cpu")
    pr = tvm.transform_and_rehash(ps, torch.as_tensor(T), voxel_size=VOX,
                                  planarity_threshold=THR)
    return {k: np.asarray(v) for k, v in jr._asdict().items()}, convert.map_state_to_numpy(pr)


def _assert_exact(a, b, c1):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["l0_data"], a["l0_data"], atol=1e-5, rtol=0)
    occ = a["l1_meta"][:, 0] != -1
    sa, sb = a["l1_surfel"][occ], b["l1_surfel"][occ]
    np.testing.assert_allclose(sb[:, 3:6], sa[:, 3:6], atol=1e-4, rtol=0)
    np.testing.assert_allclose(sb[:, 6], sa[:, 6], atol=1e-3, rtol=0)
    near = np.abs(sa[:, 6] - THR) < 1e-5
    np.testing.assert_array_equal(sb[~near, 7], sa[~near, 7])
    cmp = (sa[:, 7] > 0) & ~_ill_conditioned(a["l0_data"], c1)[occ]
    np.testing.assert_allclose(sb[cmp, :3], sa[cmp, :3], atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def scan_map():
    return _jax_map(8192, _frames(n=3))


def test_rehash_exact_correction_matches_jax(scan_map):
    a, b = _rehash_both(scan_map, _quarter_turn())
    _assert_exact(a, b, 8192)
    assert int(a["n_l0"]) > 5000 and int(a["n_l0"]) <= int(scan_map.n_l0)
    assert int((a["l1_surfel"][:, 7] > 0).sum()) > 100


def _records(st, c1):
    hi, lo, cnt, cen, live = (np.asarray(x) for x in jvm.l0_records(
        jvm.VoxelMapState(**{k: jnp.asarray(v) for k, v in st.items()})))
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return {int(k): (c, p) for k, c, p, l in zip(keys, cnt, cen, live) if l}


def test_rehash_general_correction_matches_jax_at_key_level(scan_map):
    a, b = _rehash_both(scan_map, _general())
    ra, rb = _records(a, 8192), _records(b, 8192)
    shared = ra.keys() & rb.keys()
    assert len(ra.keys() ^ rb.keys()) <= 0.001 * len(ra)
    assert len(ra) > 5000
    for k in shared:
        assert ra[k][0] == rb[k][0]
        np.testing.assert_allclose(rb[k][1], ra[k][1], atol=1e-4, rtol=0)
    tol = max(2, int(0.001 * len(ra)))
    assert abs(int(a["n_l0"]) - int(b["n_l0"])) <= tol
    assert abs(int(a["n_l1"]) - int(b["n_l1"])) <= tol
    assert int(a["n_dropped"]) == int(b["n_dropped"])


def test_rehash_of_a_dense_map_drops_the_overflow_as_jax():
    """A 6 m cube of points every 0.25 m: ~1700 live children in 64-ish
    parents, over the 4-per-slot compaction of a 128-slot map."""
    c1 = 128
    g = np.arange(-3.0, 3.0, 0.25, dtype=np.float32) + 0.1
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    mask = np.ones(len(pts), bool)
    js = _jax_map(c1, [(pts, mask, np.zeros(3, np.float32))])
    n_live = int(js.n_l0)
    assert n_live > 4 * c1
    a, b = _rehash_both(js, _quarter_turn())
    _assert_exact(a, b, c1)
    assert int(a["n_dropped"]) - int(js.n_dropped) >= n_live - 4 * c1


def test_backend_rehash_identity_keeps_the_map():
    cfg = SystemConfig(map_l0_capacity=4096, map_l1_capacity=4096, map_voxel_size=VOX,
                       surfel_planarity_threshold=THR)
    frames = _frames(n=1)
    js = _jax_map(4096, frames)
    ps = convert.map_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                      device="cpu")
    pr = SingleChipMapBackend(cfg, device="cpu").rehash(ps, np.eye(4, dtype=np.float32))
    ra = _records({k: np.asarray(v) for k, v in js._asdict().items()}, 4096)
    rb = _records(convert.map_state_to_numpy(pr), 4096)
    assert ra.keys() == rb.keys()
    assert int(pr.n_l0) == int(js.n_l0)


# K9a's edge cases: (n = c1, dead keys, keys crowded into one bucket,
# slot_from_top)
BULK_CASES = {"overflow": (256, 0, 20, 256), "dead": (256, 60, 12, 256),
              "slots_below_placed": (256, 10, 12, 50), "all_dead": (256, 256, 0, 256),
              "one": (1, 0, 0, 1)}


@pytest.mark.parametrize("case", sorted(BULK_CASES))
def test_bulk_index_twin_against_jax(case):
    """K9a's twin (map_bulk_index_plain) against JAX's _bulk_index and
    _write_bulk with bulk_build's meta rows, directly, on the keys of
    synthetic.bulk_index_keys: a bucket holding more than its 8 cells
    (its keys past the 8th not placed), dead keys between live ones,
    fewer slots than placed keys, every key dead, one key. The index and
    meta rows (less the port's sink rows) and the count placed are equal."""
    n, n_dead, crowd, top = BULK_CASES[case]
    nb = tvm._n_buckets(n)
    hi, lo, live = synthetic.bulk_index_keys(n, nb, seed=n_dead + crowd, n_dead=n_dead,
                                             crowd=crowd)
    slot, cellpos, placed = jvm._bulk_index(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(live),
                                            nb, top)
    fresh = jvm.empty_map(0, n)
    j_index = np.asarray(jvm._write_bulk(fresh.l1_index, slot, cellpos, placed, jnp.asarray(hi),
                                         jnp.asarray(lo)))
    st = jnp.where(placed, slot, n)
    j_meta = fresh.l1_meta
    j_meta = j_meta.at[st, 0].set(jnp.asarray(hi.view(np.int32)), mode="drop")
    j_meta = j_meta.at[st, 1].set(jnp.asarray(lo.view(np.int32)), mode="drop")
    j_meta = np.asarray(j_meta.at[st, 3].set(cellpos, mode="drop"))

    hi64, lo64 = torch.as_tensor(hi.astype(np.int64)), torch.as_tensor(lo.astype(np.int64))
    b = torch.where(torch.as_tensor(live), tvm.hash_bucket(hi64, lo64, nb - 1), nb)
    b_s, i_s = torch.sort(b.to(torch.int64), stable=True)
    st_t = tvm.empty_map(0, n, device="cpu")
    n_placed = tvm.map_bulk_index_plain(b_s, i_s, K.to_i32(hi64), K.to_i32(lo64),
                                        st_t.l1_index, st_t.l1_meta, top)
    np.testing.assert_array_equal(st_t.l1_index[:-1].numpy(), j_index)
    np.testing.assert_array_equal(st_t.l1_meta[:-1].numpy(), j_meta)
    assert int(n_placed) == int(np.asarray(placed).sum())
    per_bucket = np.bincount(b[torch.as_tensor(live)].numpy(), minlength=nb)
    fits = int(np.minimum(per_bucket, 8).sum())
    assert int(n_placed) == min(fits, top)
    if crowd > 8:      # the crowded bucket overflows: some live keys are not placed
        assert per_bucket.max() >= crowd and fits < int(live.sum())


@pytest.mark.parametrize("n_live, n_dead", [(3000, 333), (0, 500)])
def test_bulk_build_on_merge_records_matches_jax(n_live, n_dead):
    """bulk_build (K9a's and K9b's twins, K4c's) against JAX's on
    synthetic.merge_records: runs of equal voxels up to 60 records long
    (K9b's tiles and window are 32 and 8), M not a multiple of 32, dead
    records among the live ones, more parents than the 256 slots (the rest
    dropped); and an all-dead record set. The integer state identical and
    the child rows equal bit for bit (each run summed in its order on both
    sides)."""
    cen, cnt, live = synthetic.merge_records(n_live, n_dead, seed=3)
    m = cen.shape[0]
    js = jvm.bulk_build(jnp.asarray(cen), jnp.asarray(cnt), jnp.asarray(live), m, 256,
                        voxel_size=VOX, planarity_threshold=THR)
    ps = tvm.bulk_build(torch.as_tensor(cen), torch.as_tensor(cnt), torch.as_tensor(live), m,
                        256, voxel_size=VOX, planarity_threshold=THR)
    a = {k: np.asarray(v) for k, v in js._asdict().items()}
    b = convert.map_state_to_numpy(ps)
    for k in INT_FIELDS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(b["l0_data"], a["l0_data"])
    assert int(a["n_l0"]) == (260 if n_live else 0)
    assert int(a["n_dropped"]) == (2099 if n_live else 0)
