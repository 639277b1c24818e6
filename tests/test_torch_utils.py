"""The port's keys, Lie-group helpers and eigh3 against the JAX package,
on the same numpy inputs (CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import voxel_map as jvm
from lidar_odometry_tpu.utils import eigh3 as jeigh
from lidar_odometry_tpu.utils import keys as jkeys
from lidar_odometry_tpu.utils import lie as jlie
from lidar_odometry_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_tpu_torch.utils import eigh3 as teigh
from lidar_odometry_tpu_torch.utils import keys as tkeys
from lidar_odometry_tpu_torch.utils import lie as tlie


def _coords(seed, n=4096, lo=-40000, hi=40000):
    rng = np.random.default_rng(seed)
    c = rng.integers(lo, hi, size=(n, 3)).astype(np.int32)
    c[:, :2] = np.clip(c[:, :2], -32768, 32767)
    return c


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_match_jax(seed):
    c = _coords(seed)
    jhi, jlo = jkeys.pack_key(jnp.asarray(c))
    thi, tlo = tkeys.pack_key(torch.as_tensor(c))
    np.testing.assert_array_equal(np.asarray(jhi).astype(np.int64), thi.numpy())
    np.testing.assert_array_equal(np.asarray(jlo).astype(np.int64), tlo.numpy())
    np.testing.assert_array_equal(tkeys.unpack_key(thi, tlo).numpy(), c)


def test_sort_key_orders_like_the_key_pair():
    c = _coords(2)
    hi, lo = tkeys.pack_key(torch.as_tensor(c))
    order = torch.argsort(tkeys.sort_key(hi, lo), stable=True).numpy()
    ref = np.lexsort((lo.numpy(), hi.numpy()))
    np.testing.assert_array_equal(order, ref)
    inv = torch.tensor([tkeys.INVALID_U32])
    assert int(tkeys.sort_key(inv, inv)) == tkeys.INVALID_SORT_KEY


def test_compact_key_order_and_envelope():
    """The filter's key is JAX's 10-bit x-major compact key, and points
    outside +-512 voxels fall out of the envelope (voxel_filter.py:71-78)."""
    rng = np.random.default_rng(3)
    c = rng.integers(-520, 520, size=(5000, 3)).astype(np.int32)
    key, ok = tkeys.compact_key(torch.as_tensor(c))
    b = c.astype(np.int64) + 512
    ok_ref = np.all((b >= 0) & (b < 1024), axis=1)
    bu = np.where(ok_ref[:, None], b, 0).astype(np.uint32)
    ref = (bu[:, 0] << np.uint32(20)) | (bu[:, 1] << np.uint32(10)) | bu[:, 2]
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    np.testing.assert_array_equal(key.numpy()[ok_ref], ref[ok_ref].astype(np.int64))


def test_hash_bucket_exact_including_all_ones():
    rng = np.random.default_rng(4)
    hi = rng.integers(0, 2**32, size=20000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=20000, dtype=np.uint64).astype(np.uint32)
    hi[:4] = [0xFFFFFFFF, 0, 0xFFFFFFFF, 0x80000000]
    lo[:4] = [0xFFFFFFFF, 0xFFFFFFFF, 0, 0x7FFFFFFF]
    for mask in (7, 1023, 16383):
        ref = np.asarray(jvm._hash_bucket(jnp.asarray(hi), jnp.asarray(lo), mask))
        got = tvm.hash_bucket(torch.as_tensor(hi.astype(np.int64)),
                              torch.as_tensor(lo.astype(np.int64)), mask)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_voxel_coords_floor_semantics():
    pts = np.array([[-0.01, 0.49, 0.51], [-0.5, -0.51, 1.0]], np.float32)
    got = tkeys.voxel_coords(torch.as_tensor(pts), 1.0 / 0.5).numpy()
    ref = np.asarray(jkeys.voxel_coords(jnp.asarray(pts), 1.0 / 0.5))
    np.testing.assert_array_equal(got, ref)


def _rand_w(seed, n=256):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, 3)).astype(np.float32)
    w[:8] *= 1e-8          # small-angle branch
    w[8:16] *= 3.0
    return w


@pytest.mark.parametrize("seed", [5, 6])
def test_lie_matches_jax(seed):
    w = _rand_w(seed)
    R_j = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    R_t = tlie.so3_exp(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-5)

    rng = np.random.default_rng(seed + 10)
    Rn = (R_j + 1e-3 * rng.standard_normal(R_j.shape)).astype(np.float32)
    np.testing.assert_allclose(tlie.so3_project(torch.as_tensor(Rn)).numpy(),
                               np.asarray(jlie.so3_project(jnp.asarray(Rn))), atol=1e-5)

    t = rng.standard_normal((w.shape[0], 3)).astype(np.float32) * 10
    T_j = np.asarray(jlie.se3_matrix(jnp.asarray(R_j), jnp.asarray(t)))
    T_t = tlie.se3_matrix(torch.tensor(R_j), torch.tensor(t))
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-6)
    np.testing.assert_allclose(tlie.se3_inv(T_t).numpy(),
                               np.asarray(jlie.se3_inv(jnp.asarray(T_j))), atol=1e-5)
    np.testing.assert_allclose(
        tlie.se3_from_exp_rt(torch.as_tensor(t[0]), torch.as_tensor(w[20])).numpy(),
        np.asarray(jlie.se3_from_exp_rt(jnp.asarray(t[0]), jnp.asarray(w[20]))), atol=1e-5)
    pts = rng.standard_normal((100, 3)).astype(np.float32) * 30
    np.testing.assert_allclose(
        tlie.transform_points(T_t[0], torch.as_tensor(pts)).numpy(),
        np.asarray(jlie.transform_points(jnp.asarray(T_j[0]), jnp.asarray(pts))),
        atol=1e-4)


@pytest.mark.parametrize("seed", [7, 8])
def test_eigh3_matches_jax(seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((512, 6, 3)).astype(np.float32)
    X[:, :, 2] *= 0.05                   # planar blobs
    A = np.einsum("nki,nkj->nij", X, X) / 6.0
    A[:4] = np.diag([0.3, 0.1, 0.2]).astype(np.float32)   # near-diagonal
    A = A.astype(np.float32)
    lam_j, v_j = jeigh.eigh3(jnp.asarray(A))
    lam_t, v_t = teigh.eigh3(torch.as_tensor(A))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), atol=1e-5)
    # eigenvectors up to sign, where the smallest eigenvalue is isolated
    lam = np.asarray(lam_j)
    iso = (lam[:, 1] - lam[:, 0]) > 1e-3
    dots = np.abs(np.sum(v_t.numpy() * np.asarray(v_j), axis=-1))
    np.testing.assert_allclose(dots[iso], 1.0, atol=1e-5)


def test_port_never_imports_jax():
    """The port and chip_smoke.py import torch and numpy, never jax and
    nothing of lidar_odometry_tpu."""
    import re
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    files = list((root / "lidar_odometry_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    pat = re.compile(r"import jax|from jax|lidar_odometry_tpu[^_]")
    bad = [f"{f.name}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pat.search(line)]
    assert not bad, bad
