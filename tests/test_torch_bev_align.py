"""The port's loop prealignment (ops/bev_align.py: K7's plain twin and
torch.fft on the CPU) against the JAX package's ops/bev_align.py on the
same numpy clouds.

Tolerances: the occupancy images equal a float64 numpy rasterisation
except next to points that lie within 1e-4 m of a cell edge;
the x-y offset is identical (it is a whole number of cells: the phase
correlation's first maximum); the prealigned pose agrees with JAX's to
1e-5 (its yaw is float32 trigonometry of the same inputs), for Iris
biases on both sides of the +-180 degree wrap."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidar_odometry_tpu.ops import bev_align as jbev
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import bev_align


def _yaw(deg):
    a = np.radians(deg)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return T


@pytest.fixture(scope="module")
def scene():
    world = synthetic.make_world(seed=4, extent=50.0, n_buildings=14)
    rng = np.random.default_rng(4)
    m_pose = np.eye(4, dtype=np.float32)
    m_pose[:3, 3] = (2.0, -1.0, 1.8)
    q_true = _yaw(25.0) @ m_pose
    q_true[:3, 3] += (3.5, 2.0, 0.0)
    matched = synthetic.sample_scan(world, m_pose, 6000, rng, max_range=45.0, noise=0.01)
    query = synthetic.sample_scan(world, q_true, 5000, rng, max_range=45.0, noise=0.01)
    m_world = (matched @ m_pose[:3, :3].T + m_pose[:3, 3]).astype(np.float32)
    drift = _yaw(-6.0)
    drift[:3, 3] = (-4.0, 3.0, 0.0)
    q_est = (drift @ q_true).astype(np.float32)
    return dict(m_pose=m_pose, m_world=m_world, m_mask=np.ones(len(m_world), bool),
                query=query.astype(np.float32), q_mask=np.ones(len(query), bool), q_est=q_est,
                q_true=q_true)


def test_occupancy_images(scene):
    pts, center = scene["m_world"], scene["m_pose"][:3, 3]
    T = torch.eye(4).reshape(16)
    img = bev_align.bev_raster(torch.as_tensor(scene["query"]), torch.as_tensor(scene["q_mask"]),
                               T, torch.as_tensor(pts), torch.as_tensor(scene["m_mask"]),
                               torch.as_tensor(center)).numpy()
    assert img.dtype == np.complex64 and not img.imag.any()
    img = img.real
    for k, p in enumerate((scene["query"], pts)):
        rel = p[:, :2].astype(np.float64) - center[:2]
        ij = np.floor(rel).astype(int) + 64
        ok = np.all((ij >= 0) & (ij < 128), 1)
        ref = np.zeros((128, 128), np.float32)
        ref[ij[ok, 0], ij[ok, 1]] = 1.0
        near = ok & (np.abs(rel - np.round(rel)).min(1) < 1e-4)
        allowed = np.zeros((130, 130), bool)
        for di in (0, 1, 2):
            for dj in (0, 1, 2):
                allowed[ij[near, 0] + di, ij[near, 1] + dj] = True
        diff = img[k] != ref
        assert not (diff & ~allowed[1:-1, 1:-1]).any()
        assert diff.sum() <= near.sum() and ref.sum() > 200


def test_translation_offset_matches_jax(scene):
    q_world = (scene["query"] @ scene["q_true"][:3, :3].T + scene["q_true"][:3, 3]
               + np.array([-4.0, 3.0, 0.0], np.float32)).astype(np.float32)
    args = (q_world, scene["q_mask"], scene["m_world"], scene["m_mask"],
            scene["m_pose"][:3, 3].copy())
    j = np.asarray(jbev.bev_translation_offset(*(jnp.asarray(a) for a in args)))
    p = bev_align.bev_translation_offset(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_array_equal(p, j)
    np.testing.assert_allclose(p, [4.0, -3.0], atol=1.0)


@pytest.mark.parametrize("bias", [0.0, 31.0, -150.0, 300.0])
def test_prealign_pose_matches_jax(scene, bias):
    args = (scene["q_est"], scene["m_pose"], np.float32(bias), scene["query"], scene["q_mask"],
            scene["m_world"], scene["m_mask"])
    j = np.asarray(jbev.prealign_pose_jnp(*(jnp.asarray(a) for a in args)))
    p = bev_align.prealign_pose_t(*(torch.as_tensor(np.array(a)) for a in args)).numpy()
    np.testing.assert_allclose(p, j, atol=1e-5, rtol=0)


def test_host_prealign_pose_matches_jax(scene):
    args = (scene["q_est"], scene["m_pose"], 25, scene["query"], scene["q_mask"],
            scene["m_world"], scene["m_mask"])
    j = jbev.prealign_pose(*args)
    p = bev_align.prealign_pose(*args, device="cpu")
    np.testing.assert_allclose(p, j, atol=1e-5, rtol=0)
    # the yaw bias of the true relative rotation brings the query within a
    # cell of its true position
    assert np.linalg.norm(p[:2, 3] - scene["q_true"][:2, 3]) < 1.5
