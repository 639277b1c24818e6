"""The port's whole slice — make_chunk_runner over 8 frames in two chunks —
against the JAX chunk runner on the same scans (CPU).

The JAX runner compiles one large program; it runs in a fresh subprocess
that writes its outputs to an .npz, so that compile never lands late in a
long-lived test worker (see the note in tests/conftest.py)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.eval import ate_rmse
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.models import fast_pipeline as tfp
from lidar_odometry_tpu_torch.ops import icp as ticp
from lidar_odometry_tpu_torch.ops import pko as tpko

ROOT = Path(__file__).resolve().parent.parent
KW = dict(scan_voxel_size=0.5, point_stride=1, scan_capacity=8192,
          keyframe_distance=1.0, keyframe_rotation=0.3, max_distance=120.0,
          planarity_threshold=0.1)
C1 = 8192
ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)

_JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from lidar_odometry_tpu.models import fast_pipeline as fp
    from lidar_odometry_tpu.ops import icp, pko
    d = np.load(sys.argv[1])
    kw = {k: d["kw_" + k].item() for k in %r}
    runner = fp.make_chunk_runner(icp.ICPConfig(max_iterations=4, voxel_size=0.5),
                                  pko.make_pko_constants(*%r), return_features=True, **kw)
    carry = fp.init_carry(0, %d)
    out = {}
    for c in range(2):
        carry, (p, kf, nc, feat, mask) = runner(carry, jnp.asarray(d["scans"][4 * c:4 * c + 4]))
        out.update({f"poses{c}": p, f"kf{c}": kf, f"nc{c}": nc, f"feat{c}": feat,
                    f"mask{c}": mask})
        if c == 0:
            # copied now: the next call donates the carry
            out.update({"c0_" + k: np.asarray(v) for k, v in carry._asdict().items()
                        if k != "map_state"})
            out.update({"c0_map_" + k: np.asarray(v)
                        for k, v in carry.map_state._asdict().items()})
    out.update({"map_" + k: v for k, v in carry.map_state._asdict().items()})
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""") % (tuple(KW), ARGS, C1)


def _scans(n_frames=8, seed=5):
    world = synthetic.make_world(seed=seed, extent=60.0, n_buildings=14)
    poses = synthetic.straight_trajectory(n_frames, step=0.4)
    rng = np.random.default_rng(seed)
    scans = np.full((n_frames, 6000, 3), np.nan, np.float32)
    for i in range(n_frames):
        s = synthetic.sample_scan(world, poses[i], 6000, rng, max_range=50.0, noise=0.01)
        scans[i, :len(s)] = s
    return scans, poses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scans, poses = _scans()
    tmp = tmp_path_factory.mktemp("pipeline")
    inp, outp = tmp / "in.npz", tmp / "jax.npz"
    np.savez(inp, scans=scans, **{"kw_" + k: v for k, v in KW.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(inp), str(outp)],
                          env=env, cwd=str(ROOT), timeout=600, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jax_out = dict(np.load(outp))

    runner = tfp.make_chunk_runner(ticp.ICPConfig(max_iterations=4, voxel_size=0.5),
                                   tpko.make_pko_constants(*ARGS, device="cpu"),
                                   return_features=True, **KW)
    carry = tfp.init_carry(0, C1, device="cpu")
    port = {}
    for c in range(2):
        carry, (p, kf, nc, feat, mask) = runner(carry, torch.tensor(scans[4 * c:4 * c + 4]))
        port.update({f"poses{c}": p.numpy(), f"kf{c}": kf.numpy(), f"nc{c}": nc.numpy(),
                     f"feat{c}": feat.numpy(), f"mask{c}": mask.numpy()})
    port.update({"map_" + k: v for k, v in convert.map_state_to_numpy(carry.map_state).items()})
    return scans, poses, jax_out, port


def _rot_err(A, B):
    R = A[:3, :3].astype(np.float64).T @ B[:3, :3].astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    return float(np.arcsin(min(np.linalg.norm(w), 1.0)))


def test_chunk_runner_matches_jax(runs):
    _, gt, jo, po = runs
    for c in range(2):
        np.testing.assert_array_equal(po[f"kf{c}"], jo[f"kf{c}"])
        np.testing.assert_array_equal(po[f"mask{c}"], jo[f"mask{c}"])
        np.testing.assert_allclose(po[f"feat{c}"], jo[f"feat{c}"], atol=2e-4)
        assert np.all(np.abs(po[f"nc{c}"] - jo[f"nc{c}"]) <= 2)
        for a, b in zip(po[f"poses{c}"], jo[f"poses{c}"]):
            np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=1e-3)
            assert _rot_err(a, b) < 1e-3
    est_p = np.concatenate([po["poses0"], po["poses1"]])
    est_j = np.concatenate([jo["poses0"], jo["poses1"]])
    assert ate_rmse(est_p, gt) < 0.05
    assert ate_rmse(est_j, gt) < 0.05
    assert po["kf0"].sum() + po["kf1"].sum() >= 3


def test_chunk_runner_map_matches_jax(runs):
    """The map after the 8 frames. The poses agree to ~1e-4 and the JAX
    features carry their prefix-sum error (< 2e-4), so a point on a voxel
    face may land one voxel over: the voxel and cell counts agree within
    0.1 %, and nearly every live cell key is shared."""
    _, _, jo, po = runs
    for k in ("n_l0", "n_l1"):
        a, b = int(po["map_" + k]), int(jo["map_" + k])
        assert abs(a - b) <= max(1, b // 1000), (k, a, b)
    live = lambda m: {tuple(r) for r in m[m[:, 0] != -1][:, :2]}
    pj, pp = live(jo["map_l1_meta"]), live(po["map_l1_meta"])
    assert len(pj & pp) >= 0.999 * len(pj)


def test_second_chunk_from_a_converted_jax_carry(runs):
    """The JAX carry after chunk 0, carried across by convert.py, runs
    chunk 1 in the port to the same poses and keyframes."""
    scans, _, jo, _ = runs
    carry = convert.carry_from_numpy(
        {**{k: jo["c0_" + k] for k in ("T_prev", "velocity", "last_kf_pose",
                                        "initialized", "kf_count")},
         "map_state": {k: jo["c0_map_" + k] for k in convert.MAP_FIELDS}}, device="cpu")
    runner = tfp.make_chunk_runner(ticp.ICPConfig(max_iterations=4, voxel_size=0.5),
                                   tpko.make_pko_constants(*ARGS, device="cpu"), **KW)
    carry, (p, kf, nc) = runner(carry, torch.tensor(scans[4:]))
    np.testing.assert_array_equal(kf.numpy(), jo["kf1"])
    for a, b in zip(p.numpy(), jo["poses1"]):
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=1e-3)
        assert _rot_err(a, b) < 1e-3
