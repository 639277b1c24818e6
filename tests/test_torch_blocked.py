"""The port's blocked multi-sequence runner — B = 2 lanes over one shared
map, a boot chunk of 4 frames at block=1, then 4 frames at block=4 —
against the JAX blocked runner on the same scans (CPU).

The JAX runner runs in a fresh subprocess that writes its outputs to an
.npz, as in tests/test_torch_pipeline.py."""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.eval import ate_rmse
from lidar_odometry_tpu_torch.models import fast_pipeline as tfp
from lidar_odometry_tpu_torch.ops import icp as ticp
from lidar_odometry_tpu_torch.ops import pko as tpko

from test_torch_pipeline import ARGS, KW, _rot_err, _scans

ROOT = Path(__file__).resolve().parent.parent
B = 2
C1 = 8192 * B
BOOT, BLOCK = 4, 4

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
    cfg, consts = icp.ICPConfig(max_iterations=4, voxel_size=0.5), pko.make_pko_constants(*%r)
    boot = fp.make_blocked_runner(cfg, consts, batch=%d, block=1, **kw)
    blocked = fp.make_blocked_runner(cfg, consts, batch=%d, block=%d, **kw)
    carry = fp.init_blocked_carry(%d, 0, %d)
    scans = d["scans"]
    out = {}
    carry, (p, kf, nc) = boot(carry, jnp.asarray(scans[:, :%d]))
    out.update(poses0=p, kf0=kf, nc0=nc)
    # copied now: the next call donates the carry
    out.update({"c0_" + k: np.asarray(v) for k, v in carry._asdict().items() if k != "map_state"})
    out.update({"c0_map_" + k: np.asarray(v) for k, v in carry.map_state._asdict().items()})
    carry, (p, kf, nc) = blocked(carry, jnp.asarray(scans[:, %d:]))
    out.update(poses1=p, kf1=kf, nc1=nc)
    out.update({"map_" + k: v for k, v in carry.map_state._asdict().items()})
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""") % (tuple(KW), ARGS, B, B, BLOCK, B, C1, BOOT, BOOT)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's many small CPU ops, as in
    tests/test_torch_estimator.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _runners():
    cfg = ticp.ICPConfig(max_iterations=4, voxel_size=0.5)
    consts = tpko.make_pko_constants(*ARGS, device="cpu")
    return (tfp.make_blocked_runner(cfg, consts, batch=B, block=1, **KW),
            tfp.make_blocked_runner(cfg, consts, batch=B, block=BLOCK, **KW))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    lanes = [_scans(seed=5 + b) for b in range(B)]
    scans = np.stack([s for s, _ in lanes])           # (B, 8, N, 3)
    gts = [p for _, p in lanes]
    tmp = tmp_path_factory.mktemp("blocked")
    inp, outp = tmp / "in.npz", tmp / "jax.npz"
    np.savez(inp, scans=scans, **{"kw_" + k: v for k, v in KW.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(inp), str(outp)],
                          env=env, cwd=str(ROOT), timeout=600, capture_output=True, text=True)
    print(f"JAX blocked runner subprocess: {time.perf_counter() - t0:.1f} s")
    assert proc.returncode == 0, proc.stderr[-4000:]
    jax_out = dict(np.load(outp))

    boot, blocked = _runners()
    carry = tfp.init_blocked_carry(B, 0, C1, device="cpu")
    port = {}
    carry, (p, kf, nc) = boot(carry, torch.tensor(scans[:, :BOOT]))
    port.update(poses0=p.numpy(), kf0=kf.numpy(), nc0=nc.numpy())
    carry, (p, kf, nc) = blocked(carry, torch.tensor(scans[:, BOOT:]))
    port.update(poses1=p.numpy(), kf1=kf.numpy(), nc1=nc.numpy())
    port.update({"map_" + k: v for k, v in convert.map_state_to_numpy(carry.map_state).items()})
    return scans, gts, jax_out, port


def _same_poses(a_all, b_all):
    for a_lane, b_lane in zip(a_all, b_all):
        for a, b in zip(a_lane, b_lane):
            np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=1e-3)
            assert _rot_err(a, b) < 1e-3


def test_blocked_runner_matches_jax(runs):
    _, gts, jo, po = runs
    for c in range(2):
        np.testing.assert_array_equal(po[f"kf{c}"], jo[f"kf{c}"])
        _same_poses(po[f"poses{c}"], jo[f"poses{c}"])
        assert po[f"poses{c}"].shape == (B, (BOOT, 8 - BOOT)[c], 4, 4)
    for b in range(B):
        est = np.concatenate([po["poses0"][b], po["poses1"][b]])
        # poses come back with the lane offsets removed
        assert ate_rmse(est, gts[b]) < 0.05
        assert po["kf0"][b].sum() + po["kf1"][b].sum() >= 2


def test_blocked_runner_map_matches_jax(runs):
    """The shared map after both chunks: the same n_dropped, voxel and cell
    counts within 0.1 %, and nearly every live cell key shared (as in
    test_torch_pipeline.py)."""
    _, _, jo, po = runs
    assert int(po["map_n_dropped"]) == int(jo["map_n_dropped"])
    for k in ("n_l0", "n_l1"):
        a, b = int(po["map_" + k]), int(jo["map_" + k])
        assert abs(a - b) <= max(1, b // 1000), (k, a, b)
    live = lambda m: {tuple(r) for r in m[m[:, 0] != -1][:, :2]}
    pj, pp = live(jo["map_l1_meta"]), live(po["map_l1_meta"])
    assert len(pj & pp) >= 0.999 * len(pj)


def test_blocked_chunk_from_a_converted_jax_carry(runs):
    """The JAX carry after the boot chunk, carried across by convert.py,
    runs the block=4 chunk in the port to the same poses and keyframes."""
    scans, _, jo, _ = runs
    carry = convert.carry_from_numpy(
        {**{k: jo["c0_" + k] for k in ("T_prev", "velocity", "last_kf_pose",
                                        "initialized", "kf_count")},
         "map_state": {k: jo["c0_map_" + k] for k in convert.MAP_FIELDS}}, device="cpu")
    assert carry.T_prev.shape == (B, 4, 4) and carry.initialized.shape == (B,)
    _, blocked = _runners()
    carry, (p, kf, _) = blocked(carry, torch.tensor(scans[:, BOOT:]))
    np.testing.assert_array_equal(kf.numpy(), jo["kf1"])
    _same_poses(p.numpy(), jo["poses1"])


def test_blocked_chunk_refuses_a_ragged_block():
    _, blocked = _runners()
    carry = tfp.init_blocked_carry(B, 0, 1024, device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        blocked(carry, torch.zeros((B, 3, 16, 3)))
