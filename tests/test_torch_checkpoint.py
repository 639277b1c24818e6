"""The port's checkpoint archives against the JAX package's (CPU).

Loops on (the Iris DB fills; a straight drive closes no loop), sync_loop,
16 frames of 8000 points, a checkpoint after frame 10, window_size 5.
The JAX package runs in one fresh subprocess: frames 0-9 and its archive
A, then A and B each restored by JAX's own restore and run over frames
10-15, and a version-2 rewrite of A offered to JAX's restore. Meanwhile
the port runs frames 0-9, saves archive B, and runs on to frame 15 (its
uninterrupted run). The port then holds:
  * A restored and saved again at once equal to A, entry by entry, bit
    for bit (names, dtypes, shapes, values);
  * each package's continuation from A, and from B, within 2e-3 of the
    other's, in positions and rotation entries;
  * its continuation from B within 1e-3 m of its uninterrupted run;
  * the keyframes older than the window spilled before the save and after
    the restore, their clouds exact;
  * a version-2 rewrite of A restored (JAX's restore raises
    AssertionError on it: it accepts versions 1 and 3 only), and a
    version-1 rewrite (no lc.* entries) restored with its Iris DB rebuilt
    from the clouds;
  * a save after process_chunk(defer_host=True) chunks holds every
    processed frame (JAX's save leaves a queued chunk queued and out of
    its archive);
  * a map sharded over a ShardGroup refused by save (JAX's save writes the
    sharded layout, and its restore loads it into a single-device map that
    fails at the next keyframe: tools/jax_sharded_checkpoint.py);
  * restore(device="cuda") raising where there is no CUDA device.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_odometry_tpu_torch import checkpoint
from lidar_odometry_tpu_torch.config import SystemConfig
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.models.estimator import Estimator

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(scan_capacity=4096, map_l0_capacity=65536, map_l1_capacity=16384,
           keyframe_capacity=128, point_stride=2, keyframe_distance_threshold=0.3,
           window_size=5, enable_loop_detection=True, enable_console_statistics=False)
N_FRAMES, SPLIT = 16, 10


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rewrite_archive(src, dst, version):
    """A copy of archive `src` in an older layout: version 2 stacks the
    padded clouds in kf.clouds (no kf.cloud.<id> entries); version 1 also
    has no lc.* entries."""
    import io
    import json
    import zipfile
    import numpy as np
    data = np.load(src)
    arrays = {k: data[k] for k in data.files if not k.startswith("kf.cloud.")}
    if version == 1:
        arrays = {k: v for k, v in arrays.items() if not k.startswith("lc.")}
    clouds = []
    for i, kf_id in enumerate(data["kf.ids"]):
        mask = data["kf.masks"][i]
        cloud = np.zeros((mask.shape[0], 3), np.float32)
        cloud[mask] = data[f"kf.cloud.{int(kf_id):06d}"]
        clouds.append(cloud)
    arrays["kf.clouds"] = np.stack(clouds)
    meta = json.loads(bytes(data["meta_json"]).decode())
    meta["version"] = version
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with zipfile.ZipFile(dst, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(arr), allow_pickle=False)
            zf.writestr(name + ".npy", buf.getvalue())


_JAX_SIDE = textwrap.dedent("""
    import json, sys, time
    from pathlib import Path
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lidar_odometry_tpu import checkpoint
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.models.estimator import Estimator
    scans = np.load(sys.argv[1])["scans"]
    tmp = Path(sys.argv[2])
    cfg = SystemConfig(**json.loads(sys.argv[3]))
    split = int(sys.argv[4])
    est = Estimator(cfg, sync_loop=True)
    for s in scans[:split]:
        est.process_frame(s)
    checkpoint.save(str(tmp / "a.npz"), est)
    # a chunk still queued for host bookkeeping (process_chunk(defer_host=
    # True)): JAX's save neither drains nor reads it
    est._deferred_chunks.append("a queued chunk")
    checkpoint.save(str(tmp / "a_queued.npz"), est)
    out = {"queued_left": np.array(len(est._deferred_chunks))}
    est.shutdown()
    for name in ("a", "b"):
        while not (tmp / f"{name}.npz").exists():    # the port writes b.npz meanwhile
            time.sleep(0.05)
        est = checkpoint.restore(str(tmp / f"{name}.npz"), cfg, sync_loop=True)
        for s in scans[split:]:
            est.process_frame(s)
        out[f"traj_{name}"] = est.trajectory()
        est.shutdown()
    rewrite_archive(str(tmp / "a.npz"), str(tmp / "a_v2.npz"), 2)
    try:
        checkpoint.restore(str(tmp / "a_v2.npz"), cfg, sync_loop=True)
        out["v2"] = np.array("restored")
    except AssertionError:
        out["v2"] = np.array("AssertionError")
    np.savez(tmp / "jax.npz", **out)
""")


def _scans():
    world = synthetic.make_world(seed=17, extent=60.0, n_buildings=12)
    poses = synthetic.straight_trajectory(N_FRAMES, step=0.4)
    rng = np.random.default_rng(17)
    scans = np.full((N_FRAMES, 8192, 3), np.nan, np.float32)
    for i in range(N_FRAMES):
        s = synthetic.sample_scan(world, poses[i], 8000, rng, max_range=50.0, noise=0.01)
        scans[i, :len(s)] = s
    return scans


def _entries(path):
    data = np.load(path)
    return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scans = _scans()
    tmp = tmp_path_factory.mktemp("checkpoint")
    np.savez(tmp / "in.npz", scans=scans)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    script = textwrap.dedent(inspect.getsource(rewrite_archive)) + _JAX_SIDE
    log = open(tmp / "jax.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", script, str(tmp / "in.npz"), str(tmp),
                             json.dumps(CFG), str(SPLIT)], env=env, cwd=str(ROOT),
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        cfg = SystemConfig(**CFG)
        est = Estimator(cfg, sync_loop=True, device="cpu")
        for s in scans[:SPLIT]:
            assert est.process_frame(s)
        spilled_before = [kf.kf_id for kf in est.keyframes if kf.is_spilled]
        clouds = {kf.kf_id: kf.feature_cloud[kf.feature_mask].copy() for kf in est.keyframes}
        checkpoint.save(str(tmp / "b.part.npz"), est)
        os.replace(tmp / "b.part.npz", tmp / "b.npz")
        spilled_after_save = [kf.kf_id for kf in est.keyframes if kf.is_spilled]
        for s in scans[SPLIT:]:
            assert est.process_frame(s)
        uninterrupted = est.trajectory()
        est.shutdown()
        proc.wait(timeout=600)
    finally:
        proc.kill()
        log.close()
    assert proc.returncode == 0, (tmp / "jax.log").read_text()[-4000:]
    return dict(scans=scans, tmp=tmp, cfg=cfg, jax=dict(np.load(tmp / "jax.npz")),
                uninterrupted=uninterrupted, spilled_before=spilled_before,
                spilled_after_save=spilled_after_save, clouds=clouds)


def _continue(est, scans):
    for s in scans[SPLIT:]:
        assert est.process_frame(s)
    traj = est.trajectory()
    est.shutdown()
    return traj


def _close(a, b, tol):
    assert a.shape == b.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=tol)
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=tol)


def test_jax_archive_round_trips_bit_for_bit(runs):
    """The port restores JAX's archive A and saves it again at once: the
    same entries, dtypes, shapes and bytes."""
    tmp = runs["tmp"]
    est = checkpoint.restore(str(tmp / "a.npz"), runs["cfg"], sync_loop=True, device="cpu")
    checkpoint.save(str(tmp / "a_again.npz"), est)
    est.shutdown()
    a, again = _entries(tmp / "a.npz"), _entries(tmp / "a_again.npz")
    assert sorted(again) == sorted(a)
    assert any(k.startswith("kf.cloud.") for k in a) and a["lc.iris_kf_ids"].size >= 5
    for k in a:
        assert (again[k].dtype, again[k].shape) == (a[k].dtype, a[k].shape), k
        assert again[k].tobytes() == a[k].tobytes(), k


@pytest.mark.parametrize("archive", ["a", "b"])
def test_both_packages_continue_alike(runs, archive):
    """From JAX's archive A and from the port's B alike, the port's
    continuation and JAX's (its own restore) agree within 2e-3."""
    est = checkpoint.restore(str(runs["tmp"] / f"{archive}.npz"), runs["cfg"], sync_loop=True,
                             device="cpu")
    assert est.frame_count == SPLIT and len(est.frames) == SPLIT
    _close(_continue(est, runs["scans"]), runs["jax"][f"traj_{archive}"], 2e-3)


def test_resume_matches_the_uninterrupted_run(runs):
    """The port resumed from its own archive B against its run that went on
    without a break (the gap is printed)."""
    est = checkpoint.restore(str(runs["tmp"] / "b.npz"), runs["cfg"], sync_loop=True,
                             device="cpu")
    traj = _continue(est, runs["scans"])
    gap = np.abs(traj[:, :3, 3] - runs["uninterrupted"][:, :3, 3]).max()
    print(f"resume gap {gap:.3e} m")
    assert gap <= 1e-3


def test_tiering_survives_the_round_trip(runs):
    """Saving leaves the spilled keyframes spilled; the restore lands the
    keyframes older than the window in the spool and the rest resident,
    every cloud exact."""
    w = CFG["window_size"]
    est = checkpoint.restore(str(runs["tmp"] / "b.npz"), runs["cfg"], sync_loop=True,
                             device="cpu")
    n_kf = est.get_keyframe_count()
    assert n_kf > w + 2
    assert runs["spilled_before"] == runs["spilled_after_save"]
    assert len(runs["spilled_before"]) == n_kf - w
    assert [kf.kf_id for kf in est.keyframes if kf.is_spilled] == runs["spilled_before"]
    assert os.path.isdir(est._spool_dir)
    for kf in est.keyframes:
        np.testing.assert_array_equal(kf.feature_cloud[kf.feature_mask], runs["clouds"][kf.kf_id])
    est.shutdown()


@pytest.mark.parametrize("version", [2, 1])
def test_older_archives_restore(runs, version):
    """Version 2 (stacked clouds) restores as A does, where JAX's restore
    raises AssertionError; version 1 (no lc.* entries) rebuilds the Iris
    DB from the clouds: the same keyframe ids and images, and code words
    that agree with JAX's in all but the rare words whose filter response
    sits on the threshold (tests/test_torch_iris.py)."""
    tmp = runs["tmp"]
    old = tmp / f"a_v{version}_port.npz"
    rewrite_archive(str(tmp / "a.npz"), str(old), version)
    if version == 2:
        assert str(runs["jax"]["v2"]) == "AssertionError"
    ref = checkpoint.restore(str(tmp / "a.npz"), runs["cfg"], sync_loop=True, device="cpu")
    est = checkpoint.restore(str(old), runs["cfg"], sync_loop=True, device="cpu")
    assert [k.kf_id for k in est.keyframes] == [k.kf_id for k in ref.keyframes]
    assert [k.is_spilled for k in est.keyframes] == [k.is_spilled for k in ref.keyframes]
    for k, r in zip(est.keyframes, ref.keyframes):
        np.testing.assert_array_equal(k.feature_cloud, r.feature_cloud)
        np.testing.assert_array_equal(k.stored_pose, r.stored_pose)
    got, want = est.loop_detector.export_state(), ref.loop_detector.export_state()
    for name in ("iris_kf_ids", "iris_img", "iris_positions") + ("iris_T", "iris_M") * (
            version == 2):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("iris_T", "iris_M"):
        assert np.mean(got[name] == want[name]) > 0.99, name
    np.testing.assert_array_equal(est.trajectory(), ref.trajectory())
    est.shutdown()
    ref.shutdown()


def test_save_drains_deferred_chunks(runs, tmp_path):
    """Loops off, two chunks through process_chunk(defer_host=True): the
    archive holds all 8 frames, and restores them. JAX's save left the
    chunk queued in its estimator (its archive has the 10 frames before
    it)."""
    assert int(runs["jax"]["queued_left"]) == 1
    assert len(np.load(runs["tmp"] / "a_queued.npz")["fr.kf_ref"]) == SPLIT
    cfg = runs["cfg"].replace(enable_loop_detection=False)
    est = Estimator(cfg, device="cpu")
    scans = runs["scans"]
    est.process_chunk(scans[0:4], defer_host=True)
    est.process_chunk(scans[4:8], defer_host=True)
    path = str(tmp_path / "deferred.npz")
    checkpoint.save(path, est)
    assert not est._deferred_chunks
    data = np.load(path)
    assert len(data["fr.kf_ref"]) == 8
    assert json.loads(bytes(data["meta_json"]).decode())["frame_count"] == 8
    back = checkpoint.restore(path, cfg, device="cpu")
    np.testing.assert_array_equal(back.trajectory(), est.trajectory())
    assert back.get_keyframe_count() == est.get_keyframe_count() >= 4


def test_sharded_map_and_missing_card_are_refused(runs, tmp_path):
    from lidar_odometry_tpu_torch.models.map_backend import ShardedMapBackend
    from lidar_odometry_tpu_torch.parallel import mesh
    cfg = runs["cfg"].replace(enable_loop_detection=False)
    est = Estimator(cfg, sync_loop=True, device="cpu",
                    map_backend=ShardedMapBackend(cfg, mesh.make_group(2, device="cpu")))
    with pytest.raises(ValueError, match="sharded"):
        checkpoint.save(str(tmp_path / "sharded.npz"), est)
    assert not (tmp_path / "sharded.npz").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            checkpoint.restore(str(runs["tmp"] / "b.npz"), runs["cfg"])
    with zipfile.ZipFile(runs["tmp"] / "b.npz") as zf:
        assert all(n.endswith(".npy") for n in zf.namelist())
