"""The port's loop-closure detector (models/loop_closure.py: the Iris DB
on the device, K8a-K8c on their plain twins on the CPU) against the JAX
package's LoopClosureDetector on the same keyframe clouds, and the DB
carried across by convert.py.

Tolerance: the same candidate (query and match keyframe ids) and the same
Iris bias; similarity scores within 5e-3 (the descriptors' code bits may
differ where a float32 FFT response sits on its threshold; see
tests/test_torch_iris.py); an empty answer where JAX's is empty."""
import numpy as np
import pytest

from lidar_odometry_tpu.models.loop_closure import (LoopClosureConfig as JaxConfig,
                                                    LoopClosureDetector as JaxDetector)
from lidar_odometry_tpu_torch import convert
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.models.loop_closure import (LoopClosureConfig,
                                                          LoopClosureDetector)

GATES = dict(min_keyframe_gap=10, max_search_distance=6.0, similarity_threshold=0.45)


@pytest.fixture(scope="module")
def keyframes():
    """Sensor-frame clouds along 1.1 laps of a small circuit: the second
    lap revisits the first."""
    world = synthetic.make_world(seed=9, extent=40.0, n_buildings=12)
    poses = synthetic.circuit_trajectory(44, length=12.0, radius=5.0, step=1.3)
    rng = np.random.default_rng(9)
    out = []
    for p in poses:
        s = synthetic.sample_scan(world, p, 3000, rng, max_range=35.0, noise=0.02)
        cloud = np.zeros((3072, 3), np.float32)
        mask = np.zeros(3072, bool)
        cloud[:len(s)], mask[:len(s)] = s, True
        out.append((cloud, mask, p[:3, 3].astype(np.float32)))
    return out


def _run(det, kfs, queries):
    found = []
    for i, (cloud, mask, pos) in enumerate(kfs):
        det.add_keyframe(cloud, mask, i, pos)
        if i in queries:
            found.append([(c.query_keyframe_id, c.match_keyframe_id, c.similarity_score, c.bias)
                          for c in det.detect_loop_closures(cloud, mask, i, pos)])
    return found


def _same(jf, pf):
    assert len(jf) == len(pf)
    for a, b in zip(jf, pf):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x[0] == y[0] and x[1] == y[1] and x[3] == y[3], (x, y)
            assert abs(x[2] - y[2]) < 5e-3, (x, y)


def test_detector_matches_jax(keyframes):
    queries = set(range(30, 44, 2))
    jf = _run(JaxDetector(JaxConfig(**GATES), capacity=64), keyframes, queries)
    pf = _run(LoopClosureDetector(LoopClosureConfig(**GATES), capacity=64, device="cpu"),
              keyframes, queries)
    _same(jf, pf)
    assert sum(len(x) for x in pf) >= 2, pf


def test_db_carried_across_answers_as_jax(keyframes):
    jd = JaxDetector(JaxConfig(**GATES), capacity=64)
    for i, (cloud, mask, pos) in enumerate(keyframes[:36]):
        jd.add_keyframe(cloud, mask, i, pos)
    state = jd.export_state()
    pd = convert.loop_detector_from_numpy(state, LoopClosureConfig(**GATES), 64, device="cpu")
    back = pd.export_state()
    np.testing.assert_array_equal(back["iris_img"], state["iris_img"])
    np.testing.assert_array_equal(back["iris_T"].view(np.uint32), state["iris_T"])
    np.testing.assert_array_equal(back["iris_kf_ids"], state["iris_kf_ids"])
    cloud, mask, pos = keyframes[40]
    jc = jd.detect_loop_closures(cloud, mask, 40, pos)
    pc = pd.detect_loop_closures(cloud, mask, 40, pos)
    _same([[(c.query_keyframe_id, c.match_keyframe_id, c.similarity_score, c.bias) for c in jc]],
          [[(c.query_keyframe_id, c.match_keyframe_id, c.similarity_score, c.bias) for c in pc]])


def test_gating_and_a_full_db():
    det = LoopClosureDetector(LoopClosureConfig(min_keyframe_gap=10, max_search_distance=5.0,
                                                similarity_threshold=0.9),
                              capacity=2, device="cpu")
    rng = np.random.default_rng(0)
    cloud = rng.uniform(-20, 20, (2000, 3)).astype(np.float32)
    mask = np.ones(2000, bool)
    assert not det.add_keyframe(cloud, np.zeros(2000, bool), 9, np.zeros(3))
    det.add_keyframe(cloud, mask, 0, np.zeros(3, np.float32))
    assert det.detect_loop_closures(cloud, mask, 5, np.zeros(3, np.float32)) == []
    assert det.detect_loop_closures(cloud, mask, 50, np.asarray([100.0, 0, 0])) == []
    out = det.detect_loop_closures(cloud, mask, 50, np.zeros(3, np.float32))
    assert len(out) == 1 and out[0].match_keyframe_id == 0 and out[0].similarity_score < 0.05
    # fill the DB; an unknown query then uses the scratch row, never row 1
    det.add_keyframe(cloud[::-1].copy(), mask, 1, np.ones(3, np.float32))
    det.add_keyframe(cloud, mask, 2, np.zeros(3, np.float32))    # over capacity: dropped
    before = det._img[1].clone()
    out = det.detect_loop_closures(cloud * 0.5, mask, 99, np.zeros(3, np.float32))
    assert det._db_n == 2 and bool((det._img[1] == before).all())
    det.clear()
    assert det.detect_loop_closures(cloud, mask, 50, np.zeros(3, np.float32)) == []
