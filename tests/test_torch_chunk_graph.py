"""The chunk runners as the JAX runner runs them: the keyframe map update
predicated on the device (no host read in the frame step) and, on the card,
each chunk one captured CUDA graph (models/fast_pipeline.GraphedChunk).

On the CPU: a non-keyframe's predicated update leaves every map tensor
bit-equal to no update; the predicated chunk equals a chunk that takes the
keyframe branch on the host, bit for bit; the frame step reads nothing on
the host; the launch counts and kept scratch of a capture (kernels.py).
The `cuda` tests hold the captured chunks against graph=False on the card
(tests/conftest.py imports jax; these tests need none):

    python -m pytest tests/test_torch_chunk_graph.py -q --noconftest -o addopts=""
"""
import sys
import threading

import numpy as np
import pytest
import torch

from lidar_odometry_tpu_torch import kernels
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.models import fast_pipeline as fp
from lidar_odometry_tpu_torch.ops import icp, pko
from lidar_odometry_tpu_torch.ops import voxel_map as vm
from lidar_odometry_tpu_torch.utils import lie

KW = dict(scan_voxel_size=0.5, point_stride=1, scan_capacity=4096,
          keyframe_distance=1.0, keyframe_rotation=0.3, max_distance=120.0,
          planarity_threshold=0.1)
ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)
C1 = 4096
MODES = {"surfel": dict(icp=dict(), compute_surfels=True),
         "kd": dict(icp=dict(use_surfel_correspondence=False), compute_surfels=False)}


def _scans(n_frames, seed=5, n_points=4000, step=0.6):
    world = synthetic.make_world(seed=seed, extent=60.0, n_buildings=14)
    poses = synthetic.straight_trajectory(n_frames, step=step)
    rng = np.random.default_rng(seed)
    scans = np.full((n_frames, n_points, 3), np.nan, np.float32)
    for i in range(n_frames):
        s = synthetic.sample_scan(world, poses[i], n_points, rng, max_range=50.0, noise=0.01)
        scans[i, :len(s)] = s
    return scans


def _runner(mode, device, **extra):
    m = MODES[mode]
    return fp.make_chunk_runner(icp.ICPConfig(max_iterations=4, voxel_size=0.5, **m["icp"]),
                                pko.make_pko_constants(*ARGS, device=device),
                                compute_surfels=m["compute_surfels"], **KW, **extra)


def _host_branch_runner(mode):
    """The chunk as the port ran it before the predication: the keyframe
    flag read on the host, the update called on keyframes only."""
    m = MODES[mode]
    cfg = icp.ICPConfig(max_iterations=4, voxel_size=0.5, **m["icp"])
    pre = fp._make_pre(cfg, pko.make_pko_constants(*ARGS, device="cpu"),
                       scan_voxel_size=KW["scan_voxel_size"], point_stride=1,
                       scan_capacity=KW["scan_capacity"],
                       keyframe_distance=KW["keyframe_distance"],
                       keyframe_rotation=KW["keyframe_rotation"])

    def chunk(carry, scans):
        outs = []
        for f in range(scans.shape[0]):
            T, velocity, is_kf, n_corr, feat, mask = pre(carry, scans[f])
            ms = carry.map_state
            if bool(is_kf):
                ms = vm.update_map(ms, lie.transform_points(T, feat), mask, T[:3, 3],
                                   KW["max_distance"], voxel_size=0.5,
                                   planarity_threshold=KW["planarity_threshold"],
                                   compute_surfels=m["compute_surfels"],
                                   evict_enabled=carry.kf_count % 4 == 0)
            carry = fp.OdomCarry(ms, T, velocity, torch.where(is_kf, T, carry.last_kf_pose),
                                 torch.ones((), dtype=torch.bool),
                                 carry.kf_count + is_kf.to(torch.int32))
            outs.append((T, is_kf, n_corr))
        return carry, tuple(torch.stack(c) for c in zip(*outs))

    return chunk


def _clone(state: vm.VoxelMapState) -> vm.VoxelMapState:
    return vm.VoxelMapState(*(t.clone() for t in state))


def _assert_maps_equal(a: vm.VoxelMapState, b: vm.VoxelMapState) -> None:
    for name, x, y in zip(vm.VoxelMapState._fields, a, b):
        assert x.shape == y.shape and torch.equal(x, y), name


@pytest.fixture(scope="module")
def scans():
    return torch.tensor(_scans(6))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_non_keyframe_update_leaves_the_map_bit_equal(scans, mode):
    """On a map of a few keyframes, with the keyframe count at a multiple
    of 4 (eviction due) and a radius of 2 m (every parent a candidate),
    the frame step's update for a non-keyframe leaves all ten map tensors
    as they were; the same call for a keyframe changes them."""
    runner = _runner(mode, "cpu", return_features=True)
    carry, (poses, is_kf, _nc, feats, masks) = runner(fp.init_carry(0, C1, device="cpu"),
                                                      scans[:5])
    assert int(is_kf.sum()) >= 3 and int(carry.map_state.n_l0) > 0
    carry = carry._replace(kf_count=torch.tensor(4, dtype=torch.int32))
    before = _clone(carry.map_state)
    world = lie.transform_points(poses[-1], feats[-1])
    for flag in (False, True):
        is_kf = torch.tensor(flag)
        out = vm.update_map(_clone(before), world, masks[-1] & is_kf, poses[-1][:3, 3], 2.0,
                            voxel_size=0.5, planarity_threshold=KW["planarity_threshold"],
                            compute_surfels=MODES[mode]["compute_surfels"],
                            evict_enabled=is_kf & (carry.kf_count % 4 == 0))
        if flag:
            assert not all(torch.equal(x, y) for x, y in zip(out, before))
        else:
            _assert_maps_equal(out, before)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_predicated_chunk_equals_the_host_branch(scans, mode):
    """The predicated frame step against the host-branch one: poses,
    keyframe flags, correspondence counts and the map bit-equal over two
    chunks; graph=True runs the same eager chunk on the CPU and captures
    nothing."""
    ref = _host_branch_runner(mode)
    runs = {}
    for name, run in (("host", ref), ("eager", _runner(mode, "cpu", graph=False)),
                      ("graph", _runner(mode, "cpu"))):
        carry, outs = fp.init_carry(0, C1, device="cpu"), []
        for c in range(2):
            carry, out = run(carry, scans[3 * c:3 * c + 3])
            outs.append(out)
        runs[name] = (carry, [torch.cat(col) for col in zip(*outs)])
        if name == "graph":
            assert isinstance(run, fp.GraphedChunk) and run.graphs == {}
    (hc, ho), kf = runs["host"], runs["host"][1][1]
    assert 0 < int(kf.sum()) < len(kf)
    for name in ("eager", "graph"):
        carry, out = runs[name]
        for a, b in zip(out, ho):
            assert torch.equal(a, b), name
        _assert_maps_equal(carry.map_state, hc.map_state)
        for a, b in zip(carry[1:], hc[1:]):
            assert torch.equal(a, b), name


def _no_host_reads(monkeypatch):
    """Make every host read of a tensor made from models/fast_pipeline.py
    itself raise (the CPU twins' own reads stay allowed: they never run
    on the card)."""
    def guard(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            if sys._getframe(1).f_code.co_filename.endswith("models/fast_pipeline.py"):
                raise AssertionError(f"host read ({name}) in the frame step")
            return orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)
    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist"):
        guard(name)


@pytest.mark.parametrize("mode", sorted(MODES) + ["blocked"])
def test_frame_step_reads_nothing_on_the_host(scans, mode, monkeypatch):
    if mode == "blocked":
        run = fp.make_blocked_runner(icp.ICPConfig(max_iterations=4, voxel_size=0.5),
                                     pko.make_pko_constants(*ARGS, device="cpu"), batch=2,
                                     block=2, graph=False, **KW)
        carry, chunk = fp.init_blocked_carry(2, 0, 2 * C1, device="cpu"), scans[None, :2]
        chunk = torch.cat([chunk, chunk + 1.0])
    else:
        run, carry, chunk = _runner(mode, "cpu", graph=False), fp.init_carry(
            0, C1, device="cpu"), scans[:3]
    _no_host_reads(monkeypatch)
    with pytest.raises(AssertionError, match="host read"):
        exec(compile("bool(torch.ones(()))", fp.__file__, "exec"), {"torch": torch})
    carry, out = run(carry, chunk)
    monkeypatch.undo()
    assert bool(torch.all(torch.isfinite(out[0])))


class _Stream:
    cuda_stream = 7


@pytest.fixture
def fake_launch(monkeypatch):
    """Kernel.launch and zeroed_scratch without a card: the entry point
    returns success, the current stream is a stand-in."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    k = kernels.KERNELS["voxel_filter"]
    monkeypatch.setattr(k, "_fn", lambda *a: 0)
    monkeypatch.setattr(kernels, "_scratch", {})
    kernels.reset_counts()
    yield k
    kernels.reset_counts()


def test_captured_launches_count_once_a_replay(fake_launch):
    """A launch under capturing() counts into the capture, not into
    counts(); add_replay adds the capture's counts (and fused counts) once
    a replay; another thread's launches during the capture count as
    before."""
    k11b = kernels.KERNELS["shard_alpha_normal_eq"]
    with kernels.capturing() as cap:
        fake_launch.launch()
        fake_launch.launch()
        other = threading.Thread(target=fake_launch.launch)
        other.start()
        other.join()
        k11b._fn = lambda *a: 0
        try:
            k11b.launch(fused=("shard_sample",))
        finally:
            k11b._fn = None
    assert cap.launches == {"voxel_filter": 2, "shard_alpha_normal_eq": 1}
    assert cap.fused == {"shard_sample": 1}
    assert kernels.counts()["voxel_filter"] == 1
    for _ in range(3):
        kernels.add_replay(cap)
    assert kernels.counts()["voxel_filter"] == 7
    assert kernels.counts()["shard_alpha_normal_eq"] == 3
    assert kernels.fused_counts()["shard_sample"] == 3


def test_capture_uses_scratch_allocated_before_it(fake_launch):
    """Under capture zeroed_scratch hands out the buffer it holds for the
    stream and the capture keeps it; a request it would have to allocate
    raises."""
    buf = kernels.zeroed_scratch("voxel_filter", "cpu", 300)
    with kernels.capturing() as cap:
        assert kernels.zeroed_scratch("voxel_filter", "cpu", 300) is buf
        with pytest.raises(kernels.KernelError, match="capture"):
            kernels.zeroed_scratch("voxel_filter", "cpu", 4096)
        with pytest.raises(kernels.KernelError, match="capture"):
            kernels.zeroed_scratch("map_bulk_merge", "cpu", 2)
    assert cap.scratch == [buf]
    assert kernels.zeroed_scratch("voxel_filter", "cpu", 4096).numel() == 4096


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return "cuda"


@pytest.fixture(scope="module")
def card_scans(dev):
    return torch.tensor(_scans(15), device=dev)


def _run_chunks(run, carry, chunks, dim=0):
    outs = []
    for ch in chunks:
        carry, out = run(carry, ch)
        outs.append(out)
    torch.cuda.synchronize()
    return carry, [torch.cat(col, dim) for col in zip(*outs)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES) + ["blocked"])
def test_captured_chunks_equal_eager_ones(dev, card_scans, mode):
    """Five chunks of 3 frames (a warm-up, a capture, three replays) through
    graph=True and graph=False: outputs and the map bit-equal, and equal
    kernel launch counts."""
    if mode == "blocked":
        lanes = torch.stack([card_scans, card_scans + 1.0])
        make = lambda g: fp.make_blocked_runner(
            icp.ICPConfig(max_iterations=4, voxel_size=0.5),
            pko.make_pko_constants(*ARGS, device=dev), batch=2, block=3, graph=g, **KW)
        init = lambda: fp.init_blocked_carry(2, 0, 2 * C1, device=dev)
        chunks, dim = [lanes[:, 3 * c:3 * c + 3] for c in range(5)], 1
    else:
        make = lambda g: _runner(mode, dev, graph=g)
        init = lambda: fp.init_carry(0, C1, device=dev)
        chunks, dim = [card_scans[3 * c:3 * c + 3] for c in range(5)], 0
    res = {}
    for g in (False, True):
        run = make(g)
        kernels.reset_counts()
        carry, out = _run_chunks(run, init(), chunks, dim)
        res[g] = carry, out, kernels.counts()
    assert len(run.graphs) == 1
    (ce, oe, ne), (cg, og, ng) = res[False], res[True]
    for a, b in zip(oe, og):
        assert torch.equal(a, b)
    _assert_maps_equal(ce.map_state, cg.map_state)
    assert ne == ng and ne["voxel_filter"] == 15


@pytest.mark.cuda
def test_captured_features_outlive_the_next_replay(dev, card_scans):
    """return_features=True (the Estimator's defer_host keeps each chunk's
    feats until it drains): the feats of a replayed chunk hold after the
    next replays, equal to the eager run's."""
    res = {}
    for g in (False, True):
        run = _runner("surfel", dev, return_features=True, graph=g)
        carry, kept = fp.init_carry(0, C1, device=dev), []
        for c in range(5):
            carry, out = run(carry, card_scans[3 * c:3 * c + 3])
            kept.append(out[3])
        torch.cuda.synchronize()
        res[g] = kept
    for a, b in zip(res[False], res[True]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_map_replaced_between_captured_chunks_is_used(dev, card_scans):
    """A carry whose map is not the graph's buffers (a restore, a rehash)
    is copied in: after the capture, chunk 3 runs from the eager run's
    state at that point, and then from a fresh empty map, as graph=False
    does."""
    eager, graphed = _runner("surfel", dev, graph=False), _runner("surfel", dev)
    chunks = [card_scans[3 * c:3 * c + 3] for c in range(5)]
    ce, _ = _run_chunks(eager, fp.init_carry(0, C1, device=dev), chunks[:3])
    cg, _ = _run_chunks(graphed, fp.init_carry(0, C1, device=dev), chunks[:3])
    assert len(graphed.graphs) == 1
    copy = lambda c: fp.OdomCarry(_clone(c.map_state), *(t.clone() for t in c[1:]))
    # every carry tensor new (a carry rebuilt from host state), then the
    # graph's own pose buffers with a fresh map (the Estimator's carry
    # after a rehash)
    a, oa = eager(copy(ce), chunks[3])
    b, ob = graphed(copy(ce), chunks[3])
    fresh = fp.init_carry(0, C1, device=dev).map_state
    a, oa2 = eager(copy(a)._replace(map_state=_clone(fresh)), chunks[4])
    b, ob2 = graphed(b._replace(map_state=_clone(fresh)), chunks[4])
    torch.cuda.synchronize()
    for x, y in zip(oa + oa2, ob + ob2):
        assert torch.equal(x, y)
    _assert_maps_equal(a.map_state, b.map_state)
    assert len(graphed.graphs) == 1
