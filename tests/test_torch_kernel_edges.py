"""The plain twins of K1 and K10c on the edge cases their card tests
(tests/test_torch_kernels.py) hold the kernels to, on the CPU.

K1: scans made of voxel runs of known lengths (synthetic.voxel_runs) that
cross the kernel's 512-entry tiles, one run longer than a tile, n not a
multiple of the tile, all keys invalid, more voxels than the output
capacity. The port's filter against the JAX filter (below the capacity:
the JAX filter folds the segments past it into the last kept one, a fault
the port does not copy) at the 2e-4 of tests/test_torch_voxel_filter.py,
and against a numpy float64 per-voxel mean at 2e-5 (a run of 1500 points
adds 1500 float32 terms).

K10c: synthetic separator systems (synthetic.separator_system) at D = 1,
D not a multiple of the kernel's 4-separator panel, and D = 200, with a
loop block given twice and an invalid loop: the twin's xs against a numpy
float64 assembly of the same blocks (scatter-adds, then (H + H^T) / 2)
solved by numpy at 1e-10 of max|xs|, its backward error at most 1e-13, and
NaN everywhere for a system that is not positive definite.

K10b: interior eliminations over partition plans (dpgo.make_plan) of
block-tridiagonal systems (synthetic.chain_system) whose partitions have
one valid row, no valid row, the left coupling at the first valid row,
no left separator (has_left false) or no interior (ur_valid false), and
chains longer than the kernel's 16-row staging ring: the twin's S, r, F,
G and g against JAX's vmapped _eliminate_interior_spd under x64 at 1e-10
of each output's largest magnitude.

K3: residual sets (synthetic.pko_residuals) with n not a multiple of the
kernel's 32-entry tiles, fewer than 100 valid, one valid, none valid, one
whose EM stops before its 100-round cap and one that runs to it: the
twin's count, alpha index and iteration-0 scale against the JAX program
(norm scale, stratified sample, GMM and JS argmin) on the same input, the
scale at 1e-6 relative (the sums differ in order), the rest exactly; and
the twin's alpha index over K11d's 104 merged samples (8 shards) against
JAX's with its own k-means draw over 104.

K8g: the twin's products at b = 1, 5 and 16 against a numpy float32
product of re and im by the filter, and against JAX's broadcast complex
product with subnormals flushed as XLA on the CPU flushes them, exactly.

K2b: correspondence rows (synthetic.normal_eq_rows) with n not a multiple
of the kernel's cluster of 8 x 512 threads, n below a warp, no valid row,
fewer valid rows than min_correspondence_points, normals with no x
component (the elimination swaps rows), steps just below and above the
1e-6 small-angle threshold, a NaN residual (a non-finite step, which
leaves T as it was) and the Cauchy loss: the twin's T against JAX's
_robust_weights and _gn_step at tests/test_torch_icp.py's tolerances
(translation 1e-4, rotation 1e-4 rad), its H (with the 1e-8 floor) at 1e-5
of the largest entry, its flags exactly.

K11b: shard rows with a row count that is not a multiple of the kernel's
32-row chunk, A = 1 (no PKO) and A = 101, a shard with no valid row, a
done lane and the robust loss off: the twin's (A, 42) systems against
JAX's W @ Z as sharded_map.py:318-330 writes it at 1e-5 of the largest
entry, the count exactly, a done lane's rows unwritten.

K4c: child tables (synthetic.surfel_blocks) with every row dead, dead rows
between live ones, parents of 1, 5 and 27 children, equal eigenvalues (a
lattice of 27 children, and a flat square of 9), R not a multiple of the
kernel's 8 parents a block and R = c1 (the rehash's every slot): the
reordered twin (its sums in the kernel's butterfly order) against JAX's
_block_stats, eigh3 and planarity verdict at tests/test_torch_voxel_map.py's
tolerances (means and planarity 1e-4, normals 1e-4 where the two smallest
eigenvalues are apart), the live-child masks exactly, the verdicts exactly
outside a 1e-5 band around the threshold.

K11a: points (synthetic.shard_points) all owned by one shard (over > 0),
none owned, n not a multiple of the kernel's cluster tile of 16384, a rank
holding shards 1-2 of 4 (first > 0, n_local < n_shards), S = 1 (cap = N),
S = 8, and 2 lanes at two poses: the twin's (p_own, ok, sel, over) equal
to JAX's _compact_owned of owner_of_points (of the points the twin hashes,
moved in the twin's rounding where there is a pose).

K6b: point tables (synthetic.knn_cloud) whose 2 m bins hold more rows than
the widest probe, one 150 m wide at 0.5 m bins (the binary-search path),
one on a 0.25 m lattice with repeated points (exact ties in the squared
distance across bins and within one) and one with every row valid whose
last bin is shorter than the probe (the clamp repeats the last row as an
ok candidate); query counts that are not a multiple of the kernel's warp
a query or 8-query block, queries with fewer than k candidates and with
none; r = 1 and 2, W = 4, 5, 8 and 16, k = 5 and 1: the twin's neighbours
(every slot) and ok flags equal to JAX's knn_query, its distances within
1e-6.

K5b: candidate sets (synthetic.plane_candidates) with exact ties, fewer
than 5 ok candidates, collinear nearest three and all-masked rows, at k =
5 and 8 (the kernel's group of 8 lanes a point), 9, 27 and 125 (16 lanes a
point; 125 not a multiple of 16), row counts not a multiple of the
kernel's 4 or 8 points a warp: the twin's selection equal to jax.lax.top_k's,
its validity flags and nearest point equal to JAX's _plane_fit_5nn, the
centroid within 1e-5, and where the two smallest eigenvalues of the 5
points' covariance are more than 1e-2 of the largest apart
(tests/test_torch_grid_knn.py's rule) the normal within 1e-5 and the
distance within 1e-4 (the normal's float32 error times coordinates of up
to ~9 m).

K11c: shard rows (synthetic.normal_eq_shards) at S = 1 with two lanes and
n not a multiple of the kernel's 16-flag loads (rows off their 16-byte
alignment), S = 2 with fewer valid entries than the quota, S = 4 with a
shard of no valid entry and with n past one tile of 16384 flags, S = 8
with a done lane: the twin's sample and ok slots exactly JAX's
stratified_sample of |r| / scale with fold_in(PRNGKey(42), shard), zero
in every other shard's slots, a done lane's rows unwritten. (The card
cases of K11c and K5a are in tests/test_torch_kernels.py; K5a's twin with
the row mask against JAX is in tests/test_torch_grid_knn.py.)

K4b: key-sorted points (synthetic.scatter_add_inputs) in runs of 1, 2 and
300 points, a run across two of the kernel's 256-row block ends, a long
invalid tail run, unplaced parents (their leaders go to the sink) and p
not a multiple of 256: the twin's rows exactly JAX's segment_sum and
unique row scatter-add as voxel_map.py:501-507 and :542-548 write them
(mode="drop"), and within 1e-6 of a numpy float64 per-voxel sum,
relative to the sum of its terms' magnitudes; the sink row stays zero.

K10d: back-substitution inputs (synthetic.backsub_system) at n_pad = 17,
300, 4096 (the kernel's one cluster of 16 x 256 threads) and 8192 (past
it), with real_mask rows of zero, a NaN in dx and an inactive loop state:
dx and |dx| against numpy float64 at 1e-12, the retracted poses against
the poses times JAX's _bse3_exp of the same dx under x64 at 1e-12, and
the loop state as the while_loop sets it; a non-finite dx or an inactive
state leaves every pose as it was.

K8c: comparisons (synthetic.iris_hamming_case) at K = 1, 2 and 32 with
invalid padding, shifts at and beside +-180 and across the column wrap, a
candidate equal to the query (distance 0), an all-masked candidate
(+inf), equal distances across the shifts (the first minimum) and across
the orientations (the flipped one): the twin's distances and biases bit
for bit JAX's _hamming_over_shifts and _compare_one's choice at the same
given shifts.

K6a: clouds (synthetic.point_grid_cloud) that fit the dense window, that
are one bin too wide in x, y or z, with no valid row, one valid row, 3089
rows (not a multiple of the kernel's CTA), 20000 rows (past one round of
its cluster), points in the window's last bin and duplicate keys: the
twin's grid, origin, fits and count exactly JAX build_point_table's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_odometry_tpu.ops import icp as jicp
from lidar_odometry_tpu.ops import iris as jiris
from lidar_odometry_tpu.ops import knn as jknn
from lidar_odometry_tpu.ops import pko as jpko
from lidar_odometry_tpu.ops import voxel_filter as jvf
from lidar_odometry_tpu.ops import voxel_map as jvm
from lidar_odometry_tpu.parallel import distributed_pgo as jdpgo
from lidar_odometry_tpu.parallel import sharded_map as jsm
from lidar_odometry_tpu.utils import eigh3 as jeigh3
from lidar_odometry_tpu.utils import lie as jlie
from lidar_odometry_tpu_torch.io import synthetic
from lidar_odometry_tpu_torch.ops import icp as ticp
from lidar_odometry_tpu_torch.ops import iris as tiris
from lidar_odometry_tpu_torch.ops import knn as tknn
from lidar_odometry_tpu_torch.ops import pko as tpko
from lidar_odometry_tpu_torch.ops import voxel_filter as tvf
from lidar_odometry_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
from lidar_odometry_tpu_torch.parallel import shard_ops as so

# the card tests' K1 cases: (run lengths, invalid rows, cap)
K1_CASES = {
    "runs_cross_tile_boundaries": ([3] * 700, 0, 8192),
    "run_longer_than_a_tile": ([2] * 300 + [1500] + [1] * 200, 0, 8192),
    "n_not_a_multiple_of_the_tile": ([1, 2, 5] * 333, 7, 8192),
    "all_keys_invalid": ([], 1000, 256),
    "more_voxels_than_cap": ([2] * 900 + [1] * 900, 0, 1000),
}


def _numpy_means(raw, voxel=0.5):
    """Per-voxel float64 means in the compact key's x-major order."""
    pts = raw[np.all(np.isfinite(raw), axis=1)].astype(np.float64)
    keys = np.floor(pts / voxel).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv.reshape(-1), pts)
    return sums / np.bincount(inv.reshape(-1), minlength=len(uniq))[:, None]


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_voxel_filter_twin_on_kernel_edges(case):
    counts, n_invalid, cap = K1_CASES[case]
    raw = synthetic.voxel_runs(counts, n_invalid, seed=len(counts))
    n = raw.shape[0]
    tc, tm, tn = tvf.voxel_filter(torch.as_tensor(raw), n, voxel_size=0.5, stride=1,
                                  out_capacity=cap, compact_keys=True)
    assert int(tn) == len(counts)
    live = min(len(counts), cap)
    assert tm.numpy().tolist() == [True] * live + [False] * (cap - live)
    assert np.all(tc.numpy()[live:] == 0.0)
    mean = _numpy_means(raw)
    np.testing.assert_allclose(tc.numpy()[:live], mean[:live], atol=2e-5)
    if len(counts) < cap:
        jc, jm, jn = jvf.voxel_filter(jnp.asarray(raw), jnp.int32(n), voxel_size=0.5, stride=1,
                                      out_capacity=cap, compact_keys=True)
        assert int(jn) == len(counts)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)


def _numpy_separator_solve(c):
    """xs of the separator system assembled block by block in float64
    numpy, in the order of the JAX scatter-adds, symmetrised and solved."""
    D = len(c["seps"])
    H = np.zeros((D, D, 6, 6))
    bs = np.zeros((D, 6))
    S = c["S"]
    for k in range(D):
        H[k, k] += c["diag"][c["seps"][k]] + S[k, 3]
        bs[k] += c["b"][c["seps"][k]] + c["r"][k, 1]
        if k > 0:
            H[k - 1, k - 1] += S[k, 0]
            H[k - 1, k] += S[k, 1]
            H[k, k - 1] += S[k, 2]
            bs[k - 1] += c["r"][k, 0]
        if c["adj_mask"][k]:
            H[k, k + 1] += c["off"][c["adj_off"][k]]
            H[k + 1, k] += c["off"][c["adj_off"][k]].T
    for l in range(len(c["loop_a"])):
        if c["loop_valid"][l]:
            H[c["loop_a"][l], c["loop_b"][l]] += c["lb"][l]
            H[c["loop_b"][l], c["loop_a"][l]] += c["lb"][l].T
    Hs = H.transpose(0, 2, 1, 3).reshape(6 * D, 6 * D)
    return np.linalg.solve((Hs + Hs.T) / 2, bs.reshape(-1)).reshape(D, 6)


def _twin(c):
    t = {k: torch.as_tensor(v) for k, v in c.items()}
    return dpgo.reduced_solve_plain(*[t[k] for k in ("diag", "off", "b", "lb", "S", "r")],
                                    *[t[k] for k in dpgo.RED_KEYS])


@pytest.mark.parametrize("D", [1, 5, 7, 200])
def test_separator_solve_twin_on_kernel_edges(D):
    c = synthetic.separator_system(D, 6, seed=D)
    assert D < 3 or len(c["loop_a"]) == 7   # 6 loops, the first pair twice, the last invalid
    xs, Hs, bs = _twin(c)
    ref = _numpy_separator_solve(c)
    np.testing.assert_allclose(xs.numpy(), ref, atol=1e-10 * np.abs(ref).max(), rtol=0)
    x = xs.reshape(-1)
    backward = float((Hs @ x - bs).abs().max() / (Hs.abs().sum(1).max() * x.abs().max()))
    assert backward <= 1e-13


def test_separator_solve_twin_not_positive_definite():
    xs = _twin(synthetic.separator_system(9, 3, seed=3, spd=False))[0]
    assert bool(torch.isnan(xs).all())


# the card tests' K10b cases: (n_pad, separators); partitions' valid rows:
#   one_row_each: 1, 0, 1, 0, 1 (max_m = 1)
#   edges: 3 (no left separator), 0, 1, 23, 0, 31 (max_m 31, past the ring)
#   long_chain: 200, 54
K10B_CASES = {
    "one_row_each": (8, [1, 2, 4, 5, 7]),
    "edges": (64, [3, 4, 6, 30, 31, 63]),
    "long_chain": (256, [200, 255]),
}


def _jax_eliminate(plan, diag, off, b):
    """JAX _gn_device's interior packing of the plan, then the vmapped
    _eliminate_interior_spd, under x64: (S, r, F, G, g) as numpy."""
    p = {k: (plan[k].astype(bool) if k in ("valid", "ovalid", "has_left", "ur_valid")
             else plan[k]) for k in dpgo.PLAN_KEYS}
    max_m = p["int_idx"].shape[1]
    Dint = np.where(p["valid"][..., None, None], diag[p["int_idx"]], np.eye(6))
    Oint = np.where(p["ovalid"][..., None, None], off[p["off_idx"]], 0.0)
    if max_m == 1:
        Oint = Oint[:, :0]
    Bint = np.where(p["valid"][..., None], b[p["int_idx"]], 0.0)
    Lleft = np.where(p["has_left"][:, None, None], np.swapaxes(off[p["left_off"]], -1, -2), 0.0)
    Lsep = np.eye(max_m)[p["lsep_row"]][..., None, None] * Lleft[:, None]
    Uright = np.where(p["ur_valid"][:, None, None], off[p["uright_off"]], 0.0)
    with jax.enable_x64():
        (s_ll, s_lr, s_rl, s_rr, r_l, r_r), (F, G, g) = jax.vmap(jdpgo._eliminate_interior_spd)(
            *map(jnp.asarray, (Dint, Oint, Bint, Lsep, Lleft, Uright, p["valid"])))
        return (np.stack([np.asarray(x) for x in (s_ll, s_lr, s_rl, s_rr)], 1),
                np.stack([np.asarray(r_l), np.asarray(r_r)], 1), np.asarray(F), np.asarray(G),
                np.asarray(g))


@pytest.mark.parametrize("case", sorted(K10B_CASES))
def test_eliminate_twin_on_kernel_edges(case):
    n_pad, seps = K10B_CASES[case]
    c = synthetic.chain_system(n_pad, seed=n_pad)
    plan = dpgo.make_plan(n_pad, seps)
    valid = plan["valid"].sum(1)
    assert plan["max_m"] == {"one_row_each": 1, "edges": 31, "long_chain": 200}[case]
    if case == "edges":
        assert valid.tolist() == [3, 0, 1, 23, 0, 31]
        assert not plan["has_left"][0] and not plan["ur_valid"][1]
    assert np.all(plan["lsep_row"][plan["has_left"]]
                  == plan["max_m"] - valid[plan["has_left"]])   # at the first valid row
    g = {k: torch.as_tensor(plan[k].astype(np.int32)) for k in dpgo.PLAN_KEYS}
    got = dpgo.eliminate(g, *(torch.as_tensor(c[k]) for k in ("diag", "off", "b")))
    ref = _jax_eliminate(plan, c["diag"], c["off"], c["b"])
    for name, o, r in zip(("S", "r", "F", "G", "g"), got, ref):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-10 * np.abs(r).max(),
                                   err_msg=name)


# the card tests' K3 cases: (n, kind, seed, n_valid or None for ~80 %)
K3_CASES = {
    "n_not_a_multiple_of_32": (14339, "mixture", 2, None),
    "fewer_than_100_valid": (14336, "wide", 3, 37),
    "one_valid": (14336, "wide", 4, 1),
    "none_valid": (14336, "wide", 5, 0),
    "em_stops_early": (14336, "mixture", 1, None),
    "em_runs_to_the_cap": (14336, "mixture", 0, None),
}
PKO_ARGS = (0.1, 10.0, 100, 10.0, "huber", 3, 100)


@pytest.fixture(scope="module")
def pko_consts():
    return jpko.make_pko_constants(*PKO_ARGS), tpko.make_pko_constants(*PKO_ARGS, device="cpu")


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_pko_twin_on_kernel_edges(pko_consts, case):
    jc, tc = pko_consts
    n, kind, seed, n_valid = K3_CASES[case]
    r, valid = synthetic.pko_residuals(n, kind, seed, n_valid)
    key = jax.random.PRNGKey(42)
    r_abs = jnp.abs(jnp.asarray(r))
    scale = jicp._norm_scale_from(r_abs, jnp.asarray(valid))
    samples, _ = jpko.stratified_sample(r_abs / jnp.maximum(scale, 1e-6), jnp.asarray(valid),
                                        100, key)
    ref = int(jpko.pko_alpha_index_from_samples(samples, jc, key=key))

    aux, s = tpko.pko_alpha_index(torch.as_tensor(r), torch.as_tensor(valid),
                                  torch.zeros((3,), dtype=torch.int32), torch.ones((1,)), True, tc)
    assert aux.tolist() == [int(valid.sum()), ref]
    np.testing.assert_allclose(float(s[0]), float(scale), rtol=1e-6)
    t_samples = tpko.stratified_sample(torch.as_tensor(np.abs(r)) / torch.clamp(s[0], min=1e-6),
                                       torch.as_tensor(valid), tc.u)
    *_, (km, em) = tpko.fit_gmm(t_samples, tc.pick, rounds=True)
    assert 1 <= km <= 100
    if case == "em_stops_early":
        assert em < 100
    if case == "em_runs_to_the_cap":
        assert em == 100


def test_pko_twin_over_the_merged_samples_of_8_shards(pko_consts):
    jc, tc = pko_consts
    _, pick = tpko.shard_draws(8)
    r, valid = synthetic.pko_residuals(104 * 3, "mixture", 8)
    samples = (np.abs(r[valid][:104]) / 0.05).astype(np.float32)
    assert samples.shape == (104,)
    ref = int(jpko.pko_alpha_index_from_samples(jnp.asarray(samples), jc,
                                                key=jax.random.PRNGKey(42)))
    got = tpko.alpha_index_from_samples(torch.as_tensor(samples), tc, torch.as_tensor(pick))
    assert int(got) == ref


@pytest.mark.parametrize("b", [1, 5, 16])
def test_gabor_product_twin(b):
    rng = np.random.default_rng(b)
    spec = (rng.standard_normal((b, 80, 360)) + 1j * rng.standard_normal((b, 80, 360))
            ).astype(np.complex64)
    filt = tiris.log_gabor_filters().astype(np.float32)
    got = tiris.gabor_product_plain(torch.as_tensor(spec), torch.as_tensor(filt)).numpy()
    assert got.shape == (b, 4, 80, 360) and got.dtype == np.complex64
    f = filt[None, :, None, :]
    np.testing.assert_array_equal(got.real, spec.real[:, None] * f)
    np.testing.assert_array_equal(got.imag, spec.imag[:, None] * f)
    # XLA on the CPU reads subnormal filter values as zero and flushes
    # subnormal products to zero (the filters' tails reach 1e-45); the twin,
    # numpy and the card keep both. Otherwise JAX's products are the twin's.
    ref = np.asarray(jnp.asarray(spec)[:, None]
                     * jnp.asarray(filt).astype(jnp.complex64)[None, :, None, :])
    tiny = np.finfo(np.float32).tiny
    flush = lambda a: np.where(np.abs(a) < tiny, np.float32(0), a)
    fz = flush(f)
    np.testing.assert_array_equal(ref.real, flush(spec.real[:, None] * fz))
    np.testing.assert_array_equal(ref.imag, flush(spec.imag[:, None] * fz))
    np.testing.assert_array_equal(filt, np.asarray(jiris._filters()))


# the card tests' K2b cases: synthetic.normal_eq_rows arguments, with the
# loss and min_correspondence_points where they differ from ICPConfig's
K2B_CASES = {
    "n_not_a_multiple_of_the_cluster": dict(n=14339, seed=1),
    "n_below_a_warp": dict(n=20, seed=2, min_corr=5),
    "no_valid_point": dict(n=1000, seed=3, n_valid=0),
    "count_below_min": dict(n=1000, seed=4, n_valid=30),
    "pivot_rows_swap": dict(n=2000, seed=5, flat_x=True),
    "step_below_small_angle": dict(n=3000, seed=6, step=(1e-6, -5e-7, 2e-7, 2e-7, -1.5e-7, 1e-7)),
    "step_above_small_angle": dict(n=3000, seed=7, step=(2e-4, -1e-4, 5e-5, 2e-6, -1.5e-6, 1e-6)),
    "non_finite_step": dict(n=3000, seed=8, nan_residual=True),
    "cauchy": dict(n=5000, seed=9, loss="cauchy"),
}
K2B_SCALE, K2B_ALPHA = 0.05, 40


def _k2b_case(case):
    kw = dict(K2B_CASES[case])
    loss, min_corr = kw.pop("loss", "huber"), kw.pop("min_corr", 50)
    return synthetic.normal_eq_rows(**kw), loss, min_corr


def _pivot_swaps(H):
    """Whether Gaussian elimination with partial pivoting on H swaps rows."""
    A = np.array(H, np.float64)
    for c in range(6):
        p = c + int(np.argmax(np.abs(A[c:, c])))
        if abs(A[p, c]) > abs(A[c, c]):
            return True
        A[c + 1:] -= np.outer(A[c + 1:, c] / A[c, c], A[c])
    return False


@pytest.mark.parametrize("case", sorted(K2B_CASES))
def test_normal_eq_twin_on_kernel_edges(pko_consts, case):
    jc, tc = pko_consts
    (p, nrm, r, valid, T), loss, min_corr = _k2b_case(case)
    tcfg = ticp.ICPConfig(loss_type=loss, min_correspondence_points=min_corr)
    jcfg = jicp.ICPConfig(loss_type=loss, min_correspondence_points=min_corr)
    count = int(valid.sum())
    tt = torch.as_tensor
    T_out, flags, hg = ticp.icp_normal_eq(
        tt(p), tt(nrm), tt(r), tt(valid), tt(T).reshape(16), torch.full((1,), K2B_SCALE),
        torch.zeros((3,), dtype=torch.int32), torch.tensor([count, K2B_ALPHA], dtype=torch.int32),
        tc, tcfg)
    # JAX: the residual from a target q on the plane's side at distance r
    pw = p @ T[:3, :3].T + T[:3, 3]
    q = (pw - nrm * r[:, None]).astype(np.float32)
    norm_resid = np.abs(r) / np.float32(max(K2B_SCALE, 1e-6))
    jT, dt_n, dw_n = jicp._gn_step(jnp.asarray(T), jnp.asarray(p), jnp.asarray(nrm),
                                   jnp.asarray(q), jnp.asarray(valid), jnp.asarray(norm_resid),
                                   jc.alphas[K2B_ALPHA], jcfg)
    insufficient = count < min_corr
    tol = (jcfg.translation_tolerance, jcfg.rotation_tolerance)
    conv = float(dt_n) < tol[0] and float(dw_n) < tol[1]
    # the flags turn on the norms: no case sits within 1 % of a tolerance
    assert all(abs(float(v) - t) > 1e-2 * t for v, t in zip((dt_n, dw_n), tol))
    ref_T = T if insufficient else np.asarray(jT)
    assert flags.tolist() == [int(insufficient or conv), int(insufficient),
                              0 if insufficient else count]
    got = T_out.numpy().reshape(4, 4)
    np.testing.assert_allclose(got[:3, 3], ref_T[:3, 3], atol=1e-4)
    Rd = got[:3, :3].astype(np.float64).T @ ref_T[:3, :3].astype(np.float64)
    w = np.array([Rd[2, 1] - Rd[1, 2], Rd[0, 2] - Rd[2, 0], Rd[1, 0] - Rd[0, 1]]) / 2
    assert float(np.linalg.norm(w)) < 1e-4
    # H from the twin's 21 upper entries, against JAX's normal equations
    a = nrm @ T[:3, :3]
    J = np.concatenate([a, np.cross(p, a)], 1).astype(np.float64)
    wr = np.asarray(jicp._robust_weights(jnp.asarray(norm_resid), jc.alphas[K2B_ALPHA], loss))
    Hj = J.T @ (J * (wr * valid)[:, None]) + np.eye(6) * 1e-8   # the floor _gn_step adds
    H = np.zeros((6, 6))
    H[np.triu_indices(6)] = hg.numpy()[:21]
    H = H + np.triu(H, 1).T
    assert np.abs(H - Hj).max() <= 1e-5 * max(np.abs(Hj).max(), 1e-8)
    if case == "pivot_rows_swap":
        assert _pivot_swaps(Hj)
    if case == "non_finite_step":
        assert not np.isfinite(hg.numpy()[21:]).all() and np.array_equal(got, T)
    if case.startswith("step_"):
        theta = float(np.linalg.norm(np.asarray(K2B_CASES[case]["step"][3:])))
        assert (theta < 1e-6) == (case == "step_below_small_angle")


# the card tests' K11b cases: lanes x shards an instance set, rows a shard,
# alphas, loss, robust loss, a shard of lane 0 with no valid row, a done lane
K11B_CASES = {
    "rows_not_a_multiple_of_the_chunk": dict(lanes=1, shards=4, n=1013, n_alpha=101),
    "one_alpha": dict(lanes=1, shards=4, n=700, n_alpha=1),
    "alphas_101_cauchy": dict(lanes=1, shards=4, n=2048, n_alpha=101, loss="cauchy"),
    "a_shard_without_valid_rows": dict(lanes=1, shards=4, n=700, n_alpha=101, empty=2),
    "done_lane": dict(lanes=2, shards=2, n=700, n_alpha=101, done=1),
    "robust_loss_off": dict(lanes=1, shards=4, n=700, n_alpha=101, robust=False),
}


def _k11b_case(case):
    """A K11b case's wrapper arguments (p, nrm, r, valid, T, flags, mom,
    alphas), config and shards a lane."""
    c = K11B_CASES[case]
    p, nrm, r, valid, T, mom = synthetic.normal_eq_shards(c["lanes"], c["shards"], c["n"],
                                                          seed=len(case), empty=c.get("empty"))
    cfg = ticp.ICPConfig(loss_type=c.get("loss", "huber"), use_robust_loss=c.get("robust", True))
    flags = torch.zeros((c["lanes"], 3), dtype=torch.int32)
    if "done" in c:
        flags[c["done"]] = torch.tensor([1, 0, 77], dtype=torch.int32)
    alphas = (tpko.make_pko_constants(*PKO_ARGS, device="cpu").alphas if c["n_alpha"] > 1
              else torch.full((1,), cfg.robust_loss_delta))
    T16 = torch.as_tensor(T).reshape(1, 16).repeat(c["lanes"], 1).contiguous()
    tt = torch.as_tensor
    return (tt(p), tt(nrm), tt(r), tt(valid), T16, flags, tt(mom), alphas), cfg, c["shards"]


@pytest.mark.parametrize("case", sorted(K11B_CASES))
def test_alpha_normal_eq_twin_on_kernel_edges(case):
    args, cfg, n_local = _k11b_case(case)
    p, nrm, r, valid, T16, flags, mom, alphas = args
    g, a = p.shape[0], alphas.shape[0]
    out = torch.full((g, so.buffer_width(a, n_local, 25)), -7.0)
    so.shard_alpha_normal_eq(*args, cfg, n_local=n_local, out=out)
    for i in range(g):
        lane = i // n_local
        if bool(flags[lane, 0]):
            assert bool((out[i] == -7.0).all())
            continue
        # JAX: the lane's moments -> scale (sharded_map.py:380-386), then W @ Z
        m = jnp.sum(jnp.asarray(mom[lane].numpy()), axis=0)
        n0 = jnp.maximum(m[0], 1.0)
        mean = m[1] / n0
        scale = jnp.sqrt(jnp.maximum(m[2] / n0 - mean * mean, 0.0)) / 6.0
        Rj = jnp.asarray(T16[lane].view(4, 4)[:3, :3].numpy())
        an = jnp.asarray(nrm[i].numpy()) @ Rj
        J = jnp.concatenate([an, jnp.cross(jnp.asarray(p[i].numpy()), an)], axis=-1)
        Z = jnp.concatenate([(J[:, :, None] * J[:, None, :]).reshape(-1, 36),
                             J * jnp.asarray(r[i].numpy())[:, None]], axis=1)
        w = jnp.asarray(valid[i].numpy()).astype(jnp.float32)
        if cfg.use_robust_loss:
            nr = jnp.abs(jnp.asarray(r[i].numpy())) / jnp.maximum(scale, 1e-6)
            W = jicp._robust_weights(nr[None, :], jnp.asarray(alphas.numpy())[:, None],
                                     cfg.loss_type) * w[None, :]
        else:
            W = jnp.broadcast_to(w, (a, w.shape[0]))
        ref = np.asarray(W @ Z).reshape(-1)
        got = out[i, :a * 42].numpy()
        assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-30)
        assert float(out[i, -1]) == float(valid[i].sum())
    if case == "a_shard_without_valid_rows":
        assert bool((out[2, :a * 42] == 0.0).all()) and float(out[2, -1]) == 0.0


# the card tests' K4c cases: (children of each parent, lattice, rows)
K4C_CASES = {
    "all_rows_dead": ([8] * 64, False, "dead"),
    "dead_rows_between_live": (list(range(5, 28)) * 26, False, "odd_dead"),
    "children_1_5_27": ([1, 5, 27] * 200, False, "all"),
    "equal_eigenvalues": ([27, 9] * 100, True, "all"),
    "r_not_a_multiple_of_the_block": ([5 + i % 23 for i in range(1237)], False, "all"),
    "rehash_every_slot": ([(7 * i) % 28 if i % 3 == 0 else 0 for i in range(4096)], False, "all"),
}


def _k4c_case(case):
    """(l0 (c1 * 27 + 1, 4), r_slot (R,) int64, c1) of a K4c case."""
    children, lattice, rows = K4C_CASES[case]
    c1 = len(children)
    l0 = torch.as_tensor(synthetic.surfel_blocks(children, seed=len(case), lattice=lattice))
    slots = torch.arange(c1)
    if rows == "dead":
        slots = torch.full((1000,), -1, dtype=torch.int64)
    elif rows == "odd_dead":
        slots = torch.stack([slots, torch.full_like(slots, -1)], 1).reshape(-1)
    return l0, slots, c1


@pytest.mark.parametrize("case", sorted(K4C_CASES))
def test_surfel_recompute_twin_on_kernel_edges(case):
    l0, r_slot, c1 = _k4c_case(case)
    thr = np.float32(0.1)
    srows, non_planar, kidmask = tvm.map_surfel_recompute(l0, r_slot, c1, thr)
    r_ok = r_slot.numpy() >= 0
    rows = np.clip(r_slot.numpy(), 0, c1 - 1)[:, None] * 27 + np.arange(27)[None, :]
    blk = np.where(r_ok[:, None, None], l0.numpy()[rows], 0.0).astype(np.float32)
    _cnt, mean, cov, ok = jvm._block_stats(jnp.asarray(blk))
    lam, normal = jeigh3.eigh3(cov)
    plan = np.asarray(lam[:, 0] / (lam[:, 2] + 1e-6))
    kid = (np.asarray(ok).astype(np.int64) << np.arange(27)).sum(1)
    np.testing.assert_array_equal(kidmask.numpy(), kid)
    np.testing.assert_allclose(srows[:, 3:6].numpy(), np.asarray(mean), atol=1e-4)
    np.testing.assert_allclose(srows[:, 6].numpy(), plan, atol=1e-4)
    assert bool((srows[:, 7] == 1.0).all())
    ev = np.linalg.eigvalsh(np.asarray(cov, np.float64))
    well = (ev[:, 1] - ev[:, 0]) > 1e-4 * (ev[:, 2] + 1e-6)
    np.testing.assert_allclose(srows[well, :3].numpy(), np.asarray(normal)[well], atol=1e-4)
    verdict = r_ok & (plan > thr)
    band = np.abs(plan - thr) < 1e-5
    assert not ((non_planar.numpy() != verdict) & ~band).any()
    if case == "all_rows_dead":
        assert bool((srows == torch.tensor([0.0, 0, 1, 0, 0, 0, 0, 1])).all())
        assert not bool(non_planar.any()) and not bool(kidmask.any())
    if case == "equal_eigenvalues":
        assert not well[0::2].any() and well[1::2].all()   # 27: isotropic; 9: a flat square


# the card tests' K11a cases: lanes, points a lane, shards, the rank's
# first shard and local shards, a pose per lane, points
K11A_CASES = {
    "every_point_in_one_shard": dict(lanes=1, n=5000, shards=4, one_cell=True),
    "no_point_owned": dict(lanes=1, n=5000, shards=4, masked=True),
    "n_not_a_multiple_of_the_tile": dict(lanes=1, n=16384 + 1029, shards=2),
    "shards_1_2_of_4": dict(lanes=1, n=9000, shards=4, first=1, n_local=2),
    "one_shard": dict(lanes=1, n=7000, shards=1),
    "eight_shards": dict(lanes=1, n=16384, shards=8),
    "two_lanes_at_two_poses": dict(lanes=2, n=14336, shards=4, pose=True),
}


def _k11a_case(case):
    """K11a's wrapper arguments (pts, mask, T, S, first, n_local, cap,
    inv) of a case."""
    c = K11A_CASES[case]
    pts, mask = synthetic.shard_points(c["lanes"], c["n"], seed=len(case),
                                       one_cell=c.get("one_cell", False),
                                       masked=c.get("masked", False))
    T = None
    if c.get("pose"):
        T = np.tile(np.eye(4, dtype=np.float32), (c["lanes"], 1, 1))
        for lane in range(c["lanes"]):
            a = 0.3 + 0.2 * lane
            T[lane, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            T[lane, :3, 3] = (1.3 - lane, -0.4, 0.2)
        T = torch.as_tensor(T.reshape(c["lanes"], 16))
    s = c["shards"]
    return (torch.as_tensor(pts), torch.as_tensor(mask), T, s, c.get("first", 0),
            c.get("n_local", s), so.owned_cap(c["n"], s), so.owner_inv(0.5, 3))


@pytest.mark.parametrize("case", sorted(K11A_CASES))
def test_shard_own_twin_on_kernel_edges(case):
    args = _k11a_case(case)
    pts, mask, T, s, first, n_local, cap, inv = args
    p_own, ok, sel, over = so.shard_own(*args)
    moved = pts if T is None else so._transform_plain(T, pts)
    compact = jax.jit(jsm._compact_owned, static_argnums=4)
    for lane in range(pts.shape[0]):
        owner = jsm.owner_of_points(jnp.asarray(moved[lane].numpy()), s, voxel_size=0.5)
        for k in range(n_local):
            g, me = lane * n_local + k, first + k
            jp, jok, jsel = compact(jnp.asarray(pts[lane].numpy()), jnp.asarray(mask[lane].numpy()),
                                    owner, jnp.int32(me), cap)
            np.testing.assert_array_equal(sel[g].numpy(), np.asarray(jsel))
            np.testing.assert_array_equal(ok[g].numpy(), np.asarray(jok))
            np.testing.assert_array_equal(p_own[g].numpy(), np.asarray(jp))
            owned = int((mask[lane].numpy() & (np.asarray(owner) == me)).sum())
            assert int(over[g]) == max(owned - cap, 0)
    if case == "every_point_in_one_shard":
        assert int(over.max()) > 0
    if case == "no_point_owned":
        assert not bool(ok.any()) and bool((sel == pts.shape[1] - 1).all())


# the card tests' K6b cases: knn_cloud's options, the bin size, k, r, W and
# the query count
K6B_CASES = {
    "queries_not_a_multiple_of_the_block": dict(k=5, r=1, w=8, n_q=613),
    "radius_2": dict(k=5, r=2, w=8),
    "width_4": dict(k=5, r=1, w=4),
    "width_5": dict(k=5, r=1, w=5),
    "width_16": dict(k=5, r=1, w=16),
    "binary_search_r1": dict(k=5, r=1, w=4, wide=True),
    "binary_search_r2": dict(k=5, r=2, w=8, wide=True),
    "ties_across_and_within_bins": dict(k=5, r=1, w=8, ties=True),
    "ties_radius_2_width_16": dict(k=5, r=2, w=16, ties=True),
    "valid_table_short_last_bin": dict(k=5, r=1, w=8, all_valid=True),
    "k_1": dict(k=1, r=1, w=8),
    "k_1_radius_2_binary_search": dict(k=1, r=2, w=8, wide=True),
}


def _k6b_case(case):
    """(pts, mask, queries, bin size, k, r, W) of a K6b case."""
    c = K6B_CASES[case]
    pts, mask, q = synthetic.knn_cloud(3000, seed=len(case), n_queries=c.get("n_q", 600),
                                       wide=c.get("wide", False), ties=c.get("ties", False),
                                       all_valid=c.get("all_valid", False))
    return pts, mask, q, 0.5 if c.get("wide") else 2.0, c["k"], c["r"], c["w"]


@pytest.mark.parametrize("case", sorted(K6B_CASES))
def test_point_knn_twin_on_kernel_edges(case):
    pts, mask, q, bin_size, k, r, w = _k6b_case(case)
    jt = jknn.build_point_table(jnp.asarray(pts), jnp.asarray(mask), bin_size=bin_size)
    pt = tknn.build_point_table(torch.as_tensor(pts), torch.as_tensor(mask), bin_size=bin_size)
    assert bool(pt.fits) == (bin_size == 2.0)
    jn, jo, jd = (np.asarray(x) for x in jknn.knn_query(jt, jnp.asarray(q), bin_size=bin_size,
                                                        k=k, radius=r, bucket_width=w))
    pn, po, pd = (x.numpy() for x in tknn.knn_query(pt, torch.as_tensor(q), k=k, radius=r,
                                                    bucket_width=w))
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(pd[fin], jd[fin], atol=1e-6, rtol=0)
    n_ok = po.sum(1)
    assert (n_ok == 0).any() and (n_ok == k).any()
    if k > 1:
        assert ((n_ok > 0) & (n_ok < k)).any()             # fewer than k candidates
    if bin_size == 2.0:                                    # bins fuller than the probe
        _, counts = np.unique(pt.key.numpy()[pt.valid.numpy()], return_counts=True)
        assert counts.max() > w
    if "ties" in case:                                     # equal distances in one row
        assert (po[:, 1:] & (pd[:, 1:] == pd[:, :-1])).any()
    if case == "valid_table_short_last_bin":               # the clamp's repeated last row
        last = pt.pts[-1].numpy()
        hits = po & np.all(pn == last, -1)
        assert (hits.sum(1) > 1).any()


# the card tests' K5b cases: (rows, candidates a row, gate)
K5B_CASES = {
    "k_5": (613, 5, True),
    "k_5_ungated": (613, 5, False),
    "k_8": (402, 8, True),
    "k_9": (402, 9, False),
    "k_27": (613, 27, True),
    "k_125": (613, 125, True),
    "k_125_ungated": (301, 125, False),
}


def _k5b_case(case):
    n, k, gate = K5B_CASES[case]
    return synthetic.plane_candidates(n, k, seed=len(case)) + (gate,)


def _degenerate(nb, nb_ok):
    """Rows whose masked covariance has its two smallest eigenvalues within
    1e-2 of the largest (float64)."""
    m = nb_ok[..., None].astype(np.float64)
    cnt = np.maximum(m.sum(1), 1.0)
    d = (nb - ((nb * m).sum(1) / cnt)[:, None]) * m
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", d, d) / cnt[..., None])
    return (lam[:, 1] - lam[:, 0]) <= 1e-2 * (lam[:, 2] + 1e-6)


@pytest.mark.parametrize("case", sorted(K5B_CASES))
def test_plane_fit_twin_on_kernel_edges(case):
    p, cand, ok, mask, gate = _k5b_case(case)
    jcfg = jicp.ICPConfig(max_correspondence_distance=0.1, plane_fit_planarity=0.1)
    tcfg = ticp.ICPConfig(max_correspondence_distance=0.1, plane_fit_planarity=0.1)
    fit = jax.jit(jicp._plane_fit_5nn, static_argnames=("cfg", "gate"))
    jn, jc, jnn, jv, jd = (np.asarray(x) for x in fit(
        jnp.asarray(p), jnp.asarray(cand), jnp.asarray(ok), jnp.asarray(mask), cfg=jcfg,
        gate=gate))
    d2 = jnp.where(jnp.asarray(ok), jnp.sum((jnp.asarray(cand) - p[:, None, :]) ** 2, -1),
                   jnp.inf)
    jsel = np.asarray(jax.lax.top_k(-d2, 5)[1])
    t = ticp.plane_fit_5nn(torch.as_tensor(p), torch.as_tensor(cand), torch.as_tensor(ok),
                           torch.as_tensor(mask), tcfg, gate)
    np.testing.assert_array_equal(t.sel.numpy(), jsel)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_array_equal(t.nearest.numpy(), jnn)
    np.testing.assert_allclose(t.centroid.numpy(), jc, atol=1e-5)
    deg = _degenerate(np.take_along_axis(cand, jsel[..., None], 1).astype(np.float64),
                      np.take_along_axis(ok, jsel, 1))
    tenth = len(p) // 10
    assert deg[2 * tenth:4 * tenth].all() and not deg.all()   # the lines and empty rows
    # a normal off by eps * lambda_2 / (lambda_1 - lambda_0) ~ 6e-6 rad moves
    # n.p by up to ~5e-5 at these 5-9 m coordinates
    np.testing.assert_allclose(t.dist.numpy()[~deg], jd[~deg], atol=1e-4)
    assert np.abs(np.sum(t.normal.numpy() * jn, -1))[~deg].min() > 1 - 1e-5
    assert not t.valid.numpy()[tenth:4 * tenth].any()         # too few, collinear, masked
    assert t.valid.numpy().any()
    sd = np.take_along_axis(np.where(ok, ((cand - p[:, None]) ** 2).sum(-1), np.inf), jsel, 1)
    assert (np.isfinite(sd[:tenth, 1:]) & (sd[:tenth, 1:] == sd[:tenth, :-1])).any()  # ties


# the card tests' K11c cases: lanes, shards a lane, n, few or no valid rows,
# a done lane
K11C_CASES = {
    "s1_two_lanes_rows_not_a_multiple_of_16": dict(lanes=2, shards=1, n=1013),
    "s2_fewer_valid_than_quota": dict(lanes=1, shards=2, n=1200, few=(1, 20)),
    "s4_no_valid_row": dict(lanes=1, shards=4, n=700, empty=2),
    "s4_two_tiles": dict(lanes=1, shards=4, n=20011),
    "s8_two_lanes_one_done": dict(lanes=2, shards=8, n=613, done=0),
}


@pytest.mark.parametrize("case", sorted(K11C_CASES))
def test_shard_sample_twin_on_kernel_edges(case):
    c = K11C_CASES[case]
    s = c["shards"]
    _, _, r, valid, _, mom = synthetic.normal_eq_shards(c["lanes"], s, c["n"], seed=len(case),
                                                        empty=c.get("empty"))
    if "few" in c:
        valid[c["few"][0], c["few"][1]:] = False
    flags = torch.zeros((c["lanes"], 3), dtype=torch.int32)
    if "done" in c:
        flags[c["done"]] = torch.tensor([1, 0, 77], dtype=torch.int32)
    u = torch.as_tensor(tpko.shard_draws(s)[0])
    q = u.shape[1]
    off = 101 * 42
    out = torch.full((c["lanes"] * s, so.buffer_width(101, s, q)), -7.0)
    so.shard_sample(torch.as_tensor(r), torch.as_tensor(valid), flags, torch.as_tensor(mom), u,
                    first=0, n_local=s, off=off, out=out)
    scale = so.scale_from_moments(torch.as_tensor(mom))
    key = jax.random.PRNGKey(42)
    for i in range(c["lanes"] * s):
        lane, me = i // s, i % s
        if bool(flags[lane, 0]):
            assert bool((out[i] == -7.0).all())
            continue
        nr = jnp.abs(jnp.asarray(r[i])) / jnp.maximum(jnp.float32(float(scale[lane])), 1e-6)
        samp, sok = jpko.stratified_sample(nr, jnp.asarray(valid[i]), q,
                                           jax.random.fold_in(key, me))
        sokf = np.asarray(sok, np.float32)
        ref = np.zeros(2 * s * q, np.float32)
        ref[me * q:(me + 1) * q] = np.asarray(samp) * sokf
        ref[s * q + me * q:s * q + (me + 1) * q] = sokf
        np.testing.assert_array_equal(out[i, off:off + 2 * s * q].numpy(), ref)
        assert bool((out[i, :off] == -7.0).all()) and float(out[i, -1]) == -7.0
    n_ok = out[:, off + s * q:off + 2 * s * q].sum(1)
    if "few" in c or "empty" in c:
        assert bool((n_ok[(flags[:, 0] == 0).repeat_interleave(s)] < q).any())


# the card tests' K4b cases: (run lengths, invalid rows, every n-th parent unplaced)
K4B_CASES = {
    "runs_of_1_2_and_300": ([1, 2, 300] * 4 + [1] * 50, 0, 0),
    "run_across_two_block_ends": ([3] * 60 + [700] + [2] * 40, 0, 0),
    "invalid_tail_run": ([1, 2, 3, 4] * 60, 2000, 0),
    "unplaced_leaders": ([1 + i % 5 for i in range(400)], 37, 3),
    "p_not_a_multiple_of_256": ([2, 1, 3] * 150 + [13], 100, 7),
}


def _k4b_case(case):
    counts, n_invalid, every = K4B_CASES[case]
    d, c1 = synthetic.scatter_add_inputs(counts, n_invalid, seed=len(case),
                                         unplaced_every=every)
    return {k: torch.as_tensor(v) for k, v in d.items()}, c1


@pytest.mark.parametrize("case", sorted(K4B_CASES))
def test_scatter_add_twin_on_kernel_edges(case):
    t, c1 = _k4b_case(case)
    nrows = c1 * 27
    keys = ("pts", "s_idx", "firstk", "valid_s", "placed", "pslot", "ch_off")
    got = tvm.map_scatter_add(t["l0"].clone(), *[t[k] for k in keys])
    n = {k: v.numpy() for k, v in t.items()}
    # the JAX program's accumulation, as voxel_map.py:501-507 and :542-548 write it
    s_idx, firstk, valid_s = (jnp.asarray(n[k]) for k in ("s_idx", "firstk", "valid_s"))
    p = s_idx.shape[0]
    pts_s = jnp.where(valid_s[:, None], jnp.asarray(n["pts"])[s_idx], 0.0)
    data4 = jnp.concatenate([valid_s.astype(jnp.float32)[:, None], pts_s], axis=1)
    gix = jnp.cumsum(firstk.astype(jnp.int32)) - 1
    seg4 = jax.ops.segment_sum(data4, gix, num_segments=p, indices_are_sorted=True)
    tot4 = seg4[gix]
    placed_s = jnp.asarray(n["placed"])[s_idx]
    pslot_s = jnp.asarray(n["pslot"])[s_idx]
    off_s = jnp.asarray(n["ch_off"])[s_idx]
    tgt = jnp.where(firstk & placed_s, pslot_s * 27 + off_s, nrows)
    ref = jnp.asarray(n["l0"][:nrows]).at[tgt].add(tot4, mode="drop", unique_indices=True)
    np.testing.assert_array_equal(got[:nrows].numpy(), np.asarray(ref))
    assert bool((got[nrows] == 0.0).all())
    # a numpy float64 sum of each voxel's points at its leader's row, held
    # at 1e-6 of the sum of its terms' magnitudes (a float32 sum of n terms
    # errs by up to n eps of that; the existing rows reach ~250)
    ref64 = n["l0"][:nrows].astype(np.float64)
    scale = np.abs(ref64)
    lead = np.flatnonzero(n["firstk"])
    for a, b in zip(lead, list(lead[1:]) + [p]):
        i = n["s_idx"][a]
        if not n["placed"][i]:
            continue
        run = n["pts"][n["s_idx"][a:b][n["valid_s"][a:b]]].astype(np.float64)
        row = n["pslot"][i] * 27 + n["ch_off"][i]
        ref64[row] += np.concatenate([[len(run)], run.sum(0)])
        scale[row] += np.concatenate([[len(run)], np.abs(run).sum(0)])
    assert (np.abs(got[:nrows].numpy() - ref64) <= 1e-6 * scale).all()
    if case == "unplaced_leaders":
        assert not n["placed"][n["s_idx"][lead]].all()
    if case == "invalid_tail_run":
        assert not n["valid_s"][-2000:].any() and not n["firstk"][-1999:].any()


# the card tests' K10d cases: (n_pad, partitions, real_mask zero rows, NaN, inactive)
K10D_CASES = {
    "n_pad_17": (17, 3, 0, False, False),
    "n_pad_300_zero_mask_rows": (300, 8, 45, False, False),
    "n_pad_4096_one_cluster": (4096, 73, 396, False, False),
    "n_pad_8192_past_one_cluster": (8192, 60, 100, False, False),
    "nan_in_dx": (300, 8, 0, True, False),
    "inactive": (300, 8, 0, False, True),
}


def _k10d_case(case):
    """(graph dict of tensors, poses, xs, F, G, g, max_iters, tol) of a K10d case."""
    n_pad, parts, zero, nan, inactive = K10D_CASES[case]
    a, plan = synthetic.backsub_system(n_pad, parts, seed=n_pad + zero, zero_rows=zero)
    if nan:
        a["g"][1, -1, 2] = np.nan
    g = {k: torch.as_tensor(a[k]) for k in ("real_mask", "pose_row", *dpgo.BACK_KEYS)}
    g["st"] = torch.tensor([2.0, 0.5, 1.0, 0.0 if inactive else 1.0], dtype=torch.float64)
    return (g, torch.as_tensor(a["poses"]), *(torch.as_tensor(a[k]) for k in
                                                ("xs", "F", "G", "g")), 10, 1e-6)


def _numpy_dx(g, xs, F, G, gv):
    """dx of the back-substitution in numpy float64, row by row."""
    n_pad = g["real_mask"].shape[0]
    x = np.zeros((n_pad, 6))
    xs, F, G, gv = (t.numpy() for t in (xs, F, G, gv))
    for k, (row_idx, row_ok) in enumerate(zip(g["int_idx"].numpy(), g["valid"].numpy())):
        xl = xs[g["xl_idx"][k]] if g["has_left"][k] else np.zeros(6)
        for m in np.flatnonzero(row_ok):
            x[row_idx[m]] = gv[k, m] - F[k, m] @ xl - G[k, m] @ xs[k]
    x[g["seps"].numpy()] = xs
    return x * g["real_mask"].numpy()[:, None]


@pytest.mark.parametrize("case", sorted(K10D_CASES))
def test_backsub_retract_twin_on_kernel_edges(case):
    g, poses, xs, F, G, gv, max_iters, tol = _k10d_case(case)
    n_pad, _, zero, nan, inactive = K10D_CASES[case]
    st0 = g["st"].clone()
    p0 = poses.clone()
    dpgo.backsub_retract(g, poses, xs, F, G, gv, max_iters, tol)
    if inactive:
        assert torch.equal(poses, p0) and torch.equal(g["st"], st0)
        return
    dx = _numpy_dx(g, xs, F, G, gv)
    dxn = np.linalg.norm(dx)
    st = g["st"].numpy()
    if nan:
        assert torch.equal(poses, p0)
        assert st[0] == 3 and st[2] == 0 and st[3] == 0 and not np.isfinite(st[1])
        return
    assert abs(st[1] - dxn) <= 1e-12 * dxn
    assert st[0] == 3 and st[2] == 1 and st[3] == float(dxn >= tol)
    if zero:
        assert not dx[n_pad - zero:].any()
    with jax.enable_x64():
        dR, dt = (np.asarray(v) for v in jdpgo._bse3_exp(jnp.asarray(dx)))
    R, t = p0[:, :3, :3].numpy(), p0[:, :3, 3].numpy()
    np.testing.assert_allclose(poses[:, :3, :3].numpy(), R @ dR, rtol=0, atol=1e-12)
    np.testing.assert_allclose(poses[:, :3, 3].numpy(),
                               np.einsum("nij,nj->ni", R, dt) + t, rtol=0, atol=1e-12)
    assert bool((poses[:, 3] == torch.tensor([0.0, 0, 0, 1], dtype=torch.float64)).all())
    # the twin's dx is the numpy one: the poses it retracts by agree above;
    # its own dx, compared directly
    new, dxn_t, ok = dpgo.backsub_retract_plain(p0, xs, F, G, gv,
                                                *[g[k] for k in dpgo.BACK_KEYS], g["real_mask"])
    assert bool(ok) and abs(float(dxn_t) - dxn) <= 1e-12 * dxn


@pytest.fixture(scope="module")
def jax_compare():
    """JAX's comparison of one query against K candidates at given shifts:
    _hamming_over_shifts forward and on the candidate rolled by 180
    columns, then _compare_one's choice and compare_batch's +inf for
    invalid slots, vmapped over the candidates."""
    def one(qT, qM, dT, dM, s1, s2, ok):
        d1, b1 = jiris._hamming_over_shifts(qT, qM, dT, dM, s1)
        d2, b2 = jiris._hamming_over_shifts(qT, qM, jiris._roll_cols(dT, 180),
                                            jiris._roll_cols(dM, 180), s2)
        use1 = d1 < d2
        return (jnp.where(ok, jnp.where(use1, d1, d2), jnp.inf),
                jnp.where(use1, b1, (b2 + 180) % 360))
    return jax.jit(jax.vmap(one, in_axes=(None, None, 0, 0, 0, 0, 0)))


@pytest.mark.parametrize("case", synthetic.IRIS_HAMMING_CASES)
def test_iris_hamming_twin_on_kernel_edges(jax_compare, case):
    T, M, qidx, cand, shifts, valid = synthetic.iris_hamming_case(case, seed=len(case))
    out = tiris.iris_hamming(torch.as_tensor(T), torch.as_tensor(M), qidx, torch.as_tensor(cand),
                             torch.as_tensor(shifts), torch.as_tensor(valid)).numpy()
    u = tiris.to_uint32
    jd, jb = (np.asarray(x) for x in jax_compare(
        jnp.asarray(u(T[qidx])), jnp.asarray(u(M[qidx])), jnp.asarray(u(T[cand])),
        jnp.asarray(u(M[cand])), jnp.asarray(shifts[:, 0]), jnp.asarray(shifts[:, 1]),
        jnp.asarray(valid)))
    np.testing.assert_array_equal(out[:, 0].view(np.int32), jd.astype(np.float32).view(np.int32))
    np.testing.assert_array_equal(out[:, 1], jb.astype(np.float32))
    d, b = out[:, 0], out[:, 1]
    assert np.isinf(d[~valid]).all()
    assert np.isfinite(d[valid][3 if case == "all_masked_candidate" else 0:]).all()
    if case == "candidate_is_the_query":          # windows holding shift 0 (mod 360)
        assert (d[:4] == 0).all() and (b[:4] % 360 == 0).all()
    elif case == "all_masked_candidate":          # +inf both ways: the flipped one's bias
        assert np.isinf(d[:3]).all()
        np.testing.assert_array_equal(b[:3], (shifts[:3, 1] - 2 + 180) % 360)
    elif case == "ties_across_shifts":            # the first of five, then the flipped one
        np.testing.assert_array_equal(b[:4], (shifts[:4, 1] - 2 + 180) % 360)
    elif case == "ties_across_orientations":      # the flipped one's shift, plus 180
        assert (((b[:4] - 180 - (shifts[:4, 0] - 2)) % 360) <= 4).all()


@pytest.mark.parametrize("case", synthetic.POINT_GRID_CASES)
def test_point_grid_twin_on_kernel_edges(case):
    pts, mask, bin_size = synthetic.point_grid_cloud(case, seed=len(case))
    jt = jknn.build_point_table(jnp.asarray(pts), jnp.asarray(mask), bin_size=bin_size)
    pt = tknn.build_point_table(torch.as_tensor(pts), torch.as_tensor(mask), bin_size=bin_size)
    np.testing.assert_array_equal(pt.grid.numpy(), np.asarray(jt.grid))
    np.testing.assert_array_equal(pt.origin.numpy(), np.asarray(jt.origin))
    assert bool(pt.fits) == bool(jt.fits) and int(pt.n) == int(jt.n) == int(mask.sum())
    assert bool(pt.fits) == (case != "no_valid_row" and not case.startswith("one_bin"))
    occupied = int((pt.grid != len(pts)).sum())
    if case == "points_in_the_windows_last_bin":
        assert pt.grid[-1] != len(pts) and pt.grid[0] != len(pts)
    if case == "duplicate_keys":                    # runs: a bin keeps its first row
        assert occupied < 0.2 * mask.sum()
    if case == "no_valid_row":
        assert occupied == 0
