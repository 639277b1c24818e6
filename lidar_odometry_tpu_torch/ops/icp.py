"""Scan-to-map point-to-plane ICP (counterpart of the JAX package's
ops/icp.py: ICPConfig, _surfel_correspondences, _is_collinear,
_plane_fit_5nn, _grid_plane_correspondences, _norm_scale_from,
_robust_weights, _gn_step, icp_optimize).

One Gauss-Newton iteration of surfel mode is three launches, with every
intermediate on the device and no host read:
  K2a icp_correspond (csrc/icp.cu): transform each point by T, probe the
      parent's bucket row, read the surfel row, write the signed residual,
      the normal and the gated validity;
  K3  pko_alpha (ops/pko.py): count, iteration-0 scale, the alpha index;
  K2b icp_normal_eq (csrc/icp.cu): robust weights, J = [R^T n, p x R^T n],
      the 21 + 6 sums of J^T W J and J^T W r reduced over a thread-block
      cluster a lane, and in its rank-0 CTA the 6x6 solve (+1e-8 I), the
      retract T * (Exp(dw), dt) and the done / failed / n_corr update.
K3 needs every normalised residual before any weight exists, hence two
ICP launches and not one. The loop always runs max_iterations launches;
once the solve is done (converged or failed) the kernels return at once
and leave the state as it is, which gives the result of the JAX
while_loop with early exit. Lanes (the blocked multi-sequence runner; JAX
icp_optimize under vmap with the map shared): B solves against one map
take one launch of each kernel, with a leading B on the points, poses,
flags, scale and alpha index; each lane keeps its own done and failed
flags, and a done lane stays frozen while the others iterate. The sharded
ICP (parallel/sharded_map.py) takes one K2a launch an iteration for all
its (lane, shard) instances (icp_correspond_instances), each against its
shard's row range of the map's tables.

KD-tree mode (use_surfel_correspondence=False) finds its correspondences
in the L0 voxels instead of the surfels, in two launches in place of K2a:
  K5a grid_knn (ops/voxel_map.py): the (2r+1)^3 neighbourhood's centroids;
  K5b plane_fit_5nn (csrc/grid_knn.cu): the 5 nearest of them, the
      collinearity test on the nearest 3, a plane fit with eigh3, the
      distance and planarity gates.
then K3 and K2b as in surfel mode. The residual target is the plane's
centroid; the magnitude that sets the iteration-0 scale and PKO's alpha
is K5b's point-to-plane distance.

The loop-closure solve (icp_optimize_loop, loop_closure_solve) aligns a
keyframe to a matched keyframe's world cloud: the prealign (ops/
bev_align.py, K7), then up to 30 (100 without prealign) coarse steps on
2 m point-table bins and up to 8 polish steps on 0.5 m bins, each step
  K6b point_knn (ops/knn.py): the 5 nearest table points;
  K5b: their plane fit, ungated (coarse) or gated (polish);
  K3, then K2b with a weight residual: the residual is taken against the
      nearest neighbour (coarse) or the centroid (polish), the robust
      weight from the plane distance;
then the 1-NN inlier ratio (K6b point_nn1). One host read per solve.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from .. import kernels
from ..utils import eigh3 as E
from ..utils import keys as K
from ..utils import lie
from . import bev_align, knn, pko
from . import voxel_map as vm

__all__ = ["ICPConfig", "icp_optimize", "icp_correspond", "icp_correspond_instances",
           "icp_correspond_plain",
           "icp_normal_eq", "icp_normal_eq_plain", "icp_normal_eq_shape", "robust_weights",
           "PlaneFit",
           "plane_fit_5nn", "plane_fit_5nn_plain", "icp_optimize_loop",
           "loop_solve", "loop_prealign", "loop_closure_solve", "POLISH_TOLERANCE"]


@dataclass(frozen=True)
class ICPConfig:
    max_iterations: int = 4
    translation_tolerance: float = 0.005
    rotation_tolerance: float = 0.005
    max_correspondence_distance: float = 1.0
    min_correspondence_points: int = 50
    use_robust_loss: bool = True
    robust_loss_delta: float = 0.1
    use_surfel_correspondence: bool = True
    loss_type: str = "huber"
    use_adaptive_m_estimator: bool = True
    voxel_size: float = 0.5
    hierarchy_factor: int = 3
    # KD-tree mode: the candidate neighbourhood's radius in L0 voxels
    # (2: the 5x5x5 cube, 125 candidates) and the plane fit's planarity gate
    grid_knn_radius: int = 2
    plane_fit_planarity: float = 0.1


def robust_weights(abs_norm_resid, delta, loss_type: str):
    if loss_type == "cauchy":
        ratio = abs_norm_resid / delta
        return 1.0 / (1.0 + ratio * ratio)
    return torch.where(abs_norm_resid > delta,
                       delta / torch.clamp(abs_norm_resid, min=1e-30), 1.0)


# ---------------------------------------------------------------------------
# K2a: correspondences
# ---------------------------------------------------------------------------

def _lanes(pts, name: str):
    """The leading lane shape of (N, 3) or (B, N, 3) points: () or (B,)."""
    lead = tuple(pts.shape[:-2])
    if len(lead) > 1:
        raise kernels.KernelInputError(f"{name}: expected (N, 3) or (B, N, 3) points")
    return lead


def _per_lane(fn, *args):
    """fn over each lane of the leading-B tensors among args (None and
    non-tensors pass as they are), its tensor results stacked."""
    b = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]
    pick = lambda a, i: a[i] if isinstance(a, torch.Tensor) else a
    outs = [fn(*(pick(a, i) for a in args)) for i in range(b)]
    return tuple(torch.stack(c) for c in zip(*outs))


def icp_correspond(pts, mask, T, flags, map_state: vm.VoxelMapState, cfg: ICPConfig,
                   out=None):
    """K2a's wrapper. pts (N, 3) f32, mask (N,) bool, T (16,) f32 row-major,
    flags (3,) int32 [done, failed, n_corr]; for B lanes each with a
    leading B, all against the one map. Returns (normals (N, 3), signed
    residual (N,), valid (N,) bool), with the leading B for lanes, written
    into `out` (three contiguous tensors of those shapes) when it is
    given."""
    lead = _lanes(pts, "icp_correspond")
    if not pts.is_cuda:
        if lead:
            res = _per_lane(lambda p, m, t: icp_correspond_plain(p, m, t, map_state, cfg),
                            pts, mask, T)
        else:
            res = icp_correspond_plain(pts, mask, T, map_state, cfg)
        return _into(out, res)
    n = pts.shape[-2]
    kernels.check(pts, "pts", torch.float32, lead + (n, 3))
    kernels.check(mask, "mask", torch.bool, lead + (n,))
    kernels.check(T, "T", torch.float32, lead + (16,))
    kernels.check(flags, "flags", torch.int32, lead + (3,))
    b = lead[0] if lead else 1
    return _correspond_launch(pts.view(b, n, 3), mask.view(b, n), T.view(b, 16),
                              flags.view(b, 3), map_state, (0, 0), (0, 0), 1, cfg, lead, out)


def icp_correspond_instances(pts, mask, T, flags, maps, cfg: ICPConfig, out=None):
    """K2a over every (lane, shard) instance of one sharded ICP iteration,
    in one launch. pts (G, n, 3) f32 and mask (G, n) bool, instance g =
    lane * n_local + k; T (L, 16), flags (L, 3) per lane; maps [L][n_local]
    the instances' maps, shard k of lane l at l lane strides and k shard
    strides from lane 0's shard 0 in one set of tables (parallel/
    sharded_map.py local_views; lanes may share their maps). Returns (normals (G, n,
    3), residual (G, n), valid (G, n)), written into `out` when it is
    given. On CPU tensors the twin runs instance by instance."""
    lanes, per_lane = len(maps), len(maps[0])
    g_n = lanes * per_lane
    if pts.shape[0] != g_n or T.shape[0] != lanes or flags.shape[0] != lanes:
        raise kernels.KernelInputError(
            f"icp_correspond_instances: {lanes} lanes x {per_lane} maps need {g_n} point "
            f"sets and {lanes} poses, got {pts.shape[0]} and {T.shape[0]}")
    flat = [m for row in maps for m in row]
    if not pts.is_cuda:
        res = [icp_correspond_plain(pts[g], mask[g], T[g // per_lane], flat[g], cfg)
               for g in range(g_n)]
        return _into(out, tuple(torch.stack(c) for c in zip(*res)))
    index_strides = _instance_strides([m.l1_index for m in flat], per_lane, "l1_index")
    surfel_strides = _instance_strides([m.l1_surfel for m in flat], per_lane, "l1_surfel")
    return _correspond_launch(pts, mask, T, flags, flat[0], index_strides, surfel_strides,
                              per_lane, cfg, (g_n,), out)


def _into(out, res):
    if out is None:
        return res
    for o, v in zip(out, res):
        o.copy_(v)
    return out


def _instance_strides(tables, per_lane: int, name: str):
    """(lane stride, shard stride) in elements between the instances'
    tables (instance g = lane * per_lane + shard): every table must be
    contiguous and 16-byte aligned, of the first one's device, dtype and
    shape, and lie at lane * the lane stride + shard * the shard stride
    from it."""
    t0 = tables[0]
    es = t0.element_size()
    gap = lambda g: (tables[g].data_ptr() - t0.data_ptr()) // es
    shard = gap(1) if per_lane > 1 else 0
    lane = gap(per_lane) if len(tables) > per_lane else 0
    for g, t in enumerate(tables):
        if (t.device != t0.device or t.dtype != t0.dtype or t.shape != t0.shape
                or not t.is_contiguous()):
            raise kernels.KernelInputError(f"{name}: instance {g}'s table is not a contiguous "
                                           f"table of instance 0's device, dtype and shape")
        kernels.check_aligned(t, name)
        want = (g // per_lane) * lane + (g % per_lane) * shard
        if t.data_ptr() - t0.data_ptr() != want * es:
            raise kernels.KernelInputError(f"{name}: instance {g}'s table is not at lane x "
                                           f"{lane} + shard x {shard} elements from instance 0's")
    return lane, shard


def _correspond_launch(pts, mask, T, flags, map_state, index_strides, surfel_strides,
                       per_lane, cfg, lead, out):
    """One K2a launch over pts.shape[0] instances (pts (G, n, 3)) into
    `out`, or into new tensors of lead + (n, ...); returns the outputs."""
    g_n, n = pts.shape[0], pts.shape[1]
    lanes = g_n // per_lane
    kernels.check(pts, "pts", torch.float32, (g_n, n, 3))
    kernels.check(mask, "mask", torch.bool, (g_n, n))
    kernels.check(T, "T", torch.float32, (lanes, 16))
    kernels.check(flags, "flags", torch.int32, (lanes, 3))
    kernels.check(map_state.l1_index, "l1_index", torch.int32)
    kernels.check(map_state.l1_surfel, "l1_surfel", torch.float32)
    for t, name in ((T, "T"), (map_state.l1_index, "l1_index"),
                    (map_state.l1_surfel, "l1_surfel")):
        kernels.check_aligned(t, name)
    if out is None:
        dev = pts.device
        nrm = torch.empty(lead + (n, 3), dtype=torch.float32, device=dev)
        r = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
        valid = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    else:
        nrm, r, valid = out
        kernels.check(nrm, "nrm", torch.float32, lead + (n, 3))
        kernels.check(r, "r", torch.float32, lead + (n,))
        kernels.check(valid, "valid", torch.bool, lead + (n,))
    kernels.KERNELS["icp_correspond"].launch(
        pts.data_ptr(), mask.data_ptr(), n, g_n, per_lane, T.data_ptr(), flags.data_ptr(),
        map_state.l1_index.data_ptr(), *index_strides, map_state.n_buckets,
        map_state.l1_surfel.data_ptr(), *surfel_strides, map_state.c1,
        vm.parent_inv(cfg.voxel_size, cfg.hierarchy_factor),
        K.f32(cfg.max_correspondence_distance), nrm.data_ptr(), r.data_ptr(),
        valid.data_ptr())
    return nrm, r, valid


def icp_correspond_plain(pts, mask, T, map_state, cfg: ICPConfig):
    p_world = lie.transform_points(T.view(4, 4), pts)
    normals, centroids, valid = vm.lookup_surfels(
        map_state, p_world, voxel_size=cfg.voxel_size,
        hierarchy_factor=cfg.hierarchy_factor)
    r = torch.sum(normals * (p_world - centroids), dim=-1)
    valid = valid & mask & (torch.abs(r) <= K.f32(cfg.max_correspondence_distance))
    return normals, r, valid


# ---------------------------------------------------------------------------
# K2b: normal equations, solve, retract
# ---------------------------------------------------------------------------

def icp_normal_eq(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg: ICPConfig,
                  rw=None):
    """K2b's wrapper. scale (1,) f32; aux (2,) int32 [count, alpha_index];
    rw (N,) f32 or None: the residual whose magnitude sets the robust
    weights, in place of r (the loop-closure ICP weights by the plane
    distance and takes r against the nearest neighbour). Returns (T_out
    (16,), flags_out (3,) int32, hg (27,) = the 21 upper entries of H row
    by row, then g), with a leading B for lanes (hg is left unwritten for
    a lane whose solve is done)."""
    lead = _lanes(pts, "icp_normal_eq")
    if not pts.is_cuda:
        if lead:
            return _per_lane(lambda *a: icp_normal_eq_plain(*a[:8], consts, cfg, a[8]),
                             pts, nrm, r, valid, T, scale, flags, aux, rw)
        return icp_normal_eq_plain(pts, nrm, r, valid, T, scale, flags, aux,
                                   consts, cfg, rw)
    n = pts.shape[-2]
    kernels.check(pts, "pts", torch.float32, lead + (n, 3))
    kernels.check(nrm, "nrm", torch.float32, lead + (n, 3))
    kernels.check(r, "r", torch.float32, lead + (n,))
    if rw is not None:
        kernels.check(rw, "rw", torch.float32, lead + (n,))
    kernels.check(valid, "valid", torch.bool, lead + (n,))
    kernels.check(T, "T", torch.float32, lead + (16,))
    kernels.check(scale, "scale", torch.float32, lead + (1,))
    kernels.check(flags, "flags", torch.int32, lead + (3,))
    kernels.check(aux, "aux", torch.int32, lead + (2,))
    dev = pts.device
    lanes = lead[0] if lead else 1
    # T_out and hg share one allocation (T_out first, so 16-byte aligned as
    # K2a reads it); the kernel needs no scratch and nothing zeroed
    out = torch.empty((lanes * (16 + 27),), dtype=torch.float32, device=dev)
    T_out = out[:lanes * 16].view(lead + (16,))
    hg = out[lanes * 16:].view(lead + (27,))
    flags_out = torch.empty(lead + (3,), dtype=torch.int32, device=dev)
    kernels.KERNELS["icp_normal_eq"].launch(
        pts.data_ptr(), nrm.data_ptr(), r.data_ptr(),
        None if rw is None else rw.data_ptr(), valid.data_ptr(), n, lanes,
        T.data_ptr(), scale.data_ptr(), flags.data_ptr(), aux.data_ptr(),
        consts.alphas.data_ptr(), int(cfg.use_adaptive_m_estimator),
        K.f32(cfg.robust_loss_delta), int(cfg.use_robust_loss),
        int(cfg.loss_type == "cauchy"), cfg.min_correspondence_points,
        K.f32(cfg.translation_tolerance), K.f32(cfg.rotation_tolerance),
        T_out.data_ptr(), flags_out.data_ptr(), hg.data_ptr())
    return T_out, flags_out, hg


def icp_normal_eq_shape() -> dict:
    """K2b's launch shape as built: CTAs a lane's cluster, threads a CTA,
    points a thread loads at once. Builds the kernels if needed."""
    import ctypes
    fn = kernels.library("icp").lo_icp_normal_eq_shape
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    out = (ctypes.c_int * 3)()
    fn(out)
    return dict(zip(("cluster", "threads", "unroll"), list(out)))


_TRIU = [(a, b) for a in range(6) for b in range(a, 6)]


def icp_normal_eq_plain(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg, rw=None):
    T4 = T.view(4, 4)
    R = T4[:3, :3]
    done, failed, n_corr = flags[0] != 0, flags[1] != 0, flags[2]
    count, aidx = aux[0], aux[1]
    insufficient = count < cfg.min_correspondence_points
    rn = torch.abs(r if rw is None else rw) / torch.clamp(scale.reshape(()), min=1e-6)
    if cfg.use_adaptive_m_estimator:
        delta = consts.alphas[aidx.to(torch.int64)]
    else:
        delta = torch.tensor(K.f32(cfg.robust_loss_delta), device=pts.device)
    w = (robust_weights(rn, delta, cfg.loss_type) if cfg.use_robust_loss
         else torch.ones_like(r))
    w = torch.where(valid, w, 0.0)
    a = nrm @ R
    J = torch.where(valid[:, None], torch.cat([a, torch.linalg.cross(pts, a)], 1), 0.0)
    H = J.T @ (J * w[:, None])
    g = J.T @ torch.where(valid, w * r, 0.0)
    H = H + torch.eye(6, dtype=H.dtype, device=H.device) * 1e-8
    dx = torch.linalg.solve_ex(H, -g)[0]
    ok = torch.all(torch.isfinite(dx))
    dx = torch.where(ok, dx, 0.0)
    dt, dw = dx[:3], dx[3:]
    T_new = T4 @ lie.se3_from_exp_rt(dt, dw)
    conv = ((torch.linalg.norm(dt) < cfg.translation_tolerance)
            & (torch.linalg.norm(dw) < cfg.rotation_tolerance))
    step = ~done & ~insufficient
    T_out = torch.where(step, T_new, T4).reshape(16)
    flags_out = torch.stack([done | insufficient | (step & conv),
                             failed | (~done & insufficient),
                             torch.where(step, count, n_corr)]).to(torch.int32)
    hg = torch.cat([torch.stack([H[i, j] for i, j in _TRIU]), g])
    return T_out, flags_out, hg


# ---------------------------------------------------------------------------
# K5b: the 5-NN plane fit of KD-tree mode
# ---------------------------------------------------------------------------

class PlaneFit(NamedTuple):
    normal: torch.Tensor    # (N, 3)
    centroid: torch.Tensor  # (N, 3) of the fitted points
    nearest: torch.Tensor   # (N, 3) the nearest candidate
    valid: torch.Tensor     # (N,) bool
    dist: torch.Tensor      # (N,) |n.p - n.c|
    resid: torch.Tensor     # (N,) n.(p - c), the residual the normal equations take
    sel: torch.Tensor       # (N, 5) int32 the chosen candidates, nearest first


def plane_fit_5nn(p_world, cand, cand_ok, mask, cfg: ICPConfig, gate: bool, flags=None):
    """K5b's wrapper. p_world (N, 3) f32 query points, cand (N, K, 3) f32
    candidates with cand_ok (N, K) bool, K >= 5, mask (N,) bool. Takes the
    5 nearest candidates (ties to the lower index, as jax.lax.top_k),
    tests the nearest 3 for collinearity, fits a plane to the 5 over their
    mask and gates the fit: valid = mask & all 5 ok & not collinear, and
    with `gate` also dist <= max_correspondence_distance and planarity <=
    plane_fit_planarity. `flags` as in vm.grid_knn_neighbors. Returns a
    PlaneFit."""
    if not p_world.is_cuda:
        return plane_fit_5nn_plain(p_world, cand, cand_ok, mask, cfg, gate)
    n, k = cand.shape[0], cand.shape[1]
    if k < 5:
        raise ValueError(f"plane_fit_5nn: needs at least 5 candidates, got {k}")
    kernels.check(p_world, "p_world", torch.float32, (n, 3))
    kernels.check(cand, "cand", torch.float32, (n, k, 3))
    kernels.check(cand_ok, "cand_ok", torch.bool, (n, k))
    kernels.check(mask, "mask", torch.bool, (n,))
    if flags is not None:
        kernels.check(flags, "flags", torch.int32, (3,))
    f = dict(dtype=torch.float32, device=p_world.device)
    out = PlaneFit(normal=torch.empty((n, 3), **f), centroid=torch.empty((n, 3), **f),
                   nearest=torch.empty((n, 3), **f),
                   valid=torch.empty((n,), dtype=torch.bool, device=p_world.device),
                   dist=torch.empty((n,), **f), resid=torch.empty((n,), **f),
                   sel=torch.empty((n, 5), dtype=torch.int32, device=p_world.device))
    kernels.KERNELS["plane_fit_5nn"].launch(
        p_world.data_ptr(), cand.data_ptr(), cand_ok.data_ptr(), mask.data_ptr(), n, k,
        None if flags is None else flags.data_ptr(), int(gate),
        K.f32(cfg.max_correspondence_distance), K.f32(cfg.plane_fit_planarity),
        *(t.data_ptr() for t in out))
    return out


def _top5(p_world, cand, cand_ok):
    """Indices (N, 5) of the 5 nearest ok candidates, ties to the lower
    index; not-ok candidates count as infinitely far."""
    d = cand - p_world[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    d2 = torch.where(cand_ok, d2, math.inf)
    return torch.sort(d2, dim=1, stable=True).indices[:, :5]


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _is_collinear(p0, p1, p2, threshold: float):
    c = torch.linalg.cross(_unit(p1 - p0), _unit(p2 - p0))
    return torch.linalg.norm(c, dim=-1) < threshold


def plane_fit_5nn_plain(p_world, cand, cand_ok, mask, cfg: ICPConfig, gate: bool):
    sel = _top5(p_world, cand, cand_ok)
    nb = torch.gather(cand, 1, sel[..., None].expand(-1, -1, 3))
    nb_ok = torch.gather(cand_ok, 1, sel)
    collinear = _is_collinear(nb[:, 0], nb[:, 1], nb[:, 2], 0.5)
    normal, centroid, plan = E.plane_from_points(nb, nb_ok)
    dist = torch.abs(torch.sum(normal * p_world, -1) - torch.sum(normal * centroid, -1))
    valid = mask & torch.all(nb_ok, 1) & ~collinear
    if gate:
        valid = (valid & (dist <= K.f32(cfg.max_correspondence_distance))
                 & (plan <= K.f32(cfg.plane_fit_planarity)))
    return PlaneFit(normal=normal, centroid=centroid, nearest=nb[:, 0], valid=valid, dist=dist,
                    resid=torch.sum(normal * (p_world - centroid), -1),
                    sel=sel.to(torch.int32))


def _grid_plane_correspondences(map_state, pts, mask, T, flags, cfg: ICPConfig) -> PlaneFit:
    """KD-tree-mode correspondences: K5a's candidates (the row mask ANDed
    into their flags in the kernel), K5b's plane fit."""
    p_world = lie.transform_points(T.view(4, 4), pts)
    cand, cand_ok = vm.grid_knn_neighbors(map_state, p_world, voxel_size=cfg.voxel_size,
                                          radius=cfg.grid_knn_radius, flags=flags, mask=mask)
    return plane_fit_5nn(p_world, cand, cand_ok, mask, cfg, gate=True, flags=flags)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def icp_optimize(map_state: vm.VoxelMapState, pts, mask, T_init,
                 pko_consts: pko.PKOConstants, cfg: ICPConfig):
    """Scan-to-map ICP. pts (N, 3) local features with mask (N,); T_init
    (4, 4) world pose guess. Returns (T_opt (4, 4), success () bool,
    n_correspondences () int32); on failure T_opt is T_init. For B lanes
    against the one map: pts (B, N, 3), mask (B, N), T_init (B, 4, 4) ->
    (B, 4, 4), (B,), (B,)."""
    lead = _lanes(pts, "icp_optimize")
    if lead and not cfg.use_surfel_correspondence:
        # KD-tree mode's kernels (K5a, K5b) take one lane: solve lane by lane
        return _per_lane(lambda p, m, t: icp_optimize(map_state, p, m, t, pko_consts, cfg),
                         pts, mask, T_init)
    dev = pts.device
    T = T_init.reshape(lead + (16,)).contiguous()
    flags = torch.zeros(lead + (3,), dtype=torch.int32, device=dev)
    scale = torch.ones(lead + (1,), dtype=torch.float32, device=dev)
    for i in range(cfg.max_iterations):
        if cfg.use_surfel_correspondence:
            nrm, r, valid = icp_correspond(pts, mask, T, flags, map_state, cfg)
            r_abs = r   # K3 takes |r|
        else:
            fit = _grid_plane_correspondences(map_state, pts, mask, T, flags, cfg)
            nrm, r, valid, r_abs = fit.normal, fit.resid, fit.valid, fit.dist
        aux, scale = _scale_and_alpha(r_abs, valid, flags, scale, i == 0, pko_consts, cfg)
        T, flags, _ = icp_normal_eq(pts, nrm, r, valid, T, scale, flags, aux,
                                    pko_consts, cfg)
    success = flags[..., 1] == 0
    T_final = torch.where(success[..., None, None], T.view(lead + (4, 4)), T_init)
    return T_final, success, flags[..., 2]


def _scale_and_alpha(r_abs, valid, flags, scale, first: bool, pko_consts, cfg: ICPConfig):
    """The iteration-0 residual scale and the robust delta's index (K3)."""
    if cfg.use_adaptive_m_estimator:
        return pko.pko_alpha_index(r_abs, valid, flags, scale, first, pko_consts)
    if first:
        scale = pko.norm_scale_from(torch.abs(r_abs), valid)[..., None]
    count = valid.sum(-1)
    aux = torch.stack([count, torch.zeros_like(count)], -1).to(torch.int32)
    return aux, scale


# ---------------------------------------------------------------------------
# the loop-closure solve (JAX icp_optimize_loop, _loop_solve_jit,
# _loop_prealign_jit, loop_closure_solve)
# ---------------------------------------------------------------------------

# The polish phase's step tolerances, much tighter than the odometry's: a
# 3e-4 rad loop rotation error at a 20 m lever arm bends the trajectory by
# ~6 mm (the JAX package's measurement behind the same values).
POLISH_TOLERANCE = (1e-4, 2e-5)


def _plane_correspondences(table: knn.PointTable, pts, mask, T, cfg: ICPConfig, *,
                           radius: int, bucket_width: int, gate: bool, flags):
    """5-NN against a point table (K6b) and the plane fit (K5b)."""
    p_world = lie.transform_points(T.view(4, 4), pts).contiguous()
    nb, nb_ok, _ = knn.knn_query(table, p_world, k=5, radius=radius,
                                 bucket_width=bucket_width, flags=flags)
    return p_world, plane_fit_5nn(p_world, nb, nb_ok, mask, cfg, gate=gate, flags=flags)


def _loop_phase(table, pts, mask, T, flags, pko_consts, cfg: ICPConfig, *, iterations: int,
                radius: int, bucket_width: int, polish: bool):
    """Up to `iterations` Gauss-Newton steps against one table. Coarse
    (polish=False): ungated fits, the residual against the nearest
    neighbour. Polish: gated fits, the residual against the fitted
    centroid, and the RMS plane distance of the last step taken. Both
    weight each point by its plane distance (K2b's weight residual)."""
    scale = torch.ones((1,), dtype=torch.float32, device=pts.device)
    rms = torch.zeros((), dtype=torch.float32, device=pts.device)
    for i in range(iterations):
        if not pts.is_cuda and bool(flags[0]):
            break     # on the host the loop may stop; the card's kernels return at once
        p_world, fit = _plane_correspondences(table, pts, mask, T, cfg, radius=radius,
                                              bucket_width=bucket_width, gate=polish,
                                              flags=flags)
        r = fit.resid if polish else torch.sum(fit.normal * (p_world - fit.nearest), -1)
        aux, scale = _scale_and_alpha(fit.dist, fit.valid, flags, scale, i == 0, pko_consts, cfg)
        if polish:
            w = fit.valid.to(torch.float32)
            step = (flags[0] == 0) & (aux[0] >= cfg.min_correspondence_points)
            new = torch.sqrt(torch.sum(fit.dist * fit.dist * w) / torch.clamp(w.sum(), min=1.0))
            rms = torch.where(step, new, rms)
        T, flags, _ = icp_normal_eq(pts, fit.normal, r, fit.valid, T, scale, flags, aux,
                                    pko_consts, cfg, rw=fit.dist)
    return T, flags, rms


def icp_optimize_loop(curr_pts, curr_mask, T_curr, matched_table: knn.PointTable,
                      pko_consts: pko.PKOConstants, cfg: ICPConfig, *, T_init=None,
                      max_loop_iterations: int = 100, search_radius: int = 2,
                      bucket_width: int = 16, fine_table=None, polish_iterations: int = 8):
    """Loop-closure ICP of the query keyframe's local features against the
    matched keyframe's world cloud: up to max_loop_iterations coarse steps
    (success needs convergence), then, with a fine table, up to
    polish_iterations steps from a converged pose, then the 1-NN inlier
    ratio (distance < 1 m, >= 0.5 to succeed). Returns (T_rel =
    T_curr^-1 T_opt (4, 4), success () bool, inlier_ratio (), resid_rms ()),
    all on the device."""
    dev = curr_pts.device
    T = (T_curr if T_init is None else T_init).reshape(16).contiguous()
    flags = torch.zeros((3,), dtype=torch.int32, device=dev)
    T, flags, _ = _loop_phase(matched_table, curr_pts, curr_mask, T, flags, pko_consts, cfg,
                              iterations=max_loop_iterations, radius=search_radius,
                              bucket_width=bucket_width, polish=False)
    converged = (flags[0] != 0) & (flags[1] == 0)
    resid_rms = torch.zeros((), dtype=torch.float32, device=dev)
    if fine_table is not None and polish_iterations > 0:
        tol_t, tol_r = POLISH_TOLERANCE
        pcfg = replace(cfg, translation_tolerance=tol_t, rotation_tolerance=tol_r)
        pflags = torch.stack([(~converged).to(torch.int32), flags[1] * 0, flags[2] * 0])
        T, _, resid_rms = _loop_phase(fine_table, curr_pts, curr_mask, T, pflags, pko_consts,
                                      pcfg, iterations=polish_iterations, radius=1,
                                      bucket_width=4, polish=True)
    p_world = lie.transform_points(T.view(4, 4), curr_pts).contiguous()
    d1 = knn.nn1_distance(matched_table, p_world, radius=search_radius,
                          bucket_width=bucket_width)
    w = curr_mask.to(torch.float32)
    inlier_ratio = (torch.sum(((d1 < 1.0) & curr_mask).to(torch.float32))
                    / torch.clamp(w.sum(), min=1.0))
    success = converged & (inlier_ratio >= 0.5)
    T_rel = lie.se3_inv(T_curr) @ T.view(4, 4)
    return T_rel, success, inlier_ratio, resid_rms


def loop_solve(curr_pts, curr_mask, T_curr, matched_pts, matched_mask, matched_pose, T_init,
               pko_consts, cfg: ICPConfig, max_loop_iterations: int, search_radius: int,
               bucket_width: int, bin_scale: float, polish_iterations: int):
    """The matched keyframe's world cloud, its coarse (and fine) point
    tables, the loop ICP. Returns one packed (19,) f32 tensor
    [T_rel (16) | success | inlier_ratio | resid_rms]."""
    matched_world = lie.transform_points(matched_pose, matched_pts).contiguous()
    table = knn.build_point_table(matched_world, matched_mask,
                                  bin_size=K.f32(cfg.voxel_size * bin_scale))
    fine = None
    if polish_iterations > 0:
        fine = knn.build_point_table(matched_world, matched_mask, bin_size=cfg.voxel_size)
    T_rel, success, inlier, rms = icp_optimize_loop(
        curr_pts, curr_mask, T_curr, table, pko_consts, cfg, T_init=T_init,
        max_loop_iterations=max_loop_iterations, search_radius=search_radius,
        bucket_width=bucket_width, fine_table=fine, polish_iterations=polish_iterations)
    return torch.cat([T_rel.reshape(16), success.to(torch.float32)[None], inlier[None],
                      rms[None]])


def loop_prealign(T_curr, matched_pose, bias_deg, curr_pts, curr_mask, matched_pts,
                  matched_mask):
    """The prealigned world pose of the query keyframe (Iris yaw + BEV
    phase correlation against the matched keyframe's world cloud)."""
    matched_world = lie.transform_points(matched_pose, matched_pts).contiguous()
    return bev_align.prealign_pose_t(T_curr, matched_pose, bias_deg, curr_pts, curr_mask,
                                     matched_world, matched_mask)


def loop_closure_solve(curr_pts, curr_mask, T_curr, matched_pts, matched_mask, matched_pose,
                       bias_deg, pko_consts, cfg: ICPConfig, *, prealign: bool = True,
                       max_loop_iterations: int = 100, search_radius: int = 2,
                       bucket_width: int = 16, bin_scale: float = 4.0,
                       polish_iterations: int = 8):
    """The loop-closure geometry: prealign (with `prealign`, then a coarse
    search radius of at most 1), coarse + fine loop ICP, inlier check.
    curr/matched points are each keyframe's LOCAL features, poses (4, 4)
    f32 world poses, bias_deg a 0-d f32 tensor. Returns the packed (19,)
    f32 tensor of loop_solve, on the device."""
    if prealign:
        T_init = loop_prealign(T_curr, matched_pose, bias_deg, curr_pts, curr_mask,
                               matched_pts, matched_mask)
        search_radius = min(search_radius, 1)
    else:
        T_init = T_curr
    return loop_solve(curr_pts, curr_mask, T_curr, matched_pts, matched_mask, matched_pose,
                      T_init, pko_consts, cfg, max_loop_iterations, search_radius,
                      bucket_width, bin_scale, polish_iterations)
