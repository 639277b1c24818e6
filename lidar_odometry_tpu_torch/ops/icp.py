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
      the 21 + 6 sums of J^T W J and J^T W r reduced across blocks, and in
      the last block the 6x6 solve (+1e-8 I), the retract T * (Exp(dw), dt)
      and the done / failed / n_corr update.
K3 needs every normalised residual before any weight exists, hence two
ICP launches and not one. The loop always runs max_iterations launches;
once the solve is done (converged or failed) the kernels return at once
and leave the state as it is, which gives the result of the JAX
while_loop with early exit.

KD-tree mode (use_surfel_correspondence=False) finds its correspondences
in the L0 voxels instead of the surfels, in two launches in place of K2a:
  K5a grid_knn (ops/voxel_map.py): the (2r+1)^3 neighbourhood's centroids;
  K5b plane_fit_5nn (csrc/grid_knn.cu): the 5 nearest of them, the
      collinearity test on the nearest 3, a plane fit with eigh3, the
      distance and planarity gates.
then K3 and K2b as in surfel mode. The residual target is the plane's
centroid; the magnitude that sets the iteration-0 scale and PKO's alpha
is K5b's point-to-plane distance.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import kernels
from ..utils import eigh3 as E
from ..utils import keys as K
from ..utils import lie
from . import pko
from . import voxel_map as vm

__all__ = ["ICPConfig", "icp_optimize", "icp_correspond", "icp_correspond_plain",
           "icp_normal_eq", "icp_normal_eq_plain", "robust_weights", "PlaneFit",
           "plane_fit_5nn", "plane_fit_5nn_plain"]

NE_THREADS = 256
NE_MAX_BLOCKS = 128


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

def icp_correspond(pts, mask, T, flags, map_state: vm.VoxelMapState, cfg: ICPConfig):
    """K2a's wrapper. pts (N, 3) f32, mask (N,) bool, T (16,) f32 row-major,
    flags (3,) int32 [done, failed, n_corr]. Returns (normals (N, 3),
    signed residual (N,), valid (N,) bool)."""
    if not pts.is_cuda:
        return icp_correspond_plain(pts, mask, T, map_state, cfg)
    n = pts.shape[0]
    kernels.check(pts, "pts", torch.float32, (n, 3))
    kernels.check(mask, "mask", torch.bool, (n,))
    kernels.check(T, "T", torch.float32, (16,))
    kernels.check(flags, "flags", torch.int32, (3,))
    kernels.check(map_state.l1_index, "l1_index", torch.int32)
    kernels.check(map_state.l1_surfel, "l1_surfel", torch.float32)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=pts.device)
    r = torch.empty((n,), dtype=torch.float32, device=pts.device)
    valid = torch.empty((n,), dtype=torch.bool, device=pts.device)
    kernels.KERNELS["icp_correspond"].launch(
        pts.data_ptr(), mask.data_ptr(), n, T.data_ptr(), flags.data_ptr(),
        map_state.l1_index.data_ptr(), map_state.n_buckets,
        map_state.l1_surfel.data_ptr(), map_state.c1,
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

def icp_normal_eq(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg: ICPConfig):
    """K2b's wrapper. scale (1,) f32; aux (2,) int32 [count, alpha_index].
    Returns (T_out (16,), flags_out (3,) int32, hg (27,) = the 21 upper
    entries of H row by row, then g)."""
    if not pts.is_cuda:
        return icp_normal_eq_plain(pts, nrm, r, valid, T, scale, flags, aux,
                                   consts, cfg)
    n = pts.shape[0]
    kernels.check(pts, "pts", torch.float32, (n, 3))
    kernels.check(nrm, "nrm", torch.float32, (n, 3))
    kernels.check(r, "r", torch.float32, (n,))
    kernels.check(valid, "valid", torch.bool, (n,))
    kernels.check(T, "T", torch.float32, (16,))
    kernels.check(scale, "scale", torch.float32, (1,))
    kernels.check(flags, "flags", torch.int32, (3,))
    kernels.check(aux, "aux", torch.int32, (2,))
    dev = pts.device
    grid = max(1, min(NE_MAX_BLOCKS, (n + NE_THREADS - 1) // NE_THREADS))
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)   # blocks done
    partials = torch.empty((grid, 27), dtype=torch.float32, device=dev)
    T_out = torch.empty((16,), dtype=torch.float32, device=dev)
    flags_out = torch.empty((3,), dtype=torch.int32, device=dev)
    hg = torch.empty((27,), dtype=torch.float32, device=dev)
    kernels.KERNELS["icp_normal_eq"].launch(
        pts.data_ptr(), nrm.data_ptr(), r.data_ptr(), valid.data_ptr(), n,
        T.data_ptr(), scale.data_ptr(), flags.data_ptr(), aux.data_ptr(),
        consts.alphas.data_ptr(), int(cfg.use_adaptive_m_estimator),
        K.f32(cfg.robust_loss_delta), int(cfg.use_robust_loss),
        int(cfg.loss_type == "cauchy"), cfg.min_correspondence_points,
        K.f32(cfg.translation_tolerance), K.f32(cfg.rotation_tolerance),
        partials.data_ptr(), counter.data_ptr(), T_out.data_ptr(),
        flags_out.data_ptr(), hg.data_ptr())
    return T_out, flags_out, hg


_TRIU = [(a, b) for a in range(6) for b in range(a, 6)]


def icp_normal_eq_plain(pts, nrm, r, valid, T, scale, flags, aux, consts, cfg):
    T4 = T.view(4, 4)
    R = T4[:3, :3]
    done, failed, n_corr = flags[0] != 0, flags[1] != 0, flags[2]
    count, aidx = aux[0], aux[1]
    insufficient = count < cfg.min_correspondence_points
    rn = torch.abs(r) / torch.clamp(scale.reshape(()), min=1e-6)
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
    """KD-tree-mode correspondences: K5a's candidates, K5b's plane fit."""
    p_world = lie.transform_points(T.view(4, 4), pts)
    cand, cand_ok = vm.grid_knn_neighbors(map_state, p_world, voxel_size=cfg.voxel_size,
                                          radius=cfg.grid_knn_radius, flags=flags)
    return plane_fit_5nn(p_world, cand, cand_ok & mask[:, None], mask, cfg, gate=True,
                         flags=flags)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def icp_optimize(map_state: vm.VoxelMapState, pts, mask, T_init,
                 pko_consts: pko.PKOConstants, cfg: ICPConfig):
    """Scan-to-map ICP. pts (N, 3) local features with mask (N,); T_init
    (4, 4) world pose guess. Returns (T_opt (4, 4), success () bool,
    n_correspondences () int32); on failure T_opt is T_init."""
    dev = pts.device
    T = T_init.reshape(16).contiguous()
    flags = torch.zeros((3,), dtype=torch.int32, device=dev)
    scale = torch.ones((1,), dtype=torch.float32, device=dev)
    for i in range(cfg.max_iterations):
        if cfg.use_surfel_correspondence:
            nrm, r, valid = icp_correspond(pts, mask, T, flags, map_state, cfg)
            r_abs = r   # K3 takes |r|
        else:
            fit = _grid_plane_correspondences(map_state, pts, mask, T, flags, cfg)
            nrm, r, valid, r_abs = fit.normal, fit.resid, fit.valid, fit.dist
        if cfg.use_adaptive_m_estimator:
            aux, scale = pko.pko_alpha_index(r_abs, valid, flags, scale, i == 0,
                                             pko_consts)
        else:
            if i == 0:
                scale = pko.norm_scale_from(torch.abs(r_abs), valid).reshape(1)
            aux = torch.stack([valid.sum(), torch.zeros_like(valid.sum())]).to(torch.int32)
        T, flags, _ = icp_normal_eq(pts, nrm, r, valid, T, scale, flags, aux,
                                    pko_consts, cfg)
    success = flags[1] == 0
    T_final = torch.where(success, T.view(4, 4), T_init)
    return T_final, success, flags[2]
