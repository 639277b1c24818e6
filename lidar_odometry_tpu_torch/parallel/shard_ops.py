"""The sharded map's kernels K11a-d (csrc/shard.cu) and their plain twins
(counterparts of the JAX package's parallel/sharded_map.py
owner_of_points, _owned_cap, _compact_owned and robust_icp_loop's
gn_round).

A launch covers G = L x n_local shard instances (L lanes, each with the
n_local shards this rank holds of its map); instance g = lane * n_local + k
holds global shard first + k. The ICP's cross-shard sums take gathered
rows (ShardGroup.all_gather, (L, S, ...)) and add them in shard order.

  K11a shard_own: each point's owner, the parent cell's second hash mod
      S, after an optional transform T (ICP hashes world points but
      compacts body points), and the order-preserving compaction of the
      masked owned points into `cap` rows an instance, padded with row
      N - 1 (the clipped sort's padding), with the count of owned points
      past `cap` (dropped, as JAX drops them), on one thread-block cluster
      a lane that ranks every point once for all of the lane's local
      shards (at most 8); or the owner ids alone (the rehash).
  K11b shard_alpha_normal_eq: from K2a's per-shard correspondences, J =
      [R^T n, p x R^T n] and Z = [vec(J J^T) | J r]; for each of A robust
      deltas the weighted sum of Z (A, 42) and the count, the product W @ Z
      on a thread-block cluster an (instance, 32 alphas); or the raw
      moments [sum w, sum |r| w, sum r^2 w] of iteration 0.
  K11c shard_sample: one draw per stratum of the valid ranks of |r| /
      scale with the shard's uniforms, into the shard's slice of the
      (S * quota) sample and ok buffers, zero elsewhere; a slice of K11b's
      grid, so the ICP's rounds run it inside K11b's launch
      (shard_alpha_normal_eq_sample), and alone through shard_sample.
  K11d shard_gn_select: on the gathered buffers, the sample slots filled
      with the mean of the filled ones, K3's GMM fit and JS argmin, the
      chosen system's 6x6 solve, the retract and the done / failed /
      n_corr rules; one block a lane, a done lane returns at once.

Buffers: the ICP round's per-shard row is [A * 42 systems | S * quota
samples | S * quota ok | count] (ld = A * 42 + 2 S quota + 1), as the JAX
program psums it; K11b writes the systems and the count, K11c the sample
slots, both in one launch. The iteration-0 scale std / 6 comes from the
gathered moments, summed in shard order with each operation rounded
(scale_from_moments); K11b and K11c each derive it from the same moments.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops import icp as icp_ops
from ..ops import pko
from ..ops import voxel_map as vm
from ..utils import keys as K
from ..utils import lie

__all__ = ["owned_cap", "owner_inv", "shard_own", "shard_own_plain", "shard_owner",
           "shard_owner_plain", "scale_from_moments", "shard_alpha_normal_eq",
           "shard_alpha_normal_eq_plain", "shard_alpha_normal_eq_shape",
           "shard_alpha_normal_eq_sample", "shard_sample", "shard_sample_plain",
           "shard_gn_select", "shard_gn_select_plain", "buffer_width"]


MAX_LOCAL_SHARDS = 8   # K11a's local shards a launch (pko.shard_draws' largest S)
MAX_QUOTA = 100        # K11c's draws a shard
MAX_SAMPLE_ROW = 65521  # K11c's entries an instance (4096 chunks of 16 flags)


def owned_cap(n: int, n_shards: int) -> int:
    """Static per-shard point capacity: N/S with scale-aware headroom for
    the per-parent-cell hash imbalance, margin 1 + 30 S / sqrt(N) clamped
    to [1.1, 2.2], a multiple of 256, at most N (the JAX _owned_cap)."""
    if n_shards <= 1:
        return n
    margin = min(max(1.0 + 30.0 * n_shards / np.sqrt(n), 1.1), 2.2)
    cap = int(np.ceil(n / n_shards * margin / 256.0)) * 256
    return min(cap, n)


def owner_inv(voxel_size: float, hierarchy_factor: int) -> float:
    """1 / parent-cell size: the owner hashes the same parent key as the
    surfel lookup."""
    return vm.parent_inv(voxel_size, hierarchy_factor)


def buffer_width(n_alpha: int, n_shards: int, quota: int) -> int:
    """ld of the ICP round's per-shard row."""
    return n_alpha * 42 + 2 * n_shards * quota + 1


# ---------------------------------------------------------------------------
# K11a: ownership and compaction
# ---------------------------------------------------------------------------

def shard_owner_plain(pts, n_shards: int, inv: float) -> torch.Tensor:
    hi, lo = K.pack_key(K.voxel_coords(pts, inv))
    h = vm._mul32(hi, 0x85EBCA77) ^ vm._mul32(lo, 0xC2B2AE3D)
    h = vm._mul32(h ^ (h >> 16), 0x7FEB352D)
    h = h ^ (h >> 15)
    return (h % n_shards).to(torch.int32)


def _transform_plain(T, pts):
    """R p + t of (L, 16) poses on (L, N, 3) points, each product and sum
    rounded in the kernel's order."""
    T4 = T.view(-1, 1, 4, 4)
    return (((pts[..., 0:1] * T4[..., :3, 0] + pts[..., 1:2] * T4[..., :3, 1])
             + pts[..., 2:3] * T4[..., :3, 2]) + T4[..., :3, 3])


def shard_own(pts, mask, T, n_shards: int, first: int, n_local: int, cap: int, inv: float):
    """K11a's wrapper. pts (L, N, 3) f32, mask (L, N) bool, T (L, 16) f32
    (owners of T p; None: of p). Returns, for the G = L * n_local
    instances, (p_own (G, cap, 3) f32, ok (G, cap) bool, sel (G, cap)
    int32, over (G,) int32 owned points past cap)."""
    if not pts.is_cuda:
        return shard_own_plain(pts, mask, T, n_shards, first, n_local, cap, inv)
    lanes, n = pts.shape[0], pts.shape[1]
    kernels.check(pts, "pts", torch.float32, (lanes, n, 3))
    kernels.check(mask, "mask", torch.bool, (lanes, n))
    if not 1 <= n_local <= MAX_LOCAL_SHARDS:
        raise kernels.KernelInputError(f"n_local: the kernel covers 1 to {MAX_LOCAL_SHARDS} "
                                       f"local shards, got {n_local}")
    if T is not None:
        kernels.check(T, "T", torch.float32, (lanes, 16))
    g = lanes * n_local
    dev = pts.device
    p_own = torch.empty((g, cap, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((g, cap), dtype=torch.bool, device=dev)
    sel = torch.empty((g, cap), dtype=torch.int32, device=dev)
    over = torch.empty((g,), dtype=torch.int32, device=dev)
    kernels.KERNELS["shard_own"].launch(
        pts.data_ptr(), mask.data_ptr(), n, lanes, None if T is None else T.data_ptr(),
        n_shards, first, n_local, cap, inv, p_own.data_ptr(), ok.data_ptr(), sel.data_ptr(),
        over.data_ptr(), None)
    return p_own, ok, sel, over


def shard_own_plain(pts, mask, T, n_shards: int, first: int, n_local: int, cap: int,
                    inv: float):
    lanes, n = pts.shape[0], pts.shape[1]
    owner = shard_owner_plain(pts if T is None else _transform_plain(T, pts), n_shards, inv)
    outs = []
    for lane in range(lanes):
        for k in range(n_local):
            idx = torch.nonzero(mask[lane] & (owner[lane] == first + k)).flatten()
            sel = torch.full((cap,), n - 1, dtype=torch.int64, device=pts.device)
            kept = idx[:cap]
            sel[:kept.numel()] = kept
            ok = torch.arange(cap, device=pts.device) < idx.numel()
            over = torch.clamp(torch.tensor(idx.numel() - cap), min=0)
            outs.append((pts[lane][sel], ok, sel.to(torch.int32), over.to(torch.int32)))
    return tuple(torch.stack(c).to(pts.device) for c in zip(*outs))


def shard_owner(pts, n_shards: int, inv: float) -> torch.Tensor:
    """K11a's owner-only mode: (M, 3) f32 points -> (M,) int32 owners."""
    if not pts.is_cuda:
        return shard_owner_plain(pts, n_shards, inv)
    m = pts.shape[0]
    kernels.check(pts, "pts", torch.float32, (m, 3))
    owner = torch.empty((m,), dtype=torch.int32, device=pts.device)
    kernels.KERNELS["shard_own"].launch(
        pts.data_ptr(), None, m, 1, None, n_shards, 0, 1, 0, inv, None, None, None, None,
        owner.data_ptr())
    return owner


# ---------------------------------------------------------------------------
# K11b: per-alpha normal equations and moments
# ---------------------------------------------------------------------------

def scale_from_moments(mom) -> torch.Tensor:
    """(L, S, 3) gathered raw moments -> (L,) the iteration-0 scale std / 6,
    the shards' moments added in shard order."""
    m = mom[:, 0]
    for s in range(1, mom.shape[1]):
        m = m + mom[:, s]
    n0 = torch.clamp(m[:, 0], min=1.0)
    mean = m[:, 1] / n0
    var = torch.clamp(m[:, 2] / n0 - mean * mean, min=0.0)
    # a tensor divisor: a CUDA tensor divided by a Python scalar is
    # multiplied by its reciprocal, which rounds differently
    return torch.sqrt(var) / torch.full_like(var, 6.0)


def shard_alpha_normal_eq(p_own, nrm, r, valid, T, flags, mom, alphas, cfg, *, n_local: int,
                          moments: bool = False, out=None):
    """K11b's wrapper. For G instances: p_own, nrm (G, n, 3) f32, r (G, n)
    f32, valid (G, n) bool; T (L, 16) f32 and flags (L, 3) int32 of the
    lanes; mom (L, S, 3) the gathered moments; alphas (A,) f32 the robust
    deltas (weights from cfg's loss with cfg.use_robust_loss, else unit).
    moments=True returns the (G, 3) raw moments (zero for a done lane);
    else writes the (A, 42) systems and the count into out (G, ld) and
    returns it, a done lane's rows left unwritten."""
    if not r.is_cuda:
        return shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T, flags, mom, alphas, cfg,
                                           n_local=n_local, moments=moments, out=out)
    if moments:
        g = r.shape[0]
        _check_ne(p_own, nrm, r, valid, T, flags)
        out = torch.empty((g, 3), dtype=torch.float32, device=r.device)   # all written
        kernels.KERNELS["shard_alpha_normal_eq"].launch(
            p_own.data_ptr(), nrm.data_ptr(), r.data_ptr(), valid.data_ptr(), r.shape[1], g,
            n_local, T.data_ptr(), flags.data_ptr(), None, 1, None, 1,
            int(cfg.use_robust_loss), int(cfg.loss_type == "cauchy"), 1, 3, out.data_ptr(),
            None, 0, 0, 0)
        return out
    _launch_ne(p_own, nrm, r, valid, T, flags, mom, alphas, cfg, n_local, out, None, 0, 0)
    return out


def shard_alpha_normal_eq_sample(p_own, nrm, r, valid, T, flags, mom, alphas, u, cfg, *,
                                 first: int, n_local: int, off: int, out):
    """K11b with K11c's sample in its launch: shard_alpha_normal_eq's
    systems and count and shard_sample's slots [off, off + 2 S quota) of
    out (G, ld), one launch (K11c's work counted in its `fused`); the
    arguments as those two take them. Returns out."""
    if not r.is_cuda:
        shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T, flags, mom, alphas, cfg,
                                    n_local=n_local, out=out)
        return shard_sample_plain(r, valid, flags, mom, u, first=first, n_local=n_local,
                                  off=off, out=out)
    _check_sample(r, valid, flags, mom, u, off, out, "shard_alpha_normal_eq_sample")
    _launch_ne(p_own, nrm, r, valid, T, flags, mom, alphas, cfg, n_local, out, u, first, off)
    return out


def _check_ne(p_own, nrm, r, valid, T, flags):
    g, n = r.shape
    lanes = T.shape[0]
    kernels.check(p_own, "p_own", torch.float32, (g, n, 3))
    kernels.check(nrm, "nrm", torch.float32, (g, n, 3))
    kernels.check(r, "r", torch.float32, (g, n))
    kernels.check(valid, "valid", torch.bool, (g, n))
    kernels.check(T, "T", torch.float32, (lanes, 16))
    kernels.check(flags, "flags", torch.int32, (lanes, 3))


def _launch_ne(p_own, nrm, r, valid, T, flags, mom, alphas, cfg, n_local, out, u, first, off):
    """K11b's systems into out; with u (S, quota), K11c's sample slice in
    the same grid."""
    g, n = r.shape
    lanes = T.shape[0]
    _check_ne(p_own, nrm, r, valid, T, flags)
    n_shards = mom.shape[1]
    kernels.check(mom, "mom", torch.float32, (lanes, n_shards, 3))
    kernels.check(alphas, "alphas", torch.float32)
    kernels.check(out, "out", torch.float32)
    a = alphas.shape[0]
    if out.shape[0] != g or out.shape[1] < a * 42 + 1:
        raise kernels.KernelInputError(f"shard_alpha_normal_eq: out of shape {tuple(out.shape)}")
    kernels.KERNELS["shard_alpha_normal_eq"].launch(
        p_own.data_ptr(), nrm.data_ptr(), r.data_ptr(), valid.data_ptr(), n, g, n_local,
        T.data_ptr(), flags.data_ptr(), mom.data_ptr(), n_shards, alphas.data_ptr(), a,
        int(cfg.use_robust_loss), int(cfg.loss_type == "cauchy"), 0, out.shape[1],
        out.data_ptr(), None if u is None else u.data_ptr(), 0 if u is None else u.shape[1],
        first, off, fused=() if u is None else ("shard_sample",))


def shard_alpha_normal_eq_plain(p_own, nrm, r, valid, T, flags, mom, alphas, cfg, *,
                                n_local: int, moments: bool = False, out=None):
    g = r.shape[0]
    w = valid.to(torch.float32)
    live = flags[torch.arange(g, device=r.device) // n_local, 0] == 0
    if moments:
        ra = torch.abs(r)
        m = torch.stack([w.sum(1), (ra * w).sum(1), (ra * ra * w).sum(1)], 1)
        return torch.where(live[:, None], m, 0.0)
    a = alphas.shape[0]
    denom = torch.clamp(scale_from_moments(mom), min=1e-6)
    for i in range(g):
        lane = i // n_local
        if not live[i]:
            continue
        R = T[lane].view(4, 4)[:3, :3]
        an = nrm[i] @ R
        J = torch.cat([an, torch.linalg.cross(p_own[i], an)], 1)
        Z = torch.cat([(J[:, :, None] * J[:, None, :]).reshape(-1, 36), J * r[i][:, None]], 1)
        Z = torch.where(valid[i][:, None], Z, 0.0)
        if cfg.use_robust_loss:
            rn = torch.abs(r[i]) / denom[lane]
            W = icp_ops.robust_weights(rn[None, :], alphas[:, None], cfg.loss_type) * w[i]
        else:
            W = w[i].expand(a, -1)
        out[i, :a * 42] = (W @ Z).reshape(-1)
        out[i, -1] = w[i].sum()
    return out


# ---------------------------------------------------------------------------
# K11c: the per-shard stratified sample
# ---------------------------------------------------------------------------

def shard_sample(r, valid, flags, mom, u, *, first: int, n_local: int, off: int, out):
    """K11c's wrapper (alone: the ICP's rounds run it inside K11b's launch,
    shard_alpha_normal_eq_sample). r (G, n) f32, valid (G, n) bool, flags
    (L, 3) int32, mom (L, S, 3), u (S, quota) f32 every shard's uniforms.
    Writes each instance's samples (times ok) and ok flags at [off, off +
    S quota) and [off + S quota, off + 2 S quota) of out (G, ld), zero
    outside its shard's slots; returns out. A done lane's rows are left
    unwritten."""
    if not r.is_cuda:
        return shard_sample_plain(r, valid, flags, mom, u, first=first, n_local=n_local,
                                  off=off, out=out)
    _check_sample(r, valid, flags, mom, u, off, out, "shard_sample")
    g, n = r.shape
    kernels.KERNELS["shard_sample"].launch(
        r.data_ptr(), valid.data_ptr(), n, g, n_local, first, flags.data_ptr(), mom.data_ptr(),
        mom.shape[1], u.data_ptr(), u.shape[1], off, out.shape[1], out.data_ptr())
    return out


def _check_sample(r, valid, flags, mom, u, off, out, name):
    g, n = r.shape
    lanes, n_shards = mom.shape[0], mom.shape[1]
    q = u.shape[1]
    kernels.check(r, "r", torch.float32, (g, n))
    kernels.check(valid, "valid", torch.bool, (g, n))
    kernels.check(flags, "flags", torch.int32, (lanes, 3))
    kernels.check(mom, "mom", torch.float32, (lanes, n_shards, 3))
    kernels.check(u, "u", torch.float32, (n_shards, q))
    kernels.check(out, "out", torch.float32)
    if out.shape[0] != g or out.shape[1] < off + 2 * n_shards * q:
        raise kernels.KernelInputError(f"{name}: out of shape {tuple(out.shape)}")
    if not (1 <= q <= MAX_QUOTA and 1 <= n <= MAX_SAMPLE_ROW):
        raise kernels.KernelInputError(f"{name}: the kernel takes 1 to {MAX_QUOTA} draws a "
                                       f"shard and 1 to {MAX_SAMPLE_ROW} entries an instance, "
                                       f"got {q} and {n}")


def shard_sample_plain(r, valid, flags, mom, u, *, first: int, n_local: int, off: int, out):
    n_shards, q = u.shape
    m = n_shards * q
    denom = torch.clamp(scale_from_moments(mom), min=1e-6)
    for i in range(r.shape[0]):
        lane, me = i // n_local, first + i % n_local
        if bool(flags[lane, 0]):
            continue
        samp = pko.stratified_sample(torch.abs(r[i]) / denom[lane], valid[i], u[me], m=q)
        okf = (torch.arange(q, device=r.device) < valid[i].sum()).to(torch.float32)
        out[i, off:off + 2 * m] = 0.0
        out[i, off + me * q:off + (me + 1) * q] = samp * okf
        out[i, off + m + me * q:off + m + (me + 1) * q] = okf
    return out


# ---------------------------------------------------------------------------
# K11d: select, solve, retract
# ---------------------------------------------------------------------------

def shard_alpha_normal_eq_shape() -> dict:
    """K11b's launch shape as built: CTAs a cluster, threads a CTA, alphas
    a cluster. Builds the kernels if needed."""
    import ctypes
    fn = kernels.library("shard").lo_shard_alpha_normal_eq_shape
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    out = (ctypes.c_int * 3)()
    fn(out)
    return dict(zip(("cluster", "threads", "alphas"), list(out)))


def shard_gn_select(buf, T, flags, consts, pick, cfg, *, n_alpha: int, quota: int,
                    use_pko: bool):
    """K11d's wrapper. buf (L, S, ld) f32 the gathered rows; T (L, 16) f32,
    flags (L, 3) int32 [done, failed, n_corr]; consts the PKO constants
    (r_grid, Q), pick (3,) int32 the k-means start over the S * quota
    samples. Returns (T_out (L, 16), flags_out (L, 3) int32, info (L, 2)
    int32 [alpha index, rounded count]); a done lane passes through with
    info zero."""
    if not buf.is_cuda:
        return shard_gn_select_plain(buf, T, flags, consts, pick, cfg, n_alpha=n_alpha,
                                     quota=quota, use_pko=use_pko)
    lanes, n_shards, ld = buf.shape
    kernels.check(buf, "buf", torch.float32)
    kernels.check(T, "T", torch.float32, (lanes, 16))
    kernels.check(flags, "flags", torch.int32, (lanes, 3))
    if ld != buffer_width(n_alpha, n_shards, quota if use_pko else 0):
        raise kernels.KernelInputError(
            f"shard_gn_select: rows of {ld} floats for {n_alpha} alphas")
    if use_pko:
        kernels.check(pick, "pick", torch.int32, (3,))
        kernels.check(consts.Q, "Q", torch.float32, (n_alpha, consts.r_grid.shape[0]))
    dev = buf.device
    T_out = torch.empty((lanes, 16), dtype=torch.float32, device=dev)
    flags_out = torch.empty((lanes, 3), dtype=torch.int32, device=dev)
    info = torch.empty((lanes, 2), dtype=torch.int32, device=dev)
    kernels.KERNELS["shard_gn_select"].launch(
        buf.data_ptr(), lanes, n_shards, ld, n_alpha, quota, int(use_pko), T.data_ptr(),
        flags.data_ptr(), pick.data_ptr() if use_pko else None,
        consts.r_grid.data_ptr() if use_pko else None, consts.Q.data_ptr() if use_pko else None,
        consts.r_grid.shape[0] if use_pko else 0, cfg.min_correspondence_points,
        K.f32(cfg.translation_tolerance), K.f32(cfg.rotation_tolerance), T_out.data_ptr(),
        flags_out.data_ptr(), info.data_ptr())
    return T_out, flags_out, info


def shard_gn_select_plain(buf, T, flags, consts, pick, cfg, *, n_alpha: int, quota: int,
                          use_pko: bool):
    lanes, n_shards, ld = buf.shape
    m = n_shards * quota
    T_out, flags_out, info = T.clone(), flags.clone(), torch.zeros_like(flags[:, :2])
    for lane in range(lanes):
        if bool(flags[lane, 0]):
            continue
        acc = buf[lane, 0]
        for s in range(1, n_shards):
            acc = acc + buf[lane, s]
        best = torch.zeros((), dtype=torch.int64, device=buf.device)
        if use_pko:
            s_all = acc[n_alpha * 42:n_alpha * 42 + m]
            o_all = acc[n_alpha * 42 + m:n_alpha * 42 + 2 * m]
            meanv = (s_all.double().sum().float()
                     / torch.clamp(o_all.double().sum().float(), min=1.0))
            s_fin = torch.where(o_all > 0.5, s_all, meanv)
            best = pko.alpha_index_from_samples(s_fin, consts, pick).to(torch.int64)
        hg = acc[best * 42 + torch.arange(42, device=buf.device)]
        count = acc[ld - 1]
        H = hg[:36].view(6, 6) + torch.eye(6, dtype=hg.dtype, device=hg.device) * 1e-8
        dx = torch.linalg.solve_ex(H, -hg[36:42])[0]
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        dt, dw = dx[:3], dx[3:]
        T_new = T[lane].view(4, 4) @ lie.se3_from_exp_rt(dt, dw)
        conv = ((torch.linalg.norm(dt) < cfg.translation_tolerance)
                & (torch.linalg.norm(dw) < cfg.rotation_tolerance))
        insufficient = count < cfg.min_correspondence_points
        step = ~insufficient
        n_corr = torch.round(count).to(torch.int32)
        T_out[lane] = torch.where(step, T_new.reshape(16), T[lane])
        flags_out[lane] = torch.stack([(insufficient | (step & conv)).to(torch.int32),
                                       ((flags[lane, 1] != 0) | insufficient).to(torch.int32),
                                       torch.where(step, n_corr, flags[lane, 2])])
        info[lane] = torch.stack([best.to(torch.int32), n_corr])
    return T_out, flags_out, info
