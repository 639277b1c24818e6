"""The "distributed" pose-graph backend: Gauss-Newton over the chain +
loop-edge graph with a partitioned Schur-complement solve, in float64
(counterpart of the JAX package's parallel/distributed_pgo.py:
gn_optimize_device and the host planning it uses, and the host solvers
block_tridiag_solve and schur_partitioned_solve).

A SLAM pose graph is a chain of odometry factors plus a few loop edges, so
its normal matrix is block-tridiagonal (6x6 blocks) plus a few off-band
blocks. The keyframes are cut into partitions whose boundaries (the
separators) include every loop endpoint; each partition's interior chain
is eliminated onto its two separators, the small separator system (with
the loop blocks) is solved, and the interiors back-substitute. Every shape
is padded to a power of two, with identity-regularised padding poses after
the last real keyframe, exactly as the JAX host wrapper pads them, so the
plans and every intermediate compare one to one.

One Gauss-Newton iteration is four kernels (csrc/pgo.cu), each with its
plain float64 PyTorch twin below:
  K10a pgo_linearize — prior and between factors into the diagonal,
      off-diagonal, right-hand-side and loop blocks (JAX _linearize_device);
  K10b pgo_eliminate — every partition's interior chain eliminated onto its
      separators (JAX _eliminate_interior_spd under vmap, with the interior
      packing of _gn_device);
  K10c pgo_reduced_solve — the separator system assembled, factored and
      solved (the reduced solve of _gn_device);
  K10d pgo_backsub_retract — back-substitution, the norm and finiteness of
      dx, the SE(3) retraction and the loop state (the rest of _gn_device's
      while_loop body and its condition).
The loop state (iteration, |dx|, ok, active) stays on the device: the host
issues max_iters rounds of the four kernels, each returns at once once the
loop has stopped, and one optimize call reads the card once, for the poses
and that state together. For CPU tensors the wrappers run the plain twins
and the loop stops as soon as the state says so.

Non-convergence is failure: gn_optimize_device returns ok = converged.

The host solvers (the JAX host Gauss-Newton iteration's and the mesh dry
runs') compute in their input's dtype, float32 or float64, with two
kernels (csrc/schur.cu) and their plain twins:
  K12a pgo_block_thomas — the solve of a chain system (JAX
      block_tridiag_solve), partitioned: the chain cut into P ~ sqrt(2n)
      partitions (thomas_partitions), each interior eliminated onto its
      two separators, the separators' block-tridiagonal system solved by
      block-Thomas, the interiors formed from it;
  K12b pgo_eliminate_lu — every partition's interior chain eliminated by
      LU (JAX _eliminate_interior under vmap), over the host packing of
      schur_partitioned_solve, which solves the reduced separator system
      and back-substitutes on the host, its partitions split over the
      shards of a ShardGroup where one is given.
Nothing falls back: on a CUDA tensor a wrapper launches its kernel or
raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import kernels

__all__ = ["plan_partition", "dense_solve", "make_plan", "pack_graph", "upload",
           "gn_optimize_device", "linearize", "linearize_plain", "eliminate",
           "eliminate_plain", "reduced_solve", "reduced_solve_plain", "reduced_solve_shape",
           "backsub_retract", "BACKSUB_SHAPE",
           "backsub_retract_plain", "gn_iterations", "LIN_KEYS", "PLAN_KEYS",
           "RED_KEYS", "BACK_KEYS", "block_tridiag_solve", "block_tridiag_solve_plain",
           "thomas_partitions", "THOMAS_MAX_PARTITIONS",
           "pack_interiors", "eliminate_interior_lu", "eliminate_interior_lu_plain",
           "schur_partitioned_solve"]

_LIE_EPS = 1e-10  # reference kEpsLie (PoseGraphOptimizer.cpp:31)
_F64 = torch.float64


# ---------------------------------------------------------------------------
# host planning (copies of the JAX module's numpy code)
# ---------------------------------------------------------------------------

def plan_partition(n: int, n_blocks: int, loop_edges: Sequence[Tuple[int, int]]):
    """Choose separator indices: evenly spaced block boundaries, snapped to
    include every loop-edge endpoint. Returns sorted separator indices
    (always includes n-1). Pose 0 stays interior of the first block
    (prior-pinned) unless a loop edge references it: every loop endpoint
    must be a separator."""
    seps = set(int(round(i * (n - 1) / n_blocks)) for i in range(1, n_blocks + 1))
    for a, b in loop_edges:
        seps.add(int(a))
        seps.add(int(b))
    if not any(0 in (int(a), int(b)) for a, b in loop_edges):
        seps.discard(0)
    return sorted(seps)


def dense_solve(diag, off, b, loop_edges=(), loop_blocks=()):
    """Reference dense solve of the block-tridiagonal(+loops) system, for
    testing. diag (n,6,6), off (n-1,6,6) with off[i] = H[i, i+1]."""
    n = diag.shape[0]
    H = np.zeros((n * 6, n * 6))
    for i in range(n):
        H[i*6:(i+1)*6, i*6:(i+1)*6] = diag[i]
    for i in range(n - 1):
        H[i*6:(i+1)*6, (i+1)*6:(i+2)*6] = off[i]
        H[(i+1)*6:(i+2)*6, i*6:(i+1)*6] = off[i].T
    for (a, bb), (Baa, Bab, Bbb) in zip(loop_edges, loop_blocks):
        H[a*6:(a+1)*6, a*6:(a+1)*6] += Baa
        H[a*6:(a+1)*6, bb*6:(bb+1)*6] += Bab
        H[bb*6:(bb+1)*6, a*6:(a+1)*6] += Bab.T
        H[bb*6:(bb+1)*6, bb*6:(bb+1)*6] += Bbb
    return np.linalg.solve(H, np.asarray(b).reshape(-1)).reshape(n, 6)


def make_plan(n_pad: int, seps: Sequence[int]):
    """The static gather/scatter index plan for a (n_pad, seps) partition:
    each partition's interior rows FRONT-padded to max_m, the couplings to
    its left and right separators, and the adjacent-separator couplings.
    seps must be sorted and end at n_pad - 1."""
    seps = [int(s) for s in seps]
    if seps != sorted(seps) or seps[-1] != n_pad - 1:
        raise ValueError("separators must be sorted and end at n_pad - 1")
    D = len(seps)
    prev = [-1] + seps[:-1]
    max_m = max(max(s - p - 1 for p, s in zip(prev, seps)), 1)

    int_idx = np.zeros((D, max_m), np.int32)
    valid = np.zeros((D, max_m), bool)
    off_idx = np.zeros((D, max(max_m - 1, 1)), np.int32)
    ovalid = np.zeros((D, max(max_m - 1, 1)), bool)
    has_left = np.zeros(D, bool)
    left_off = np.zeros(D, np.int32)
    lsep_row = np.zeros(D, np.int32)
    uright_off = np.zeros(D, np.int32)
    ur_valid = np.zeros(D, bool)
    xl_idx = np.zeros(D, np.int32)
    sep_of = {s: i for i, s in enumerate(seps)}
    for k, (p, s) in enumerate(zip(prev, seps)):
        m = s - p - 1
        if m == 0:
            continue
        int_idx[k, max_m - m:] = np.arange(p + 1, s)
        valid[k, max_m - m:] = True
        if m > 1:
            off_idx[k, max_m - m: max_m - 1] = np.arange(p + 1, s - 1)
            ovalid[k, max_m - m: max_m - 1] = True
        if p >= 0:
            has_left[k] = True
            left_off[k] = p
            lsep_row[k] = max_m - m
            xl_idx[k] = sep_of[p]
        uright_off[k] = s - 1
        ur_valid[k] = True
    adj_mask = np.zeros(D, bool)
    adj_off = np.zeros(D, np.int32)
    for i in range(D - 1):
        if seps[i + 1] == seps[i] + 1:
            adj_mask[i] = True
            adj_off[i] = seps[i]
    return dict(seps=np.asarray(seps, np.int32), int_idx=int_idx, valid=valid,
                off_idx=off_idx, ovalid=ovalid, has_left=has_left,
                left_off=left_off, lsep_row=lsep_row, uright_off=uright_off,
                ur_valid=ur_valid, xl_idx=xl_idx, adj_mask=adj_mask,
                adj_off=adj_off, max_m=max_m, D=D, n_pad=n_pad)


def _pow2(x: int, lo: int = 1) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def _csr(rows: np.ndarray, ents: np.ndarray, n_rows: int):
    """Row pointers and entries of (row, entry) pairs, each row's entries
    ascending: the order in which the kernels sum them."""
    order = np.lexsort((ents, rows))
    ptr = np.zeros(n_rows + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr).astype(np.int32), ents[order].astype(np.int32)


@dataclass
class Packed:
    """One graph as padded arrays (the packing of the JAX host wrapper) plus
    the partition plan, split by type for upload: `f64` and `i32` map names
    to arrays (flags as 0/1 int32)."""
    n_pad: int
    D: int
    max_m: int
    L: int
    f64: Dict[str, np.ndarray]
    i32: Dict[str, np.ndarray]


def pack_graph(poses: np.ndarray, priors, betweens, n_blocks: int = 8, max_iters: int = 10,
               tol: float = 1e-6) -> Packed:
    """Factor lists -> padded arrays + partition plan. `priors` is a list of
    (key, measured (4,4), sqrt_info (6,6)); `betweens` of (key_from, key_to,
    measured, sqrt_info). n_pad = pow2(n, 8), with padding poses of
    pad_reg = 1 in the last partition; P, M and L (loop edges) are powers of
    two, invalid slots masked. Beside the JAX arrays: pose_row (each pose's
    row in the plan, or -(separator + 1)), and the per-pose lists of
    incident factor blocks (inc_ptr/inc_ent) and chain couplings
    (chain_ptr/chain_ent) that fix the kernels' summation order; and the
    loop state st = [it, |dx|, ok, active] at its start (_state0)."""
    n = len(poses)
    loop_edges = []
    for i, j, _, _ in betweens:
        lo, hi = (i, j) if i < j else (j, i)
        if hi != lo + 1:
            loop_edges.append((lo, hi))
    seps_real = plan_partition(n, min(n_blocks, max(n // 2, 1)), loop_edges)
    n_pad = _pow2(n, 8)
    seps = sorted(set(seps_real + [n_pad - 1]))
    plan = make_plan(n_pad, seps)
    sep_of = {s: i for i, s in enumerate(seps)}
    D, max_m = plan["D"], plan["max_m"]

    P = _pow2(max(len(priors), 1))
    M = _pow2(max(len(betweens), 1))
    L = _pow2(max(len(loop_edges), 1))

    prior_key = np.zeros(P, np.int32)
    prior_meas = np.tile(np.eye(4), (P, 1, 1))
    prior_sqrtI = np.zeros((P, 6, 6))
    prior_valid = np.zeros(P, bool)
    for k, (key, meas, sqI) in enumerate(priors):
        prior_key[k] = key
        prior_meas[k] = meas
        prior_sqrtI[k] = sqI
        prior_valid[k] = True

    bt_from = np.zeros(M, np.int32)
    bt_to = np.zeros(M, np.int32)
    bt_meas = np.tile(np.eye(4), (M, 1, 1))
    bt_sqrtI = np.zeros((M, 6, 6))
    bt_valid = np.zeros(M, bool)
    chain_slot = np.full(M, n_pad - 1, np.int32)  # dump row by default
    loop_bt = np.zeros(L, np.int32)
    loop_a = np.zeros(L, np.int32)
    loop_b = np.zeros(L, np.int32)
    loop_valid = np.zeros(L, bool)
    li = 0
    for k, (i, j, meas, sqI) in enumerate(betweens):
        bt_from[k] = i
        bt_to[k] = j
        bt_meas[k] = meas
        bt_sqrtI[k] = sqI
        bt_valid[k] = True
        lo, hi = (i, j) if i < j else (j, i)
        if hi == lo + 1:
            chain_slot[k] = lo
        else:
            loop_bt[li] = k
            loop_a[li] = sep_of[lo]
            loop_b[li] = sep_of[hi]
            loop_valid[li] = True
            li += 1

    poses_pad = np.tile(np.eye(4), (n_pad, 1, 1))
    poses_pad[:n] = poses
    real_mask = np.zeros(n_pad)
    real_mask[:n] = 1.0
    pad_reg = np.zeros(n_pad)
    pad_reg[n:] = 1.0

    pose_row = np.zeros(n_pad, np.int32)
    for i, s in enumerate(seps):
        pose_row[s] = -(i + 1)
    kk, rr = np.nonzero(plan["valid"])
    pose_row[plan["int_idx"][kk, rr]] = kk * max_m + rr

    # a factor block's entry number: prior k -> k, between k as "from" ->
    # P + k, as "to" -> P + M + k; each pose sums its entries ascending,
    # which is the order of the JAX scatter-adds
    pv, bv = np.nonzero(prior_valid)[0], np.nonzero(bt_valid)[0]
    inc_ptr, inc_ent = _csr(
        np.concatenate([prior_key[pv], bt_from[bv], bt_to[bv]]).astype(np.int64),
        np.concatenate([pv, P + bv, P + M + bv]).astype(np.int64), n_pad)
    ch = bv[chain_slot[bv] < n_pad - 1]
    chain_ptr, chain_ent = _csr(chain_slot[ch].astype(np.int64), ch.astype(np.int64), n_pad)

    f64 = dict(st=_state0(max_iters, tol), poses=poses_pad, real_mask=real_mask, pad_reg=pad_reg,
               prior_meas=prior_meas, prior_sqrtI=prior_sqrtI, bt_meas=bt_meas,
               bt_sqrtI=bt_sqrtI)
    i32 = dict(prior_key=prior_key, prior_valid=prior_valid, bt_from=bt_from, bt_to=bt_to,
               bt_valid=bt_valid, chain_slot=chain_slot, loop_bt=loop_bt, loop_a=loop_a,
               loop_b=loop_b, loop_valid=loop_valid, pose_row=pose_row, inc_ptr=inc_ptr,
               inc_ent=inc_ent, chain_ptr=chain_ptr, chain_ent=chain_ent,
               **{k: plan[k] for k in ("seps", "int_idx", "valid", "off_idx", "ovalid",
                                       "has_left", "left_off", "lsep_row", "uright_off",
                                       "ur_valid", "xl_idx", "adj_mask", "adj_off")})
    return Packed(n_pad=n_pad, D=D, max_m=max_m, L=L,
                  f64={k: np.asarray(v, np.float64) for k, v in f64.items()},
                  i32={k: np.asarray(v, np.int32) for k, v in i32.items()})


def upload(packed: Packed, device) -> Dict[str, torch.Tensor]:
    """The packed arrays on `device` as views into two flat buffers, one
    float64 and one int32, each copied in one transfer (from pinned memory
    and without a host wait on a card). The float64 buffer starts with the
    loop state `st` and the padded poses, so that one download returns
    both."""
    dev = torch.device(device)
    out = {}
    for arrays, dtype in ((packed.f64, np.float64), (packed.i32, np.int32)):
        flat = np.concatenate([a.reshape(-1) for a in arrays.values()]).astype(dtype)
        host = torch.from_numpy(flat)
        if dev.type == "cuda":
            buf = host.pin_memory().to(dev, non_blocking=True)
        else:
            buf = host.to(dev)
        at = 0
        for name, a in arrays.items():
            out[name] = buf[at:at + a.size].view(a.shape)
            at += a.size
        if dtype is np.float64:
            out["_f64"] = buf
    return out


def _state0(max_iters: int, tol: float) -> np.ndarray:
    """The loop state before the first iteration: it = 0, |dx| = inf, ok,
    and active = the while condition it < max_iters and |dx| >= tol and
    ok."""
    return np.array([0.0, math.inf, 1.0, float(max_iters > 0 and math.inf >= tol)])


# ---------------------------------------------------------------------------
# SE(3) helpers of the plain twins (the JAX module's batched ones, the same
# _LIE_EPS branches)
# ---------------------------------------------------------------------------

def _bskew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _bso3_log(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < _LIE_EPS
    denom = torch.where(small, 1.0, 2.0 * torch.sin(torch.where(small, 1.0, theta)))
    factor = torch.where(small, 0.5, theta / denom)
    return w * factor[..., None]


def _bse3_log(R, t):
    """[w, u] in GTSAM order (reference SE3_Logmap)."""
    w = _bso3_log(R)
    theta = torch.linalg.vector_norm(w, dim=-1)
    small = theta < _LIE_EPS
    safe = torch.where(small, 1.0, theta)
    W = _bskew(w / safe[..., None])
    Wt = torch.einsum("...ij,...j->...i", W, t)
    WWt = torch.einsum("...ij,...j->...i", W, Wt)
    tan_half = torch.tan(0.5 * safe)
    u_big = (t - (0.5 * theta)[..., None] * Wt
             + (1.0 - theta / (2.0 * tan_half))[..., None] * WWt)
    u = torch.where(small[..., None], t, u_big)
    return torch.cat([w, u], -1)


def _bse3_exp(xi):
    """[w, u] -> (R, t) (reference SE3_Expmap)."""
    w, u = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.vector_norm(w, dim=-1)
    small = theta < _LIE_EPS
    safe = torch.where(small, 1.0, theta)
    W = _bskew(w)
    WW = W @ W
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    s, c = torch.sin(safe), torch.cos(safe)
    R_big = I + (s / safe)[..., None, None] * W + ((1.0 - c) / (safe * safe))[..., None, None] * WW
    R = torch.where(small[..., None, None], I + W, R_big)
    V_big = I + ((1.0 - c) / (safe * safe))[..., None, None] * W + \
        ((safe - s) / (safe ** 3))[..., None, None] * WW
    t = torch.where(small[..., None], u, torch.einsum("...ij,...j->...i", V_big, u))
    return R, t


def _badjoint(R, t):
    """Ad_T for [rot, trans] ordering (reference SE3_AdjointMap)."""
    z = torch.zeros_like(R)
    top = torch.cat([R, z], -1)
    bot = torch.cat([_bskew(t) @ R, R], -1)
    return torch.cat([top, bot], -2)


def _cholesky(A):
    """Lower Cholesky factor of (A + A^T) / 2, all NaN where that is not
    positive definite (jnp.linalg.cholesky's contract; the kernels take a
    non-positive pivot's square root as NaN)."""
    Lc, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    return torch.where((info == 0)[..., None, None], Lc, torch.nan)


def _cho_solve(Lc, B):
    """A^-1 B given the Cholesky factor Lc of A."""
    y = torch.linalg.solve_triangular(Lc, B, upper=False)
    return torch.linalg.solve_triangular(Lc.mT, y, upper=True)


# ---------------------------------------------------------------------------
# K10a: linearisation
# ---------------------------------------------------------------------------

def linearize_plain(poses, pad_reg, prior_key, prior_meas, prior_sqrtI, prior_valid,
                    bt_from, bt_to, bt_meas, bt_sqrtI, bt_valid, chain_slot, loop_bt,
                    loop_valid):
    """Prior + between factors -> diag (n_pad,6,6), off (n_pad-1,6,6) with
    off[i] = H[i, i+1], b (n_pad,6) and the loop blocks lb (L,6,6), each
    H[lo, hi] of its loop edge (JAX _linearize_device). Flags may be bool
    or 0/1 integers."""
    n_pad = poses.shape[0]
    dt, dev = poses.dtype, poses.device
    diag = torch.zeros((n_pad, 6, 6), dtype=dt, device=dev)
    b = torch.zeros((n_pad, 6), dtype=dt, device=dev)
    diag = diag + torch.eye(6, dtype=dt, device=dev) * pad_reg[:, None, None]

    # priors: J = I (prior_error)
    pk = prior_key.long()
    Tp = poses[pk]
    Rp, tp = Tp[:, :3, :3], Tp[:, :3, 3]
    Rm, tm = prior_meas[:, :3, :3], prior_meas[:, :3, 3]
    err_p = _bse3_log(Rm.mT @ Rp, torch.einsum("...ji,...j->...i", Rm, tp - tm))
    info_p = prior_sqrtI.mT @ prior_sqrtI
    pv = prior_valid.bool().to(dt)
    diag.index_add_(0, pk, info_p * pv[:, None, None])
    b.index_add_(0, pk, -torch.einsum("...ij,...j->...i", info_p, err_p) * pv[:, None])

    # betweens (between_error: J_to = I, J_from = -Ad(hx^-1))
    bf, bt = bt_from.long(), bt_to.long()
    Tf, Tt = poses[bf], poses[bt]
    R_f, t_f = Tf[:, :3, :3], Tf[:, :3, 3]
    R_t, t_t = Tt[:, :3, :3], Tt[:, :3, 3]
    R_m, t_m = bt_meas[:, :3, :3], bt_meas[:, :3, 3]
    R_hx = R_f.mT @ R_t
    t_hx = torch.einsum("...ji,...j->...i", R_f, t_t - t_f)
    R_err = R_m.mT @ R_hx
    t_err = torch.einsum("...ji,...j->...i", R_m, t_hx - t_m)
    err = _bse3_log(R_err, t_err)
    R_hx_inv = R_hx.mT
    t_hx_inv = -torch.einsum("...ij,...j->...i", R_hx_inv, t_hx)
    J_from = -_badjoint(R_hx_inv, t_hx_inv)
    Jw_f = bt_sqrtI @ J_from
    Jw_t = bt_sqrtI  # J_to = I
    ew = torch.einsum("...ij,...j->...i", bt_sqrtI, err)
    bv = bt_valid.bool().to(dt)
    blk_ff = Jw_f.mT @ Jw_f * bv[:, None, None]
    blk_tt = Jw_t.mT @ Jw_t * bv[:, None, None]
    Hij = Jw_f.mT @ Jw_t  # coupling (from, to)
    rhs_f = -torch.einsum("...ji,...j->...i", Jw_f, ew) * bv[:, None]
    rhs_t = -torch.einsum("...ji,...j->...i", Jw_t, ew) * bv[:, None]
    diag.index_add_(0, bf, blk_ff)
    diag.index_add_(0, bt, blk_tt)
    b.index_add_(0, bf, rhs_f)
    b.index_add_(0, bt, rhs_t)

    # chain couplings at row lo; non-chain and invalid factors go to the
    # dump row n_pad-1, which is sliced off
    Hij_lo = torch.where((bf < bt)[:, None, None], Hij, Hij.mT)
    off_acc = torch.zeros((n_pad, 6, 6), dtype=dt, device=dev)
    off_acc.index_add_(0, chain_slot.long(), Hij_lo * bv[:, None, None])
    lb = Hij_lo[loop_bt.long()] * loop_valid.bool().to(dt)[:, None, None]
    return diag, off_acc[: n_pad - 1], b, lb


# The uploaded graph arrays each plain twin takes after its tensor
# arguments, in order.
LIN_KEYS = ("pad_reg", "prior_key", "prior_meas", "prior_sqrtI", "prior_valid", "bt_from",
             "bt_to", "bt_meas", "bt_sqrtI", "bt_valid", "chain_slot", "loop_bt", "loop_valid")


def linearize(g: Dict[str, torch.Tensor], poses: torch.Tensor):
    """K10a's wrapper: (diag, off, b, lb) of the graph `g` (upload()) at
    `poses` (n_pad,4,4) f64. On a card it launches only while g["st"] says
    the loop runs; the outputs are then undefined once it has stopped."""
    if not poses.is_cuda:
        return linearize_plain(poses, *[g[k] for k in LIN_KEYS])
    n_pad, P, M, L = poses.shape[0], g["prior_key"].numel(), g["bt_from"].numel(), \
        g["loop_bt"].numel()
    _check_graph(g, poses)
    dev = poses.device
    diag = torch.empty((n_pad, 6, 6), dtype=_F64, device=dev)
    off = torch.empty((n_pad - 1, 6, 6), dtype=_F64, device=dev)
    b = torch.empty((n_pad, 6), dtype=_F64, device=dev)
    lb = torch.empty((L, 6, 6), dtype=_F64, device=dev)
    kernels.KERNELS["pgo_linearize"].launch(
        poses.data_ptr(), n_pad, g["pad_reg"].data_ptr(), g["prior_meas"].data_ptr(),
        g["prior_sqrtI"].data_ptr(), P, g["bt_from"].data_ptr(), g["bt_to"].data_ptr(),
        g["bt_meas"].data_ptr(), g["bt_sqrtI"].data_ptr(), M,
        g["loop_bt"].data_ptr(), g["loop_valid"].data_ptr(), L,
        g["inc_ptr"].data_ptr(), g["inc_ent"].data_ptr(), g["chain_ptr"].data_ptr(),
        g["chain_ent"].data_ptr(), g["st"].data_ptr(), diag.data_ptr(), off.data_ptr(),
        b.data_ptr(), lb.data_ptr())
    return diag, off, b, lb


# ---------------------------------------------------------------------------
# K10b: interior elimination
# ---------------------------------------------------------------------------

def eliminate_plain(diag, off, b, int_idx, valid, off_idx, ovalid, has_left, left_off,
                    lsep_row, uright_off, ur_valid):
    """Pack every partition's interior rows from the plan and eliminate
    them onto the partition's separators (JAX _gn_device's packing and
    vmap(_eliminate_interior_spd)). Returns S (D,4,6,6) = [S_ll, S_lr,
    S_rl, S_rr], r (D,2,6) = [r_l, r_r] and the back-substitution factors
    F, G (D,max_m,6,6), g (D,max_m,6): x_i = g_i - F_i x_left - G_i x_right."""
    D, max_m = int_idx.shape
    dt, dev = diag.dtype, diag.device
    valid, ovalid = valid.bool(), ovalid.bool()
    has_left, ur_valid = has_left.bool(), ur_valid.bool()
    I6 = torch.eye(6, dtype=dt, device=dev)
    ii = int_idx.long()
    Dint = torch.where(valid[..., None, None], diag[ii], I6)
    Oint = (torch.where(ovalid[..., None, None], off[off_idx.long()], 0.0)
            if max_m > 1 else torch.zeros((D, 0, 6, 6), dtype=dt, device=dev))
    Bint = torch.where(valid[..., None], b[ii], 0.0)
    Lleft = torch.where(has_left[:, None, None], off[left_off.long()].mT, 0.0)
    onehot = torch.nn.functional.one_hot(lsep_row.long(), max_m).to(dt)
    Lsep = onehot[..., None, None] * Lleft[:, None]
    Uright = torch.where(ur_valid[:, None, None], off[uright_off.long()], 0.0)
    return _interior_chain(Dint, Oint, Bint, Lsep, Lleft, Uright, valid,
                           lambda A, B: _cho_solve(_cholesky(A), B))


def _interior_chain(Dint, Oint, Bint, Lsep, Lleft, Uright, valid, solve):
    """Eliminate every partition's front-padded interior chain onto its
    separators, batched over partitions (JAX _eliminate_interior and
    _eliminate_interior_spd under vmap; `solve(A, B)` = A^-1 B is the 6x6
    solve, LU or Cholesky). Padded rows get Dt = I and zero right-hand
    sides. Returns S (D,4,6,6) = [S_ll, S_lr, S_rl, S_rr], r (D,2,6) =
    [r_l, r_r] and F, G (D,max_m,6,6), g (D,max_m,6): x_i = g_i - F_i
    x_left - G_i x_right."""
    D, max_m = valid.shape
    dt, dev = Dint.dtype, Dint.device
    valid = valid.bool()
    I6 = torch.eye(6, dtype=dt, device=dev)
    z66 = torch.zeros((D, 6, 6), dtype=dt, device=dev)
    z6 = torch.zeros((D, 6), dtype=dt, device=dev)
    U = torch.cat([Oint, z66[:, None]], 1)
    Lrow = torch.cat([z66[:, None], Oint.mT], 1)
    C_prev, E_prev, d_prev = z66, z66, z6
    Cs, Es, ds = [], [], []
    Dt = None
    for r in range(max_m):
        v = valid[:, r]
        L_i = Lrow[:, r]
        Dt = torch.where(v[:, None, None], Dint[:, r] - L_i @ C_prev, I6)
        rhs_b = torch.where(v[:, None], Bint[:, r] - (L_i @ d_prev[..., None])[..., 0], 0.0)
        rhs_E = torch.where(v[:, None, None], Lsep[:, r] - L_i @ E_prev, 0.0)
        sol = solve(Dt, torch.cat([U[:, r], rhs_E, rhs_b[..., None]], -1))
        C_prev = torch.where(v[:, None, None], sol[..., :6], 0.0)
        E_prev, d_prev = sol[..., 6:12], sol[..., 12]
        Cs.append(C_prev)
        Es.append(E_prev)
        ds.append(d_prev)

    Ur_solved = solve(Dt, Uright)
    F_next, G_next, g_next = Es[-1], Ur_solved, ds[-1]
    Fs, Gs, gs = [F_next], [G_next], [g_next]
    for r in range(max_m - 2, -1, -1):
        v = valid[:, r]
        F_next = torch.where(v[:, None, None], Es[r] - Cs[r] @ F_next, 0.0)
        G_next = torch.where(v[:, None, None], -Cs[r] @ G_next, 0.0)
        g_next = torch.where(v[:, None], ds[r] - (Cs[r] @ g_next[..., None])[..., 0], 0.0)
        Fs.append(F_next)
        Gs.append(G_next)
        gs.append(g_next)
    F = torch.stack(Fs[::-1], 1)
    G = torch.stack(Gs[::-1], 1)
    g = torch.stack(gs[::-1], 1)

    any_valid = valid.any(1)
    first = valid.to(torch.int32).argmax(1)
    k = torch.arange(D, device=dev)
    Lt, Ut = Lleft.mT, Uright.mT
    F0, G0, g0 = F[k, first], G[k, first], g[k, first]
    Fm, Gm, gm = F[:, -1], G[:, -1], g[:, -1]
    av = any_valid[:, None, None]
    S = torch.stack([torch.where(av, -Lt @ F0, 0.0), torch.where(av, -Lt @ G0, 0.0),
                     torch.where(av, -Ut @ Fm, 0.0), torch.where(av, -Ut @ Gm, 0.0)], 1)
    r = torch.stack([torch.where(av[..., 0], -(Lt @ g0[..., None])[..., 0], 0.0),
                     torch.where(av[..., 0], -(Ut @ gm[..., None])[..., 0], 0.0)], 1)
    return S, r, F, G, g


PLAN_KEYS = ("int_idx", "valid", "off_idx", "ovalid", "has_left", "left_off", "lsep_row",
              "uright_off", "ur_valid")


def eliminate(g: Dict[str, torch.Tensor], diag, off, b):
    """K10b's wrapper: (S, r, F, G, g) of eliminate_plain, a block of two
    warps a partition on a card (one stages the rows through shared
    memory, the other runs the chain; the forward chain's C, E and d are
    kept in a scratch of (D, max_m, 80) doubles for the backward
    chain)."""
    if not diag.is_cuda:
        return eliminate_plain(diag, off, b, *[g[k] for k in PLAN_KEYS])
    D, max_m = g["int_idx"].shape
    n_pad = diag.shape[0]
    kernels.check(diag, "diag", _F64, (n_pad, 6, 6))
    kernels.check(off, "off", _F64, (n_pad - 1, 6, 6))
    kernels.check(b, "b", _F64, (n_pad, 6))
    for k in PLAN_KEYS:
        kernels.check(g[k], k, torch.int32)
    dev = diag.device
    S = torch.empty((D, 4, 6, 6), dtype=_F64, device=dev)
    r = torch.empty((D, 2, 6), dtype=_F64, device=dev)
    F = torch.empty((D, max_m, 6, 6), dtype=_F64, device=dev)
    G = torch.empty((D, max_m, 6, 6), dtype=_F64, device=dev)
    gv = torch.empty((D, max_m, 6), dtype=_F64, device=dev)
    scratch = torch.empty((D, max_m, 80), dtype=_F64, device=dev)
    kernels.KERNELS["pgo_eliminate"].launch(
        diag.data_ptr(), off.data_ptr(), b.data_ptr(), *[g[k].data_ptr() for k in PLAN_KEYS],
        D, max_m, g["off_idx"].shape[1], g["st"].data_ptr(), scratch.data_ptr(), F.data_ptr(),
        G.data_ptr(), gv.data_ptr(), S.data_ptr(), r.data_ptr())
    return S, r, F, G, gv


# ---------------------------------------------------------------------------
# K10c: the reduced separator system
# ---------------------------------------------------------------------------

def reduced_solve_plain(diag, off, b, lb, S, r, seps, adj_mask, adj_off, loop_a, loop_b,
                        loop_valid):
    """Assemble the (D*6)^2 separator system from the separators' diagonal
    blocks, the Schur blocks, the adjacent-separator couplings and the
    loop blocks (duplicate edges add), factor it and solve (JAX _gn_device
    :625-647). Returns xs (D,6), Hs (D*6, D*6) and bs (D*6,)."""
    D = seps.shape[0]
    dt, dev = diag.dtype, diag.device
    idx = torch.arange(D, device=dev)
    km1 = torch.clamp(idx - 1, min=0)
    kp1 = torch.clamp(idx + 1, max=D - 1)
    lmask = (idx > 0).to(dt)[:, None, None]
    S_ll, S_lr, S_rl, S_rr = S.unbind(1)
    r_l, r_r = r.unbind(1)
    sp = seps.long()
    H4 = torch.zeros((D, D, 6, 6), dtype=dt, device=dev)
    H4.index_put_((idx, idx), diag[sp] + S_rr, accumulate=True)
    H4.index_put_((km1, km1), S_ll * lmask, accumulate=True)
    H4.index_put_((km1, idx), S_lr * lmask, accumulate=True)
    H4.index_put_((idx, km1), S_rl * lmask, accumulate=True)
    adj_blk = off[adj_off.long()] * adj_mask.bool().to(dt)[:, None, None]
    H4.index_put_((idx, kp1), adj_blk, accumulate=True)
    H4.index_put_((kp1, idx), adj_blk.mT, accumulate=True)
    lvm = loop_valid.bool().to(dt)[:, None, None]
    la, lbi = loop_a.long(), loop_b.long()
    H4.index_put_((la, lbi), lb * lvm, accumulate=True)
    H4.index_put_((lbi, la), lb.mT * lvm, accumulate=True)
    bs = b[sp] + r_r
    bs = bs.index_add(0, km1, r_l * (idx > 0).to(dt)[:, None])
    Hs = H4.permute(0, 2, 1, 3).reshape(D * 6, D * 6)
    Lc = _cholesky(Hs)
    xs = _cho_solve(Lc, bs.reshape(-1, 1))[:, 0].reshape(D, 6)
    return xs, Hs, bs.reshape(-1)


RED_KEYS = ("seps", "adj_mask", "adj_off", "loop_a", "loop_b", "loop_valid")


def reduced_solve(g: Dict[str, torch.Tensor], diag, off, b, lb, S, r):
    """K10c's wrapper: xs (D,6) of reduced_solve_plain; on a card one
    cluster of CTAs assembles the system in global memory, factors it with
    the forward solve riding along and solves L^T x = y."""
    if not diag.is_cuda:
        return reduced_solve_plain(diag, off, b, lb, S, r, *[g[k] for k in RED_KEYS])[0]
    D, L, n_pad = g["seps"].numel(), g["loop_a"].numel(), diag.shape[0]
    kernels.check(diag, "diag", _F64, (n_pad, 6, 6))
    kernels.check(off, "off", _F64, (n_pad - 1, 6, 6))
    kernels.check(b, "b", _F64, (n_pad, 6))
    kernels.check(lb, "lb", _F64, (L, 6, 6))
    kernels.check(S, "S", _F64, (D, 4, 6, 6))
    kernels.check(r, "r", _F64, (D, 2, 6))
    for k in RED_KEYS:
        kernels.check(g[k], k, torch.int32)
    xs = torch.empty((D, 6), dtype=_F64, device=diag.device)
    _reduced_launch(g, diag, off, b, lb, S, r, xs)
    return xs


def _reduced_launch(g, diag, off, b, lb, S, r, xs) -> None:
    """One K10c launch into xs, its inputs checked by the caller. The
    working matrix, (6D + 1 rounded up to 8)^2 doubles, is scratch: the
    system's lower triangle with bs as its last row."""
    D, L = g["seps"].numel(), g["loop_a"].numel()
    nr = (6 * D + 8) // 8 * 8
    work = torch.empty((nr * nr,), dtype=_F64, device=diag.device)
    kernels.KERNELS["pgo_reduced_solve"].launch(
        diag.data_ptr(), off.data_ptr(), b.data_ptr(), lb.data_ptr(), S.data_ptr(),
        r.data_ptr(), *[g[k].data_ptr() for k in RED_KEYS], D, L, g["st"].data_ptr(),
        work.data_ptr(), xs.data_ptr())


def reduced_solve_shape() -> Dict[str, int]:
    """K10c's launch shape as built: cluster CTAs, panel width, threads a
    CTA, shared memory a CTA (bytes). Builds the kernels if needed."""
    import ctypes
    fn = kernels.library("pgo").lo_pgo_reduced_solve_shape
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    out = (ctypes.c_int * 4)()
    fn(out)
    return dict(zip(("cluster", "panel", "threads", "smem_bytes"), list(out)))


# ---------------------------------------------------------------------------
# K10d: back-substitution, convergence test and retraction
# ---------------------------------------------------------------------------

def backsub_retract_plain(poses, xs, F, G, g, int_idx, valid, has_left, xl_idx, seps,
                          real_mask):
    """dx = the back-substituted update (x_i = g_i - F_i x_left - G_i
    x_right in the interiors, xs at the separators) times real_mask; its
    norm; whether it is all finite; and the poses retracted by it
    (T <- T Exp(dx)) where it is, else the poses unchanged (JAX _gn_device
    :649-680). Returns (poses_new, dxn, ok) as 0-d tensors."""
    n_pad = poses.shape[0]
    dt, dev = poses.dtype, poses.device
    valid = valid.bool()
    xl = torch.where(has_left.bool()[:, None], xs[xl_idx.long()], 0.0)
    xi = g - torch.einsum("kmij,kj->kmi", F, xl) - torch.einsum("kmij,kj->kmi", G, xs)
    x = torch.zeros((n_pad + 1, 6), dtype=dt, device=dev)
    scatter_idx = torch.where(valid, int_idx.long(), n_pad)
    x.index_add_(0, scatter_idx.reshape(-1),
                 torch.where(valid[..., None], xi, 0.0).reshape(-1, 6))
    x.index_add_(0, seps.long(), xs)
    dx = x[:n_pad] * real_mask[:, None]
    dxn = torch.linalg.vector_norm(dx)
    ok = torch.isfinite(dx).all()
    dR, dtr = _bse3_exp(dx)
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    out = torch.eye(4, dtype=dt, device=dev).repeat(n_pad, 1, 1)
    out[:, :3, :3] = R @ dR
    out[:, :3, 3] = torch.einsum("...ij,...j->...i", R, dtr) + t
    return torch.where(ok, out, poses), dxn, ok


BACK_KEYS = ("int_idx", "valid", "has_left", "xl_idx", "seps")
# K10d's one cluster: csrc/pgo.cu BACKSUB_CLUSTER CTAs x BACKSUB_THREADS
BACKSUB_SHAPE = {"cluster": 16, "threads": 256}


def backsub_retract(g: Dict[str, torch.Tensor], poses, xs, F, G, gv, max_iters: int,
                    tol: float) -> None:
    """K10d's wrapper: updates `poses` (n_pad,4,4) and the loop state g["st"]
    = [it, |dx|, ok, active] in place: it + 1, |dx|, ok, and active =
    it < max_iters and |dx| >= tol and ok (the while_loop's condition). One
    launch of one thread-block cluster (BACKSUB_SHAPE; the launch fails
    where the card cannot hold 16 CTAs in one cluster): the CTAs'
    sums of |dx|^2 and of non-finite entries meet in the cluster's shared
    memory, and every thread retracts its own pose where dx is all finite.
    No scratch: nothing is allocated or filled."""
    st = g["st"]
    if not poses.is_cuda:
        if not bool(st[3]):
            return
        new, dxn, ok = backsub_retract_plain(poses, xs, F, G, gv, *[g[k] for k in BACK_KEYS],
                                             g["real_mask"])
        poses.copy_(new)
        it = float(st[0]) + 1
        okf, dxf = bool(ok), float(dxn)
        st.copy_(torch.tensor([it, dxf, float(okf),
                               float(it < max_iters and dxf >= tol and okf)], dtype=_F64))
        return
    D, max_m = g["int_idx"].shape
    n_pad = poses.shape[0]
    kernels.check(poses, "poses", _F64, (n_pad, 4, 4))
    kernels.check(xs, "xs", _F64, (D, 6))
    kernels.check(F, "F", _F64, (D, max_m, 6, 6))
    kernels.check(G, "G", _F64, (D, max_m, 6, 6))
    kernels.check(gv, "g", _F64, (D, max_m, 6))
    for t, name in ((poses, "poses"), (xs, "xs"), (F, "F"), (G, "G"), (gv, "g")):
        kernels.check_aligned(t, name)
    for k in ("has_left", "xl_idx", "pose_row"):
        kernels.check(g[k], k, torch.int32)
    kernels.check(g["real_mask"], "real_mask", _F64, (n_pad,))
    kernels.check(st, "st", _F64, (4,))
    kernels.KERNELS["pgo_backsub_retract"].launch(
        xs.data_ptr(), F.data_ptr(), G.data_ptr(), gv.data_ptr(), g["has_left"].data_ptr(),
        g["xl_idx"].data_ptr(), g["pose_row"].data_ptr(), g["real_mask"].data_ptr(), n_pad,
        max_m, max_iters, float(tol), st.data_ptr(), poses.data_ptr())


def _check_graph(g: Dict[str, torch.Tensor], poses) -> None:
    n_pad = poses.shape[0]
    kernels.check(poses, "poses", _F64, (n_pad, 4, 4))
    for k in ("pad_reg", "prior_meas", "prior_sqrtI", "bt_meas", "bt_sqrtI", "st"):
        kernels.check(g[k], k, _F64)
    for k in ("prior_key", "prior_valid", "bt_from", "bt_to", "bt_valid", "chain_slot",
              "loop_bt", "loop_valid", "inc_ptr", "inc_ent", "chain_ptr", "chain_ent"):
        kernels.check(g[k], k, torch.int32)
    if g["pad_reg"].shape != (n_pad,) or g["inc_ptr"].shape != (n_pad + 1,):
        raise ValueError("the graph's arrays do not match the poses' padding")


# ---------------------------------------------------------------------------
# the optimisation
# ---------------------------------------------------------------------------

def gn_iterations(g: Dict[str, torch.Tensor], max_iters: int, tol: float) -> None:
    """Up to max_iters Gauss-Newton iterations on the uploaded graph, in
    place on g["poses"] and g["st"]: linearise, eliminate, solve the
    separator system, back-substitute and retract, until |dx| < tol or dx
    is not finite (the retraction is applied on the converging iteration
    too, and not on a non-finite one). On a card the host issues all
    max_iters rounds without waiting; the kernels of a round after the
    loop stopped return at once."""
    poses = g["poses"]
    for _ in range(max_iters):
        if not poses.is_cuda and not bool(g["st"][3]):
            break
        diag, off, b, lb = linearize(g, poses)
        S, r, F, G, gv = eliminate(g, diag, off, b)
        xs = reduced_solve(g, diag, off, b, lb, S, r)
        backsub_retract(g, poses, xs, F, G, gv, max_iters, tol)


def gn_optimize_device(poses: np.ndarray, priors, betweens, n_blocks: int = 8,
                       max_iters: int = 10, tol: float = 1e-6, device="cuda"):
    """Factor lists -> padded arrays + partition plan, the float64 GN solve
    on `device`, poses back. `priors` is a list of (key, measured (4,4),
    sqrt_info (6,6)); `betweens` of (key_from, key_to, measured,
    sqrt_info). Returns (poses_new (n,4,4) float64, ok) with ok =
    converged (|dx| < tol within max_iters, every dx finite); non-finite
    results return the input poses and False; n == 0 returns (poses,
    True). One host read of the card per call: the poses and the loop
    state together, waiting on the current stream only."""
    n = len(poses)
    if n == 0:
        return poses, True
    packed = pack_graph(np.asarray(poses, np.float64), priors, betweens, n_blocks,
                        max_iters, tol)
    g = upload(packed, device)
    gn_iterations(g, max_iters, tol)
    host = g["_f64"][: 4 + n * 16].cpu().numpy()
    _, dxn, ok, _ = host[:4]
    out = host[4:].reshape(n, 4, 4).copy()
    if not np.all(np.isfinite(out)):
        return poses, False
    return out, bool(ok) and bool(dxn < tol)


# ---------------------------------------------------------------------------
# the host solvers: K12a block-Thomas, K12b LU interior elimination, and the
# partitioned Schur solve around K12b (in the input's dtype)
# ---------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.float64)


THOMAS_MAX_PARTITIONS = 128   # K12a: a warp a partition, at most 8 warps x 16 CTAs
# K12b keeps a partition's factors (rows of 80 values) in its CTA's shared
# memory up to this many bytes (the H100 gives a CTA 227 KB), else in a
# global scratch
SCHUR_SMEM_BUDGET = 225280


def thomas_partitions(n: int) -> int:
    """K12a's partition count for a chain of n rows: ~sqrt(2n) (the
    interiors' n/P rows and the separators' P rows balanced), at least 1,
    at most n and THOMAS_MAX_PARTITIONS. Partition k ends at its separator
    (k + 1) n // P - 1."""
    return max(1, min(n, THOMAS_MAX_PARTITIONS, int(math.sqrt(2.0 * n) + 0.5)))


def block_tridiag_solve_plain(diag, off, b):
    """The solve of the block-tridiagonal system diag (n,6,6), off
    (n-1,6,6) (off[i] = H[i, i+1]), b (n,6) -> x (n,6) as K12a computes
    it, partitioned: P = thomas_partitions(n) separators s_k = (k+1) n // P
    - 1; every partition's interior (front-padded as pack_interiors packs
    it) eliminated onto its separators by LU, a loop over its rows batched
    over partitions (_interior_chain); the separators' block-tridiagonal
    system (diagonal diag[s_k] + S_rr(k) + S_ll(k+1), upper S_lr(k+1) +
    the chain's coupling where the interior between is empty, lower the
    upper transposed, as the system is symmetric) by block-Thomas with LU
    6x6 solves; then x_i = g_i - F_i x_l - G_i x_r. The same x as JAX
    block_tridiag_solve up to rounding."""
    n, dt, dev = diag.shape[0], diag.dtype, diag.device
    if n == 0:
        return torch.zeros_like(b)
    P = thomas_partitions(n)
    seps = torch.tensor([(k + 1) * n // P - 1 for k in range(P)], device=dev)
    prev = torch.cat([seps.new_full((1,), -1), seps[:-1]])
    mk = seps - prev - 1
    max_m = max(int(mk.max()), 1)
    off_p = torch.cat([off, torch.zeros((1, 6, 6), dtype=dt, device=dev)])   # off_p[n-1] = 0
    z = lambda t: torch.zeros_like(t)

    # ---- the interiors, front-padded
    r = torch.arange(max_m, device=dev)
    start = max_m - mk
    valid = r[None, :] >= start[:, None]
    rows = (prev[:, None] + 1 + r[None, :] - start[:, None]).clamp(0, n - 1)
    Dint = torch.where(valid[..., None, None], diag[rows], torch.eye(6, dtype=dt, device=dev))
    Oint = torch.where(valid[:, :-1, None, None], off_p[rows[:, :-1]], 0.0)
    Bint = torch.where(valid[..., None], b[rows], 0.0)
    has_left = ((prev >= 0) & (mk > 0))[:, None, None]
    Lleft = torch.where(has_left, off_p[prev.clamp(min=0)].mT, 0.0)
    Lsep = torch.where((r[None, :] == start[:, None])[..., None, None], Lleft[:, None], 0.0)
    Uright = torch.where((mk > 0)[:, None, None], off_p[(seps - 1).clamp(min=0)], 0.0)
    S, rr, F, G, g = _interior_chain(Dint, Oint, Bint, Lsep, Lleft, Uright, valid,
                                     torch.linalg.solve)

    # ---- the separators' system
    S_ll, S_lr, _, S_rr = S.unbind(1)
    r_l, r_r = rr.unbind(1)
    nxt = lambda t: torch.cat([t[1:], z(t[:1])])
    empty = mk == 0
    A = (diag[seps] + S_rr) + nxt(S_ll)
    Up = nxt(S_lr + torch.where(empty[:, None, None], off_p[prev.clamp(min=0)], 0.0))
    Low = torch.cat([z(Up[:1]), Up[:-1].mT])
    rhs = (b[seps] + r_r) + nxt(r_l)
    C_prev, d_prev = z(A[0]), z(rhs[0])
    Cs, ds = [], []
    for k in range(P):
        Dt = A[k] - Low[k] @ C_prev
        bt = rhs[k] - (Low[k] @ d_prev[:, None])[:, 0]
        sol = torch.linalg.solve(Dt, torch.cat([Up[k], bt[:, None]], 1))
        C_prev, d_prev = sol[:, :6], sol[:, 6]
        Cs.append(C_prev)
        ds.append(d_prev)
    xs = [ds[-1]] * P
    for k in range(P - 2, -1, -1):
        xs[k] = ds[k] - (Cs[k] @ xs[k + 1][:, None])[:, 0]
    xs = torch.stack(xs)

    # ---- the interiors' x
    xl = torch.cat([z(xs[:1]), xs[:-1]])
    xi = (g - (F @ xl[:, None, :, None])[..., 0]) - (G @ xs[:, None, :, None])[..., 0]
    x = torch.empty_like(b)
    x[seps] = xs
    x[rows[valid]] = xi[valid]
    return x


def block_tridiag_solve(diag, off, b):
    """K12a's wrapper: x (n,6) of block_tridiag_solve_plain, in the inputs'
    dtype (float32 or float64); on a card one launch, a cluster of up to
    16 CTAs, a warp a partition."""
    if not diag.is_cuda:
        return block_tridiag_solve_plain(diag, off, b)
    n, dt = diag.shape[0], diag.dtype
    if dt not in _FLOATS:
        raise kernels.KernelInputError(f"diag: expected float32 or float64, got {dt}")
    kernels.check(diag, "diag", dt, (n, 6, 6))
    kernels.check(off, "off", dt, (max(n - 1, 0), 6, 6))
    kernels.check(b, "b", dt, (n, 6))
    dev = diag.device
    x = torch.empty((n, 6), dtype=dt, device=dev)
    if n == 0:
        return x
    P = thomas_partitions(n)
    scratch = torch.empty((P * 164 + n * 80,), dtype=dt, device=dev)
    kernels.KERNELS["pgo_block_thomas"].launch(
        diag.data_ptr(), off.data_ptr(), b.data_ptr(), n, P, int(dt == _F64),
        scratch.data_ptr(), x.data_ptr())
    return x


def pack_interiors(diag, off, b, seps):
    """The JAX schur_partitioned_solve's host packing: every partition's
    interior rows (between the previous separator and its own) FRONT-padded
    to max_m with identity diagonal blocks and zero right-hand sides, in
    diag's dtype. Returns (Dint (D,max_m,6,6), Oint (D,max_m-1,6,6), Bint
    (D,max_m,6), Lsep (D,max_m,6,6), Lleft (D,6,6), Uright (D,6,6), Valid
    (D,max_m) bool): Lleft = H[first interior, left separator], also in
    Lsep at the first valid row; Uright = H[last interior, right
    separator]."""
    dtype = diag.dtype
    D = len(seps)
    prev = [-1] + list(seps[:-1])
    max_m = max(max(s - p - 1 for p, s in zip(prev, seps)), 1)
    Dint = np.zeros((D, max_m, 6, 6), dtype)
    Oint = np.zeros((D, max_m - 1, 6, 6), dtype)
    Bint = np.zeros((D, max_m, 6), dtype)
    Lsep = np.zeros((D, max_m, 6, 6), dtype)
    Lleft = np.zeros((D, 6, 6), dtype)
    Uright = np.zeros((D, 6, 6), dtype)
    Valid = np.zeros((D, max_m), bool)
    for k, (p, s) in enumerate(zip(prev, seps)):
        m = s - p - 1
        if m == 0:
            continue
        sl = slice(p + 1, s)
        Dint[k, max_m - m:] = diag[sl]
        Dint[k, : max_m - m] = np.eye(6, dtype=dtype)
        if m > 1:
            Oint[k, max_m - m: max_m - 1] = off[p + 1: s - 1]
        Bint[k, max_m - m:] = b[sl]
        Valid[k, max_m - m:] = True
        if p >= 0:
            Lleft[k] = off[p].T
            Lsep[k, max_m - m] = off[p].T
        Uright[k] = off[s - 1]
    return Dint, Oint, Bint, Lsep, Lleft, Uright, Valid


def eliminate_interior_lu_plain(Dint, Oint, Bint, Lsep, Lleft, Uright, valid):
    """Every partition of pack_interiors' layout eliminated onto its two
    separators by LU (JAX _eliminate_interior under vmap): S (D,4,6,6) =
    [S_ll, S_lr, S_rl, S_rr], r (D,2,6) = [r_l, r_r], F, G (D,max_m,6,6),
    g (D,max_m,6), a loop over the rows batched over partitions."""
    return _interior_chain(Dint, Oint, Bint, Lsep, Lleft, Uright, valid, torch.linalg.solve)


def eliminate_interior_lu(Dint, Oint, Bint, Lsep, Lleft, Uright, valid):
    """K12b's wrapper: (S, r, F, G, g) of eliminate_interior_lu_plain in the
    inputs' dtype (float32 or float64; valid bool), a warp a partition on a
    card."""
    if not Dint.is_cuda:
        return eliminate_interior_lu_plain(Dint, Oint, Bint, Lsep, Lleft, Uright, valid)
    D, m, dt = Dint.shape[0], Dint.shape[1], Dint.dtype
    if dt not in _FLOATS:
        raise kernels.KernelInputError(f"Dint: expected float32 or float64, got {dt}")
    kernels.check(Dint, "Dint", dt, (D, m, 6, 6))
    kernels.check(Oint, "Oint", dt, (D, m - 1, 6, 6))
    kernels.check(Bint, "Bint", dt, (D, m, 6))
    kernels.check(Lsep, "Lsep", dt, (D, m, 6, 6))
    kernels.check(Lleft, "Lleft", dt, (D, 6, 6))
    kernels.check(Uright, "Uright", dt, (D, 6, 6))
    kernels.check(valid, "valid", torch.bool, (D, m))
    dev = Dint.device
    S = torch.empty((D, 4, 6, 6), dtype=dt, device=dev)
    r = torch.empty((D, 2, 6), dtype=dt, device=dev)
    F = torch.empty((D, m, 6, 6), dtype=dt, device=dev)
    G = torch.empty((D, m, 6, 6), dtype=dt, device=dev)
    g = torch.empty((D, m, 6), dtype=dt, device=dev)
    scratch = (torch.empty((D * m * 80,), dtype=dt, device=dev)
               if m * 80 * Dint.element_size() > SCHUR_SMEM_BUDGET else None)
    if D:
        kernels.KERNELS["pgo_eliminate_lu"].launch(
            Dint.data_ptr(), Oint.data_ptr(), Bint.data_ptr(), Lsep.data_ptr(),
            Lleft.data_ptr(), Uright.data_ptr(), valid.data_ptr(), D, m, int(dt == _F64),
            None if scratch is None else scratch.data_ptr(), S.data_ptr(), r.data_ptr(),
            F.data_ptr(), G.data_ptr(), g.data_ptr())
    return S, r, F, G, g


def schur_partitioned_solve(diag, off, b, separators: Sequence[int], loop_edges=(),
                            loop_blocks=(), group=None, device=None):
    """Solve the chain (+ separator loop edges) system by the separator
    Schur complement (JAX schur_partitioned_solve): every partition's
    interior eliminated by K12b on `device`, then on the host the reduced
    separator system (the separators' diagonal blocks, the Schur blocks,
    the couplings of consecutive separators and the loop blocks (Baa, Bab,
    Bbb) of each loop edge (a, b)) solved and the interiors
    back-substituted. `separators` from plan_partition: sorted, ending at
    n - 1, every loop endpoint among them.

    It computes in diag's dtype: float64 in gives float64 out, float32
    gives float32 (the JAX function casts to float32 unless x64 is on).
    `group` (a ShardGroup) is the counterpart of the JAX `mesh=`: the
    partitions split evenly over its shards (else ValueError), each rank
    eliminates its shards' contiguous partitions in one launch, and the
    outputs are all-gathered in partition order, so every rank solves the
    same reduced system. `device` defaults to the group's, else "cuda".
    Returns x (n,6) numpy."""
    diag_np = np.asarray(diag)
    dtype = diag_np.dtype
    off_np = np.asarray(off).astype(dtype, copy=False)
    b_np = np.asarray(b).astype(dtype, copy=False)
    n = diag_np.shape[0]
    seps = [int(s) for s in separators]
    if seps != sorted(seps) or seps[-1] != n - 1:
        raise ValueError("separators must be sorted and end at n - 1")
    D = len(seps)
    prev = [-1] + seps[:-1]
    packed = pack_interiors(diag_np, off_np, b_np, seps)
    max_m = packed[0].shape[1]
    lo, hi = 0, D
    if group is not None:
        if D % group.n_shards:
            raise ValueError(f"{D} partitions do not split evenly over {group.n_shards} shards")
        per = D // group.n_shards
        lo, hi = group.first * per, (group.first + group.n_local) * per
        device = group.device if device is None else device
    dev = torch.device("cuda" if device is None else device)
    S, r, F, G, g = eliminate_interior_lu(
        *[torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev) for a in packed])
    out = torch.cat([t.reshape(hi - lo, -1) for t in (S, r, F, G, g)], 1)
    if group is not None:
        out = group.all_gather(out)
    out = out.cpu().numpy()
    cut = np.cumsum([0, 144, 12, 36 * max_m, 36 * max_m, 6 * max_m])
    S, r, F, G, g = (out[:, a:z] for a, z in zip(cut[:-1], cut[1:]))
    S_ll, S_lr, S_rl, S_rr = S.reshape(D, 4, 6, 6).transpose(1, 0, 2, 3)
    r_l, r_r = r.reshape(D, 2, 6).transpose(1, 0, 2)
    F, G, g = F.reshape(D, max_m, 6, 6), G.reshape(D, max_m, 6, 6), g.reshape(D, max_m, 6)

    # ---- reduced separator system (replicated; D x 6 dims) ----
    Hs = np.zeros((D * 6, D * 6), dtype)
    bs = np.zeros(D * 6, dtype)
    sep_of = {s: i for i, s in enumerate(seps)}
    for i, s in enumerate(seps):
        Hs[i*6:(i+1)*6, i*6:(i+1)*6] += diag_np[s]
        bs[i*6:(i+1)*6] += b_np[s]
        # couplings between consecutive separators with empty interiors
        if i + 1 < D and seps[i + 1] == s + 1:
            Hs[i*6:(i+1)*6, (i+1)*6:(i+2)*6] += off_np[s]
            Hs[(i+1)*6:(i+2)*6, i*6:(i+1)*6] += off_np[s].T
    for k in range(D):
        Hs[k*6:(k+1)*6, k*6:(k+1)*6] += S_rr[k]
        bs[k*6:(k+1)*6] += r_r[k]
        if k > 0:
            i_l = k - 1
            Hs[i_l*6:(i_l+1)*6, i_l*6:(i_l+1)*6] += S_ll[k]
            Hs[i_l*6:(i_l+1)*6, k*6:(k+1)*6] += S_lr[k]
            Hs[k*6:(k+1)*6, i_l*6:(i_l+1)*6] += S_rl[k]
            bs[i_l*6:(i_l+1)*6] += r_l[k]
    for (a, bb), (Baa, Bab, Bbb) in zip(loop_edges, loop_blocks):
        ia, ib = sep_of[a], sep_of[bb]
        Hs[ia*6:(ia+1)*6, ia*6:(ia+1)*6] += Baa
        Hs[ia*6:(ia+1)*6, ib*6:(ib+1)*6] += Bab
        Hs[ib*6:(ib+1)*6, ia*6:(ia+1)*6] += Bab.T
        Hs[ib*6:(ib+1)*6, ib*6:(ib+1)*6] += Bbb
    xs = np.linalg.solve(Hs, bs).reshape(D, 6)

    # ---- back-substitution: x_i = g_i - F_i x_left - G_i x_right ----
    x = np.zeros((n, 6), dtype)
    for i, s in enumerate(seps):
        x[s] = xs[i]
    for k, (p, s) in enumerate(zip(prev, seps)):
        m = s - p - 1
        if m == 0:
            continue
        xl = xs[sep_of[p]] if p in sep_of else np.zeros(6, dtype)
        xi = g[k] - F[k] @ xl - G[k] @ xs[sep_of[s]]
        x[p + 1: s] = xi[max_m - m:]
    return x
