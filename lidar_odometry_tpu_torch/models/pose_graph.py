"""Batch Gauss-Newton pose-graph optimizer (counterpart of the JAX
package's models/pose_graph.py, a copy of its host solver: float64 numpy
and scipy sparse, as the reference runs it on its background thread).

  * GTSAM conventions: [rot, trans] tangent ordering;
  * BetweenFactor error log(measured^-1 * T_from^-1 * T_to) with
    J_to = I, J_from = -Ad(hx^-1);
  * PriorFactor error log(measured^-1 * T), J = I;
  * diagonal information from noise sigmas, whitened by sqrt-info;
  * sparse H assembled from triplets and solved with scipy's sparse
    solver, retraction T <- T * Exp(delta), <= 10 iterations,
    ||dx|| < 1e-6;
  * incremental API: add_first_keyframe (tight 1e-4 prior),
    add_keyframe_with_odom, add_loop_and_optimize.

backend="manual" is that host solve. backend="distributed" runs the whole
Gauss-Newton optimisation (linearisation, the partitioned Schur solve,
retraction and the convergence loop) on `device` through
parallel/distributed_pgo.gn_optimize_device, from 4 keyframes up; smaller
graphs take the host loop, as in the JAX package. Unlike the JAX backend it
never falls back to the host loop: an error of the device solve reaches
the caller. A solve that does not converge returns False and leaves the
poses as they were. The JAX backend's host loop, whose steps are the
partitioned Schur solve (distributed_pgo.schur_partitioned_solve), is
_optimize_distributed_host, a method of its own.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..parallel import distributed_pgo as dpgo
from ..utils import lie

_EPS = 1e-10  # reference kEpsLie (PoseGraphOptimizer.cpp:31)


# ---- SE(3) helpers in GTSAM [rot, trans] ordering (reference :36-162) ----

def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64)


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


def so3_log(R):
    """(3, 3) -> axis-angle w (utils/lie.so3_log in float64)."""
    return lie.so3_log(_f64(R)).numpy()


def so3_exp(w):
    """Axis-angle w -> (3, 3) (utils/lie.so3_exp in float64)."""
    return lie.so3_exp(_f64(w)).numpy()


def se3_log(R, t):
    """(R, t) -> [w, u] (GTSAM order): utils/lie.se3_log's [u, w] in
    float64, swapped (reference SE3_Logmap :81-96)."""
    xi = lie.se3_log(lie.se3_matrix(_f64(R), _f64(t))).numpy()
    return np.concatenate([xi[3:], xi[:3]])


def se3_exp(xi):
    """[w, u] -> (R, t) (GTSAM order): utils/lie.se3_exp of [u, w] in
    float64 (reference SE3_Expmap :98-118)."""
    xi = np.asarray(xi, np.float64)
    R, t = lie.se3_rt(lie.se3_exp(_f64(np.concatenate([xi[3:], xi[:3]]))))
    return R.numpy(), t.numpy()


def adjoint(R, t):
    """Ad_T for [rot, trans] ordering (reference SE3_AdjointMap :120-130)."""
    Ad = np.zeros((6, 6))
    Ad[:3, :3] = R
    Ad[3:, :3] = _skew(t) @ R
    Ad[3:, 3:] = R
    return Ad


def make_information(trans_noise, rot_noise):
    """Diagonal information in GTSAM order [rot x3, trans x3]
    (reference makeInformationMatrix :605-621)."""
    info = np.zeros(6)
    info[:3] = 1.0 / (rot_noise * rot_noise)
    info[3:] = 1.0 / (trans_noise * trans_noise)
    return np.diag(info)


@dataclass
class PriorFactor:
    key: int
    measured: np.ndarray  # (4,4)
    sqrt_info: np.ndarray  # (6,6)


@dataclass
class BetweenFactor:
    key_from: int
    key_to: int
    measured: np.ndarray
    sqrt_info: np.ndarray


def between_error(T_from, T_to, measured):
    """Error + Jacobians of a between factor (reference :463-498)."""
    R_from, t_from = T_from[:3, :3], T_from[:3, 3]
    R_to, t_to = T_to[:3, :3], T_to[:3, 3]
    R_m, t_m = measured[:3, :3], measured[:3, 3]
    R_hx = R_from.T @ R_to
    t_hx = R_from.T @ (t_to - t_from)
    R_err = R_m.T @ R_hx
    t_err = R_m.T @ (t_hx - t_m)
    err = se3_log(R_err, t_err)
    R_hx_inv = R_hx.T
    t_hx_inv = -R_hx_inv @ t_hx
    J_from = -adjoint(R_hx_inv, t_hx_inv)
    J_to = np.eye(6)
    return err, J_from, J_to


def prior_error(T, measured):
    R, t = T[:3, :3], T[:3, 3]
    R_m, t_m = measured[:3, :3], measured[:3, 3]
    err = _se3_log_batch((R_m.T @ R)[None], (R_m.T @ (t - t_m))[None])[0]
    return err, np.eye(6)


# ---- batched linearization (vectorized over factors; the per-factor
# python path cost ~0.1 ms/factor in meshgrid/log branches — 250 ms per
# solve at 340 keyframes, most of the loop worker's host budget) ----

def _skew_batch(v):
    N = v.shape[0]
    S = np.zeros((N, 3, 3))
    S[:, 0, 1], S[:, 0, 2] = -v[:, 2], v[:, 1]
    S[:, 1, 0], S[:, 1, 2] = v[:, 2], -v[:, 0]
    S[:, 2, 0], S[:, 2, 1] = -v[:, 1], v[:, 0]
    return S


def _se3_log_batch(R, t):
    """Batched se3_log: (N,3,3),(N,3) -> (N,6) in [w, u] order."""
    tr = np.trace(R, axis1=1, axis2=2)
    theta = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    w_raw = np.stack([R[:, 2, 1] - R[:, 1, 2],
                      R[:, 0, 2] - R[:, 2, 0],
                      R[:, 1, 0] - R[:, 0, 1]], axis=1)
    small = theta < _EPS
    fac = np.where(small, 0.5,
                   theta / np.maximum(2.0 * np.sin(theta), _EPS))
    w = w_raw * fac[:, None]
    th_safe = np.where(small, 1.0, theta)
    W = _skew_batch(w / th_safe[:, None])
    Wt = np.einsum("nij,nj->ni", W, t)
    WWt = np.einsum("nij,nj->ni", W, Wt)
    tan_half = np.tan(0.5 * theta)
    coef = 1.0 - theta / np.maximum(2.0 * tan_half, _EPS)
    u = t - (0.5 * theta)[:, None] * Wt + coef[:, None] * WWt
    u = np.where(small[:, None], t, u)
    return np.concatenate([w, u], axis=1)


def _se3_exp_batch(xi):
    """Batched se3_exp: (N,6) [w,u] -> (R (N,3,3), t (N,3))."""
    w, u = xi[:, :3], xi[:, 3:]
    theta = np.linalg.norm(w, axis=1)
    small = theta < _EPS
    th = np.where(small, 1.0, theta)
    Wu = _skew_batch(w / th[:, None])
    WWu = np.einsum("nij,njk->nik", Wu, Wu)
    I = np.broadcast_to(np.eye(3), (len(xi), 3, 3))
    s, c = np.sin(theta), np.cos(theta)
    R = I + s[:, None, None] * Wu + (1.0 - c)[:, None, None] * WWu
    R = np.where(small[:, None, None], I + _skew_batch(w), R)
    V = (I + ((1.0 - c) / th)[:, None, None] * Wu
         + ((th - s) / th)[:, None, None] * WWu)
    t = np.einsum("nij,nj->ni", V, u)
    t = np.where(small[:, None], u, t)
    return R, t


def _between_error_batch(T_from, T_to, measured):
    """Batched between_error: (N,4,4)x3 -> err (N,6), J_from (N,6,6)
    (J_to = I for every factor, reference :463-498)."""
    R_from, t_from = T_from[:, :3, :3], T_from[:, :3, 3]
    R_to, t_to = T_to[:, :3, :3], T_to[:, :3, 3]
    R_m, t_m = measured[:, :3, :3], measured[:, :3, 3]
    R_hx = np.einsum("nji,njk->nik", R_from, R_to)
    t_hx = np.einsum("nji,nj->ni", R_from, t_to - t_from)
    R_err = np.einsum("nji,njk->nik", R_m, R_hx)
    t_err = np.einsum("nji,nj->ni", R_m, t_hx - t_m)
    err = _se3_log_batch(R_err, t_err)
    R_hx_inv = np.swapaxes(R_hx, 1, 2)
    t_hx_inv = -np.einsum("nij,nj->ni", R_hx_inv, t_hx)
    Ad = np.zeros((len(err), 6, 6))
    Ad[:, :3, :3] = R_hx_inv
    Ad[:, 3:, :3] = np.einsum("nij,njk->nik", _skew_batch(t_hx_inv), R_hx_inv)
    Ad[:, 3:, 3:] = R_hx_inv
    return err, -Ad


class PoseGraphOptimizer:
    """Incremental-build, batch-solve pose graph. Thread-safe: a lock
    guards the graph, since the estimator's loop worker calls
    add_loop_and_optimize while the main thread adds odometry factors.
    backend="manual" is the scipy sparse solve; "distributed" the float64
    device solve on `device` in `n_blocks` partitions."""

    def __init__(self, backend: str = "manual", n_blocks: int = 8, device="cuda"):
        if backend not in ("manual", "distributed"):
            raise ValueError(f"pgo_backend {backend!r}: expected 'manual' or 'distributed'")
        self._priors: List[PriorFactor] = []
        self._betweens: List[BetweenFactor] = []
        self._poses: Dict[int, np.ndarray] = {}
        self._keyframe_ids: List[int] = []
        self._kf_to_index: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.backend = backend
        self.n_blocks = n_blocks
        self.device = device
        self.loop_closure_count = 0
        self.odometry_count = 0

    # ---- incremental API ----

    def add_first_keyframe(self, keyframe_id: int, pose: np.ndarray) -> bool:
        with self._lock:
            if self._keyframe_ids:
                return False
            info = make_information(1e-4, 1e-4)  # tight prior (:184)
            self._priors.append(PriorFactor(0, pose.astype(np.float64), np.sqrt(info)))
            self._poses[keyframe_id] = pose.astype(np.float64)
            self._keyframe_ids.append(keyframe_id)
            self._kf_to_index[keyframe_id] = 0
            return True

    def add_keyframe_with_odom(self, prev_id: int, curr_id: int,
                               curr_pose: np.ndarray, relative_pose: np.ndarray,
                               trans_noise: float, rot_noise: float) -> bool:
        with self._lock:
            if curr_id in self._kf_to_index:
                return True
            curr_index = len(self._keyframe_ids)
            if prev_id in self._kf_to_index:
                prev_index = self._kf_to_index[prev_id]
                info = make_information(trans_noise, rot_noise)
                self._betweens.append(BetweenFactor(
                    prev_index, curr_index, relative_pose.astype(np.float64),
                    np.sqrt(info)))
            else:
                # loose prior fallback (:226-231)
                info = make_information(0.5, 0.1)
                self._priors.append(PriorFactor(
                    curr_index, curr_pose.astype(np.float64), np.sqrt(info)))
            self._poses[curr_id] = curr_pose.astype(np.float64)
            self._keyframe_ids.append(curr_id)
            self._kf_to_index[curr_id] = curr_index
            self.odometry_count += 1
            return True

    def add_loop_and_optimize(self, from_id: int, to_id: int,
                              relative_pose: np.ndarray,
                              trans_noise: float, rot_noise: float) -> bool:
        with self._lock:
            if from_id not in self._kf_to_index or to_id not in self._kf_to_index:
                return False
            info = make_information(trans_noise, rot_noise)
            self._betweens.append(BetweenFactor(
                self._kf_to_index[from_id], self._kf_to_index[to_id],
                relative_pose.astype(np.float64), np.sqrt(info)))
            # Propagate solver failure so Estimator's "PGO failed" path
            # actually fires (ADVICE round-1 item 2).
            ok = self._optimize(max_iterations=10, convergence_threshold=1e-6)
            if ok:
                self.loop_closure_count += 1
            return ok

    def get_all_optimized_poses(self) -> Dict[int, np.ndarray]:
        with self._lock:
            return {k: v.copy() for k, v in self._poses.items()}

    def get_optimized_pose(self, keyframe_id: int):
        with self._lock:
            p = self._poses.get(keyframe_id)
            return None if p is None else p.copy()

    def clear(self):
        with self._lock:
            self._priors.clear()
            self._betweens.clear()
            self._poses.clear()
            self._keyframe_ids.clear()
            self._kf_to_index.clear()
            self.loop_closure_count = 0
            self.odometry_count = 0

    # ---- solver (reference optimize :326-390) ----

    def _linearize(self, n_vars):
        """Every factor linearised, batched over the between factors (the
        per-factor python path cost ~250 ms per solve at 340 keyframes,
        round-4 profiling). Returns b (n,6), the prior keys with their
        blocks J^T J (P,6,6), and the between keys ki, kj with their blocks
        H_ii, H_jj and H_ij = Jw_i^T Jw_j (N,6,6); H is their sum."""
        b = np.zeros((n_vars, 6))
        pk, Hp = [], []
        for prior in self._priors:
            kf_id = self._keyframe_ids[prior.key]
            err, J = prior_error(self._poses[kf_id], prior.measured)
            Jw = prior.sqrt_info @ J
            ew = prior.sqrt_info @ err
            pk.append(prior.key)
            Hp.append(Jw.T @ Jw)
            b[prior.key] -= Jw.T @ ew
        pk = np.array(pk, dtype=np.int64)
        Hp = np.array(Hp).reshape(-1, 6, 6)

        ki = np.array([bt.key_from for bt in self._betweens], dtype=np.int64)
        kj = np.array([bt.key_to for bt in self._betweens], dtype=np.int64)
        if not self._betweens:
            z = np.zeros((0, 6, 6))
            return b, pk, Hp, ki, kj, z, z, z
        T_from = np.stack([self._poses[self._keyframe_ids[i]] for i in ki])
        T_to = np.stack([self._poses[self._keyframe_ids[j]] for j in kj])
        meas = np.stack([bt.measured for bt in self._betweens])
        sq = np.stack([bt.sqrt_info for bt in self._betweens])
        err, J_from = _between_error_batch(T_from, T_to, meas)
        Jw_f = np.einsum("nab,nbc->nac", sq, J_from)
        Jw_t = sq                                  # J_to = I
        ew = np.einsum("nab,nb->na", sq, err)
        np.subtract.at(b, ki, np.einsum("nba,nb->na", Jw_f, ew))
        np.subtract.at(b, kj, np.einsum("nba,nb->na", Jw_t, ew))
        return (b, pk, Hp, ki, kj, np.einsum("nba,nbc->nac", Jw_f, Jw_f),
                np.einsum("nba,nbc->nac", Jw_t, Jw_t), np.einsum("nba,nbc->nac", Jw_f, Jw_t))

    def _build_linear_system(self, n_vars):
        """The sparse H (6n x 6n, CSC) and b (6n,) of _linearize's blocks,
        one COO assembly."""
        b, pk, Hp, ki, kj, Hii, Hjj, Hij = self._linearize(n_vars)
        bi = np.concatenate([pk, ki, kj, ki, kj])
        bj = np.concatenate([pk, ki, kj, kj, ki])
        Bv = np.concatenate([Hp, Hii, Hjj, Hij, Hij.transpose(0, 2, 1)])
        blk_r, blk_c = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
        rows = (bi[:, None, None] * 6 + blk_r[None]).ravel()
        cols = (bj[:, None, None] * 6 + blk_c[None]).ravel()
        H = sp.csc_matrix((Bv.ravel(), (rows, cols)),
                          shape=(n_vars * 6, n_vars * 6))
        return H, b.reshape(-1)

    def _optimize(self, max_iterations=10, convergence_threshold=1e-6) -> bool:
        n_vars = len(self._keyframe_ids)
        if n_vars == 0:
            return True
        if self.backend == "distributed" and n_vars >= 4:
            return self._optimize_distributed_device(max_iterations, convergence_threshold)
        return self._host_iterations(self._solve_sparse, n_vars, max_iterations,
                                     convergence_threshold)

    def _optimize_distributed_host(self, max_iterations=10, convergence_threshold=1e-6) -> bool:
        """The JAX distributed backend's host Gauss-Newton loop
        (models/pose_graph.py:383-406 there, which it runs when its device
        program fails): from 4 keyframes up each step is _solve_distributed,
        the partitioned Schur solve on self.device; smaller graphs take the
        sparse solve. Not reached from _optimize: the port has no fallback."""
        n_vars = len(self._keyframe_ids)
        if n_vars == 0:
            return True
        solve = self._solve_distributed if n_vars >= 4 else self._solve_sparse
        return self._host_iterations(solve, n_vars, max_iterations, convergence_threshold)

    def _solve_sparse(self, n_vars):
        H, b = self._build_linear_system(n_vars)
        try:
            return spla.spsolve(H, b)
        except Exception:
            return None

    def _host_iterations(self, solve, n_vars, max_iterations, convergence_threshold) -> bool:
        """Up to max_iterations steps dx = solve(n_vars), each retracted
        into the poses; True once |dx| < convergence_threshold, False on a
        failed or non-finite solve."""
        for _ in range(max_iterations):
            dx = solve(n_vars)
            if dx is None or not np.all(np.isfinite(dx)):
                return False
            # batched retraction T <- T * Exp(delta)
            P = np.stack([self._poses[k] for k in self._keyframe_ids])
            dR, dt = _se3_exp_batch(dx.reshape(-1, 6))
            T_new = np.broadcast_to(np.eye(4), P.shape).copy()
            T_new[:, :3, :3] = np.einsum("nij,njk->nik", P[:, :3, :3], dR)
            T_new[:, :3, 3] = (np.einsum("nij,nj->ni", P[:, :3, :3], dt)
                               + P[:, :3, 3])
            for i, kf_id in enumerate(self._keyframe_ids):
                self._poses[kf_id] = T_new[i]
            if np.linalg.norm(dx) < convergence_threshold:
                return True
        return False

    def _linearize_distributed(self, n_vars):
        """_linearize's blocks in block-tridiagonal form: diag (n,6,6), off
        (max(n-1,1),6,6) with off[i] = H[i, i+1], b (n,6), and the off-band
        (loop) edges (lo, hi), in factor order, with their blocks (0,
        H[lo, hi], 0), whose diagonal parts are already in diag (JAX
        _solve_distributed)."""
        b, pk, Hp, ki, kj, Hii, Hjj, Hij = self._linearize(n_vars)
        diag = np.zeros((n_vars, 6, 6))
        np.add.at(diag, pk, Hp)
        np.add.at(diag, ki, Hii)
        np.add.at(diag, kj, Hjj)
        fwd = ki < kj
        lo, hi = np.where(fwd, ki, kj), np.where(fwd, kj, ki)
        H_lh = np.where(fwd[:, None, None], Hij, Hij.transpose(0, 2, 1))
        band = hi == lo + 1
        off = np.zeros((max(n_vars - 1, 1), 6, 6))
        np.add.at(off, lo[band], H_lh[band])
        zero = np.zeros((6, 6))
        loop_edges = list(zip(lo[~band].tolist(), hi[~band].tolist()))
        loop_blocks = [(zero, B, zero) for B in H_lh[~band]]
        return diag, off, b, loop_edges, loop_blocks

    def _solve_distributed(self, n_vars):
        """One Gauss-Newton step by the partitioned Schur solve
        (dpgo.schur_partitioned_solve, K12b on self.device), separators
        planned over min(n_blocks, n/2) partitions and every loop endpoint.
        Returns dx (6n,), or None when the reduced system is singular (JAX
        returns None on any error; here a kernel's error reaches the
        caller)."""
        diag, off, b, loop_edges, loop_blocks = self._linearize_distributed(n_vars)
        seps = dpgo.plan_partition(n_vars, min(self.n_blocks, max(n_vars // 2, 1)), loop_edges)
        try:
            x = dpgo.schur_partitioned_solve(diag, off, b, seps, loop_edges, loop_blocks,
                                             device=self.device)
        except np.linalg.LinAlgError:
            return None
        return x.reshape(-1)

    def _optimize_distributed_device(self, max_iterations, convergence_threshold) -> bool:
        """The whole GN optimisation on the device
        (parallel/distributed_pgo.gn_optimize_device); the host only packs
        the factor arrays. The poses are written only when it converged."""
        poses = np.stack([self._poses[k] for k in self._keyframe_ids])
        priors = [(p.key, p.measured, p.sqrt_info) for p in self._priors]
        betweens = [(bt.key_from, bt.key_to, bt.measured, bt.sqrt_info)
                    for bt in self._betweens]
        out, ok = dpgo.gn_optimize_device(
            poses, priors, betweens, n_blocks=self.n_blocks, max_iters=max_iterations,
            tol=convergence_threshold, device=self.device)
        if not ok:
            return False
        for i, kf_id in enumerate(self._keyframe_ids):
            self._poses[kf_id] = out[i]
        return True

    # ---- state carried across from the JAX package (convert.py) ----

    def export_factors(self) -> dict:
        """The graph as arrays: poses by keyframe order, priors, betweens."""
        with self._lock:
            return {
                "keyframe_ids": np.asarray(self._keyframe_ids, np.int64),
                "poses": (np.stack([self._poses[k] for k in self._keyframe_ids])
                          if self._keyframe_ids else np.zeros((0, 4, 4))),
                "prior_keys": np.asarray([p.key for p in self._priors], np.int64),
                "prior_measured": np.asarray([p.measured for p in self._priors]).reshape(-1, 4, 4),
                "prior_sqrt_info": np.asarray([p.sqrt_info for p in self._priors]).reshape(-1, 6, 6),
                "between_keys": np.asarray([(b.key_from, b.key_to) for b in self._betweens],
                                           np.int64).reshape(-1, 2),
                "between_measured": np.asarray([b.measured for b in self._betweens]).reshape(-1, 4, 4),
                "between_sqrt_info": np.asarray([b.sqrt_info for b in self._betweens]
                                                ).reshape(-1, 6, 6),
                "counts": np.asarray([self.odometry_count, self.loop_closure_count], np.int64),
            }

    def import_factors(self, state: dict) -> None:
        """Replace the graph by the arrays of export_factors."""
        with self._lock:
            ids = [int(k) for k in state["keyframe_ids"]]
            self._keyframe_ids = ids
            self._kf_to_index = {k: i for i, k in enumerate(ids)}
            self._poses = {k: np.asarray(state["poses"][i], np.float64) for i, k in enumerate(ids)}
            self._priors = [PriorFactor(int(k), np.asarray(m, np.float64), np.asarray(s, np.float64))
                            for k, m, s in zip(state["prior_keys"], state["prior_measured"],
                                               state["prior_sqrt_info"])]
            self._betweens = [BetweenFactor(int(k[0]), int(k[1]), np.asarray(m, np.float64),
                                            np.asarray(s, np.float64))
                              for k, m, s in zip(state["between_keys"], state["between_measured"],
                                                 state["between_sqrt_info"])]
            self.odometry_count, self.loop_closure_count = (int(c) for c in state["counts"])
