"""Loop-closure detection over LiDAR-Iris descriptors (counterpart of the
JAX package's models/loop_closure.py).

  * keyframes are queued with their LOCAL-frame feature cloud and their
    position at queue time; a query first extracts the queued descriptors
    (K8a, torch.fft, K8b) straight into the device DB;
  * candidates are gated on the host by keyframe-id gap and by the
    distance between the stored positions (positions frozen at queue time,
    as in the JAX package; corrected poses do not reach the gate);
  * the at most 32 nearest survivors are compared with the query in one
    batched compare (torch.fft shifts, K8c), power-of-two padded, and the
    best one under similarity_threshold is returned.

The DB lives on the device as three tensors of capacity + 1 rows written
in place: the images (uint8), the T and the M codes (int32 words). Row
`capacity` is scratch for the descriptor of a query that is not in the DB,
so a full DB never has a live row overwritten.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..ops import iris
from ..utils import logging_util as log

__all__ = ["LoopCandidate", "LoopClosureConfig", "LoopClosureDetector"]


@dataclass
class LoopCandidate:
    query_keyframe_id: int
    match_keyframe_id: int
    similarity_score: float
    bias: int


@dataclass
class LoopClosureConfig:
    enable_loop_detection: bool = True
    similarity_threshold: float = 0.3
    min_keyframe_gap: int = 50
    max_search_distance: float = 5.0
    enable_debug_output: bool = False


class LoopClosureDetector:
    _DRAIN_BATCH = 16
    _MAX_CANDIDATES = 32

    def __init__(self, config: LoopClosureConfig, capacity: int = 4096, device="cuda"):
        self.config = config
        self.capacity = capacity
        self.device = device
        self._filters = torch.as_tensor(iris.log_gabor_filters(), device=device)
        self._img = None           # (capacity + 1, ROWS, COLS) uint8
        self._T = None             # (capacity + 1, PACKED_WORDS, COLS) int32
        self._M = None
        self._db_n = 0
        self._kf_ids: List[int] = []
        self._positions: List[np.ndarray] = []
        self._pending: List[tuple] = []    # (cloud, mask, kf_id, position)
        # the main thread queues keyframes while the loop worker drains
        self._pending_lock = threading.Lock()
        self.total_queries = 0
        self.total_candidates = 0

    def add_keyframe(self, cloud: np.ndarray, mask: np.ndarray, kf_id: int,
                     position: np.ndarray) -> bool:
        if cloud is None or not np.asarray(mask).any():
            log.warn("[LoopClosureDetector] Empty point cloud for keyframe {}", kf_id)
            return False
        with self._pending_lock:
            self._pending.append((cloud, mask, kf_id, np.array(position, copy=True)))
        return True

    def _ensure_db(self) -> None:
        if self._img is None:
            rows = self.capacity + 1
            dev = self.device
            self._img = torch.zeros((rows, iris.ROWS, iris.COLS), dtype=torch.uint8, device=dev)
            self._T = torch.zeros((rows, iris.PACKED_WORDS, iris.COLS), dtype=torch.int32,
                                  device=dev)
            self._M = torch.zeros_like(self._T)

    def _mark_stream(self) -> None:
        """The DB outlives the stream that allocated it: tell the allocator
        that the calling thread's stream uses it too."""
        if self._img is not None and self._img.is_cuda:
            s = torch.cuda.current_stream(self._img.device)
            for t in (self._img, self._T, self._M, self._filters):
                t.record_stream(s)

    def _extract_store(self, clouds: np.ndarray, masks: np.ndarray, start: int) -> None:
        """Descriptors of a (b, N, 3) batch written into DB rows
        [start, start + b)."""
        self._ensure_db()
        self._mark_stream()
        pts = torch.as_tensor(np.ascontiguousarray(clouds, np.float32), device=self.device)
        msk = torch.as_tensor(np.ascontiguousarray(masks, bool), device=self.device)
        bits = iris.iris_bits(pts, msk)
        T, M = iris.features(bits.to(torch.float32), self._filters)
        b = bits.shape[0]
        self._img[start:start + b] = bits.to(torch.uint8)
        self._T[start:start + b] = T
        self._M[start:start + b] = M

    def _drain_pending(self) -> None:
        """Extract the queued keyframes in power-of-two batches (at most 16)
        that always fit the remaining room, so a batch starts at db_n and
        its pad rows land past the live region."""
        while True:
            room = self.capacity - self._db_n
            with self._pending_lock:
                if not self._pending:
                    break
                if room <= 0:
                    for _c, _m, kf_id, _p in self._pending:
                        log.warn("[LoopClosureDetector] DB capacity exceeded, dropping KF {}",
                                 kf_id)
                    self._pending = []
                    break
                b = 1
                while b * 2 <= room and b < min(len(self._pending), self._DRAIN_BATCH):
                    b *= 2
                take = min(b, len(self._pending))
                batch, self._pending = self._pending[:take], self._pending[take:]
            k = len(batch)
            clouds = np.stack([x[0] for x in batch] + [batch[0][0]] * (b - k))
            masks = np.stack([x[1] for x in batch] + [batch[0][1]] * (b - k))
            self._extract_store(clouds, masks, self._db_n)
            for _c, _m, kf_id, position in batch:
                self._kf_ids.append(kf_id)
                self._positions.append(position)
                self._db_n += 1

    def detect_loop_closures(self, query_cloud: np.ndarray, query_mask: np.ndarray,
                             query_kf_id: int, query_position: np.ndarray) -> List[LoopCandidate]:
        if not self.config.enable_loop_detection:
            return []
        self.total_queries += 1
        self._drain_pending()
        if self._db_n == 0:
            return []
        self._mark_stream()
        if query_kf_id in self._kf_ids:
            qi = self._kf_ids.index(query_kf_id)
        else:
            # a query that is not in the DB extracts past the live region:
            # row db_n while there is room, the scratch row once it is full
            qi = min(self._db_n, self.capacity)
            self._extract_store(np.asarray(query_cloud)[None], np.asarray(query_mask)[None], qi)

        ids = np.asarray(self._kf_ids[: self._db_n])
        pos = np.stack(self._positions[: self._db_n])
        gap_ok = (query_kf_id - ids) >= self.config.min_keyframe_gap
        dist = np.linalg.norm(pos - np.asarray(query_position)[None, :], axis=-1)
        cand_idx = np.nonzero(gap_ok & (dist <= self.config.max_search_distance))[0]
        if len(cand_idx) == 0:
            return []
        if len(cand_idx) > self._MAX_CANDIDATES:
            order = np.argsort(dist[cand_idx])[: self._MAX_CANDIDATES]
            cand_idx = cand_idx[np.sort(order)]
        pad = 1
        while pad < len(cand_idx):
            pad *= 2
        idx_p = np.zeros(pad, np.int32)
        idx_p[: len(cand_idx)] = cand_idx
        valid = np.zeros(pad, bool)
        valid[: len(cand_idx)] = True
        out = iris.compare_rows(
            self._img, self._T, self._M, qi, torch.as_tensor(idx_p, device=self.device),
            torch.as_tensor(valid, device=self.device)).cpu().numpy()
        dists = out[:, 0]
        biases = out[:, 1].astype(np.int32)
        best = int(np.argmin(dists))
        best_score = float(dists[best])
        if not np.isfinite(best_score) or best_score > self.config.similarity_threshold:
            return []
        match_id = int(ids[idx_p[best]])
        self.total_candidates += 1
        if self.config.enable_debug_output:
            log.debug("[LoopClosureDetector] {} <-> {} (distance: {:.4f}, bias: {})",
                      query_kf_id, match_id, best_score, int(biases[best]))
        return [LoopCandidate(query_kf_id, match_id, best_score, int(biases[best]))]

    def clear(self) -> None:
        """Forget every descriptor; the DB tensors stay allocated."""
        self._db_n = 0
        self._kf_ids = []
        self._positions = []
        with self._pending_lock:
            self._pending = []
        self.total_queries = 0
        self.total_candidates = 0

    # ------------------------------------------------------------------
    # state as arrays (the JAX export_state layout, int32 code words)
    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        self._drain_pending()
        n = self._db_n
        w = (n, iris.PACKED_WORDS, iris.COLS)
        return {
            "iris_img": (self._img[:n].cpu().numpy() if n
                         else np.zeros((0, iris.ROWS, iris.COLS), np.uint8)),
            "iris_T": self._T[:n].cpu().numpy() if n else np.zeros(w, np.int32),
            "iris_M": self._M[:n].cpu().numpy() if n else np.zeros(w, np.int32),
            "iris_kf_ids": np.asarray(self._kf_ids, np.int32),
            "iris_positions": (np.stack(self._positions) if n
                               else np.zeros((0, 3), np.float32)),
        }

    def import_state(self, state: dict) -> None:
        """Load export_state arrays; T and M may be the JAX uint32 words."""
        self.clear()
        n = len(state["iris_kf_ids"])
        if n > self.capacity:
            log.warn("[LoopClosureDetector] state has {} descriptors, capacity {}: truncating",
                     n, self.capacity)
        n_used = min(n, self.capacity)
        if n_used:
            self._ensure_db()
            words = lambda a: torch.as_tensor(
                np.asarray(a[:n_used]).astype(np.uint32).view(np.int32), device=self.device)
            self._img[:n_used] = torch.as_tensor(np.array(state["iris_img"][:n_used], np.uint8),
                                                 device=self.device)
            self._T[:n_used] = words(state["iris_T"])
            self._M[:n_used] = words(state["iris_M"])
        self._kf_ids = [int(k) for k in state["iris_kf_ids"][:n_used]]
        self._positions = [np.asarray(state["iris_positions"][i]) for i in range(n_used)]
        self._db_n = n_used
