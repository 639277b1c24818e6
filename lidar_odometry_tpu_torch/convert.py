"""State carried between the JAX package and the port, as numpy arrays.

The repo has no model weights: what crosses is PKO's constant tables, the
map / odometry state, the loop detector's Iris DB (the arrays of the JAX
LoopClosureDetector.export_state(); its uint32 code words become the
port's int32 words, bit for bit) and the pose graph's factors. The map keeps the JAX layout field for field
(bucket rows of [slot x8 | hi x8 | lo x8 | pad], key halves as int32 bit
patterns), so conversion is a copy; the port's tables only add one
trailing sink row each (ops/voxel_map.py), which these functions add and
strip. Callers pass {name: np.asarray(value)} of the JAX objects, so this
module never touches JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.fast_pipeline import OdomCarry
from .models.loop_closure import LoopClosureConfig, LoopClosureDetector
from .models.pose_graph import PoseGraphOptimizer
from .ops import pko
from .ops.voxel_map import VoxelMapState

__all__ = ["pko_constants_from_numpy", "map_state_from_numpy",
           "map_state_to_numpy", "sharded_map_from_numpy", "sharded_map_to_numpy",
           "carry_from_numpy", "loop_detector_from_numpy", "pose_graph_from_numpy",
           "MAP_FIELDS", "TABLES", "POSE_GRAPH_FIELDS"]

POSE_GRAPH_FIELDS = ("keyframe_ids", "poses", "prior_keys", "prior_measured",
                     "prior_sqrt_info", "between_keys", "between_measured",
                     "between_sqrt_info", "counts")

MAP_FIELDS = VoxelMapState._fields
# the fields with one row a slot, to which the port adds its sink row
TABLES = ("l0_data", "l1_index", "l1_meta", "l1_last", "l1_surfel", "l1_free")


def pko_constants_from_numpy(arrays: dict, kernel_type: str = "huber",
                             gmm_components: int = 3, gmm_sample_size: int = 100,
                             device="cuda") -> pko.PKOConstants:
    """alphas, Z, r_grid, Q of a JAX PKOConstants."""
    if (gmm_sample_size, gmm_components) != (pko.GMM_SAMPLES, pko.GMM_COMPONENTS):
        raise ValueError("the port carries the draws for 100 samples and 3 "
                         "components only")
    return pko.from_arrays(arrays, kernel_type, device)


def _sink_row(name: str, table: np.ndarray) -> np.ndarray:
    if name == "l1_index" or name == "l1_meta":
        return np.full((1,) + table.shape[1:], -1, table.dtype)
    if name == "l1_free":
        return np.asarray([table.shape[0]], table.dtype)
    return np.zeros((1,) + table.shape[1:], table.dtype)


def map_state_from_numpy(arrays: dict, device="cuda") -> VoxelMapState:
    """The ten VoxelMapState fields of a JAX map -> the port's state."""
    out = {}
    for name in MAP_FIELDS:
        a = np.asarray(arrays[name])
        if name in TABLES:
            a = np.concatenate([a, _sink_row(name, a)])
        out[name] = torch.tensor(a, device=device)
    return VoxelMapState(**out)


def map_state_to_numpy(state: VoxelMapState) -> dict:
    """The port's state -> the ten fields in the JAX shapes."""
    out = {}
    for name in MAP_FIELDS:
        a = getattr(state, name).detach().cpu().numpy()
        out[name] = a[:-1] if name in TABLES else a
    return out


def sharded_map_from_numpy(arrays: dict, n_shards: int, device="cuda",
                           shards=None) -> VoxelMapState:
    """A JAX sharded map (the ten fields of gather_state: tables (S *
    local, ...), scalars (S,)) -> the port's layout of the shards in
    `shards` (default all, in order; a rank passes its own): each shard's
    tables with their sink rows, one shard after another, and (n,)
    scalars."""
    shards = range(n_shards) if shards is None else list(shards)
    out = {}
    for name in MAP_FIELDS:
        a = np.asarray(arrays[name])
        if name in TABLES:
            per = a.reshape((n_shards, a.shape[0] // n_shards) + a.shape[1:])
            a = np.concatenate([np.concatenate([per[s], _sink_row(name, per[s])])
                                for s in shards])
        else:
            a = a[list(shards)]
        out[name] = torch.tensor(a, device=device)
    return VoxelMapState(**out)


def sharded_map_to_numpy(state: VoxelMapState) -> dict:
    """The port's sharded layout -> the ten fields in the JAX global layout
    (sink rows stripped)."""
    n = state.n_l0.shape[0]
    out = {}
    for name in MAP_FIELDS:
        a = getattr(state, name).detach().cpu().numpy().copy()
        if name in TABLES:
            per = a.reshape((n, a.shape[0] // n) + a.shape[1:])
            a = per[:, :-1].reshape((-1,) + a.shape[1:])
        out[name] = a
    return out


def carry_from_numpy(arrays: dict, device="cuda") -> OdomCarry:
    """An OdomCarry's fields; `map_state` is itself a dict of map fields.
    Takes a single-stream carry (poses (4, 4), flags ()) or a blocked one
    (poses (B, 4, 4), flags (B,)) alike."""
    t = lambda k: torch.tensor(np.asarray(arrays[k]), device=device)
    return OdomCarry(
        map_state=map_state_from_numpy(arrays["map_state"], device=device),
        T_prev=t("T_prev").to(torch.float32), velocity=t("velocity").to(torch.float32),
        last_kf_pose=t("last_kf_pose").to(torch.float32),
        initialized=t("initialized").to(torch.bool),
        kf_count=t("kf_count").to(torch.int32))


def loop_detector_from_numpy(arrays: dict, config: LoopClosureConfig, capacity: int,
                             device="cuda") -> LoopClosureDetector:
    """A detector holding the Iris DB of a JAX LoopClosureDetector's
    export_state(): iris_img, iris_T, iris_M, iris_kf_ids,
    iris_positions."""
    det = LoopClosureDetector(config, capacity=capacity, device=device)
    det.import_state({k: np.asarray(v) for k, v in arrays.items()})
    return det


def pose_graph_from_numpy(arrays: dict, backend: str = "manual", n_blocks: int = 8,
                          device="cuda") -> PoseGraphOptimizer:
    """A pose graph of `backend` ("manual" or "distributed", the latter
    solving on `device` in `n_blocks` partitions) from the JAX graph's
    fields: keyframe_ids (K,),
    poses (K, 4, 4) in keyframe order, prior_keys (P,) / prior_measured
    (P, 4, 4) / prior_sqrt_info (P, 6, 6), between_keys (B, 2) /
    between_measured (B, 4, 4) / between_sqrt_info (B, 6, 6) (keys are
    keyframe indices), counts (2,) [odometry, loop closures]."""
    graph = PoseGraphOptimizer(backend=backend, n_blocks=n_blocks, device=device)
    graph.import_factors({k: np.asarray(arrays[k]) for k in POSE_GRAPH_FIELDS})
    return graph
