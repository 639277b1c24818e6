"""The shard group of the sharded surfel map (counterpart of the JAX
package's parallel/mesh.py make_mesh and initialize_multihost).

The JAX package shards the map over a device mesh's "map" axis. The port
runs one process a GPU (NCCL cannot put two ranks on one card), and a
process may hold several shards of one map: the shard axis is then also a
tensor axis, the leading axis of the per-shard tensors. A ShardGroup is
`world_size` ranks x `n_local` shards a rank, `n_shards` in all; rank r
holds the contiguous shards r * n_local ... r * n_local + n_local - 1.

Two collectives are all the sharded map needs, both over that leading
local-shard axis:
  * all_gather(x): every shard's row in global shard order;
  * psum(x): the rows summed one after another in global shard order.
Both gather every row before they add, so a sum never depends on how the
shards are spread over ranks: two calls are bit-equal, and 2 ranks x 2
shards sum exactly as 1 rank x 4. One rank makes no collective call.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ShardGroup", "make_group", "initialize_multihost"]


class ShardGroup:
    """`world_size` ranks x `n_local` shards a rank on `device`; `group` is
    the torch.distributed process group (None for one process)."""

    def __init__(self, n_local: int, device="cuda", group=None):
        if n_local < 1:
            raise ValueError(f"a rank holds at least one shard, not {n_local}")
        self.n_local = n_local
        self.device = device
        self.group = group
        if group is None:
            self.world_size, self.rank = 1, 0
        else:
            self.world_size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        self.n_shards = self.world_size * n_local
        self.first = self.rank * n_local

    @property
    def local_ids(self) -> range:
        """Global ids of this rank's shards."""
        return range(self.first, self.first + self.n_local)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """x has this rank's n_local shards on `dim`; returns every shard's
        slice in global shard order (n_shards on `dim`). One rank: x itself."""
        if self.world_size == 1:
            return x
        xs = x.movedim(dim, 0).contiguous()
        parts = [torch.empty_like(xs) for _ in range(self.world_size)]
        dist.all_gather(parts, xs, group=self.group)
        return torch.cat(parts, 0).movedim(0, dim)

    def psum(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum over every shard's slice of x (n_local on `dim`), taken
        one shard after another in global shard order."""
        g = self.all_gather(x, dim).movedim(dim, 0)
        out = g[0]
        for s in range(1, g.shape[0]):
            out = out + g[s]
        return out


def make_group(n_local_shards: int, device="cuda", group=None) -> ShardGroup:
    """A shard group of n_local_shards shards on this rank; over the
    default process group when one is initialised (or over `group`),
    else one process."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return ShardGroup(n_local_shards, device=device, group=group)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None) -> int:
    """Join the process group: NCCL for CUDA, gloo on the CPU (`backend`
    overrides). Arguments fall back to MASTER_ADDR (with MASTER_PORT, or
    an address of the form tcp://host:port or file://path), WORLD_SIZE and
    RANK. Call once a process before any sharded work; returns this
    process's rank."""
    addr = coordinator_address or os.environ.get("MASTER_ADDR")
    if not addr:
        raise ValueError("initialize_multihost: no coordinator address (MASTER_ADDR)")
    if "://" not in addr:
        addr = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank)
    return rank
