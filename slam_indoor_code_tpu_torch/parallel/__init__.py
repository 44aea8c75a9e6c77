"""Mesh-parallel execution: the sharded frontend fan-out and the
distributed Schur BA (counterpart of the JAX package's parallel/), with the
split and the reductions written out over explicit devices.  Tested on a
virtual 8-shard CPU mesh and on one card; ``worker`` runs the two-process
bring-up."""

from .ba_sharded import ShardedBA, ShardedBAResult
from .frontend_sharded import ShardedFrontend
from .mesh import (Mesh, batch_sharding, initialize_distributed, make_mesh,
                   map_batch, reduce_sum, replicated)

__all__ = [
    "Mesh",
    "ShardedBA",
    "ShardedBAResult",
    "ShardedFrontend",
    "batch_sharding",
    "initialize_distributed",
    "make_mesh",
    "map_batch",
    "reduce_sum",
    "replicated",
]
