"""Mesh and sharding layer (port of ``rwm_pt_tpu.parallel``): one process
drives every shard of a mesh of torch devices (``mesh.py``)."""
from .mesh import (Mesh, NamedSharding, ShardedTensor, chain_sharding,
                   initialize_distributed, make_mesh, pooled_mean,
                   pt_sharding, shard_init_states)

__all__ = ["initialize_distributed", "make_mesh", "chain_sharding",
           "pt_sharding", "shard_init_states", "pooled_mean", "Mesh",
           "NamedSharding", "ShardedTensor"]
