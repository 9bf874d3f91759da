"""Multi-device scaling (counterpart of `tostore_tpu/parallel/`).

Where the JAX package builds a `jax.sharding.Mesh` and hands `shard_map`
bodies to XLA, the port keeps a [dp, shard] grid of (process rank, torch
device) cells, runs each body as a plain function on the cells a process
owns, and merges with `torch.distributed` collectives (mesh.py). The
mapping from the source system's "nodes fetch disjoint ID ranges" is the
JAX package's: corpus rows stripe over the "shard" axis, queries split
over "dp", and per-shard partial top-k results merge after one gather of
k * n_shards candidates.

The JAX package also exports `corpus_sharding` and `replicated`, the
`NamedSharding` specs its callers hand to `jax.device_put`. The port has
no such object: a striped array is `mesh.Striped`, a replicated one
`mesh.Replicated`, and both are built from host values directly.
"""

from .mesh import make_mesh
from .sharded import (
    sharded_flat_topk,
    sharded_kmeans,
    sharded_kmeans_step,
    ShardedFlatIndex,
)

__all__ = [
    "make_mesh",
    "sharded_flat_topk",
    "sharded_kmeans",
    "sharded_kmeans_step",
    "ShardedFlatIndex",
]
