"""Data layer: the counter-based batch generator (the JAX package's threefry
streams, token for token) and the shard assignment record."""
from repro_torch.data.pipeline import (
    ShardAssignment,
    global_batch_for_step,
    host_batch_numpy,
    make_batch,
    shard_batch,
)

__all__ = [
    "ShardAssignment",
    "global_batch_for_step",
    "host_batch_numpy",
    "make_batch",
    "shard_batch",
]
