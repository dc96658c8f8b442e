"""Data layer. This slice holds only the shard assignment record; the
counter-based batch generator comes with the trainer slice."""
from repro_torch.data.pipeline import ShardAssignment

__all__ = ["ShardAssignment"]
