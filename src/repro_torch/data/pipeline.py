"""Shard assignment record shared by the batch planner.

The JAX package's module also holds ``make_batch``, the counter-based
(threefry) shard generator; its bit-exact port comes with the trainer slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShardAssignment:
    """Which global shard indices a node computes this step."""
    node: int
    shards: tuple[int, ...]
