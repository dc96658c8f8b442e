"""Checkpoints: the in-memory peer replicas of member state (the on-disk
store comes with the trainer slice)."""
from repro_torch.checkpoint.replicate import (
    REPLICA_TAG,
    PeerRestore,
    ReplicaIntegrityError,
    ReplicaRecord,
    ReplicaUnavailable,
    ShardReplicator,
)

__all__ = [
    "PeerRestore",
    "REPLICA_TAG",
    "ReplicaIntegrityError",
    "ReplicaRecord",
    "ReplicaUnavailable",
    "ShardReplicator",
]
