"""Checkpoints: the on-disk store (the JAX package's format, in both
directions) and the in-memory peer replicas of member state."""
from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    CheckpointManifest,
    latest_step,
    restore,
    restore_member,
    save,
)
from repro_torch.checkpoint.replicate import (
    REPLICA_TAG,
    PeerRestore,
    ReplicaIntegrityError,
    ReplicaRecord,
    ReplicaUnavailable,
    ShardReplicator,
)

__all__ = [
    "AsyncCheckpointer",
    "CheckpointManifest",
    "PeerRestore",
    "REPLICA_TAG",
    "ReplicaIntegrityError",
    "ReplicaRecord",
    "ReplicaUnavailable",
    "ShardReplicator",
    "latest_step",
    "restore",
    "restore_member",
    "save",
]
