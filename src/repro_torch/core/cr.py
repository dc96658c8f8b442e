"""Per-legion checkpoint/restart (the paper's §VII direction).

  * checkpoints are **per-(legion, member)** files written independently:
    file operations run on the local_comm (paper §V), so no global barrier;
  * **restart-only-failed**: a replacement node restores exactly the dead
    member's shard (``checkpoint.store.restore_member``) while survivors
    keep running from live state;
  * with the counter-based data pipeline, the restarted member regenerates
    precisely the shards the dead node would have consumed, so recovery is
    bit-exact.

``LegionCheckpointer`` wraps the store with the topology: it knows which
member owns which state shard and snapshots asynchronously off the
training path. :class:`RestartRecord` is what the substitution restore
ladder (``core.substitute.restore_member_state``) appends to its log.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch import tracing
from repro_torch.checkpoint import store
from repro_torch.core.hierarchy import LegionTopology

PyTree = Any


@dataclass
class RestartRecord:
    node: int
    legion: int
    step: int
    source: str            # "checkpoint" (store read) | "peer" (ring replica)


class LegionCheckpointer:
    """Topology-aware wrapper over the sharded checkpoint store."""

    def __init__(self, directory: str, *, keep: int = 3, async_writes: bool = True):
        self.directory = directory
        self.async_writer = store.AsyncCheckpointer(directory, keep=keep) \
            if async_writes else None
        self.keep = keep
        self.restarts: list[RestartRecord] = []
        # ShardReplicator wired in by VirtualCluster: every save() also
        # pushes the host-snapshotted shards to their POV-ring buddies
        self.replicator = None

    # -- save ---------------------------------------------------------------------

    def shard_map_for(self, topo: LegionTopology,
                      state_of: Callable[[int], PyTree]
                      ) -> dict[tuple[int, int], PyTree]:
        """{(legion, node): node state} for every live member."""
        return {
            (lg.index, n): state_of(n)
            for lg in topo.legions for n in lg.members
        }

    def save(self, step: int, topo: LegionTopology,
             state_of: Callable[[int], PyTree], *, meta: dict | None = None,
             sync: bool = False, write: bool = True) -> float:
        """Snapshot every member's shard. Returns blocking seconds.

        ``write=False`` skips the store and only replicates: over ranks
        every rank calls ``save`` with the same whole state, so the session
        ledgers stay equal, and rank 0 alone writes the files."""
        shards = self.shard_map_for(topo, state_of)
        meta = dict(meta or {})
        meta.setdefault("k", topo.k)
        if self.replicator is not None:
            # ring replication rides every checkpoint: the same snapshot goes
            # to each member's POV buddy (in memory, posted through the
            # session ledger; settles at the next boundary)
            self.replicator.push_map(step, topo, shards)
        if not write:
            return 0.0
        if self.async_writer is not None and not sync:
            return self.async_writer.save_async(step, shards, meta=meta)
        with tracing.span("checkpoint.save", step=step) as sp:
            store.save(self.directory, step, shards, meta=meta)
        return sp.seconds

    def wait(self) -> None:
        if self.async_writer is not None:
            self.async_writer.wait()

    def close(self) -> None:
        if self.async_writer is not None:
            self.async_writer.close()

    # -- restart-only-failed ---------------------------------------------------------

    def latest_step(self) -> int | None:
        return store.latest_step(self.directory)

    def restore_failed_member(self, legion: int, node: int,
                              *, step: int | None = None,
                              template: PyTree | None = None) -> PyTree:
        """Load exactly one dead member's shard for its replacement node."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state = store.restore_member(self.directory, step, legion, node,
                                     template=template)
        self.restarts.append(RestartRecord(node=node, legion=legion, step=step,
                                           source="checkpoint"))
        return state

    def restore_all(self, *, step: int | None = None,
                    template: PyTree | None = None):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return store.restore(self.directory, step, template=template)

    def files_for_step(self, step: int) -> list[str]:
        sdir = os.path.join(self.directory, f"step_{step:06d}")
        out = []
        for root, _, names in os.walk(sdir):
            out.extend(os.path.join(root, n) for n in names)
        return sorted(out)
