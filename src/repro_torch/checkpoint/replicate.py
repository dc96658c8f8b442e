"""Ring-replicated in-memory shard checkpoints — O(shard) warm-spare restore.

The substitution path restores a spare from the on-disk store: one npz read
plus a manifest parse that is O(members) — an O(model-size) term sitting on
the critical warm-up path (``SubstituteCostModel.restore_seconds`` charges
it on every blocking splice). This module keeps a *second*, in-memory copy
of every member's host-snapshotted state shard on its POV-ring buddy
(``LegionTopology.buddy_of`` — the successor-legion pairing ``pov()``
already defines for masters, generalized to all members):

  * **push on every async checkpoint** — ``LegionCheckpointer.save`` hands
    the freshly host-snapshotted shard map to :meth:`ShardReplicator.push`;
    each shard is checksummed (the store's own ``_checksum``) and posted to
    its buddy as one point-to-point envelope on the world
    :class:`~repro_torch.mpi.ledger.MessageLedger` — replication traffic rides
    the same fault-aware p2p as application messages, so a buddy dying
    mid-flight discards the envelope (and the replica) for free, and the
    ledger conservation invariant covers replication without new machinery;
  * **O(shard) restore** — ``restore_member_state`` (core.substitute) asks
    the surviving buddy first: a dict lookup plus one simulated
    cross-member transfer charged through :class:`LinkModel`
    (``alpha_cross + nbytes / beta_cross`` — the buddy lives in the
    successor legion, a cross-legion link), independent of cluster and
    model size. Checksums are re-verified on the stored arrays; a mismatch
    (or a dead buddy — correlated loss, e.g. a rack outage spanning
    adjacent legions) falls back to ``store.restore_member``;
  * **re-homing on topology mutations** — shrink/substitute/expand change
    the ring, so committed replicas are re-homed the way
    ``SpareProvisioner`` re-homes slots: lazily at the next boundary tick,
    one holder-to-new-buddy transfer per moved replica; replicas whose
    holder died are dropped (that is exactly the correlated-loss surface
    the store fallback exists for).

Everything here is simulation bookkeeping: the "network" is the ledger,
the "memory" is this object, and the costs are the alpha-beta link model —
consistent with how the rest of the runtime charges repair work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.store import _checksum, _flatten, _to_numpy
from repro_torch.core.collectives import LinkModel
from repro_torch.core.hierarchy import LegionTopology

PyTree = Any

# Tag replication envelopes ride under on the world ledger — far above the
# small integers applications use, so replica traffic never matches an
# application recv.
REPLICA_TAG = 7701


class ReplicaUnavailable(LookupError):
    """No usable replica: never pushed, still in flight, or the buddy that
    held it is dead (correlated loss) — fall back to the store."""


class ReplicaIntegrityError(IOError):
    """A held replica failed its checksum re-verification — treat it as
    lost and fall back to the store, never splice corrupt state."""


@dataclass
class ReplicaRecord:
    """One member's replicated shard, as held by its ring buddy."""

    owner: int                       # the member whose state this is
    holder: int                      # the buddy holding the copy
    legion: int                      # owner's home legion at push time
    step: int                        # checkpoint step of the snapshot
    arrays: dict[str, np.ndarray]    # flattened host snapshot
    dtypes: dict[str, str]           # logical dtypes (bf16 round-trip)
    checksums: dict[str, str]        # per-leaf, store._checksum
    nbytes: int

    def verify(self) -> None:
        for key, arr in self.arrays.items():
            if _checksum(arr) != self.checksums[key]:
                raise ReplicaIntegrityError(
                    f"replica checksum mismatch for {key} "
                    f"(owner {self.owner}, holder {self.holder})")

    def as_tree(self) -> PyTree:
        """Rebuild the nested state dict from '/'-joined keys (the same
        shape ``store.restore_member`` returns for dict-of-dict trees)."""
        out: dict = {}
        for key, arr in self.arrays.items():
            parts = key.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = np.array(arr)
        return out


@dataclass
class PeerRestore:
    """One restore served from a surviving buddy (the replicator's own log;
    ``LegionCheckpointer.restarts`` records the same event when a
    checkpointer is attached, with ``source="peer"``)."""

    node: int
    legion: int
    step: int
    holder: int
    nbytes: int
    transfer_seconds: float


@dataclass
class ShardReplicator:
    """In-memory buddy replicas of per-member state shards.

    One instance per :class:`VirtualCluster` (``cluster.replicator``).
    Pushes are posted as ledger envelopes and settle at the *next* session
    boundary — replication traffic is genuinely in flight across a step,
    and a holder that dies mid-flight loses the replica exactly as a dead
    receiver loses any p2p message. Without a session (standalone use in
    unit tests) pushes commit immediately.
    """

    link: LinkModel = field(default_factory=LinkModel)
    enabled: bool = True
    # synthetic heartbeat-shard cadence in steps (chaos campaigns have no
    # trainer state to snapshot but still need replication traffic in
    # flight); 0 disables synthetic pushes
    heartbeat_every: int = 0
    cluster: Any = None              # VirtualCluster backref (set on wiring)

    replicas: dict[int, ReplicaRecord] = field(default_factory=dict)
    inflight: list[tuple[Any, ReplicaRecord]] = field(default_factory=list)
    served: list[PeerRestore] = field(default_factory=list)

    # counters (benchmarks / tests read these)
    pushes: int = 0                  # envelopes posted (or direct commits)
    delivered: int = 0               # in-flight envelopes settled into store
    lost: int = 0                    # replicas dropped with their holder
    rehomed: int = 0                 # committed replicas moved to a new buddy
    corrupt: int = 0                 # checksum mismatches on restore
    bytes_replicated: int = 0
    sim_transfer_seconds: float = 0.0  # background traffic (never charged)

    # -- cost model -----------------------------------------------------------

    def transfer_seconds(self, nbytes: int) -> float:
        """One cross-member shard transfer: the buddy is in the successor
        legion, so the copy rides a cross-legion link."""
        return self.link.alpha_cross + nbytes / self.link.beta_cross

    # -- wiring ---------------------------------------------------------------

    def _ledger(self):
        session = getattr(self.cluster, "_mpi_session", None)
        return session.world.ledger if session is not None else None

    def _step(self) -> int:
        return getattr(self.cluster, "_step", 0)

    @staticmethod
    def _alive(node: int, topo: LegionTopology, failed: set[int]) -> bool:
        return node in topo.nodes and node not in failed

    # -- push (ride the ledger) ------------------------------------------------

    def _snapshot(self, owner: int, holder: int, legion: int, step: int,
                  tree: PyTree) -> ReplicaRecord:
        arrays: dict[str, np.ndarray] = {}
        dtypes: dict[str, str] = {}
        sums: dict[str, str] = {}
        nbytes = 0
        for key, leaf in _flatten(tree).items():
            arr, logical = _to_numpy(leaf)
            arr = np.array(arr)          # own host copy, detached from owner
            arrays[key] = arr
            dtypes[key] = logical
            sums[key] = _checksum(arr)
            nbytes += arr.nbytes
        return ReplicaRecord(owner=owner, holder=holder, legion=legion,
                             step=step, arrays=arrays, dtypes=dtypes,
                             checksums=sums, nbytes=nbytes)

    def push_map(self, step: int, topo: LegionTopology,
                 shards: dict[tuple[int, int], PyTree]) -> int:
        """Replicate an already host-snapshotted shard map ({(legion, node):
        tree}) — the async checkpoint path. Returns replicas posted."""
        if not self.enabled:
            return 0
        ledger = self._ledger()
        posted = 0
        for (legion, node), tree in sorted(shards.items()):
            buddy = topo.buddy_of(node) if node in topo.nodes else None
            if buddy is None:
                continue
            record = self._snapshot(node, buddy, legion, step, tree)
            self.pushes += 1
            self.bytes_replicated += record.nbytes
            self.sim_transfer_seconds += self.transfer_seconds(record.nbytes)
            posted += 1
            if ledger is None:
                self._commit(record)
            else:
                env = ledger.post(node, buddy, REPLICA_TAG,
                                  {"replica_of": node, "step": step,
                                   "nbytes": record.nbytes},
                                  self._step())
                self.inflight.append((env, record))
        return posted

    def push(self, step: int, topo: LegionTopology,
             state_of: Callable[[int], PyTree]) -> int:
        """Snapshot and replicate every live member's shard."""
        shards = {(lg.index, n): state_of(n)
                  for lg in topo.legions for n in lg.members}
        return self.push_map(step, topo, shards)

    def _commit(self, record: ReplicaRecord) -> None:
        self.replicas[record.owner] = record
        self.delivered += 1

    # -- boundary tick (settle / rehome / heartbeat) ---------------------------

    def tick(self, topo: LegionTopology, failed: set[int], step: int) -> None:
        """Run at every session boundary, before pending substitutions are
        polled — freshly settled replicas are visible to this boundary's
        splices."""
        if not self.enabled:
            return
        self._settle(topo, failed, step)
        self._rehome(topo, failed, step)
        if self.heartbeat_every > 0 and step % self.heartbeat_every == 0:
            self.push(step, topo, lambda n: {
                "hb": np.asarray([step, n], dtype=np.int64)})

    def _settle(self, topo: LegionTopology, failed: set[int],
                step: int) -> None:
        """Deliver last boundary's in-flight envelopes whose holder still
        lives; a dead holder's envelope is left for the session's terminal
        -action discard (its recv can never post) and the replica is lost.
        An envelope *from* a now-dead owner still delivers — the payload
        left the sender before the death (ledger semantics), which is what
        makes the freshest replica usable for the owner's own restore."""
        from repro_torch.mpi.ledger import MsgState

        keep: list[tuple[Any, ReplicaRecord]] = []
        for env, record in self.inflight:
            if env.state is MsgState.DISCARDED:
                self.lost += 1
            elif self._alive(record.holder, topo, failed):
                ledger = self._ledger()
                if ledger is not None and env.state is MsgState.POSTED:
                    ledger.deliver(env, step)
                self._commit(record)
            elif env.state is MsgState.POSTED:
                # holder dead but its repair has not landed yet: keep the
                # envelope pending for the discard listener, drop the copy
                self.lost += 1
            else:
                keep.append((env, record))
        self.inflight = keep

    def _rehome(self, topo: LegionTopology, failed: set[int],
                step: int) -> None:
        """Topology mutations change the ring: drop replicas whose holder
        died, move replicas whose live holder is no longer the owner's
        buddy (one holder-to-new-buddy transfer each)."""
        for owner in list(self.replicas):
            record = self.replicas[owner]
            if not self._alive(record.holder, topo, failed):
                del self.replicas[owner]
                self.lost += 1
                continue
            if owner not in topo.nodes:
                continue             # owner gone: keep for a pending splice
            buddy = topo.buddy_of(owner)
            if buddy is None or buddy == record.holder:
                continue
            if not self._alive(buddy, topo, failed):
                continue             # new buddy not usable yet; retry later
            ledger = self._ledger()
            if ledger is not None:
                env = ledger.post(record.holder, buddy, REPLICA_TAG,
                                  {"replica_of": owner, "rehome": True,
                                   "nbytes": record.nbytes}, step)
                ledger.deliver(env, step)
            record.holder = buddy
            self.rehomed += 1
            self.sim_transfer_seconds += self.transfer_seconds(record.nbytes)

    # -- restore (the O(shard) path) -------------------------------------------

    def restore(self, owner: int, topo: LegionTopology, failed: set[int],
                *, verify: bool = True) -> tuple[PyTree, PeerRestore]:
        """Fetch ``owner``'s replica from its surviving holder.

        Raises :class:`ReplicaUnavailable` when no committed replica exists
        or the holder is dead (correlated loss), and
        :class:`ReplicaIntegrityError` when the copy fails checksum
        re-verification — both mean "fall back to the store"."""
        record = self.replicas.get(owner)
        if record is None:
            raise ReplicaUnavailable(f"no replica held for node {owner}")
        if not self._alive(record.holder, topo, failed):
            del self.replicas[owner]
            self.lost += 1
            raise ReplicaUnavailable(
                f"replica holder {record.holder} of node {owner} is dead "
                f"(correlated loss)")
        if verify:
            try:
                record.verify()
            except ReplicaIntegrityError:
                del self.replicas[owner]
                self.corrupt += 1
                raise
        restore = PeerRestore(
            node=owner, legion=record.legion, step=record.step,
            holder=record.holder, nbytes=record.nbytes,
            transfer_seconds=self.transfer_seconds(record.nbytes))
        self.served.append(restore)
        state = record.as_tree()
        del self.replicas[owner]     # consumed: the splice owns it now
        return state, restore

    def drop(self, owner: int) -> None:
        self.replicas.pop(owner, None)
