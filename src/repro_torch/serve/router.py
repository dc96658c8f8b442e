"""RequestRouter — shards the request stream across legions via the
top-level masters.

Routing reads the topology the same way everything else in the runtime
does: through an epoch-stamped :class:`TopologyView` snapshot. Selection is
hierarchical, mirroring how traffic actually flows through the N-level
tree: a request first picks the least-loaded *top-level subtree* (a child
group of the root comm — the comms the top-level masters front), then the
least-loaded live legion inside it. For depth <= 2 every legion hangs off
the root directly, so this degenerates to the classic least-loaded-legion
policy unchanged. After a repair changes a ring, :meth:`reconcile` re-homes
the queues of legions that left it, so no request is ever stranded on a
structure that no longer exists.

Selection is fully deterministic: equal loads tie-break on the lowest
subtree index, then the lowest legion index, and never on dict iteration
order — two engines fed the same seeded request stream produce
byte-identical dispatch traces (property-tested in tests/test_serve.py).
"""
from __future__ import annotations

from repro_torch.serve.queue import LegionQueue, Request


class RequestRouter:
    """Least-loaded sharding of requests over top-level subtrees, then the
    live legions within."""

    def __init__(self):
        self.queues: dict[int, LegionQueue] = {}
        self.rerouted: int = 0          # requests re-homed by reconcile()
        # legion index -> top-level subtree index (root comm child), from
        # the last reconciled snapshot
        self._subtree: dict[int, int] = {}

    # -- topology tracking ---------------------------------------------------

    def _live_legions(self, view) -> list[int]:
        return [lg.index for lg in view.legions if lg.members]

    def reconcile(self, view) -> list[Request]:
        """Sync queues with a topology snapshot. Queues for legions that
        left the ring are drained and their requests resubmitted; returns
        the re-homed requests (metrics count them)."""
        live = set(self._live_legions(view))
        self._subtree = {idx: view.subtree_of(idx) for idx in live}
        orphans: list[Request] = []
        for idx in [i for i in self.queues if i not in live]:
            orphans.extend(self.queues.pop(idx).drain())
        for idx in live:
            self.queues.setdefault(idx, LegionQueue(legion=idx))
        if orphans:
            self.rerouted += len(orphans)
            for req in orphans:
                self.route(req, front=True)
        return orphans

    # -- selection -----------------------------------------------------------

    def peek(self) -> LegionQueue:
        """The queue the *next* routed request would land in, without
        placing anything — admission control estimates feasibility against
        this target. Ties break (load, index) at both stages."""
        if not self.queues:
            raise RuntimeError("no live legions to route to")
        # stage 1: least-loaded top-level subtree (ties: lowest subtree idx)
        load: dict[int, int] = {}
        for idx, q in self.queues.items():
            sub = self._subtree.get(idx, idx)
            load[sub] = load.get(sub, 0) + len(q)
        best_sub = min(load, key=lambda s: (load[s], s))
        # stage 2: least-loaded legion inside it (ties: lowest legion idx)
        return min(
            (q for idx, q in self.queues.items()
             if self._subtree.get(idx, idx) == best_sub),
            key=lambda q: (len(q), q.legion))

    def route(self, req: Request, *, front: bool = False) -> LegionQueue:
        """Place one request on the current least-loaded target."""
        target = self.peek()
        (target.push_front if front else target.push)(req)
        return target

    # -- submission ----------------------------------------------------------

    def submit(self, requests: list[Request], view) -> None:
        """Shard new requests across the live legions, least-loaded first."""
        self.reconcile(view)
        for req in requests:
            self.route(req)

    def requeue(self, req: Request, view) -> None:
        """Redeliver a request whose node died mid-batch: front of the
        least-loaded *surviving* legion's queue (its old legion may be the
        one that just shrank — reconcile first)."""
        self.reconcile(view)
        self.route(req, front=True)

    # -- views ---------------------------------------------------------------

    @property
    def backlog(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def queue_of(self, legion: int) -> LegionQueue:
        return self.queues[legion]
