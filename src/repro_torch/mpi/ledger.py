"""Per-communicator message ledger — fault-aware point-to-point matching.

Rocco & Palermo's follow-up ("Fault-Aware Non-Collective Communication
Creation and Reparation in MPI") extends Legio's interposition to calls that
do *not* involve the whole communicator: point-to-point traffic must survive
a peer dying mid-flight without deadlocking the survivor. The ledger is the
simulated network buffer that makes that checkable:

  * every ``send`` posts an :class:`Envelope` (eager buffering — the paper's
    assumption that a completed send's payload has left the sender);
  * ``recv`` matches FIFO per (src, dst, tag) — MPI's non-overtaking rule;
  * when a repair removes a node, envelopes addressed *to* it are discarded
    (nobody will ever post the matching recv), while envelopes *from* it
    stay deliverable — the payload was already buffered when the sender
    died, exactly the discard-vs-deliver split the paper's Fig. 2 argues;
  * nothing is ever silently dropped: ``posted == delivered + discarded +
    pending`` at every instant (the conservation invariant
    tests/test_mpi.py fuzzes over random fault campaigns).

Each :class:`~repro_torch.mpi.comm.Comm` owns one ledger; ``comm_dup`` creates a
fresh one — duplicated communicators are separate matching contexts, the
MPI semantics that makes libraries composable.
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field


class MsgState(enum.Enum):
    POSTED = "posted"          # in the network buffer, not yet matched
    DELIVERED = "delivered"    # matched by exactly one recv
    DISCARDED = "discarded"    # destination died before posting the recv


@dataclass
class Envelope:
    """One in-flight point-to-point message."""

    seq: int                   # ledger-wide monotone id (posting order)
    src: int
    dst: int
    tag: int
    payload: object
    posted_step: int
    state: MsgState = MsgState.POSTED
    resolved_step: int | None = None


@dataclass
class MessageLedger:
    """FIFO-matching message store for one communicator context."""

    envelopes: list[Envelope] = field(default_factory=list)
    _queues: dict[tuple[int, int, int], deque] = field(default_factory=dict)
    _seq: int = 0

    # -- posting / matching --------------------------------------------------

    def post(self, src: int, dst: int, tag: int, payload: object,
             step: int) -> Envelope:
        env = Envelope(seq=self._seq, src=src, dst=dst, tag=tag,
                       payload=payload, posted_step=step)
        self._seq += 1
        self.envelopes.append(env)
        self._queues.setdefault((src, dst, tag), deque()).append(env)
        return env

    def match(self, dst: int, src: int, tag: int) -> Envelope | None:
        """Oldest POSTED envelope for (src -> dst, tag), without consuming
        it — MPI's non-overtaking order per (source, tag) channel."""
        q = self._queues.get((src, dst, tag))
        while q:
            if q[0].state is MsgState.POSTED:
                return q[0]
            q.popleft()                      # already resolved: drop lazily
        return None

    def deliver(self, env: Envelope, step: int) -> object:
        if env.state is not MsgState.POSTED:
            raise ValueError(
                f"envelope #{env.seq} already {env.state.value} — a message "
                f"is delivered at most once")
        env.state = MsgState.DELIVERED
        env.resolved_step = step
        q = self._queues.get((env.src, env.dst, env.tag))
        if q and q[0] is env:
            q.popleft()
        payload, env.payload = env.payload, None   # resolved envelopes keep
        return payload                             # accounting, not buffers

    # -- fault awareness -----------------------------------------------------

    def discard_to(self, dead: set[int], step: int) -> list[Envelope]:
        """Discard every POSTED envelope addressed *to* a dead node — its
        matching recv will never be posted. Envelopes *from* dead senders
        are left POSTED: the payload was buffered before the death and the
        surviving receiver still collects it."""
        out = []
        for env in self.envelopes:
            if env.state is MsgState.POSTED and env.dst in dead:
                env.state = MsgState.DISCARDED
                env.resolved_step = step
                env.payload = None                 # drop the buffer with it
                out.append(env)
        return out

    # -- accounting (the conservation invariant) -----------------------------

    @property
    def posted(self) -> int:
        return len(self.envelopes)

    @property
    def delivered(self) -> int:
        return sum(1 for e in self.envelopes if e.state is MsgState.DELIVERED)

    @property
    def discarded(self) -> int:
        return sum(1 for e in self.envelopes if e.state is MsgState.DISCARDED)

    @property
    def pending(self) -> int:
        return sum(1 for e in self.envelopes if e.state is MsgState.POSTED)

    def conserved(self) -> bool:
        """posted == delivered + discarded + pending — no loss, no dup."""
        return self.posted == self.delivered + self.discarded + self.pending
