"""Failure detection: heartbeats, noticing semantics, stragglers.

MPI/ULFM surfaces faults as ``MPIX_ERR_PROC_FAILED`` return codes on the
ranks that *happened to interact* with the dead process (paper §III). On an
accelerator cluster the analogue is the coordinator-side heartbeat timeout plus
collective-op errors. This module reproduces both channels:

  * :class:`HeartbeatDetector` — per-node last-seen timestamps against a
    simulated clock; a node whose heartbeat is older than ``timeout`` becomes
    SUSPECT. Suspicion is *local knowledge*: different observers can hold
    different suspicion sets, which is exactly the Broadcast Notification
    Problem (P.3) — resolved by :mod:`repro_torch.core.agreement`.
  * :func:`notice_fault` — given a collective op's participant set and the
    ground-truth failed set, computes *which survivors notice* (P.3: in a
    Bcast only ranks downstream of the failure in the binomial tree notice;
    in Reduce/Allreduce/Barrier everyone does).
  * :class:`StragglerDetector` — per-node step-latency EWMA vs. the median;
    nodes slower than ``threshold ×`` median are soft-failed (the paper's
    discard policy applied to performance faults — beyond-paper feature).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.types import FailureEvent, FailureKind, NodeState


@dataclass
class HeartbeatDetector:
    timeout: float
    last_seen: dict[int, float] = field(default_factory=dict)
    states: dict[int, NodeState] = field(default_factory=dict)
    # incarnation guard: the topology epoch at which a node was confirmed
    # FAILED. A flapped node (transient power/network loss that returns
    # after the repair already evicted it) re-announces itself with its
    # *old* identity; without the guard, register() made it HEALTHY again
    # and the next sweep treated it as freshly live — resurrecting a node
    # the agreement already buried. Re-registration now needs a strictly
    # newer epoch, i.e. a deliberate re-provisioning, not a stale beat.
    epochs: dict[int, int] = field(default_factory=dict)

    def register(self, node: int, now: float = 0.0, *,
                 epoch: int | None = None) -> bool:
        """Admit ``node`` as HEALTHY. Returns False (and changes nothing)
        for a FAILED node unless ``epoch`` is strictly newer than the epoch
        recorded when it was repaired out — the flap guard."""
        if self.states.get(node) is NodeState.FAILED:
            if epoch is None or epoch <= self.epochs.get(node, 0):
                return False
        if epoch is not None:
            self.epochs[node] = max(epoch, self.epochs.get(node, 0))
        self.last_seen[node] = now
        self.states[node] = NodeState.HEALTHY
        return True

    def beat(self, node: int, now: float) -> None:
        if self.states.get(node) == NodeState.FAILED:
            return  # a failed node never comes back (permanent fault model)
        if node not in self.states:
            # a beat from a node nobody registered (e.g. a spare announcing
            # itself before its splice): auto-register instead of writing a
            # last_seen entry with no state — that orphan made the next
            # sweep() raise KeyError
            self.register(node, now)
            return
        self.last_seen[node] = now
        if self.states.get(node) == NodeState.SUSPECT:
            self.states[node] = NodeState.HEALTHY  # false suspicion cleared

    def sweep(self, now: float) -> list[int]:
        """Advance the detector; returns newly-SUSPECT nodes."""
        fresh = []
        for node, seen in self.last_seen.items():
            if self.states[node] == NodeState.HEALTHY and now - seen > self.timeout:
                self.states[node] = NodeState.SUSPECT
                fresh.append(node)
        return sorted(fresh)

    def confirm_failed(self, node: int, *, epoch: int | None = None) -> None:
        """Bury ``node``. ``epoch`` (the topology epoch of the repair that
        evicted it) arms the flap guard: see :meth:`register`."""
        self.states[node] = NodeState.FAILED
        if epoch is not None:
            self.epochs[node] = max(epoch, self.epochs.get(node, 0))

    def suspects(self) -> list[int]:
        return sorted(n for n, s in self.states.items() if s == NodeState.SUSPECT)

    def suspicions(self, now: float, within: list[int]) -> tuple[int, ...]:
        """Pipeline detect-stage entry point: advance the sweep to ``now``
        and return every currently-SUSPECT node among ``within`` (newly
        suspect or still unresolved from an earlier sweep). Suspicion is
        local knowledge — the caller feeds it to agreement, never straight
        to repair."""
        self.sweep(now)
        members = set(within)
        return tuple(n for n in self.suspects() if n in members)

    def healthy(self) -> list[int]:
        return sorted(n for n, s in self.states.items() if s == NodeState.HEALTHY)


# ---------------------------------------------------------------------------
# Noticing semantics (paper §III P.2/P.3)
# ---------------------------------------------------------------------------

def _bcast_children(v: int, size: int) -> list[int]:
    """Children of relative-rank ``v`` in the binomial bcast tree:
    v + 2^j for every 2^j > v with v + 2^j < size (root v=0 gets 1,2,4,...)."""
    out, j = [], 1
    while j <= v:
        j <<= 1
    while v + j < size:
        out.append(v + j)
        j <<= 1
    return out


def _bcast_notice_rel(size: int, failed_rel: set[int]) -> set[int]:
    """Relative ranks of *survivors* that notice a failure in a binomial
    bcast: live parents of a dead child (their send errors out) plus live
    descendants of a dead node (never receive -> timeout)."""
    noticers: set[int] = set()
    unreached: set[int] = set()

    def visit(v: int, cut: bool) -> None:
        dead = v in failed_rel
        if cut and not dead:
            unreached.add(v)
        for c in _bcast_children(v, size):
            if (not cut) and (not dead) and c in failed_rel:
                noticers.add(v)          # send to dead child fails
            visit(c, cut or dead)

    visit(0, False)
    return (noticers | unreached) - failed_rel


def notice_fault(
    op: str,
    participants: list[int],
    failed: set[int],
    root: int | None = None,
) -> set[int]:
    """Which *survivors* notice the fault after running ``op``.

    Mirrors the paper's P.2/P.3 observations:
      * bcast       — only ranks whose tree path crosses the failure notice
                      (the Broadcast Notification Problem);
      * reduce / allreduce / barrier / agree — every survivor notices;
      * p2p         — only the peer notices;
      * local       — nobody notices (P.1: local ops succeed).
    """
    live = [p for p in participants if p not in failed]
    hit = [p for p in participants if p in failed]
    if not hit:
        return set()
    if op in ("local", "comm_rank", "comm_size"):
        return set()
    if op == "p2p":
        return set(live)  # both endpoints involved; survivor notices
    if op == "bcast":
        if root is None:
            root = participants[0]
        size = len(participants)
        pos = {p: i for i, p in enumerate(participants)}
        root_pos = pos[root]
        failed_rel = {(pos[p] - root_pos) % size for p in hit}
        rel_notice = _bcast_notice_rel(size, failed_rel)
        return {participants[(r + root_pos) % size] for r in rel_notice}
    # reduce / allreduce / barrier / gather / scatter / agree: global notice
    return set(live)


# ---------------------------------------------------------------------------
# Stragglers
# ---------------------------------------------------------------------------

@dataclass
class StragglerDetector:
    """Soft-failure detection from per-node step latencies.

    A node is a straggler when its latency EWMA exceeds ``threshold`` times
    the cluster median AND the absolute excess clears ``min_latency`` —
    the floor keeps microsecond-scale timing noise from soft-failing nodes
    whose steps are all effectively instantaneous. threshold <= 0 disables.
    """

    threshold: float = 3.0
    alpha: float = 0.5                      # EWMA smoothing
    min_latency: float = 0.05               # s; below this, never a straggler
    ewma: dict[int, float] = field(default_factory=dict)
    min_samples: int = 3
    counts: dict[int, int] = field(default_factory=dict)

    def observe(self, node: int, latency: float) -> None:
        prev = self.ewma.get(node)
        self.ewma[node] = latency if prev is None else \
            self.alpha * latency + (1 - self.alpha) * prev
        self.counts[node] = self.counts.get(node, 0) + 1

    def drop(self, node: int) -> None:
        self.ewma.pop(node, None)
        self.counts.pop(node, None)

    def stragglers(self) -> list[int]:
        if self.threshold <= 0 or len(self.ewma) < 2:
            return []
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        if median <= 0:
            return []
        return sorted(
            n for n, v in self.ewma.items()
            if self.counts.get(n, 0) >= self.min_samples
            and v > self.threshold * median
            and v > self.min_latency
        )


@dataclass
class FaultInjector:
    """Deterministic fault schedule for tests/benchmarks/examples.

    ``schedule`` maps step -> list of FailureEvents delivered at that step.
    """

    events: list[FailureEvent] = field(default_factory=list)

    @staticmethod
    def at(pairs: list[tuple[int, int]],
           kind: FailureKind = FailureKind.CRASH) -> "FaultInjector":
        """pairs: [(step, node), ...]"""
        return FaultInjector([FailureEvent(node=n, step=s, kind=kind)
                              for s, n in pairs])

    def due(self, step: int) -> list[FailureEvent]:
        return [e for e in self.events if e.step == step]
