"""Comm — the MPI-shaped communicator handle behind which Legio hides.

This is the paper's PMPI interposition seam made explicit: every call on a
:class:`Comm` runs the same transparent sandwich,

    1. **trap** — the simulated ``MPIX_ERR_PROC_FAILED`` analogue: before
       the schedule runs, the call checks the ground-truth failed set
       against the op's participants (ULFM surfaces the error code on the
       ranks that interacted with the dead process; our centralized sim
       sees it at the call);
    2. **drain** — the observation feeds :class:`~repro_torch.core.pipeline.
       FaultPipeline` and the call drains the collective + heartbeat
       channels: detect → notice → agree → plan → apply, with the
       registered :class:`~repro_torch.core.strategy.RecoveryStrategy` repairing
       the agreed verdict (Bouteiller & Bosilca's *implicit actions*:
       recovery as a side effect of an ordinary call);
    3. **retry** — the op re-runs against a *pinned*, epoch-stamped
       :class:`~repro_torch.core.hierarchy.TopologyView` of the repaired
       structure (paper §IV: check after the op; if confirmed, repair and
       repeat the operation);

so the caller never sees a fault — unless the caller itself depended on the
dead node (its op's root, its point-to-point peer), in which case the call
raises a clean :class:`~repro_torch.mpi.errors.PeerFailedError` *after* the
repair has landed: the paper's discard semantics, never a deadlock.

Point-to-point (``send``/``recv``/``sendrecv``) is new machinery relative
to the collective schedules: a per-comm :class:`~repro_torch.mpi.ledger.
MessageLedger` with fault-aware matching (Rocco & Palermo's non-collective
follow-up) — a recv whose sender died mid-flight resolves to the discard
outcome instead of blocking forever, and messages buffered before the
death are still delivered exactly once.

PMPI-style tool layers keep working: :meth:`Comm.attach` registers an
interposer invoked with ``(op, view)`` on every call, before the schedule
runs — the executor uses it to validate its shard plan against the pinned
view; profilers can count calls without touching the app.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core.collectives import (
    CollectiveResult,
    HierarchicalCollectives,
    payload_nbytes,
)
from repro_torch.core.hierarchy import make_topology
from repro_torch.core.types import FaultSource, RecoveryAction
from repro_torch.mpi.errors import PeerFailedError, RecvWouldDeadlockError
from repro_torch.mpi.ledger import MessageLedger

if TYPE_CHECKING:
    from repro_torch.mpi.session import Session

# channels every interposed call drains — the collective error it just
# trapped plus the heartbeat suspicions that accrued since the last call
CALL_SOURCES = (FaultSource.COLLECTIVE, FaultSource.HEARTBEAT)

# repair rounds per call before giving up; each round removes the agreed
# verdict from the topology, so two rounds settle any single-drain fault
_MAX_REPAIR_ROUNDS = 8


@dataclass
class InterpositionStats:
    """Per-comm bookkeeping the transparency-overhead benchmark reads.

    The paper's "negligible overhead" claim, made structural: on the
    fault-free path every call performs exactly one pipeline drain
    (``drains == calls``), zero repair rounds, and exactly the stages the
    direct schedule would run (``collective_stages`` matches).
    """

    calls: int = 0               # MPI-shaped ops issued on this comm
    drains: int = 0              # pipeline drains the interposition ran
    repair_rounds: int = 0       # rounds that trapped PROC_FAILED
    collective_stages: int = 0   # schedule stages actually executed
    sim_seconds: float = 0.0     # alpha-beta time charged through this comm

    def record_op(self, res: CollectiveResult) -> None:
        self.collective_stages += len(res.stages)
        self.sim_seconds += res.sim_seconds

    @property
    def drains_per_call(self) -> float:
        return self.drains / self.calls if self.calls else 0.0


class Comm:
    """One communicator handle. The world comm tracks the live topology
    (substitutes splice in transparently); ``comm_split``/``comm_dup``
    derive fixed-group comms that shrink as members die (non-collective
    creation per Rocco & Palermo — the subgroup never regrows)."""

    def __init__(self, session: "Session", group: Iterable[int] | None,
                 name: str = "world"):
        self.session = session
        self.name = name
        self._group = tuple(sorted(group)) if group is not None else None
        self.ledger = MessageLedger()
        self.stats = InterpositionStats()
        self._hooks: list[Callable] = []
        self._freed = False
        # sub-topology cache for fixed-group comms, keyed by world epoch +
        # surviving membership (rebuilt only when a repair changes either)
        self._sub_topo = None
        self._sub_key: tuple | None = None
        session._register(self)

    # -- MPI_Comm_rank / MPI_Comm_size ---------------------------------------

    @property
    def members(self) -> list[int]:
        """Current member node ids, ascending (== rank order). Repairs
        remove the dead; a node that died since the last boundary remains
        a member until a call's interposition repairs it out (exactly
        ULFM's window between death and MPIX_Comm_shrink)."""
        topo_nodes = self.session.cluster.topo.nodes
        if self._group is None:
            return topo_nodes
        alive = set(topo_nodes)
        return [n for n in self._group if n in alive]

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def ranks(self) -> list[int]:
        return list(range(self.size))

    def rank_of(self, node: int) -> int:
        """The node's rank in this comm (ascending node-id order)."""
        try:
            return self.members.index(node)
        except ValueError:
            raise KeyError(f"node {node} is not a live member of "
                           f"comm {self.name!r}") from None

    def __contains__(self, node: int) -> bool:
        return node in set(self.members)

    # -- PMPI tool layers ------------------------------------------------------

    def attach(self, hook: Callable[[str, object], None],
               *, key: str | None = None) -> None:
        """Register an interposer called with ``(op, pinned_view)`` before
        every schedule runs — the PMPI profiling-layer analogue. A non-None
        ``key`` makes the registration idempotent: re-attaching under the
        same key replaces the previous hook (the world comm is shared per
        cluster, so re-built consumers must not stack duplicates)."""
        if key is not None:
            self.detach(key)
        self._hooks.append((key, hook))

    def detach(self, key: str) -> None:
        """Remove the interposer registered under ``key`` (no-op if absent)."""
        self._hooks = [(k, h) for k, h in self._hooks if k != key]

    def free(self) -> None:
        """MPI_Comm_free: drop the ledger context and stop fault-listener
        delivery to this comm."""
        self._freed = True
        self.session._unregister(self)

    # -- the interposition core ------------------------------------------------

    def _dead_among(self, among: Iterable[int] | None) -> set[int]:
        cl = self.session.cluster
        present = set(cl.topo.nodes)
        scan = self.members if among is None else [n for n in among]
        return {n for n in scan if n in cl.failed and n in present}

    def _resolve(self, op: str, *, root: int | None = None,
                 peers: tuple[int, ...] = (),
                 among: Iterable[int] | None = None,
                 gate: Callable[[set[int]], None] | None = None,
                 ) -> list[RecoveryAction]:
        """Trap → drain → repair until the op's participants are clean.

        Returns every terminal action the drains produced (also recorded on
        the session for the step report). Raises :class:`PeerFailedError`
        if the caller's ``root`` or ``peers`` land in an agreed verdict —
        after the repair has been applied, so the next call is safe.
        """
        cl = self.session.cluster
        out: list[RecoveryAction] = []
        for _ in range(_MAX_REPAIR_ROUNDS):
            dead = self._dead_among(among)
            if dead:
                self.stats.repair_rounds += 1
                cl.pipeline.observe_collective(op, self.members, dead,
                                               root=root)
            actions = cl.pipeline.drain(self.session.step,
                                        sources=CALL_SOURCES, gate=gate)
            self.stats.drains += 1
            self.session._record(actions)
            out.extend(actions)
            verdict = {n for a in actions for n in a.verdict}
            failed_peer = ({root} if root is not None else set()) | set(peers)
            failed_peer &= verdict
            if failed_peer:
                raise PeerFailedError(
                    f"{op}: peer(s) {sorted(failed_peer)} failed and were "
                    f"repaired out of comm {self.name!r} — result discarded "
                    f"for this caller (paper §IV discard semantics)",
                    op=op, peers=tuple(sorted(failed_peer)))
            if not dead or not (dead & verdict):
                # clean — or the fault went unnoticed this call (the BNP:
                # no survivor observed it); the op proceeds and the
                # heartbeat channel confirms the silent death later
                return out
        raise RuntimeError(
            f"{op}: repair did not converge after {_MAX_REPAIR_ROUNDS} "
            f"rounds on comm {self.name!r}")

    def _busy(self) -> frozenset[int]:
        """Survivors occupied by an in-flight background repair window
        (empty outside overlap mode) — excluded from schedules and
        contribution sets until their window reconciles."""
        return frozenset(self.session.cluster.repairing_participants())

    def _schedule_topo(self, view, busy: frozenset[int] = frozenset()):
        """Structure the schedules run over: the pinned world view (its
        busy-restricted sub-view during an overlap window), or the derived
        sub-topology for a fixed-group comm.

        The fixed-group cache is keyed by epoch + the *effective* live
        membership, busy exclusions included. Keying on raw membership was
        the latent ordering hazard background repair exposes: a window
        opening or closing changes the schedule without bumping the epoch,
        so a (epoch, members) key would happily serve a stale sub-topology
        that still contains mid-repair participants — a half-applied group.
        """
        if self._group is None:
            return view.restrict(busy) if busy else view
        live = [n for n in self._group
                if n in view.node_set and n not in busy]
        key = (view.epoch, tuple(live))
        if self._sub_key != key:
            self._sub_topo = make_topology(
                live, self.session.cluster.policy)
            self._sub_key = key
        return self._sub_topo

    def _run(self, op: str, fn: Callable[[HierarchicalCollectives],
                                         CollectiveResult]
             ) -> CollectiveResult:
        """Run one schedule against a pinned view of the (repaired)
        structure and charge its alpha-beta time to the cluster clock.

        During a background repair window the schedule runs over the
        survivors *outside* the window (healthy subtrees progress on their
        pinned epoch — the revoke half of revoke-then-repair). If every
        member is busy there is no healthy subtree to make progress:
        the call synchronizes (force-finishing the windows, charging the
        residual) and runs full-membership."""
        cl = self.session.cluster
        busy = self._busy()
        if busy and not any(n not in busy for n in self.members):
            self.session.sync()
            busy = frozenset()
        with cl.topo.pinned() as view:
            for _key, hook in self._hooks:
                hook(op, view)
            res = fn(cl.collectives(self._schedule_topo(view, busy)))
        cl.clock.charge(res.sim_seconds)
        self.stats.record_op(res)
        return res

    def _call(self) -> None:
        self.session.ensure_active()
        if self._freed:
            # lifecycle misuse, not a fault: PeerFailedError's contract is
            # "catch and continue", which would turn a use-after-free into
            # a silent infinite skip
            from repro_torch.mpi.errors import MPISessionError
            raise MPISessionError(
                f"comm {self.name!r} has been freed — no call may follow "
                f"MPI_Comm_free")
        self.stats.calls += 1

    def _effective_root(self, root: int) -> int:
        """The op's root if it survives, else the lowest surviving rank —
        the paper's lowest-rank master rule applied to op roots (the
        requested root's death was already surfaced as PeerFailedError in
        the call that repaired it; later calls re-home silently)."""
        members = self.members
        if not members:
            raise RuntimeError(f"comm {self.name!r} has no surviving member")
        return root if root in set(members) else members[0]

    # -- collectives (paper §V op classes, interposed) -------------------------

    def bcast(self, payload: "Any | dict[int, Any]", root: int,
              *, gate: Callable | None = None) -> CollectiveResult:
        """One-to-all. Root failure surfaces as PeerFailedError on the call
        that repairs it; every other fault is invisible. ``payload`` is the
        root's buffer — or, driver-side, a per-node buffer dict from which
        the (possibly re-homed) root's entry is taken after repair."""
        self._call()
        self._resolve("bcast", root=root, gate=gate)
        rt = self._effective_root(root)
        self._sync_if_busy(rt)
        if isinstance(payload, dict):
            payload = payload.get(rt)
            if payload is None:
                payload = self.session.cluster.dataplane.asarray(np.zeros(1))
        return self._run("bcast", lambda coll: coll.bcast(rt, payload))

    def reduce(self, contributions: dict[int, Any], root: int,
               op: Callable = np.add,
               *, gate: Callable | None = None) -> CollectiveResult:
        """All-to-one. Dead contributors are repaired out and simply do not
        contribute (discard-and-continue — the Monte-Carlo argument)."""
        self._call()
        self._resolve("reduce", root=root, gate=gate)
        rt = self._effective_root(root)
        self._sync_if_busy(rt)
        self._sync_if_no_healthy_contributor(contributions)
        return self._run("reduce", lambda coll: coll.reduce(
            rt, self._filter(contributions), op))

    def allreduce(self, contributions: dict[int, Any],
                  op: Callable = np.add,
                  *, gate: Callable | None = None) -> CollectiveResult:
        """All-to-all (reduce + bcast, §V). No root — never PeerFailedError."""
        self._call()
        self._resolve("allreduce", gate=gate)
        self._sync_if_no_healthy_contributor(contributions)
        return self._run("allreduce", lambda coll: coll.allreduce(
            self._filter(contributions), op))

    def barrier(self) -> CollectiveResult:
        """All-hands synchronization — the one collective that *cannot*
        exclude a repairing scope: in-flight background repair windows are
        force-finished first (their residual charged), exactly the
        "overlap is unsafe" escape hatch docs/recovery-modes.md names."""
        self._call()
        self._resolve("barrier")
        self.session.sync()
        return self._run("barrier", lambda coll: coll.barrier())

    def gather(self, contributions: dict[int, object] | None = None,
               *, among: Iterable[int] | None = None) -> dict[int, object]:
        """All-to-one result gather over arbitrary payloads (the serving
        result collection). Interposes faults among the op's participants
        (``among`` — e.g. the nodes actually dispatched this round) and
        returns the surviving contributions; lost participants' repairs
        have already run when this returns."""
        self._call()
        self._resolve("gather", among=among)
        alive = set(self.session.cluster.topo.nodes)
        out = {n: v for n, v in (contributions or {}).items() if n in alive}
        vals = list(out.values())
        if (len(vals) > 1
                and all(isinstance(v, (np.ndarray, torch.Tensor)) for v in vals)
                and len({(type(v), tuple(v.shape), str(v.dtype))
                         for v in vals}) == 1):
            # uniform array payloads ride the data plane (kept on the card
            # by the torch plane; identity on sim) — mixed/object payloads
            # are returned as they came
            gathered = self.session.cluster.dataplane.gather_arrays(vals)
            out = dict(zip(out.keys(), gathered))
        return out

    def _sync_if_busy(self, root: int) -> None:
        """A rooted op whose root sits inside a repairing scope cannot
        proceed degraded (the result must materialize *at the root*):
        force-finish the windows — the root's repair is waited out as
        residual, the documented overlap-unsafe case."""
        if root in self._busy():
            self.session.sync()

    def _sync_if_no_healthy_contributor(
            self, contributions: dict[int, Any]) -> None:
        """If the drain inside this very call opened a window that
        swallowed *every* surviving contributor (the torn scope was the
        whole contributing set), there is no healthy subtree to carry the
        op: synchronize — the same overlap-unsafe escape hatch as the
        all-busy-members guard — before the schedule topology is built,
        so the op then runs full-membership."""
        busy = self._busy()
        if not busy or not contributions:
            return
        alive = set(self.members) - busy
        if not any(n in alive for n in contributions):
            self.session.sync()

    def _filter(self, contributions: dict[int, Any]) -> dict[int, Any]:
        alive = set(self.members) - self._busy()
        asarray = self.session.cluster.dataplane.asarray
        return {n: asarray(v) for n, v in contributions.items()
                if n in alive}

    # -- point-to-point (fault-aware non-collective layer) ---------------------

    def _check_endpoint(self, node: int, role: str) -> None:
        """A caller endpoint must be a live member — a dead *caller* is a
        driver bug (the simulation never runs code on a dead node). The
        membership list alone is not enough: a node dead since the last
        boundary stays in the topology until a call repairs it."""
        if node not in set(self.members) or node in self.session.cluster.failed:
            raise ValueError(
                f"{role} {node} is not a live member of comm {self.name!r}")

    def _known(self, node: int) -> bool:
        cl = self.session.cluster
        in_group = self._group is None or node in self._group
        return in_group and (node in cl.topo.home or node in cl.failed)

    def _require_peer_alive(self, op: str, caller: int, peer: int) -> None:
        """Trap the p2p PROC_FAILED analogue: if the peer is dead, drain
        the pipeline (repairing it out) and surface the discard outcome."""
        cl = self.session.cluster
        if not self._known(peer):
            raise ValueError(
                f"{op}: peer {peer} is not a member of comm {self.name!r}")
        if peer not in cl.failed:
            return
        self._resolve(op, among=(caller, peer))
        raise PeerFailedError(
            f"{op}: peer {peer} failed — in-flight traffic discarded, "
            f"communicator already repaired", op=op, peers=(peer,),
            discarded=True)

    def send(self, src: int, dst: int, payload: object, tag: int = 0) -> None:
        """Post a message ``src -> dst``. Send to a dead peer raises
        PeerFailedError (the sender *is* the peer's dependent); otherwise
        the payload enters the ledger's network buffer — delivery survives
        even the sender's later death (eager buffering)."""
        self._call()
        self._check_endpoint(src, "sender")
        self._require_peer_alive("p2p", src, dst)
        self.ledger.post(src, dst, tag, payload, self.session.step)
        self._charge_p2p(src, dst, payload)

    def recv(self, dst: int, src: int, tag: int = 0) -> object:
        """Match the oldest posted message ``src -> dst``. A message posted
        before the sender died is still delivered; a recv with nothing
        posted and a dead sender resolves to the discard outcome
        (PeerFailedError) instead of deadlocking — the non-collective
        reparation path."""
        self._call()
        self._check_endpoint(dst, "receiver")
        env = self.ledger.match(dst, src, tag)
        if env is not None:
            return self.ledger.deliver(env, self.session.step)
        self._require_peer_alive("p2p", dst, src)
        raise RecvWouldDeadlockError(
            f"recv: no message from live node {src} to {dst} (tag {tag}) — "
            f"in the step-driven simulation the send must happen first")

    def sendrecv(self, node: int, dst: int, payload: object, src: int,
                 tag: int = 0) -> object:
        """MPI_Sendrecv: post ``node -> dst``, then receive ``src -> node``.
        Either dead peer surfaces as PeerFailedError after its repair."""
        self.send(node, dst, payload, tag)
        return self.recv(node, src, tag)

    def probe(self, dst: int, src: int, tag: int = 0) -> bool:
        """MPI_Iprobe: is a matching message waiting? Never faults."""
        self.session.ensure_active()
        return self.ledger.match(dst, src, tag) is not None

    def _charge_p2p(self, src: int, dst: int, payload: object) -> None:
        cl = self.session.cluster
        nbytes = (payload_nbytes(payload)
                  if isinstance(payload, (np.ndarray, torch.Tensor)) else 0)
        try:
            cross = cl.topo.legion_of(src).index != cl.topo.legion_of(dst).index
        except KeyError:
            cross = True
        t = cl.link.tree_time(2, nbytes, cross=cross)
        cl.clock.charge(t)
        self.stats.sim_seconds += t

    # -- comm creators (paper §V: run on the ENTIRE communicator) --------------

    def comm_split(self, colors: dict[int, int]) -> dict[int, "Comm"]:
        """MPI_Comm_split, driver-side: ``colors`` maps member -> color;
        returns one fixed-group comm per color.

        Built from **surviving groups** (Rocco & Palermo's fault-aware
        non-collective creation): the drain inside the call repairs the
        structure eagerly, so the groups are read from post-repair
        membership — there is no whole-comm *blocking* repair-first
        precondition. Under background repair the drain merely opens a
        window (no clock charge) and the creator schedule runs over the
        survivors outside it; a busy-but-alive participant is still a
        member of the new comm (membership is structural, not a schedule
        property — it rejoins schedules when its window reconciles), and
        the repaired-out dead never appear. A split mid-window therefore
        observes the fully-applied post-repair group, never a torn one
        (the regression test in tests/test_mpi.py diffs this against the
        blocking path as oracle)."""
        self._call()
        self._resolve("comm_creator")
        self._run("comm_creator", lambda coll: coll.comm_create())
        members = set(self.members)
        groups: dict[int, list[int]] = {}
        for node, color in colors.items():
            if node in members and color >= 0:      # MPI_UNDEFINED analogue
                groups.setdefault(color, []).append(node)
        return {
            color: Comm(self.session, nodes,
                        name=f"{self.name}/split{color}")
            for color, nodes in sorted(groups.items())
        }

    def comm_dup(self) -> "Comm":
        """MPI_Comm_dup: same group, fresh message-matching context. Like
        :meth:`comm_split`, builds from the surviving post-repair group —
        non-blocking under an in-flight background repair window."""
        self._call()
        self._resolve("comm_creator")
        self._run("comm_creator", lambda coll: coll.comm_create())
        group = self.members if self._group is not None else None
        return Comm(self.session, group, name=f"{self.name}/dup")

    def __repr__(self) -> str:
        return (f"Comm({self.name!r}, size={self.size}, "
                f"calls={self.stats.calls})")
