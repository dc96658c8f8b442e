"""FaultPipeline — every fault signal flows through explicit stages.

The paper's recovery is transparent because every action hangs off one seam
(the PMPI interposition layer); Bouteiller & Bosilca (2212.08755) argue the
recovery behind that seam should be a pipeline of implicit actions rather
than a blocking in-line procedure. This module is that pipeline for the
step-boundary seam:

    detect  — gather signals from every channel: collective PROC_FAILED
              observations fed by the executor, HeartbeatDetector.sweep
              timeouts (previously dead code — now a first-class channel),
              straggler soft-fails, and injected ground truth (trainer sims);
    notice  — apply the paper's P.2/P.3 noticing semantics per event: which
              survivors actually hold a verdict (bcast notices partially —
              the BNP; heartbeat suspicion is coordinator-state every live
              node can read);
    agree   — unify the observers' suspicion sets into one verdict
              (agreement.agree_fault — the BNP fix);
    plan    — select the registered RecoveryStrategy, partition the verdict
              into crash vs straggle soft-fails, and fold it into disjoint
              :class:`RepairScope` subtrees (the minimal communicator sets
              that contain each fault — Rocco & Palermo's scoped reparation);
    apply   — soft-fail stragglers, run the strategy once per scope via
              ``VirtualCluster.repair_scoped`` (which owns
              confirm/charge/record; disjoint scopes are charged as
              concurrent — max cost, not sum).

Each drain emits one terminal :class:`RecoveryAction` per disjoint scope —
the scopes partition the agreed verdict, so every failed node still appears
in exactly one terminal action. A drain is the span ``pipeline.drain`` with
one child span a stage (``pipeline.detect`` ... ``pipeline.apply``,
:mod:`repro_torch.tracing`); the stages' durations are recorded on every
action and in ``traces`` (benchmarks/repair_time.py reads the
breakdown, and :class:`~repro_torch.core.strategy.CostModelStrategy` fits its
per-stage EWMA estimates from the same records — the pipeline is the
adaptive scorer's only latency oracle).

Invariants (asserted by tests/test_pipeline.py and tests/test_serve.py):

  * **one terminal action per fault** — every agreed-failed node appears in
    the verdict of exactly one terminal RecoveryAction over the campaign
    (a drain never re-repairs a node a previous drain already repaired);
  * **frozen epochs under pin** — the apply stage mutates the topology only
    through ``VirtualCluster.repair``, which is never called while a
    ``TopologyView`` is pinned: a drain either completes before a
    collective snapshots the structure or raises ``TopologyTornError``;
  * **listeners see every terminal action** — subscribers registered with
    :meth:`FaultPipeline.add_listener` are invoked once per terminal
    action, *after* the repair has been applied. The serve subsystem
    (repro_torch.serve) relies on this to re-enqueue a failed node's in-flight
    requests at-least-once: the listener fires for every verdict the node
    appears in, and the engine's dedup guard collapses redeliveries back
    to exactly-once from the client's view.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Iterable

from repro_torch import tracing
from repro_torch.core.agreement import agree_fault
from repro_torch.core.detector import notice_fault
from repro_torch.core.types import (
    FailureKind,
    FaultEvent,
    FaultSource,
    PipelineTrace,
    RecoveryAction,
    RepairScope,
)

if TYPE_CHECKING:
    from repro_torch.core.executor import VirtualCluster

ALL_SOURCES = (FaultSource.COLLECTIVE, FaultSource.HEARTBEAT,
               FaultSource.STRAGGLER, FaultSource.INJECTED)


class FaultPipeline:
    """Event-driven fault pipeline drained at step boundaries."""

    def __init__(self, cluster: "VirtualCluster"):
        self.cluster = cluster
        self.inbox: list[FaultEvent] = []
        self.actions: list[RecoveryAction] = []
        self.traces: list[PipelineTrace] = []
        self._listeners: list[Callable[[RecoveryAction], None]] = []

    def add_listener(self, fn: Callable[[RecoveryAction], None]) -> None:
        """Subscribe to terminal actions. Called once per action, after the
        repair has been applied — the topology the listener reads is the
        repaired one. Registration order is invocation order."""
        self._listeners.append(fn)

    # -- signal ingestion (detect-stage feeds) --------------------------------

    def observe(self, event: FaultEvent) -> None:
        """Queue an observed fault signal for the next drain."""
        self.inbox.append(event)

    def observe_collective(self, op: str, participants: list[int],
                           failed: set[int], root: int | None = None) -> None:
        """A collective surfaced PROC_FAILED for ``failed`` participants."""
        if failed:
            self.observe(FaultEvent(
                nodes=tuple(sorted(failed)), step=self.cluster._step,
                source=FaultSource.COLLECTIVE, op=op, root=root,
                participants=tuple(participants)))

    def observe_suspicion(self, observers: Iterable[int],
                          suspects: Iterable[int],
                          step: int | None = None) -> None:
        """One *side's* suspicion of the other — the correlated-failure
        injection channel (network partitions, gray switches). Unlike the
        coordinator heartbeat (every live node reads it), this suspicion is
        held only by ``observers``: the notice stage credits exactly them,
        and agreement takes the union over LIVE observers — so a fenced
        side's accusation of the survivors never enters the verdict. If
        both sides stay alive (unfenced split), the agree stage's majority
        quorum condemns exactly the minority — see :meth:`_agree`."""
        observers = tuple(sorted(set(observers)))
        suspects = tuple(sorted(set(suspects)))
        if observers and suspects:
            self.observe(FaultEvent(
                nodes=suspects,
                step=self.cluster._step if step is None else step,
                source=FaultSource.HEARTBEAT, observers=observers))

    # -- stages ---------------------------------------------------------------

    def _detect(self, step: int,
                sources: frozenset[FaultSource]) -> list[FaultEvent]:
        cl = self.cluster
        events = [e for e in self.inbox if e.source in sources]
        self.inbox = [e for e in self.inbox if e.source not in sources]
        if FaultSource.HEARTBEAT in sources:
            suspects = cl.detector.suspicions(cl.clock.sim_seconds,
                                              cl.topo.nodes)
            if suspects:
                events.append(FaultEvent(nodes=suspects, step=step,
                                         source=FaultSource.HEARTBEAT))
        if FaultSource.STRAGGLER in sources:
            lagging = tuple(n for n in cl.straggler.stragglers()
                            if n in cl.topo.nodes)
            if lagging:
                events.append(FaultEvent(nodes=lagging, step=step,
                                         source=FaultSource.STRAGGLER,
                                         kind=FailureKind.STRAGGLE))
        return events

    def _notice(self, events: list[FaultEvent]
                ) -> tuple[dict[int, set[int]], set[int]]:
        """Per-observer suspicion sets. Collective events notice per the
        op's semantics (bcast partially — the BNP); heartbeat/straggler/
        injected suspicion is coordinator state every live node reads —
        unless the event carries explicit ``observers`` (the partition
        channel: each side's suspicion is its own side's knowledge only).

        Also returns the suspects accused *only* through observer-carrying
        events — those hold no ground truth, so the agree stage demands a
        majority quorum before condemning them."""
        cl = self.cluster
        live = set(cl.live_nodes)
        observations: dict[int, set[int]] = {}
        suspicion_only: set[int] = set()
        grounded: set[int] = set()
        for e in events:
            failed = set(e.nodes)
            if e.source is FaultSource.COLLECTIVE:
                members = (list(e.participants) if e.participants is not None
                           else cl.topo.nodes)
                noticers = notice_fault(e.op or "allreduce", members,
                                        failed, root=e.root)
                grounded |= failed
            elif e.observers is not None:
                # partition-style one-sided suspicion: only the event's own
                # observers hold it (and only while they live — a fenced
                # side's accusations die with it at the agree stage)
                noticers = set(e.observers) & live
                suspicion_only |= failed
            else:
                noticers = live
                grounded |= failed
            for obs in noticers:
                observations.setdefault(obs, set()).update(failed)
        return observations, suspicion_only - grounded

    def _agree(self, observations: dict[int, set[int]],
               suspicion_only: set[int]) -> set[int]:
        """``agree_fault`` union, then the split-brain guard: a suspect
        backed by no ground-truth channel needs accusers from a strict
        majority of live nodes. Under an unfenced two-sided partition both
        sides accuse each other while alive — the plain union would condemn
        everyone; the quorum condemns exactly the minority (the same
        resolution a real quorum-based membership service applies). Ground
        -truth channels (collective PROC_FAILED, heartbeat timeout,
        injected) are untouched, so BNP partial noticing still condemns a
        genuinely dead node on a single live observation."""
        live = self.cluster.live_nodes
        verdict = agree_fault(observations, live)
        if not suspicion_only:
            return verdict
        live_set = set(live)
        quorum = len(live) // 2 + 1
        for s in suspicion_only & verdict:
            accusers = sum(1 for obs, seen in observations.items()
                           if s in seen and obs in live_set)
            if accusers < quorum:
                verdict.discard(s)
        return verdict

    def _plan(self, verdict: set[int], events: list[FaultEvent]
              ) -> tuple[str, set[int], list[RepairScope]]:
        """Select the strategy, mark which verdict nodes are performance
        faults that must be soft-failed before repair, and partition the
        verdict into disjoint :class:`RepairScope`\\ s — the minimal
        subtrees whose members must participate. Faults in unrelated
        subtrees land in separate scopes and repair concurrently."""
        straggle = set()
        for e in events:
            if e.kind is FailureKind.STRAGGLE:
                straggle |= set(e.nodes) & verdict
        scopes = self.cluster.topo.partition_scopes(verdict)
        return self.cluster.strategy.name, straggle, scopes

    def _apply(self, verdict: set[int], straggle: set[int],
               scopes: list[RepairScope]):
        cl = self.cluster
        for n in straggle:
            cl.failed.add(n)                     # soft-fail (discard policy)
        return cl.repair_scoped(scopes)

    # -- orchestration --------------------------------------------------------

    def drain(self, step: int,
              sources: Iterable[FaultSource] = ALL_SOURCES,
              gate: Callable[[set[int]], None] | None = None,
              ) -> list[RecoveryAction]:
        """Run detect → notice → agree → plan → apply for the given channels.

        ``gate`` runs between agree and plan with the verdict — the
        executor's root-failure policy hook (STOP raises there, before any
        repair mutates state; IGNORE flags the op skipped).
        """
        with tracing.span("pipeline.drain", step=step):
            return self._drain(step, frozenset(sources), gate)

    def _drain(self, step: int, srcs: frozenset[FaultSource],
               gate: Callable[[set[int]], None] | None) -> list[RecoveryAction]:
        with tracing.span("pipeline.detect") as detect:
            events = self._detect(step, srcs)
        if not events:
            return []
        with tracing.span("pipeline.notice") as notice:
            observations, suspicion_only = self._notice(events)
        with tracing.span("pipeline.agree") as agree:
            verdict = self._agree(observations, suspicion_only)
        if not verdict:
            return []
        if gate is not None:
            gate(verdict)
        with tracing.span("pipeline.plan") as plan:
            strategy_name, straggle, scopes = self._plan(verdict, events)
        with tracing.span("pipeline.apply") as apply:
            repaired = self._apply(verdict, straggle, scopes)
        stage_seconds = {s.name[len("pipeline."):]: s.seconds
                         for s in (detect, notice, agree, plan, apply)}

        sources = tuple(sorted({e.source for e in events},
                               key=lambda s: s.value))
        windows = {id(br.report) for br in self.cluster.background}
        actions = [
            RecoveryAction(
                step=step,
                verdict=scope.verdict,
                strategy=strategy_name,
                sources=sources,
                report=report,
                terminal=True,
                stage_seconds=dict(stage_seconds),
                scope=scope,
                # the repair's charge went to a background window instead
                # of the clock — still open when the action is emitted
                overlapped=id(report) in windows,
            )
            for scope, report in repaired
        ]
        self.actions.extend(actions)
        self.traces.append(PipelineTrace(
            step=step, n_events=len(events),
            verdict=tuple(sorted(verdict)), stage_seconds=dict(stage_seconds)))
        for action in actions:
            for listener in self._listeners:
                listener(action)
        return actions
