"""ServeEngine — continuous-batching, fault-resilient request serving over
the Legio runtime.

The serving analogue of :class:`LegioExecutor.run_step`, rebuilt around
continuous batching: the global lock-step round barrier is gone. Each call
to :meth:`run_round` advances the cluster one simulated *tick*, and within
a tick every legion runs its own admission loop — a node admits a fresh
micro-batch into any free slot of its in-flight *window*
(``LegioPolicy.serve_window``) the moment a previous batch completes,
independent of every other legion's progress and of in-flight repairs.
One slow batch no longer gates global throughput; it occupies exactly one
slot on one node while everything else keeps flowing.

Per tick:

  1. boundary — the SpareProvisioner delivers re-spawned spares and
     warmed-up non-blocking substitutes rejoin (same polls as training);
  2. admit — against a *pinned* ``TopologyView``, every legion fills its
     members' free window slots from its :class:`LegionQueue`. Batch
     composition is deadline-aware: once SLOs are present the queue yields
     by slack (earliest-deadline-first over remaining service), not FIFO;
  3. faults land — injected ground truth arrives *after* admission, so a
     dying node takes its in-flight window with it; the sim clock ticks;
  4. execute — every busy live node advances each in-flight request one
     phase tick (prefill first, then decode — accounted separately in
     :class:`ServeMetrics`); requests whose ticks run out complete through
     ``work_fn`` (dedup guard: a request id completes at most once);
  5. drain — the result gather is one interposed call on the MPI facade
     (``repro_torch.mpi.Comm.gather``) among the busy nodes: it traps the lost
     nodes' PROC_FAILED, runs detect → notice → agree → plan → apply, and
     the engine's pipeline listener *migrates* every verdict node's
     in-flight requests — a request that died mid-decode keeps its decode
     progress (the KV cache moves with it) and re-enters a queue with only
     the remaining ticks to serve, instead of restarting from prefill.

Admission control (``LegioPolicy.serve_admission``) guards the door: when
a request's SLO deadline is already infeasible against its target legion's
backlog and live capacity, it is shed (or parked) *before* it enters a
queue — backpressure applies before queues blow past deadline
feasibility, never after.

The lock-step loop survives as the measurable baseline
(``ServeEngine(..., continuous=False)``): one batch per node per round,
and the round's simulated duration stretches to the slowest in-flight
batch — the synchronous-drain cost the load-curve benchmark quantifies.

Invariants (asserted by tests/test_serve.py and the chaos harness):

  * **at-least-once** — a request is never lost: it is in exactly one of
    {a legion queue, a node's in-flight window, the completed map,
    metrics.parked, metrics.abandoned, metrics.shed} at every tick
    boundary;
  * **exactly-once completion** — the dedup guard keys on the request id;
    redeliveries (and migrated decode states) of an already-completed
    request are suppressed, so the client observes exactly one completion
    per id;
  * **no stall on healthy legions** — a legion with backlog and a free
    window slot admits every tick, including ticks where another legion's
    repair is in flight (``ServeMetrics.starved_rounds() == 0``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch import tracing
from repro_torch.core.executor import VirtualCluster
from repro_torch.core.types import FaultSource, RecoveryAction
from repro_torch.mpi import Session
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import CompletionRecord, ServeMetrics
from repro_torch.serve.queue import LegionQueue, Request
from repro_torch.serve.router import RequestRouter
from repro_torch.serve.traffic import Arrival

# work_fn(node, batch, step) -> {rid: result}
WorkFn = Callable[[int, list[Request], int], dict[int, Any]]

RECOVERY_PRESETS = ("shrink", "substitute", "nonblocking", "overlap",
                    "adaptive")


def recovery_preset(name: str, *, spare_fraction: float = 0.25) -> dict:
    """Canonical ``LegioPolicy`` overrides for the serving recovery setups —
    the CLI (launch/serve.py), the benchmark (serve_latency), and the tests
    share this single source instead of drifting copies. ``overlap`` is
    shrink with background (revoke-then-repair) windows: a torn scope's
    repair happens concurrently on the sim clock while healthy legions
    keep serving — continuous batching never parks their slots on a
    remote scope's repair. ``adaptive`` scores shrink / substitute /
    nonblocking per fault from the live cost models (CostModelStrategy)
    and keeps background windows available to whichever mode wins."""
    presets = {
        "shrink": dict(recovery_mode="shrink"),
        "substitute": dict(recovery_mode="substitute_then_shrink",
                           spare_fraction=spare_fraction),
        "nonblocking": dict(recovery_mode="substitute_then_shrink",
                            spare_fraction=spare_fraction,
                            nonblocking_substitution=True),
        "overlap": dict(recovery_mode="shrink", repair_overlap=True),
        "adaptive": dict(recovery_mode="adaptive",
                         spare_fraction=spare_fraction,
                         repair_overlap=True),
    }
    return presets[name]


@dataclass
class _Slot:
    """One in-flight micro-batch occupying one window slot of a node."""

    requests: list[Request]


@dataclass
class RoundReport:
    """One serving tick, surfaced the way StepReport surfaces a step."""

    step: int
    dispatched: dict[int, int]               # node -> requests admitted
    completed_now: int
    requeued_now: int
    actions: tuple[RecoveryAction, ...] = ()
    respawned: tuple[int, ...] = ()
    expanded: tuple[tuple[int, int], ...] = ()
    backlog: int = 0
    inflight: int = 0
    sim_seconds: float = 0.0                 # deterministic round duration
    wall_seconds: float = 0.0                # the ``serve.round`` span's


@dataclass
class ServeReport:
    """Campaign summary returned by :meth:`ServeEngine.serve`."""

    rounds: int
    submitted: int
    completed: int
    metrics_summary: dict = field(default_factory=dict)
    survivors: int = 0
    repairs: int = 0


class ServeEngine:
    """Routes, admits, batches, executes, and redelivers transparently."""

    def __init__(
        self,
        cluster: "VirtualCluster | Session",
        work_fn: WorkFn,
        *,
        microbatch: int | None = None,
        window: int | None = None,
        continuous: bool = True,
        requeue: bool = True,
        observe_stragglers: bool = True,
    ):
        # all fault plumbing goes through the MPI facade; a driver may hand
        # in its Session directly (launch/serve.py) or a bare cluster
        if isinstance(cluster, Session):
            self.session = cluster
            cluster = cluster.cluster
        else:
            self.session = Session.adopt(cluster)
        self._comm = self.session.world
        self.cluster = cluster
        self.work_fn = work_fn
        self.requeue = requeue
        self.continuous = continuous
        # lock-step is the one-batch-per-node barrier baseline: the window
        # is meaningless there, the whole cluster drains before re-dispatch
        self.window = max(window or cluster.policy.serve_window, 1) \
            if continuous else 1
        # wall-clock work latency feeds the straggler detector only when the
        # caller says it is trustworthy — a work_fn that jit-compiles on
        # batch-shape changes (launch/serve.py) would soft-fail healthy
        # nodes on compile noise
        self.observe_stragglers = observe_stragglers
        self.router = RequestRouter()
        self.batcher = MicroBatcher(
            microbatch or cluster.policy.serve_microbatch)
        self.metrics = ServeMetrics()
        self.completed: dict[int, Any] = {}      # rid -> result (write-once)
        self._slots: dict[int, list[_Slot]] = {}  # node -> in-flight window
        self._next_rid = 0
        self._submitted = 0
        self.round_count = 0
        cluster.pipeline.add_listener(self._on_recovery_action)

    # -- client surface ------------------------------------------------------

    def submit(self, payloads: "list[Any] | int") -> list[int]:
        """Enqueue new requests — a count of payload-less ones, arbitrary
        payloads, or :class:`~repro_torch.serve.traffic.Arrival` specs (which
        carry service shape and SLO class). Admission control runs here:
        a request whose deadline is already infeasible is shed or parked
        at the door, never queued. Returns the assigned request ids —
        including shed ones (their outcome is in the metrics ledger)."""
        if isinstance(payloads, int):
            payloads = [None] * payloads
        cl = self.cluster
        now = cl.clock.sim_seconds
        default_slo = cl.policy.serve_slo_seconds
        rids = []
        reqs: list[Request] = []
        for item in payloads:
            req = Request(rid=self._next_rid, enqueue_step=self.round_count,
                          arrival_sim=now)
            if isinstance(item, Arrival):
                req.payload = item.payload
                req.user = item.user
                req.slo_class = item.slo_class
                req.prefill_ticks = item.prefill_ticks
                req.decode_ticks = item.decode_ticks
                if math.isfinite(item.slo_seconds) and item.slo_seconds > 0:
                    req.deadline_sim = now + item.slo_seconds
            else:
                req.payload = item
                if default_slo > 0:
                    req.deadline_sim = now + default_slo
            self._next_rid += 1
            self._submitted += 1
            rids.append(req.rid)
            reqs.append(req)
        self.router.reconcile(cl.topo.view())
        for req in reqs:
            self._admit_to_queue(req, now)
        return rids

    @property
    def pending(self) -> int:
        return self.router.backlog + sum(
            len(s.requests) for slots in self._slots.values() for s in slots)

    @property
    def _inflight(self) -> dict[int, list[Request]]:
        """node -> every request in its in-flight window (flattened).
        Kept as the accounting surface the invariant tests walk."""
        return {node: [r for s in slots for r in s.requests]
                for node, slots in self._slots.items() if slots}

    # -- admission control ---------------------------------------------------

    def _admit_to_queue(self, req: Request, now: float) -> bool:
        """Route one request, or shed/park it when its deadline is already
        infeasible against the target legion's backlog and live capacity.
        Returns True when the request entered a queue."""
        mode = self.cluster.policy.serve_admission
        if mode == "none" or not math.isfinite(req.deadline_sim):
            self.router.route(req)
            return True
        tick = self.cluster.policy.step_sim_seconds
        target = self.router.peek()
        wait = self._estimated_wait(target, tick)
        service = req.service_ticks_remaining * tick
        slack = self.cluster.policy.serve_admission_slack
        if now + wait + service + slack <= req.deadline_sim:
            self.router.route(req)
            return True
        ledger = self.metrics.shed if mode == "shed" else self.metrics.parked
        ledger.append(req.rid)
        return False

    def _estimated_wait(self, target: LegionQueue, tick: float) -> float:
        """Sim-seconds of queueing ahead of a new arrival on ``target``:
        the queued service ticks divided by the legion's live concurrency
        (members × window × microbatch requests advance per tick)."""
        cl = self.cluster
        members = next(
            (lg.members for lg in cl.topo.legions
             if lg.index == target.legion), [])
        live = sum(1 for n in members if n not in cl.failed)
        capacity = max(live * self.window * self.batcher.microbatch, 1)
        return target.pending_ticks / capacity * tick

    # -- fault plumbing ------------------------------------------------------

    def _on_recovery_action(self, action: RecoveryAction) -> None:
        """Pipeline listener: the repair for ``action.verdict`` has been
        applied — migrate every verdict node's in-flight requests. One
        topology snapshot covers the whole action (the repair already
        landed; nothing mutates between redeliveries)."""
        view = None
        for node in action.verdict:
            batch = self._pop_node(node)
            if batch and view is None:
                view = self.cluster.topo.view()
            for req in batch:
                self._redeliver(req, view, migrate=True)

    def _pop_node(self, node: int) -> list[Request]:
        """Remove and return every in-flight request of ``node``."""
        return [r for s in self._slots.pop(node, []) for r in s.requests]

    def _migrate(self, req: Request) -> None:
        """Decode-state migration: a request whose node died mid-decode
        keeps its decode progress (the KV cache travels to wherever it is
        redelivered); one that died mid-prefill has nothing to migrate and
        restarts. ``serve_migrate_decode=False`` restarts everything —
        the restart-from-prefill baseline the benchmark compares against."""
        preserved = (self.cluster.policy.serve_migrate_decode
                     and req.prefill_done >= req.prefill_ticks)
        if not preserved:
            req.prefill_done = 0
            req.decode_done = 0
            return
        req.migrations += 1
        self.metrics.migrations += 1
        self.metrics.decode_ticks_preserved += req.decode_done

    def _redeliver(self, req: Request, view=None, *,
                   migrate: bool = False) -> None:
        if req.rid in self.completed:
            # completed on a previous delivery — the dedup guard keeps the
            # at-least-once redelivery invisible to the client
            self.metrics.duplicates_suppressed += 1
            return
        if migrate:
            self._migrate(req)
        if not self.requeue:
            self.metrics.abandoned.append(req.rid)      # DROP semantics
            return
        cap = self.cluster.policy.serve_max_attempts
        if cap and req.attempts >= cap:
            self.metrics.parked.append(req.rid)
            return
        self.metrics.requeues += 1
        self.router.requeue(
            req, view if view is not None else self.cluster.topo.view())

    def _complete(self, req: Request, result: Any, step: int,
                  node: int) -> None:
        if req.rid in self.completed:
            self.metrics.duplicates_suppressed += 1
            return
        self.completed[req.rid] = result
        self.metrics.record_completion(CompletionRecord(
            rid=req.rid, enqueue_step=req.enqueue_step, complete_step=step,
            attempts=req.attempts, legion=req.legion if req.legion is not None
            else -1, node=node, arrival_sim=req.arrival_sim,
            complete_sim=self.cluster.clock.sim_seconds,
            slo_class=req.slo_class, deadline_sim=req.deadline_sim,
            migrated=req.migrations > 0))

    # -- one serving tick ----------------------------------------------------

    def run_round(self, step: int | None = None) -> RoundReport:
        """One serving tick, the span ``serve.round`` (with its ``step``):
        deliver, admit, inject, the work calls (``serve.work``), the
        gather and its drain (``pipeline.drain``); the round's wall time is
        the span's."""
        step = self.round_count if step is None else step
        with tracing.span("serve.round", step=step) as rnd:
            rep = self._round(step)
        rep.wall_seconds = rnd.seconds
        self.metrics.record_round(step, rep.sim_seconds, rnd.seconds)
        return rep

    def _round(self, step: int) -> RoundReport:
        cl = self.cluster
        sim_start = cl.clock.sim_seconds

        # 1. boundary: elastic refills + warmed-up substitutes rejoin
        boundary = self.session.deliver(step)

        # 2. admit against a pinned snapshot — a repair can neither run
        #    nor tear the structure while windows are being filled
        dispatched_sizes = self._admit_phase(step)

        # 3. faults land mid-flight; the sim clock ticks
        self.session.inject(step)

        # 4. execute — live busy nodes advance/complete, dead ones keep
        #    their windows until the drain migrates them
        completed_before = len(self.completed)
        if self.continuous:
            self._tick_phase(step)
        else:
            self._lockstep_phase(step)
        for node in cl.live_nodes:
            cl.detector.beat(node, cl.clock.sim_seconds)

        # 5. the result gather, as one interposed facade call: the lost
        #    nodes' PROC_FAILED is trapped among the busy set, the crash
        #    channels drain, and the pipeline listener migrates verdict
        #    nodes' windows before the call returns
        requeues_before = self.metrics.requeues
        self._comm.gather(among=set(self._slots))
        self.session.poll((FaultSource.STRAGGLER,))
        actions = list(self.session.take_actions())
        # safety net: a dead node whose loss produced no verdict this round
        # (e.g. no surviving observer) still must not strand its window —
        # redeliver now; the heartbeat channel will confirm the node later
        stranded_view = None
        for node in [n for n in list(self._slots) if n in cl.failed]:
            batch = self._pop_node(node)
            if batch and stranded_view is None:
                stranded_view = cl.topo.view()
            for req in batch:
                self._redeliver(req, stranded_view, migrate=True)

        self.round_count = step + 1
        return RoundReport(
            step=step,
            dispatched=dispatched_sizes,
            completed_now=len(self.completed) - completed_before,
            requeued_now=self.metrics.requeues - requeues_before,
            actions=tuple(actions),
            respawned=boundary.respawned,
            expanded=boundary.expanded,
            backlog=self.router.backlog,
            inflight=sum(len(b) for b in self._inflight.values()),
            sim_seconds=cl.clock.sim_seconds - sim_start,
        )

    # -- phases --------------------------------------------------------------

    def _admit_phase(self, step: int) -> dict[int, int]:
        """Fill every legion's free window slots from its queue — each
        legion independently, so one legion's depth (or repair) never gates
        another's admission. Returns node -> requests admitted."""
        cl = self.cluster
        now = cl.clock.sim_seconds
        tick = cl.policy.step_sim_seconds
        dispatched: dict[int, int] = {}
        busy = cl.repairing_participants()
        with cl.topo.pinned() as tv:
            self.router.reconcile(tv)
            for lg in tv.legions:
                # a member busy in a background repair window serves
                # nothing this round — but only ITS slots pause: healthy
                # legions (and this legion's other members) admit freely,
                # never parked on a remote scope's repair
                members = [n for n in lg.members
                           if n not in cl.failed and n not in busy]
                if not members:
                    continue
                queue = self.router.queue_of(lg.index)
                backlog_before = len(queue)
                free_slots = 0
                admitted = 0
                # fill one slot per member per pass, so admission spreads
                # across the legion instead of saturating the first member
                # (with window=1 this is exactly one batch per member, in
                # member order — the legacy dispatch)
                for _ in range(self.window):
                    for node in members:
                        if len(self._slots.get(node, [])) >= self.window:
                            continue
                        free_slots += 1
                        batch = self.batcher.form_one(
                            queue, now=now, tick_seconds=tick)
                        if not batch:
                            continue
                        for req in batch:
                            req.attempts += 1
                        self._slots.setdefault(node, []).append(
                            _Slot(requests=batch))
                        dispatched[node] = dispatched.get(node, 0) \
                            + len(batch)
                        admitted += len(batch)
                        self.metrics.record_dispatch(
                            step, lg.index, len(batch))
                if backlog_before and free_slots and not admitted:
                    self.metrics.record_starved(step, lg.index)
        return dispatched

    def _advance(self, req: Request) -> None:
        """One phase tick: prefill until done, then decode — each phase
        accounted separately."""
        if req.prefill_done < req.prefill_ticks:
            req.prefill_done += 1
            self.metrics.record_phase_tick("prefill")
        elif req.decode_done < req.decode_ticks:
            req.decode_done += 1
            self.metrics.record_phase_tick("decode")

    def _finish(self, node: int, ready: list[Request], step: int) -> None:
        """Requests whose service ticks ran out complete through work_fn;
        an id the work_fn drops is a delivery failure — it redelivers with
        its progress reset (the result never materialized), never records
        a completion the client didn't get."""
        cl = self.cluster
        with tracing.span("serve.work", node=node, rows=len(ready)) as work:
            results = self.work_fn(node, ready, step)
        if self.observe_stragglers:
            cl.straggler.observe(node, work.seconds)
        dropped_view = None
        for req in ready:
            if req.rid in results:
                self._complete(req, results[req.rid], step, node)
            else:
                req.prefill_done = 0
                req.decode_done = 0
                if dropped_view is None:
                    dropped_view = cl.topo.view()
                self._redeliver(req, dropped_view)

    def _tick_phase(self, step: int) -> None:
        """Continuous execution: every busy live node advances each of its
        in-flight requests one phase tick; finished requests complete and
        free their slot for next tick's admission."""
        cl = self.cluster
        busy = cl.repairing_participants()
        for node in sorted(self._slots):
            if node in cl.failed:
                continue        # dead mid-flight: the drain migrates it
            if node in busy:
                continue        # repairing: its batches stall, not migrate
            ready: list[Request] = []
            kept: list[_Slot] = []
            for slot in self._slots[node]:
                remaining = []
                for req in slot.requests:
                    if req.service_ticks_remaining > 0:
                        self._advance(req)
                    if req.service_ticks_remaining == 0:
                        ready.append(req)
                    else:
                        remaining.append(req)
                slot.requests = remaining
                if remaining:
                    kept.append(slot)
            if kept:
                self._slots[node] = kept
            else:
                del self._slots[node]
            if ready:
                self._finish(node, ready, step)

    def _lockstep_phase(self, step: int) -> None:
        """The barrier baseline: every in-flight batch runs to completion
        inside this round, and the round's simulated duration stretches to
        the slowest batch anywhere in the cluster — including one riding a
        node that just died (the survivors waited out the timeout). No
        partial progress exists at the fault, so a victim's requests
        restart from prefill; decode-state migration is a
        continuous-batching capability."""
        cl = self.cluster
        if cl.background:
            # a round barrier is all-hands: background repair windows
            # cannot ride through it — force-finish, charging the residual
            self.session.sync()
        max_ticks = max(
            (r.service_ticks_remaining
             for slots in self._slots.values()
             for s in slots for r in s.requests), default=0)
        if max_ticks > 1:
            # inject() already charged one tick; the barrier pays the rest
            cl.clock.charge((max_ticks - 1) * cl.policy.step_sim_seconds)
        for node in [n for n in sorted(self._slots) if n not in cl.failed]:
            batch = self._pop_node(node)
            for req in batch:
                self.metrics.record_phase_tick(
                    "prefill", req.prefill_ticks - req.prefill_done)
                self.metrics.record_phase_tick(
                    "decode", req.decode_ticks - req.decode_done)
                req.prefill_done = req.prefill_ticks
                req.decode_done = req.decode_ticks
            self._finish(node, batch, step)

    # -- campaign ------------------------------------------------------------

    def serve(self, max_rounds: int = 10_000) -> ServeReport:
        """Run rounds until every submitted request is completed (or parked/
        abandoned/shed), the cluster dies, or ``max_rounds`` is hit."""
        reports: list[RoundReport] = []
        while self.pending and self.cluster.live_nodes \
                and len(reports) < max_rounds:
            reports.append(self.run_round())
        return ServeReport(
            rounds=len(reports),
            submitted=self._submitted,
            completed=len(self.completed),
            metrics_summary=self.metrics.summary(max(len(reports), 1)),
            survivors=len(self.cluster.live_nodes),
            repairs=len(self.cluster.repairs),
        )
