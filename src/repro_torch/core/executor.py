"""LegioExecutor — the transparent fault-resiliency loop (paper §IV).

Communication goes exclusively through the ``repro_torch.mpi`` facade: the
executor holds a :class:`repro_torch.mpi.Session` over its cluster and issues the
step-final collective as an ordinary MPI-shaped call on the world
:class:`repro_torch.mpi.Comm`. The PMPI-style interposition inside that call owns
everything Legio owns in MPI — trapping the simulated PROC_FAILED, draining
the FaultPipeline (detect → notice → agree → plan → apply), applying the
registered RecoveryStrategy, and retrying on the repaired communicator —
so ``run_step`` is orchestration only:

  1. step boundary (``Session.boundary``): the SpareProvisioner delivers
     re-spawned spares (elastic refill, the MPI_Comm_spawn analogue),
     warmed-up non-blocking substitutes rejoin, and ground-truth faults
     land;
  2. per-node shard work (EP: no interaction until the final collective);
  3. the step-final collective runs on the comm — faults are repaired
     inside the call, before the schedule re-runs against a pinned
     TopologyView (paper §IV: check after the op; if confirmed repair,
     repeat). A failed op *root* surfaces per policy: STOP raises
     RootFailedError from the gate, IGNORE skips the op for the step
     (the facade's PeerFailedError, caught here);
  4. the straggler channel drains through the same pipeline
     (``Session.poll`` — soft-fails routed through the same strategies),
     and the StepReport surfaces every action the session recorded.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core.batch import (
    BatchPlan,
    initial_assignment,
    restore_rank,
    validate_plan,
)
from repro_torch.core.collectives import HierarchicalCollectives, LinkModel
from repro_torch.core.detector import FaultInjector, HeartbeatDetector, StragglerDetector
from repro_torch.core.hierarchy import LegionTopology, TopologyView, make_topology
from repro_torch.core.pipeline import FaultPipeline
from repro_torch.core.policy import LegioPolicy
from repro_torch.core.shrink import ShrinkEngine
from repro_torch.core.strategy import RecoveryStrategy, make_strategy
from repro_torch.core.substitute import (
    PendingSubstitution,
    SparePool,
    SparePoolExhausted,
    SpareProvisioner,
    SubstituteEngine,
    UnfilledSlot,
    restore_member_state,
)
from repro_torch.core.types import (
    BackgroundRepair,
    ClusterClock,
    FailureEvent,
    FaultSource,
    RecoveryAction,
    RepairReport,
    RepairScope,
    RepairStep,
)


class RootFailedError(RuntimeError):
    """Raised under the STOP policy when an operation's root has failed."""


@dataclass
class StepReport:
    step: int
    results: dict[int, Any]                  # node -> shard work output
    reduced: Any | None                      # step-final collective output
    failed_now: tuple[int, ...] = ()         # every node repaired this step
    repair: RepairReport | None = None       # first crash repair (back-compat)
    actions: tuple[RecoveryAction, ...] = () # all terminal pipeline actions
    skipped_op: bool = False                 # IGNORE policy fired
    sim_collective_seconds: float = 0.0
    wall_seconds: float = 0.0
    grad_scale: float = 1.0
    expanded: tuple[tuple[int, int], ...] = ()  # non-blocking splices applied
    respawned: tuple[int, ...] = ()          # provisioner deliveries this step
    repairing: tuple[int, ...] = ()          # survivors busy in an overlap
                                             # window (excluded this step)
    reconciled: tuple[RepairScope, ...] = () # windows merged at the boundary


class VirtualCluster:
    """A simulated cluster: N logical nodes, ground-truth failure state,
    simulated clock, and the Legio substitute structures."""

    def __init__(
        self,
        n_nodes: int,
        policy: LegioPolicy | None = None,
        injector: FaultInjector | None = None,
        link: LinkModel | None = None,
        shards_per_node: int = 1,
        checkpointer: Any = None,       # LegionCheckpointer (state restoration)
        device: str | Any = "cuda",     # the torch data plane's device
    ):
        self.policy = policy or LegioPolicy()
        self.injector = injector or FaultInjector()
        self.link = link or LinkModel()
        self.nodes = list(range(n_nodes))
        self.n_initial = n_nodes
        self.topo: LegionTopology = make_topology(self.nodes, self.policy)
        self.detector = HeartbeatDetector(timeout=self.policy.heartbeat_timeout)
        for n in self.nodes:
            self.detector.register(n)
        self.straggler = StragglerDetector(threshold=self.policy.straggler_threshold)
        self.shrink = ShrinkEngine(self.policy)
        self.substitute = SubstituteEngine(self.policy)
        self.strategy: RecoveryStrategy = make_strategy(self.policy)
        self.clock = ClusterClock()
        self.failed: set[int] = set()            # ground truth (hidden from app)
        self.plan: BatchPlan = initial_assignment(self.nodes, shards_per_node)
        self.shards_per_node = shards_per_node
        self.total_shards = n_nodes * shards_per_node
        self.spare_pool = SparePool.provision(n_nodes, self.policy)
        self.provisioner = SpareProvisioner.for_pool(
            n_nodes, self.spare_pool, self.policy)
        self.backlog: list[UnfilledSlot] = []    # shrunk slots awaiting refill
        self.pending: list[PendingSubstitution] = []
        self.pipeline = FaultPipeline(self)
        self.background: list[BackgroundRepair] = []  # in-flight overlap windows
        # peer-replicated shard checkpoints: lazy import keeps repro_torch.core
        # importable without pulling repro_torch.checkpoint into the module graph
        from repro_torch.checkpoint.replicate import ShardReplicator
        self.replicator = ShardReplicator(
            link=self.link, enabled=self.policy.peer_replication,
            cluster=self)
        self.checkpointer = checkpointer
        self.restored_state: dict[int, Any] = {}  # this step's splices only
        self._restored_step = -1
        self.repairs: list[RepairReport] = []
        self._step = 0
        # error-feedback residuals for compressed cross-legion reduction
        self.compress_residuals: dict[int, Any] = {}
        # data plane: what moves the bytes behind the scheduled collectives
        # (policy.data_plane — torch | sim | auto; torch on ``device``, which
        # raises without a card unless the caller asks for the CPU); lazy
        # import keeps the module graph acyclic (dist.dataplane never
        # imports repro_torch.core)
        from repro_torch.dist.dataplane import make_dataplane
        self.dataplane = make_dataplane(self.policy, device)
        self.reshards: list[Any] = []   # reshard report log (multi-card planes)

    @property
    def spares(self) -> list[int]:
        """Warm spares still available (legacy view of the pool)."""
        return self.spare_pool.available

    @property
    def checkpointer(self) -> Any:
        return self._checkpointer

    @checkpointer.setter
    def checkpointer(self, value: Any) -> None:
        """Attaching a checkpointer wires it to the cluster's replicator, so
        every ``save()`` also pushes shards to their POV-ring buddies."""
        self._checkpointer = value
        if value is not None:
            try:
                value.replicator = self.replicator
            except AttributeError:
                pass     # frozen/slotted stand-in: store-only checkpoints

    # -- fault plumbing ---------------------------------------------------------

    def inject(self, step: int) -> list[FailureEvent]:
        self._step = step
        events = self.injector.due(step)
        for e in events:
            if e.node in self.topo.nodes:
                self.failed.add(e.node)
            elif e.node in self.spare_pool.available:
                # a warm spare can die too — it must never be spliced in,
                # and the detector must bury it: without confirm_failed a
                # later stale beat auto-registered the dead spare HEALTHY
                self.failed.add(e.node)
                self.spare_pool.available.remove(e.node)
                self.detector.confirm_failed(e.node, epoch=self.topo.epoch)
            elif any(p.spare == e.node for p in self.pending):
                # died while warming up: reschedule the splice on the next
                # warm spare (fresh warmup); with the pool empty the slot
                # stays shrunk — fatal under strict substitute semantics
                self.failed.add(e.node)
                self.detector.confirm_failed(e.node, epoch=self.topo.epoch)
                dead = [p for p in self.pending if p.spare == e.node]
                self.pending = [p for p in self.pending if p.spare != e.node]
                for p in dead:
                    self.spare_pool.require(
                        1, self.policy.recovery_mode == "substitute")
                    replacement = self.spare_pool.take()
                    if replacement is None:
                        self.note_unfilled(UnfilledSlot(
                            failed=p.failed, legion=p.legion, shards=p.shards))
                        continue
                    self.pending.append(PendingSubstitution(
                        failed=p.failed, spare=replacement, legion=p.legion,
                        ready_step=step + 1 + self.policy.spare_warmup_steps,
                        shards=p.shards))
        return events

    def collectives(self, view: TopologyView | None = None
                    ) -> HierarchicalCollectives:
        return HierarchicalCollectives(
            view if view is not None else self.topo, self.link,
            compression=self.policy.grad_compression,
            topk_fraction=self.policy.topk_fraction,
            residuals=self.compress_residuals,
            dataplane=self.dataplane)

    @property
    def live_nodes(self) -> list[int]:
        return [n for n in self.topo.nodes if n not in self.failed]

    # -- repair (strategy dispatch) -------------------------------------------

    def _note_restored(self, spare: int, state: Any) -> None:
        """Record a splice's restored state, evicting previous steps' entries
        — consumers copy what they need within the step; unbounded retention
        would keep one full model+opt snapshot per fault for the campaign's
        lifetime."""
        if self._restored_step != self._step:
            self.restored_state.clear()
            self._restored_step = self._step
        self.restored_state[spare] = state

    def note_unfilled(self, slot: UnfilledSlot) -> None:
        """Remember a slot shrunk for lack of spares so the provisioner can
        heal it once replacements come up (no-op without elastic spares)."""
        if self.provisioner.enabled:
            self.backlog.append(slot)

    def repair(self, verdict: set[int],
               scope: "RepairScope | None" = None) -> RepairReport | None:
        """Apply the registered RecoveryStrategy for the agreed verdict.

        The strategy mutates the structures; this method owns the
        bookkeeping every strategy shares: detector confirmation, straggler
        eviction, clock charge, and the repair record. A strategy that
        raises after committing work (non-blocking strict exhaustion)
        attaches the committed report as ``partial_report`` — it is recorded
        before the error propagates, so the campaign log stays truthful.
        """
        if not verdict:
            return None
        if scope is None:
            scopes = self.topo.partition_scopes(set(verdict))
            scope = scopes[0] if len(scopes) == 1 else None
        try:
            report = self.strategy.repair(self, set(verdict))
        except SparePoolExhausted as exc:
            if exc.partial_report is not None:
                self._stamp_scope(exc.partial_report, scope)
                self._commit_repair(verdict, exc.partial_report)
            raise
        self._stamp_scope(report, scope)
        self._commit_repair(verdict, report)
        self._reshard_after_repair()
        return report

    def repair_scoped(self, scopes: "list[RepairScope]"
                      ) -> "list[tuple[RepairScope, RepairReport]]":
        """Apply the strategy once per disjoint :class:`RepairScope`.

        The scopes partition one drain's verdict into subtrees with
        pairwise-disjoint participant sets, so their repairs proceed
        concurrently: the simulated clock is charged the *maximum* scope
        cost, not the sum — healthy subtrees (and the faster of two
        concurrent repairs) never wait on an unrelated subtree's recovery
        (Bouteiller & Bosilca's non-blocking argument applied across
        subtrees). Bookkeeping per scope is identical to :meth:`repair`.

        Under ``policy.repair_overlap`` (revoke-then-repair) even the max
        is not charged synchronously: each scope's cost opens a
        :class:`BackgroundRepair` window on the simulated clock instead —
        the scope's survivors stay busy (schedules exclude them) until the
        clock, advanced by the healthy subtrees' own compute, passes
        ``finish_sim``; :meth:`reconcile_repairs` then merges the window
        with zero residual. A new scope whose participants or verdict
        touch an in-flight window serializes *behind* it (its window
        starts at the earlier window's finish), never observing a
        half-applied group.
        """
        out: list[tuple[RepairScope, RepairReport]] = []
        overlap = self.overlap_enabled
        worst = 0.0
        for scope in scopes:
            verdict = set(scope.verdict)
            if not verdict:
                continue
            try:
                report = self.strategy.repair(self, verdict)
            except SparePoolExhausted as exc:
                # strict-mode exhaustion is the documented overlap-unsafe
                # case: the fatal error must surface synchronously, so the
                # committed partial work is charged blocking
                if exc.partial_report is not None:
                    self._stamp_scope(exc.partial_report, scope)
                    self._commit_repair(verdict, exc.partial_report,
                                        charge=False)
                    worst = max(worst, exc.partial_report.model_cost)
                if worst:
                    self.clock.charge(worst)
                    self._refresh_liveness()
                raise
            self._stamp_scope(report, scope)
            self._commit_repair(verdict, report, charge=False)
            if overlap:
                self._open_window(scope, report)
            else:
                worst = max(worst, report.model_cost)
            out.append((scope, report))
        if worst:
            self.clock.charge(worst)
            self._refresh_liveness()
        if out:
            self._reshard_after_repair()
        return out

    # -- background (overlapped) repair ---------------------------------------

    @property
    def overlap_enabled(self) -> bool:
        """Revoke-then-repair is on iff the policy asks for it AND the
        registered strategy declares itself overlap-safe."""
        return (self.policy.repair_overlap
                and getattr(self.strategy, "overlap_safe", False))

    def _open_window(self, scope: RepairScope,
                     report: RepairReport) -> None:
        """Defer a scope's repair charge to a BackgroundRepair window. A
        window whose participants/verdict touch an in-flight one starts at
        that window's finish (serialized — busy survivors cannot enter a
        second repair mid-window); disjoint windows run concurrently."""
        now = self.clock.sim_seconds
        involved = set(scope.participants) | set(scope.verdict)
        start = now
        for br in self.background:
            if involved & (set(br.busy) | set(br.scope.verdict)):
                start = max(start, br.finish_sim)
        self.background.append(BackgroundRepair(
            scope=scope, report=report, start_step=self._step,
            start_sim=start, finish_sim=start + report.model_cost))

    def repairing_participants(self) -> set[int]:
        """Survivors busy in an in-flight background repair window —
        excluded from collective schedules and serve admission until
        :meth:`reconcile_repairs` merges their window."""
        return {n for br in self.background for n in br.busy}

    def reconcile_repairs(self, *, force: bool = False
                          ) -> list[BackgroundRepair]:
        """Merge background repair windows back into full membership —
        the deferred half of revoke-then-repair, run at every
        ``Session`` boundary.

        Without ``force`` only windows the clock has already passed merge
        (zero residual: the whole repair hid behind concurrent compute).
        With ``force`` (an explicit barrier, a rooted op on a busy root)
        every window merges *now* and the unhidden remainder is charged
        as residual wait — the price of synchronizing with a repair that
        had not finished."""
        now = self.clock.sim_seconds
        merged = [br for br in self.background
                  if force or br.done(now)]
        if not merged:
            return []
        self.background = [br for br in self.background
                           if br not in merged]
        # windows merge concurrently: a forced synchronization waits out
        # the *makespan* (max residual — serialized windows' finish times
        # already chain), and each window hides only the part of its cost
        # that actually elapsed behind compute before the merge
        waited = max(br.residual(now) for br in merged)
        for br in merged:
            self.clock.absorb(min(br.report.model_cost,
                                  max(0.0, now - br.start_sim)))
        if waited > 0.0:
            self.clock.wait(waited)
            # survivors collectively waited out the residual — their
            # heartbeat deadlines must not count the repair (same rule
            # as the blocking path's _refresh_liveness)
            self._refresh_liveness()
        return merged

    @staticmethod
    def _stamp_scope(report: RepairReport,
                     scope: "RepairScope | None") -> None:
        if scope is not None and report.scope is None:
            report.scope = scope
            report.repair_participants = scope.n_participants

    def _commit_repair(self, verdict: set[int], report: RepairReport,
                       charge: bool = True) -> None:
        for n in verdict:
            self.detector.confirm_failed(n, epoch=self.topo.epoch)
            self.straggler.drop(n)
        if charge:
            self.clock.charge(report.model_cost)
            self._refresh_liveness()
        self.repairs.append(report)

    # -- data-plane state redistribution --------------------------------------

    def register_sharded_state(self, name: str, getter: Callable[[], Any],
                               setter: Callable[[Any], None] | None = None
                               ) -> None:
        """Register a live-state pytree (via getter/setter) for post-repair
        redistribution on the data plane. On one card (the torch plane) and
        on the sim plane this is bookkeeping only: every node's state lives
        on the one device. Resharding over a device mesh after a repair
        comes with the multi-card slice. Consumers call
        this — never the data plane directly — so backend selection stays
        behind LegioPolicy/Session."""
        self.dataplane.register_state(name, getter, setter)

    def _reshard_after_repair(self) -> None:
        """Redistribute registered state onto the survivors' mesh — the
        "Shrink or Substitute" observation operationalized: the real cost
        of in-situ recovery is data motion, so it is measured (wall time of
        the redistribution pass, reported by a multi-card plane), not
        modeled by the alpha-beta formula. One-card planes report None."""
        report = self.dataplane.reshard_registered(self.topo.view())
        if report is not None:
            self.reshards.append(report)
            self.clock.charge(report.wall_seconds)
            self._refresh_liveness()

    def _refresh_liveness(self) -> None:
        """Re-stamp every survivor's heartbeat after a repair charge. The
        repair is collective among the survivors (ULFM: everyone enters
        MPIX_Comm_shrink), so its simulated duration must not count
        against their heartbeat deadlines — without this, a repair whose
        S(x) cost exceeds heartbeat_timeout (a whole rack under
        substitution) made the next sweep condemn the entire cluster."""
        now = self.clock.sim_seconds
        for n in self.live_nodes:
            self.detector.beat(n, now)

    # -- deferred (non-blocking) substitution --------------------------------

    def poll_substitutions(self, step: int) -> list[RepairReport]:
        """Apply every pending splice whose warmup has elapsed — called at
        the step boundary, before new work is assigned. Re-expansion is a
        mini-repair of its own: an include into the home legion plus the
        (overlapped, hence uncharged) state restore."""
        ready = [p for p in self.pending if p.ready_step <= step]
        if not ready:
            return []
        self.pending = [p for p in self.pending if p.ready_step > step]
        self._step = step
        reports = []
        for p in ready:
            t0 = time.perf_counter()
            self.topo.expand(p.legion, p.spare)
            self.detector.register(p.spare, self.clock.sim_seconds)
            # peer-first ladder: the replica settled (or re-homed) during
            # the warmup window, so the splice warm-starts in O(shard)
            self._note_restored(
                p.spare, restore_member_state(self, p.legion, p.failed).state)
            self.plan = restore_rank(self.plan, p.spare, shards=p.shards)
            k = len(self.topo.legion_of(p.spare).members)
            steps = [RepairStep(op="substitute", comm=f"local_{p.legion}",
                                participants=(p.spare,),
                                cost_units=self.substitute.cost.splice_cost(k - 1))]
            report = RepairReport(
                trigger=(p.failed,),
                hierarchical=self.topo.n_legions > 1,
                master_failed=False,
                steps=steps,
                model_cost=sum(st.cost_units for st in steps),
                wall_seconds=time.perf_counter() - t0,
                survivors=self.topo.size,
                mode="substitute(nonblocking)",
                substitutions=((p.failed, p.spare),),
            )
            self.clock.charge(report.model_cost)
            self.repairs.append(report)
            reports.append(report)
        # the splices changed membership: the data-plane mesh regrows and
        # registered state spreads back over the rejoined devices
        self._reshard_after_repair()
        return reports

    # -- elastic spare re-spawn (provisioner stage) ---------------------------

    def poll_provisioner(self, step: int) -> list[int]:
        """Provisioner boundary stage: deliver due replacement spares, then
        feed refilled capacity back into slots shrunk during exhaustion —
        each healed slot goes through the same pending-splice path as a
        non-blocking substitution (warmup included), so assignment finality
        and master rules hold by construction."""
        if not self.provisioner.enabled:
            return []
        delivered = self.provisioner.poll(step)
        while self.backlog and self.spare_pool.available:
            slot = self.backlog.pop(0)
            spare = self.spare_pool.take()
            self.pending.append(PendingSubstitution(
                failed=slot.failed, spare=spare, legion=slot.legion,
                ready_step=step + self.policy.spare_warmup_steps,
                shards=slot.shards))
        # the backlog may have drained what poll() just delivered — re-check
        # the watermark now so replacement provisioning overlaps the healing
        # splices' warmup instead of losing a boundary
        self.provisioner.refill(step)
        return delivered


class LegioExecutor:
    """Runs per-shard work under transparent fault resiliency."""

    def __init__(
        self,
        cluster: VirtualCluster,
        work_fn: Callable[[int, int, int], Any],
        *,
        reduce_op: Callable[[Any, Any], Any] | None = None,
        final_collective: str = "allreduce",   # allreduce | reduce | bcast | none
        root: int = 0,
    ):
        # the facade is the only communication surface; lazy import keeps
        # repro_torch.core importable without repro_torch.mpi in the module graph
        from repro_torch.mpi import Session

        self.cluster = cluster
        self.session = Session.adopt(cluster)
        self.comm = self.session.world
        # keyed: the world comm is shared per cluster — a rebuilt executor
        # replaces its hook instead of stacking another
        self.comm.attach(self._validate_pin, key="executor-validate-plan")
        self.work_fn = work_fn
        self.reduce_op = reduce_op or np.add
        self.final_collective = final_collective
        self.root = root
        self.step_count = 0
        self._skip_op = False

    # -- facade hooks (PMPI-style interposers) -----------------------------------

    def _validate_pin(self, op: str, view: TopologyView) -> None:
        """Interposer run on every comm call against the pinned view: the
        shard plan must agree with the structure the schedule reads."""
        validate_plan(self.cluster.plan, view)

    def _root_gate(self, verdict: set[int]) -> None:
        """Runs between agree and apply: the paper's root-failure knob.
        STOP raises before any repair mutates state; IGNORE lets the
        repair proceed — the facade then surfaces the dead root as
        PeerFailedError, which run_step turns into a skipped op."""
        if self.root in verdict and self.final_collective in ("bcast", "reduce"):
            if self.cluster.policy.root_failure_policy == "stop":
                raise RootFailedError(
                    f"root node {self.root} failed at step "
                    f"{self.cluster._step}")

    # -- step phases --------------------------------------------------------------

    def _work_phase(self, step: int) -> tuple[dict[int, Any], int]:
        """Per-node shard work; every live node heartbeats (idle nodes too —
        liveness is not throughput)."""
        cl = self.cluster
        results: dict[int, Any] = {}
        computed_shards = 0
        busy = cl.repairing_participants()
        for node in cl.live_nodes:
            cl.detector.beat(node, cl.clock.sim_seconds)
            if node in busy:
                continue        # occupied by a background repair window
            shards = cl.plan.shards_of(node)
            if not shards:
                continue
            t0 = time.perf_counter()
            out = [self.work_fn(node, s, step) for s in shards]
            results[node] = out[0] if len(out) == 1 else _sum_results(out)
            computed_shards += len(shards)
            cl.straggler.observe(node, time.perf_counter() - t0)
        return results, computed_shards

    def _collective_phase(self, results: dict[int, Any]
                          ) -> tuple[Any, float]:
        """Issue the step-final collective as one MPI-shaped call on the
        facade comm. The interposition inside the call traps PROC_FAILED,
        drains the crash channels (gated by the root-failure policy),
        repairs, and runs the schedule against a pinned TopologyView —
        the executor neither observes nor repairs anything itself."""
        from repro_torch.mpi import PeerFailedError

        # payloads stay where the work function left them (on the card for
        # the torch plane); host arrays and scalars are placed once
        contributions = {n: self.cluster.dataplane.asarray(v)
                         for n, v in results.items()}
        try:
            if self.final_collective == "allreduce":
                res = self.comm.allreduce(contributions, self.reduce_op,
                                          gate=self._root_gate)
                members = self.comm.members
                reduced = res.data.get(members[0]) if members else None
            elif self.final_collective == "reduce":
                res = self.comm.reduce(contributions, self.root,
                                       self.reduce_op, gate=self._root_gate)
                reduced = next(iter(res.data.values()), None)
            elif self.final_collective == "bcast":
                res = self.comm.bcast(contributions, self.root,
                                      gate=self._root_gate)
                reduced = next(iter(res.data.values()), None)
            else:
                return None, 0.0
        except PeerFailedError:
            # the op's root was in this call's verdict and the policy is
            # IGNORE: the repair has landed, the op result is discarded
            self._skip_op = True
            return None, 0.0
        return reduced, res.sim_seconds

    # -- one transparent step -----------------------------------------------------

    def run_step(self, step: int | None = None) -> StepReport:
        cl = self.cluster
        step = self.step_count if step is None else step
        t_start = time.perf_counter()
        # 0. step boundary (Session.boundary): the provisioner delivers
        #    re-spawned spares (and reschedules shrunk slots), warmed-up
        #    substitutes rejoin, faults due this step land in the ground
        #    truth, the sim clock ticks
        boundary = self.session.boundary(step)

        # 1. per-node shard work (only live nodes actually compute)
        results, computed_shards = self._work_phase(step)

        # 2. the step-final collective as one facade call — fault trap,
        #    pipeline drain, repair, and the retried schedule all happen
        #    behind it (paper §IV). With no collective this step, the crash
        #    channels still drain so heartbeat timeouts reach agreement.
        self._skip_op = False
        reduced, sim_t = (None, 0.0)
        if self.final_collective != "none" and results:
            reduced, sim_t = self._collective_phase(results)
        else:
            self.session.poll(
                (FaultSource.COLLECTIVE, FaultSource.HEARTBEAT),
                gate=self._root_gate)

        # 3. straggler soft-fails drain through the same pipeline, after
        #    the op (a lagging node's contribution still counts this step)
        self.session.poll((FaultSource.STRAGGLER,))
        actions = list(self.session.take_actions())

        self.step_count = step + 1
        # back-compat: `repair` carries the first CRASH repair only; straggler
        # soft-fail repairs are surfaced through `actions` and `failed_now`
        crash_reports = [a.report for a in actions if a.report is not None
                         and FaultSource.STRAGGLER not in a.sources]
        failed_now = tuple(sorted({n for a in actions for n in a.verdict}))
        return StepReport(
            step=step,
            results=results,
            reduced=reduced,
            failed_now=failed_now,
            repair=crash_reports[0] if crash_reports else None,
            actions=tuple(actions),
            skipped_op=self._skip_op,
            sim_collective_seconds=sim_t,
            wall_seconds=time.perf_counter() - t_start,
            # renormalize over the shards that actually contributed THIS step
            # (the post-repair plan may already show restored capacity a
            # just-spliced spare did not compute yet)
            grad_scale=(cl.total_shards / computed_shards
                        if computed_shards else 0.0),
            expanded=boundary.expanded,
            respawned=boundary.respawned,
            repairing=tuple(sorted(cl.repairing_participants())),
            reconciled=boundary.reconciled,
        )

    def run(self, n_steps: int) -> list[StepReport]:
        return [self.run_step() for _ in range(n_steps)]


def _sum_results(outs: list[Any]) -> Any:
    acc = outs[0]
    for o in outs[1:]:
        acc = acc + o
    return acc
