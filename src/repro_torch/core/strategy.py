"""RecoveryStrategy layer — pluggable repair behaviors behind one seam.

Ashraf et al. ("Shrink or Substitute", 1801.04523) show shrink and
substitution are interchangeable strategies behind a single recovery
interface; this module makes that literally true of the runtime. The
``VirtualCluster._repair_*`` methods and the if/elif ladder in
``VirtualCluster.repair`` are gone: each recovery mode is one registered
:class:`RecoveryStrategy` class, selected by ``LegioPolicy.strategy_key``.
New modes (checkpoint-restart-all, migrate, ...) are one
``@register_strategy("name")`` class, not executor surgery.

Strategies mutate the cluster (topology, batch plan, spare pool, pending
splices) but never commit bookkeeping: ``VirtualCluster.repair`` /
``VirtualCluster.repair_scoped`` own confirm/charge/record, so every
strategy gets identical accounting.

Scoped invocation: the fault pipeline partitions each drain's verdict into
disjoint :class:`~repro_torch.core.types.RepairScope` subtrees and invokes the
registered strategy once per scope (``repair_scoped``). A strategy
therefore only ever sees verdict nodes whose repairs share participants —
faults in unrelated subtrees arrive as separate calls whose repairs are
charged as concurrent (max cost, not sum). Strategies need no scope
awareness: the scope is stamped onto the returned report by the cluster.

Exhaustion semantics (satellite fix): the non-blocking strategy lands the
shrink FIRST, then checks the pool — so a strict-mode
:class:`SparePoolExhausted` always propagates from a *consistent* (shrunk)
topology, with the committed shrink report attached as ``partial_report``.

Overlap axis (``LegioPolicy.repair_overlap``, the revoke-then-repair mode):
rather than a separate BackgroundRepairStrategy, every registered strategy
carries an ``overlap_safe`` class attribute. A strategy is overlap-safe
when its structural mutation is atomic within the drain — the topology it
leaves behind is fully applied the moment ``repair`` returns, so deferring
only the *clock charge* to a :class:`~repro_torch.core.types.BackgroundRepair`
window cannot expose a half-applied group. All three built-ins qualify
(the non-blocking substitute's deferred splice goes through its own
pending-queue machinery, orthogonal to the window). Set
``overlap_safe = False`` on a future strategy whose mutation spans calls
(e.g. incremental checkpoint restore) and ``VirtualCluster`` falls back to
blocking charges for it, policy knob notwithstanding.

Invariants every strategy must preserve (asserted by tests/test_pipeline.py,
tests/test_substitute.py, and tests/test_serve.py):

  * **one terminal action per fault** — ``repair`` handles each verdict
    node exactly once; a node it removed (or substituted away) never
    reappears in a later verdict, so the pipeline emits exactly one
    terminal RecoveryAction per failed node;
  * **frozen epochs under pin** — strategies mutate the topology only via
    its epoch-guarded mutators (``remove``/``substitute``/``expand``/
    ``compact``), never while a ``TopologyView`` is pinned;
  * **assignment finality + master rule** — a splice lands in the failed
    node's home legion, and spare ids always exceed every initial id, so
    no surviving master is ever demoted;
  * **no capacity is silently lost** — every failed slot is either
    substituted, shrunk into ``RepairReport.unfilled`` (and remembered on
    the provisioner backlog), or scheduled as a ``PendingSubstitution``;
    downstream consumers (batch plan, serve queues) re-own the slot's
    work from the report, which is what makes the serve layer's
    at-least-once re-enqueue possible;
  * **repairs stay inside their scope** — the engines fold failures
    legion-by-legion and spares splice into the failed node's home
    legion, so two disjoint scopes' repairs commute — the property that
    makes per-scope application order irrelevant and the concurrency
    claim sound (asserted structurally by benchmarks/hierarchy_scaling.py).
    The one deliberate exception is shrink-mode's beyond-paper elastic
    regrow, which may expand whichever live legion is smallest.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Protocol, runtime_checkable

from repro_torch.core.batch import (
    BatchPlan,
    initial_assignment,
    reassign,
    substitute_assign,
)
from repro_torch.core.policy import LegioPolicy
from repro_torch.core.substitute import (
    PendingSubstitution,
    SparePoolExhausted,
    UnfilledSlot,
    restore_member_state,
)
from repro_torch.core.types import RepairReport, RepairStep

if TYPE_CHECKING:
    from repro_torch.core.executor import VirtualCluster


@runtime_checkable
class RecoveryStrategy(Protocol):
    """The repair half of the fault pipeline's apply stage."""

    name: str

    def repair(self, cluster: "VirtualCluster",
               verdict: set[int]) -> RepairReport: ...


_REGISTRY: dict[str, type] = {}


def register_strategy(name: str):
    """Class decorator: register a RecoveryStrategy under ``name``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_strategies() -> list[str]:
    return sorted(_REGISTRY)


def make_strategy(policy: LegioPolicy) -> RecoveryStrategy:
    """Compose the strategy the policy asks for (``policy.strategy_key``)."""
    key = policy.strategy_key
    try:
        return _REGISTRY[key](policy)
    except KeyError:
        raise KeyError(
            f"no RecoveryStrategy registered under {key!r} "
            f"(available: {available_strategies()})") from None


class _PolicyBound:
    # structural mutation is atomic within the drain for every built-in, so
    # the clock charge may be deferred to a background window (see module
    # docstring); strategies whose mutation spans calls override to False
    overlap_safe: bool = True

    def __init__(self, policy: LegioPolicy):
        self.policy = policy


@register_strategy("shrink")
class ShrinkStrategy(_PolicyBound):
    """The paper's native discard-and-continue: shrink every failed slot,
    optionally regrowing from provisioned spares into the smallest legion
    (beyond-paper elastic regrow, kept for recovery_mode="shrink")."""

    def repair(self, cluster: "VirtualCluster", verdict: set[int],
               *, regrow: bool = True) -> RepairReport:
        report = cluster.shrink.repair(cluster.topo, verdict)
        grown = []
        while regrow and cluster.spares and cluster.topo.size < cluster.n_initial:
            spare = cluster.spare_pool.take()
            target = min((lg for lg in cluster.topo.legions if lg.members),
                         key=len, default=None)
            if target is None:
                from repro_torch.core.hierarchy import make_topology
                cluster.topo = make_topology([spare], self.policy)
            else:
                cluster.topo.expand(target.index, spare)
            cluster.detector.register(spare, cluster.clock.sim_seconds)
            grown.append(spare)
        if grown:
            report.steps.append(RepairStep(
                op="include", comm="world", participants=tuple(grown),
                cost_units=0.0))
        cluster.plan = reassign(cluster.plan, verdict, self.policy.batch_policy)
        if grown:
            # new members take over dropped shards (restart-only-failed)
            extra = initial_assignment(grown, cluster.shards_per_node)
            take = list(cluster.plan.dropped_shards)
            new_assignments = list(cluster.plan.assignments)
            for a in extra.assignments:
                shards = tuple(take.pop(0) for _ in a.shards if take)
                new_assignments.append(type(a)(node=a.node, shards=shards))
            cluster.plan = BatchPlan(
                assignments=tuple(new_assignments),
                dropped_shards=tuple(take),
                policy=cluster.plan.policy)
        return report


@register_strategy("substitute")
class SubstituteStrategy(_PolicyBound):
    """Blocking substitution: splice warm spares during the repair itself;
    the substituted ranks compute from the next step. Slots the pool cannot
    cover are shrunk (then_shrink) or refused before mutation (strict) —
    shrunk slots go on the provisioner backlog for later healing."""

    def repair(self, cluster: "VirtualCluster",
               verdict: set[int]) -> RepairReport:
        owned = {n: cluster.plan.shards_of(n) for n in verdict}
        homes = {n: cluster.topo.home.get(n) for n in verdict}
        report = cluster.substitute.repair(cluster.topo, verdict,
                                           cluster.spare_pool)
        restore_steps = {st.participants[0]: st for st in report.steps
                         if st.op == "restore" and st.participants}
        for failed, spare in report.substitutions:
            cluster.detector.register(spare, cluster.clock.sim_seconds)
            outcome = restore_member_state(cluster, cluster.topo.home[spare],
                                           failed)
            cluster._note_restored(spare, outcome.state)
            # a peer hit re-costs the splice's restore stage: one O(shard)
            # cross-member transfer instead of the O(model) store read
            step = restore_steps.get(spare)
            if step is not None and outcome.source == "peer":
                step.cost_units = outcome.cost_seconds
        report.model_cost = sum(st.cost_units for st in report.steps)
        cluster.plan = substitute_assign(cluster.plan, report.substitution_map)
        if report.unfilled:
            cluster.plan = reassign(cluster.plan, set(report.unfilled),
                                    self.policy.batch_policy)
            for node in report.unfilled:
                cluster.note_unfilled(UnfilledSlot(
                    failed=node, legion=homes[node], shards=owned[node]))
        return report


@register_strategy("substitute_nonblocking")
class NonblockingSubstituteStrategy(_PolicyBound):
    """Non-blocking substitution: repair by shrink now (the next step runs
    degraded), schedule the splice for after the spare's warmup. The shrink
    lands BEFORE the pool is consulted, so strict-mode exhaustion leaves a
    consistent topology (dead nodes out) and attaches the committed shrink
    report to the raised :class:`SparePoolExhausted`."""

    def repair(self, cluster: "VirtualCluster",
               verdict: set[int]) -> RepairReport:
        topo = cluster.topo
        homes = {n: topo.home[n] for n in verdict
                 if n in topo.home and n in topo.nodes}
        # each pending splice returns exactly the failed node's own shards
        owned = {n: cluster.plan.shards_of(n) for n in homes}
        report = ShrinkStrategy(self.policy).repair(cluster, verdict,
                                                    regrow=False)
        try:
            cluster.spare_pool.require(
                len(homes), self.policy.recovery_mode == "substitute")
        except SparePoolExhausted as exc:
            exc.partial_report = report
            raise
        scheduled = 0
        for node, legion in sorted(homes.items()):
            spare = cluster.spare_pool.take()
            if spare is None:
                # substitute_then_shrink: stay shrunk, remember the slot
                cluster.note_unfilled(UnfilledSlot(
                    failed=node, legion=legion, shards=owned[node]))
                continue
            scheduled += 1
            # the fault step itself ran degraded; spare_warmup_steps MORE
            # steps run shrunk before the splice lands at a boundary
            cluster.pending.append(PendingSubstitution(
                failed=node, spare=spare, legion=legion,
                ready_step=cluster._step + 1 + self.policy.spare_warmup_steps,
                shards=owned[node]))
        report.mode = ("substitute(nonblocking)" if scheduled == len(homes)
                       else "substitute_then_shrink")
        return report


@dataclass(frozen=True)
class AdaptiveDecision:
    """One :class:`CostModelStrategy` dispatch, fully explained: every
    candidate's estimated recovery seconds and the winner that ran."""

    step: int
    verdict: tuple[int, ...]
    scores: dict[str, float] = field(default_factory=dict)
    chosen: str = "shrink"
    # EWMA-fitted detect/notice/agree/plan seconds for this verdict size —
    # paid identically by every candidate, so recorded rather than scored
    pipeline_overhead: float = 0.0


@register_strategy("adaptive")
class CostModelStrategy(_PolicyBound):
    """Adaptive recovery: score every registered mode per fault, run the
    cheapest (``recovery_mode="adaptive"``).

    The scorer combines three ingredients, all of them live state rather
    than configuration:

      * the engines' **pure plans** — ``ShrinkEngine.plan`` and
        ``SubstituteEngine.plan`` are dry-run against the current topology,
        so the structural S(x) costs scored are exactly the costs the
        winning strategy will charge;
      * the **restore ladder's actual path** — a failed node whose POV-ring
        buddy holds a live replica is scored at the O(shard) link-model
        transfer; otherwise at the store read (``restore_seconds``), the
        same decision :func:`~repro_torch.core.substitute.restore_member_state`
        will make;
      * **online-fitted pipeline latencies** — per-stage wall seconds from
        ``FaultPipeline.traces``, EWMA-smoothed per verdict-size bucket
        (alpha = 2/(adaptive_ewma_horizon+1)). The non-apply stages are paid
        identically by every candidate, so they ride on the decision record
        (``pipeline_overhead``) instead of perturbing the argmin.

    Capacity lost to a shrink is charged as opportunity cost: a slot left
    shrunk forfeits its share of cluster throughput
    (``step_sim_seconds / size``) for ``adaptive_horizon_steps`` steps —
    the knob that decides when splicing a spare beats running degraded.

    The rollback strawman (snippet-1-style CONTROL_POINT loop: every
    survivor rolls back to the last checkpoint and re-executes) is scored
    as the ``"restart"`` baseline on every decision, but never dispatched —
    restart-only-failed dominates it by construction, and the recorded
    margin is the evidence (benchmarks/recovery_cost.py plots it).

    Inner strategies are composed per dispatch with non-strict policies
    (``substitute_then_shrink``), so the adaptive mode NEVER raises
    :class:`SparePoolExhausted` — an empty pool simply prices substitution
    at shrink-or-worse and the tie-break prefers shrink. Dispatched shrinks
    pass ``regrow=False``: choosing shrink means the scorer judged spares
    not worth spending here.
    """

    #: modes the scorer may dispatch ("restart" is baseline-only)
    DISPATCHABLE = ("shrink", "substitute", "substitute_nonblocking")

    def __init__(self, policy: LegioPolicy):
        super().__init__(policy)
        self.decisions: list[AdaptiveDecision] = []
        self._ewma: dict[tuple[str, int], float] = {}  # (stage, bucket)
        self._seen_traces = 0

    # -- online fitting from pipeline traces ----------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """Power-of-two verdict-size bucket (1-node faults dominate; rack
        drains land in coarser buckets with their own latency profile)."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _ingest(self, cluster: "VirtualCluster") -> None:
        alpha = 2.0 / (self.policy.adaptive_ewma_horizon + 1.0)
        traces = cluster.pipeline.traces
        for tr in traces[self._seen_traces:]:
            bucket = self._bucket(max(1, len(tr.verdict)))
            for stage, secs in tr.stage_seconds.items():
                key = (stage, bucket)
                prev = self._ewma.get(key)
                self._ewma[key] = secs if prev is None else \
                    prev + alpha * (secs - prev)
        self._seen_traces = len(traces)

    def fitted_overhead(self, n_failed: int) -> float:
        """EWMA detect/notice/agree/plan seconds for an n-node verdict."""
        bucket = self._bucket(max(1, n_failed))
        return sum(secs for (stage, b), secs in self._ewma.items()
                   if b == bucket and stage != "apply")

    # -- scoring ---------------------------------------------------------------

    def _restore_cost(self, cluster: "VirtualCluster", node: int) -> float:
        """What the restore ladder would charge for ``node`` right now."""
        store_cost = cluster.substitute.cost.restore_seconds
        replicator = getattr(cluster, "replicator", None)
        if replicator is None or not replicator.enabled:
            return store_cost
        record = replicator.replicas.get(node)
        if record is None or record.holder in cluster.failed \
                or record.holder not in cluster.topo.nodes:
            return store_cost
        return replicator.transfer_seconds(record.nbytes)

    def score(self, cluster: "VirtualCluster",
              verdict: set[int]) -> dict[str, float]:
        """Estimated total recovery seconds per candidate mode."""
        pol, topo = self.policy, cluster.topo
        present = [n for n in sorted(verdict)
                   if n in topo.home and n in topo.nodes]
        size = max(1, topo.size)
        # opportunity cost of one slot-step: a shrunk slot forfeits its
        # share of cluster throughput until the horizon runs out
        slot_step = pol.step_sim_seconds / size
        horizon = pol.adaptive_horizon_steps

        teardown = sum(st.cost_units
                       for st in cluster.shrink.plan(topo, set(verdict)))
        spares = list(cluster.spare_pool.available)
        filled = min(len(present), len(spares))
        unfilled = len(present) - filled

        scores: dict[str, float] = {}
        scores["shrink"] = teardown + len(present) * slot_step * horizon

        # blocking substitution: the engine's own (pure) plan, each restore
        # stage re-costed the way the ladder would actually charge it
        hypo = dict(zip(present, spares))
        spare_of = {s: n for n, s in hypo.items()}
        sub = 0.0
        for st in cluster.substitute.plan(topo, set(verdict), hypo):
            if st.op == "restore" and st.participants:
                sub += self._restore_cost(cluster, spare_of[st.participants[0]])
            else:
                sub += st.cost_units
        scores["substitute"] = sub + unfilled * slot_step * horizon

        # non-blocking: shrink lands now, the splice charge lands after
        # warmup (restore overlaps the warmup — uncharged, see
        # VirtualCluster.poll_substitutions); filled slots run shrunk
        # through the warmup window only
        warmup = min(1 + pol.spare_warmup_steps, horizon)
        splices = filled * cluster.substitute.cost.splice_cost(
            max(1, topo.k) - 1)
        scores["substitute_nonblocking"] = (
            teardown + splices
            + filled * slot_step * warmup
            + unfilled * slot_step * horizon)

        # restart-from-checkpoint baseline: every survivor rolls back to
        # the last snapshot (full O(model) restore) and re-executes the
        # lost steps; the dead slots still shrink away
        ck = cluster.checkpointer
        last = ck.latest_step() if ck is not None else None
        lost = cluster._step - last if last is not None else cluster._step
        scores["restart"] = (
            teardown
            + max(0, lost) * pol.step_sim_seconds
            + cluster.substitute.cost.restore_seconds * size
            + len(present) * slot_step * horizon)
        return scores

    # -- dispatch --------------------------------------------------------------

    def repair(self, cluster: "VirtualCluster",
               verdict: set[int]) -> RepairReport:
        self._ingest(cluster)
        scores = self.score(cluster, verdict)
        # ties prefer the earlier entry — with an empty pool every
        # substitution candidate collapses to shrink's score, and shrink
        # wins without touching the provisioner
        chosen = min(self.DISPATCHABLE, key=lambda m: scores[m])
        self.decisions.append(AdaptiveDecision(
            step=cluster._step, verdict=tuple(sorted(verdict)),
            scores=scores, chosen=chosen,
            pipeline_overhead=self.fitted_overhead(len(verdict))))
        if chosen == "shrink":
            inner = replace(self.policy, recovery_mode="shrink")
            return ShrinkStrategy(inner).repair(cluster, verdict,
                                                regrow=False)
        inner = replace(
            self.policy, recovery_mode="substitute_then_shrink",
            nonblocking_substitution=(chosen == "substitute_nonblocking"))
        if chosen == "substitute_nonblocking":
            return NonblockingSubstituteStrategy(inner).repair(cluster,
                                                               verdict)
        return SubstituteStrategy(inner).repair(cluster, verdict)
