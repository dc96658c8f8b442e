"""Substitution recovery — warm spares spliced into failed legion slots.

Legio's native semantics are shrink-only (the paper's discard-and-continue),
which is right for embarrassingly parallel jobs but leaves capacity on the
floor for long campaigns. This module implements the "substitute" branch of
Ashraf et al.'s shrink-or-substitute trade-off on top of the same repair
seam:

  * :class:`SparePool` — warm standby nodes provisioned at cluster start
    (``LegioPolicy.spare_fraction`` / ``spare_nodes``). Spare ids are
    allocated *above* every initial node id, so a splice never steals a
    mastership from a survivor (the paper's lowest-rank master rule).
  * :class:`SubstituteEngine` — sibling of :class:`ShrinkEngine`. The comm
    teardown half of its plan is exactly the shrink plan (the failed
    process must leave every communicator it was in — Fig. 3); the splice
    half then includes the spare into the failed node's local_comm and
    restores its state. Topology invariants (a)–(c) hold afterwards because
    the legion count, POV ring, and home map are preserved by
    :meth:`LegionTopology.substitute`.
  * checkpoint-backed restoration — the spare adopts the *dead member's*
    shard via ``checkpoint.store.restore_member`` (restart-only-failed,
    §VII): survivors are never touched.

Modes (``LegioPolicy.recovery_mode``):
  * ``substitute``            — pool exhaustion raises
                                :class:`SparePoolExhausted` (the operator
                                asked for capacity-preserving recovery).
  * ``substitute_then_shrink``— exhaustion degrades to shrink for the
                                unfilled slots; the run continues degraded.

The non-blocking flavor (``nonblocking_substitution``) is orchestrated by
the executor: the fault step repairs by shrink (cheap, overlappable) and a
:class:`PendingSubstitution` re-expands the topology at the first step
boundary after the spare's warmup — repair overlapping useful work,
Bouteiller & Bosilca's implicit-actions argument at step granularity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch import tracing
from repro_torch.core.hierarchy import LegionTopology
from repro_torch.core.policy import LegioPolicy
from repro_torch.core.shrink import (
    ShrinkCostModel,
    ShrinkEngine,
    failures_by_legion,
    master_failed_in,
)
from repro_torch.core.types import RepairReport, RepairStep

PyTree = Any


class SparePoolExhausted(RuntimeError):
    """Raised under recovery_mode="substitute" when no warm spare is left.

    ``partial_report`` carries a repair that already committed before the
    exhaustion was discovered (the non-blocking strategy lands the shrink
    first, so the error always leaves a consistent — shrunk — topology);
    ``VirtualCluster.repair`` records it before re-raising.
    """

    partial_report: "RepairReport | None" = None


@dataclass
class SparePool:
    """Warm standby nodes. ``available`` is FIFO: the longest-warm spare is
    spliced first."""

    capacity: int
    available: list[int] = field(default_factory=list)
    consumed: list[int] = field(default_factory=list)

    @staticmethod
    def provision(n_nodes: int, policy: LegioPolicy) -> "SparePool":
        """Pool for an ``n_nodes`` cluster; spare ids start at ``n_nodes``."""
        count = policy.spare_count(n_nodes)
        return SparePool(capacity=count,
                         available=[n_nodes + i for i in range(count)])

    def take(self) -> int | None:
        if not self.available:
            return None
        spare = self.available.pop(0)
        self.consumed.append(spare)
        return spare

    @property
    def exhausted(self) -> bool:
        return not self.available

    def __len__(self) -> int:
        return len(self.available)

    def require(self, needed: int, strict: bool) -> None:
        """Under strict (recovery_mode="substitute") semantics, refuse when
        the pool cannot cover ``needed`` failed slots. The blocking engine
        calls this before anything is mutated; the non-blocking strategy
        deliberately calls it AFTER its shrink has landed, so the error
        propagates from a consistent topology (the committed shrink rides
        along as ``SparePoolExhausted.partial_report``)."""
        if strict and needed > len(self.available):
            raise SparePoolExhausted(
                f"{needed} failed node(s) but only {len(self.available)} "
                f"warm spare(s) left (recovery_mode='substitute' does not "
                f"degrade; use 'substitute_then_shrink')")

    def restock(self, node: int) -> None:
        """Feed a freshly provisioned spare back into the pool (the
        SpareProvisioner's delivery path). FIFO order is preserved: re-spawned
        spares queue behind any originals still warm."""
        self.available.append(node)


@dataclass(frozen=True)
class UnfilledSlot:
    """A failed slot that was shrunk for lack of spares — remembered so the
    provisioner can heal it once replacement spares come up."""

    failed: int
    legion: int                    # home legion index (assignment is final)
    shards: tuple[int, ...] = ()   # the slot's shards at fault time


@dataclass
class SpareProvisioner:
    """Elastic re-spawn of consumed spares — the ``MPI_Comm_spawn`` analogue
    (ROADMAP item). A background pipeline stage polled at step boundaries:

      * **watermark** — when warm + in-flight spares drop below
        ``policy.spare_refill_watermark``, schedule replacements up to the
        pool's provisioned capacity;
      * **delay** — a scheduled spare becomes warm only after
        ``policy.spare_provision_delay_steps`` steps (node acquisition +
        boot is never free);
      * **churn cap** — ``policy.spare_churn_cap`` bounds the total number
        of re-spawned spares over the campaign (0 = unbounded).

    Spare ids keep growing monotonically above every id ever allocated, so
    a re-spawned spare can never demote a surviving master (the paper's
    lowest-rank master rule) — property-tested.
    """

    policy: LegioPolicy
    pool: SparePool
    next_id: int
    inflight: list[tuple[int, int]] = field(default_factory=list)  # (node, ready_step)
    spawned: int = 0               # total re-spawned over the campaign
    delivered: list[int] = field(default_factory=list)

    @staticmethod
    def for_pool(n_nodes: int, pool: SparePool,
                 policy: LegioPolicy) -> "SpareProvisioner":
        return SpareProvisioner(policy=policy, pool=pool,
                                next_id=n_nodes + pool.capacity)

    @property
    def enabled(self) -> bool:
        return self.policy.elastic_spares

    def _churn_budget(self) -> int:
        if self.policy.spare_churn_cap <= 0:
            return 10 ** 9
        return self.policy.spare_churn_cap - self.spawned

    def poll(self, step: int) -> list[int]:
        """Deliver due spares into the pool, then top up below-watermark
        capacity. Returns the node ids delivered this boundary."""
        if not self.enabled:
            return []
        ready = [n for n, rs in self.inflight if rs <= step]
        self.inflight = [(n, rs) for n, rs in self.inflight if rs > step]
        for node in ready:
            self.pool.restock(node)
            self.delivered.append(node)
        self.refill(step)
        return ready

    def refill(self, step: int) -> None:
        """Schedule replacements for below-watermark capacity. Also called
        after the backlog consumes freshly delivered spares, so replacement
        provisioning overlaps the healing splices' warmup instead of waiting
        a boundary."""
        if self.enabled:
            self._schedule(step)

    def _schedule(self, step: int) -> None:
        covered = len(self.pool.available) + len(self.inflight)
        if covered >= self.policy.spare_refill_watermark:
            return
        # never grow past the provisioned capacity: a watermark above
        # capacity triggers earlier, it does not raise the ceiling
        deficit = min(self.pool.capacity - covered, self._churn_budget())
        ready_step = step + self.policy.spare_provision_delay_steps
        for _ in range(max(deficit, 0)):
            self.inflight.append((self.next_id, ready_step))
            self.next_id += 1
            self.spawned += 1


@dataclass(frozen=True)
class SubstituteCostModel:
    """Substitution = the shrink teardown + an include of the spare into the
    surviving local comm + the checkpoint read for state restoration.
    The splice reuses S(x) (comm reconstruction is the same collective
    machinery ULFM's shrink pays for); the restore term models the
    restart-only-failed npz read, which overlaps repair in the non-blocking
    flavor and is charged only when it blocks."""

    shrink: ShrinkCostModel = field(default_factory=ShrinkCostModel)
    restore_seconds: float = 0.35      # one member shard read (§VII scale)

    def splice_cost(self, k: int) -> float:
        return self.shrink.s_of_x(k + 1)

    def substitution_cost(self, s: int, k: int, master_failed: bool,
                          *, blocking: bool = True) -> float:
        """Single failure in a k-legion: teardown + include of the spare
        into the k-1 survivors + (if blocking) the restore read."""
        base = self.shrink.hierarchical_cost(s, k, master_failed)
        return base + self.splice_cost(k - 1) + \
            (self.restore_seconds if blocking else 0.0)


@dataclass(frozen=True)
class PendingSubstitution:
    """A scheduled non-blocking splice: apply at the first step boundary
    with ``step >= ready_step``."""

    failed: int
    spare: int
    legion: int            # the failed node's home legion (assignment final)
    ready_step: int
    shards: tuple[int, ...] = ()   # the failed node's shards at fault time —
                                   # the splice returns exactly these


class SubstituteEngine:
    """Builds and applies substitution repair plans against a LegionTopology.

    Sibling of :class:`ShrinkEngine`: identical teardown plan, plus one
    ``substitute`` + ``restore`` stage per filled slot. Slots the pool
    cannot fill are shrunk (or, under strict mode, refused)."""

    def __init__(self, policy: LegioPolicy,
                 cost: SubstituteCostModel | None = None):
        self.policy = policy
        self.cost = cost or SubstituteCostModel()
        self._shrink = ShrinkEngine(policy, self.cost.shrink)

    # ---- plan construction -------------------------------------------------

    def plan(self, topo: LegionTopology, failed: set[int],
             substitutions: dict[int, int]) -> list[RepairStep]:
        """Teardown steps (the shrink plan) + splice steps per substitution."""
        steps = self._shrink.plan(topo, failed)
        for li, dead in sorted(failures_by_legion(topo, failed).items()):
            lg = next(l for l in topo.legions if l.index == li)
            # splice participants: the legion's survivors plus the spares
            # already spliced into it — the dead members are gone by then
            k_live = len(lg.members) - len(dead)
            spliced = 0
            for node in dead:
                spare = substitutions.get(node)
                if spare is None:
                    continue
                steps.append(RepairStep(
                    op="substitute", comm=f"local_{li}",
                    participants=(spare,),
                    cost_units=self.cost.splice_cost(k_live + spliced)))
                steps.append(RepairStep(
                    op="restore", comm=f"local_{li}",
                    participants=(spare,),
                    cost_units=self.cost.restore_seconds))
                spliced += 1
        return steps

    # ---- application -------------------------------------------------------

    def repair(self, topo: LegionTopology, failed: set[int], pool: SparePool,
               *, strict: bool | None = None) -> RepairReport:
        """Plan + mutate: splice spares into every failed slot the pool can
        cover, shrink the rest. ``strict`` (default: recovery_mode ==
        "substitute") raises :class:`SparePoolExhausted` instead of
        degrading."""
        if strict is None:
            strict = self.policy.recovery_mode == "substitute"
        with tracing.span("repair.substitute") as sp:
            present = [n for n in sorted(failed)
                       if n in topo.home and n in topo.nodes]
            pool.require(len(present), strict)
            substitutions: dict[int, int] = {}
            for node in present:
                spare = pool.take()
                if spare is None:
                    break
                substitutions[node] = spare

            steps = self.plan(topo, failed, substitutions)
            master_failed = master_failed_in(topo, set(present), steps)
            hierarchical = topo.n_legions > 1

            unfilled = []
            for node in present:
                if node in substitutions:
                    topo.substitute(node, substitutions[node])
                else:
                    topo.remove(node)
                    unfilled.append(node)
            topo.compact()
        mode = ("substitute" if not unfilled else "substitute_then_shrink")
        return RepairReport(
            trigger=tuple(sorted(failed)),
            hierarchical=hierarchical,
            master_failed=master_failed,
            steps=steps,
            model_cost=sum(st.cost_units for st in steps),
            wall_seconds=sp.seconds,
            survivors=topo.size,
            mode=mode,
            substitutions=tuple(sorted(substitutions.items())),
            unfilled=tuple(unfilled),
        )

    # ---- cost queries (benchmarks) -----------------------------------------

    def cost_substitute(self, s: int, k: int, master_failed: bool,
                        *, blocking: bool = True) -> float:
        return self.cost.substitution_cost(s, k, master_failed,
                                           blocking=blocking)

    def expected_repair_cost(self, s: int, k: int,
                             *, blocking: bool = True) -> float:
        """E[cost] under uniform failure probability, P(master) = 1/k."""
        p_master = 1.0 / max(k, 1)
        return (p_master * self.cost_substitute(s, k, True, blocking=blocking)
                + (1 - p_master)
                * self.cost_substitute(s, k, False, blocking=blocking))


def restore_for_substitute(checkpointer, legion: int, failed: int,
                           *, template: PyTree | None = None) -> PyTree | None:
    """Checkpoint-backed state restoration for a substituted rank: load the
    *dead member's* shard (restart-only-failed — the spare takes over the
    failed node's identity, data shards included). Returns None when no
    checkpoint covers the member yet (fresh run, or the legion was created
    after the last snapshot)."""
    if checkpointer is None:
        return None
    try:
        return checkpointer.restore_failed_member(legion, failed,
                                                  template=template)
    except (FileNotFoundError, KeyError):
        return None


@dataclass(frozen=True)
class RestoreOutcome:
    """What the restore ladder produced for one splice."""

    state: PyTree | None
    source: str              # "peer" | "checkpoint" | "none"
    cost_seconds: float      # simulated warm-up charge for the path taken


def restore_member_state(cluster, legion: int, failed: int, *,
                         template: PyTree | None = None) -> RestoreOutcome:
    """Peer-first restore ladder for a substituted rank (O(shard) fast path).

    1. Ask the dead member's surviving POV-ring buddy for the in-memory
       replica (``cluster.replicator``): a dict lookup plus one simulated
       cross-member transfer — O(shard), independent of model and cluster
       size — with the replica's checksums re-verified before use.
    2. On correlated loss (buddy dead too — a rack outage spanning adjacent
       legions), a missing replica, or a checksum mismatch, fall back to the
       O(model-size) store read (:func:`restore_for_substitute`).

    ``RestartRecord.source`` distinguishes the paths ("peer" vs
    "checkpoint"); ``cost_seconds`` is what the splice's restore stage
    should charge — the link-model transfer for a peer hit, the cost
    model's ``restore_seconds`` for a store read.
    """
    from repro_torch.checkpoint.replicate import (
        ReplicaIntegrityError,
        ReplicaUnavailable,
    )
    from repro_torch.core.cr import RestartRecord

    replicator = getattr(cluster, "replicator", None)
    if replicator is not None and replicator.enabled:
        try:
            state, served = replicator.restore(failed, cluster.topo,
                                               cluster.failed)
        except (ReplicaUnavailable, ReplicaIntegrityError):
            pass                     # fall through to the store
        else:
            if cluster.checkpointer is not None:
                cluster.checkpointer.restarts.append(RestartRecord(
                    node=failed, legion=legion, step=served.step,
                    source="peer"))
            return RestoreOutcome(state, "peer", served.transfer_seconds)
    state = restore_for_substitute(cluster.checkpointer, legion, failed,
                                   template=template)
    return RestoreOutcome(
        state, "checkpoint" if state is not None else "none",
        cluster.substitute.cost.restore_seconds)
