"""Core vocabulary of the Legio runtime.

Terminology follows the paper (§III):

  * a node *notices* a fault when an operation it participates in returns
    ``PROC_FAILED`` (our :class:`OpStatus`);
  * a communicator is *faulty* when a member has failed but nobody noticed;
  * a communicator is *failed* once a member noticed.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"       # missed heartbeats, not yet agreed failed
    FAILED = "failed"
    STRAGGLER = "straggler"   # alive but slower than median * threshold
    SPARE = "spare"           # standby, can regrow a legion (elastic)


class OpStatus(enum.Enum):
    OK = "ok"
    PROC_FAILED = "proc_failed"    # MPIX_ERR_PROC_FAILED analogue
    REVOKED = "revoked"            # communicator revoked


class FailureKind(enum.Enum):
    CRASH = "crash"          # permanent node loss
    STRAGGLE = "straggle"    # performance fault (soft-failed by policy)


@dataclass(frozen=True)
class FailureEvent:
    node: int
    step: int
    kind: FailureKind = FailureKind.CRASH


class FaultSource(enum.Enum):
    """Detection channel a fault signal arrived on (pipeline detect stage)."""

    COLLECTIVE = "collective"    # PROC_FAILED surfaced by a collective op
    HEARTBEAT = "heartbeat"      # HeartbeatDetector.sweep timeout
    STRAGGLER = "straggler"      # StragglerDetector soft-fail
    INJECTED = "injected"        # ground-truth feed (trainer/driver sims)


PIPELINE_STAGES = ("detect", "notice", "agree", "plan", "apply")


@dataclass(frozen=True)
class RepairScope:
    """The minimal subtree of the N-level topology whose members must
    participate in one repair (Rocco & Palermo: confine reparation to the
    communicators that actually contain the fault).

    ``groups`` lists the ``(level, group index)`` comms the repair touches;
    ``participants`` is the union of those comms' surviving members — the
    only nodes that enter the repair path. Nodes outside ``participants``
    (healthy subtrees) keep progressing while this scope repairs. Scopes in
    one pipeline drain have pairwise-disjoint participants by construction
    (``LegionTopology.partition_scopes`` merges overlapping ones), which is
    what makes their repairs concurrent.
    """

    verdict: tuple[int, ...]             # failed nodes this scope covers
    level: int                           # highest level the repair reaches
    groups: tuple[tuple[int, int], ...]  # (level, group index) comms touched
    participants: tuple[int, ...]        # surviving nodes that take part

    @property
    def n_participants(self) -> int:
        return len(self.participants)

    @property
    def legions(self) -> tuple[int, ...]:
        """Level-0 legion indices inside the scope."""
        return tuple(gi for lvl, gi in self.groups if lvl == 0)

    def summary(self) -> str:
        return (f"scope(level={self.level}, legions={list(self.legions)}, "
                f"participants={self.n_participants})")


@dataclass(frozen=True)
class FaultEvent:
    """One fault signal flowing through the FaultPipeline.

    Unlike :class:`FailureEvent` (the injector's ground-truth schedule), a
    FaultEvent is *observational*: it records what some channel saw, before
    noticing semantics and agreement have run.
    """

    nodes: tuple[int, ...]
    step: int
    source: FaultSource
    kind: FailureKind = FailureKind.CRASH
    op: str | None = None        # collective op that surfaced it (COLLECTIVE)
    root: int | None = None      # the op's root, for bcast noticing
    participants: tuple[int, ...] | None = None  # the op's member set; None
                                 # = resolve against the topology at drain
    # who holds this suspicion (correlated-failure channel): None keeps the
    # historical semantics — every live node reads the coordinator state.
    # A network partition is the asymmetric case: each side suspects the
    # *other* side, so its event carries only that side's observers, and
    # agreement (the union over LIVE observers) is what makes the fenced
    # side's accusations moot — both sides converge on one verdict.
    observers: tuple[int, ...] | None = None


class ChaosAction(enum.Enum):
    """What one timed event of a fault campaign does to the cluster
    (:mod:`repro_torch.core.faultmodel` presets emit these; the
    :class:`~repro_torch.core.chaos.ChaosHarness` applies them)."""

    CRASH = "crash"            # ground-truth node death (FaultInjector)
    SUSPECT = "suspect"        # one-sided suspicion held by `observers` only
    SLOWDOWN = "slowdown"      # inflate a node's observed step latency
    FLAP_RETURN = "flap_return"  # a repaired-out node tries to come back


@dataclass(frozen=True)
class RecoveryAction:
    """Terminal outcome of one pipeline drain: the agreed verdict plus the
    repair the active RecoveryStrategy applied for it. Exactly one terminal
    action exists per agreed-failed node (property-tested)."""

    step: int
    verdict: tuple[int, ...]
    strategy: str                          # registry key of the strategy
    sources: tuple[FaultSource, ...]
    report: "RepairReport | None" = None
    terminal: bool = True
    stage_seconds: dict[str, float] = field(default_factory=dict)
    # the subtree this action repaired; one drain emits one terminal action
    # per disjoint scope, so faults in unrelated subtrees land as separate,
    # concurrently-applied actions
    scope: RepairScope | None = None
    # the repair's clock charge was deferred to a background window
    # (LegioPolicy.repair_overlap): the structure mutated eagerly, but the
    # scope's participants stay busy until the window's finish_sim passes
    overlapped: bool = False


@dataclass(frozen=True)
class PipelineTrace:
    """Per-drain stage-latency record (benchmarks read these)."""

    step: int
    n_events: int
    verdict: tuple[int, ...]
    stage_seconds: dict[str, float] = field(default_factory=dict)


@dataclass
class RepairStep:
    """One stage of a repair plan (a shrink, a notify, a promote, or a
    spare splice)."""
    op: str                      # shrink | notify | promote | include | substitute | restore
    comm: str                    # local_<i> | pov_<i> | global | world
    participants: tuple[int, ...]
    cost_units: float = 0.0      # S(x) model cost of this stage


@dataclass
class RepairReport:
    trigger: tuple[int, ...]             # failed nodes handled by this repair
    hierarchical: bool
    master_failed: bool
    steps: list[RepairStep] = field(default_factory=list)
    model_cost: float = 0.0              # sum of S(x) stage costs (sim seconds)
    wall_seconds: float = 0.0            # measured runtime of our repair path
    recompiled: bool = False
    survivors: int = 0
    mode: str = "shrink"                 # recovery mode that produced this plan
    substitutions: tuple[tuple[int, int], ...] = ()   # (failed, spare) splices
    unfilled: tuple[int, ...] = ()       # failed slots shrunk for lack of spares
    scope: RepairScope | None = None     # subtree the repair was confined to
    repair_participants: int = 0         # survivors that entered the repair
                                         # path (0 = unscoped/legacy repair)

    @property
    def substitution_map(self) -> dict[int, int]:
        return dict(self.substitutions)

    def summary(self) -> str:
        kind = "hierarchical" if self.hierarchical else "flat"
        role = "master" if self.master_failed else "worker"
        sub = f" subs={list(self.substitutions)}" if self.substitutions else ""
        scoped = (f" participants={self.repair_participants}"
                  if self.scope is not None else "")
        return (f"[repair/{kind}/{self.mode}] failed={list(self.trigger)} "
                f"role={role} stages={len(self.steps)} "
                f"model_cost={self.model_cost:.4f}s "
                f"wall={self.wall_seconds * 1e3:.2f}ms "
                f"survivors={self.survivors}{sub}{scoped}")


@dataclass
class BackgroundRepair:
    """One in-flight overlapped repair window (revoke-then-repair).

    The structural repair has already landed (topology mutated, detector
    confirmed, report recorded) — what is *deferred* is the repair's clock
    charge: the scope occupies the simulated interval
    ``[start_sim, finish_sim]`` while healthy subtrees keep computing.
    Until the cluster clock passes ``finish_sim`` the scope's surviving
    ``participants`` are busy: collective schedules exclude them and their
    p2p envelopes stay pending in the ledger (never discarded — they were
    posted to live nodes). ``VirtualCluster.reconcile_repairs`` merges the
    window back at the first ``Session`` boundary whose clock has passed
    ``finish_sim`` — by construction with zero residual wait, so a repair
    shorter than one step of compute is fully hidden.
    """

    scope: RepairScope
    report: RepairReport
    start_step: int
    start_sim: float
    finish_sim: float

    @property
    def busy(self) -> tuple[int, ...]:
        """Surviving nodes occupied by this repair for the window."""
        return self.scope.participants

    def done(self, now: float) -> bool:
        return self.finish_sim <= now + 1e-12

    def residual(self, now: float) -> float:
        """Sim-seconds of the repair not yet hidden behind compute."""
        return max(0.0, self.finish_sim - now)


@dataclass
class ClusterClock:
    """Simulated time accumulator (repair cost model) + real wall time.

    Overlapped repairs split their cost into the part *absorbed* behind
    concurrent compute (never added to ``sim_seconds``) and the *residual*
    the application actually waited for (charged like any other cost) —
    the chaos harness asserts ``residual_seconds == 0`` for disjoint-scope
    overlap runs: healthy subtrees never pay for a remote scope's repair.
    """

    sim_seconds: float = 0.0
    hidden_seconds: float = 0.0      # overlapped repair cost fully absorbed
    residual_seconds: float = 0.0    # overlapped repair cost waited out

    def charge(self, seconds: float) -> None:
        self.sim_seconds += seconds

    def absorb(self, seconds: float) -> None:
        self.hidden_seconds += seconds

    def wait(self, seconds: float) -> None:
        self.residual_seconds += seconds
        self.sim_seconds += seconds
