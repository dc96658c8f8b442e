"""FaultModel — seeded, correlated-failure campaigns from named scenarios.

Every fault the stack injected before this module was an independent
single-node death, but the paper's target clusters fail in *patterns*:
racks lose power, switches gray-fail into partitions, flapping nodes
come back after the repair already evicted them, and a repair's own load
pushes neighbours over the straggler threshold. "To Repair or Not to
Repair" (PAPERS.md) argues a recovery policy can only be judged against
realistic fault distributions; this module generates them, determin-
istically, as data — a :class:`FaultCampaign` is a seeded, replayable
list of timed :class:`ChaosEvent`\\ s that the
:class:`~repro_torch.core.chaos.ChaosHarness` applies against a live
``Session``-driven workload.

Scenario presets (``FaultModel.SCENARIOS``):

``independent``
    Today's baseline: uncorrelated single-node deaths, one per step,
    covering ``LegioPolicy.chaos_fault_fraction`` of the cluster.
``rack_outage``
    A whole legion dies at once — the failure domain the topology was
    aligned with. The rack is resolved against the *initial* topology
    via :meth:`LegionTopology.subtree_of` and deliberately chosen to be
    an **interior** legion (its master is not also the parent group's
    master), so the repair stays confined to one top-level subtree and
    healthy subtrees contribute exactly zero participants. Multiple
    racks land in distinct top-level subtrees → disjoint RepairScopes
    in one drain.
``network_partition``
    A switch splits the cluster: each side suspects the *other* side,
    emitted as one-sided :attr:`ChaosAction.SUSPECT` events whose
    ``observers`` field carries only that side's membership (the
    correlated channel ``FaultPipeline.observe_suspicion`` feeds).
    With ``chaos_partition_fence`` the minority side is also crashed
    (ground truth) — agreement's union over *live* observers then kills
    the minority's symmetric accusation and both sides converge on one
    verdict. Unfenced symmetric suspicion is the documented hazard: the
    union would bury everyone (see docs/fault-models.md).
``transient_flap``
    A node crashes, is repaired out, then *returns*
    ``chaos_flap_delay_steps`` later (:attr:`ChaosAction.FLAP_RETURN`)
    and tries to re-register with its old identity — the event the
    :class:`HeartbeatDetector` epoch guard must refuse, and which must
    not consume :class:`SpareProvisioner` churn-cap budget.
``cascade``
    A primary master crash whose repair load pushes
    ``chaos_cascade_victims`` of the *would-be scope participants* over
    the straggler threshold (:attr:`ChaosAction.SLOWDOWN` inflates
    their observed latencies by ``chaos_cascade_slowdown``) — secondary
    soft-fails surface through the STRAGGLER channel in later drains.

Campaigns are pure data and reproducible: the generator is
``np.random.default_rng((seed, scenario, n))`` — the same
:class:`FaultModel` produces byte-identical campaigns for the same
arguments, across processes and runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.detector import FaultInjector
from repro_torch.core.hierarchy import LegionTopology, make_topology
from repro_torch.core.policy import LegioPolicy
from repro_torch.core.types import ChaosAction, FailureEvent, FailureKind

__all__ = ["ChaosEvent", "FaultCampaign", "FaultModel"]


@dataclass(frozen=True)
class ChaosEvent:
    """One timed campaign event. ``nodes`` are the targets; ``observers``
    is non-empty only for SUSPECT (who holds the one-sided suspicion);
    ``factor`` only matters for SLOWDOWN (latency multiplier)."""

    step: int
    action: ChaosAction
    nodes: tuple[int, ...]
    observers: tuple[int, ...] = ()
    factor: float = 1.0


@dataclass(frozen=True)
class FaultCampaign:
    """A replayable, seeded schedule of correlated chaos events."""

    scenario: str
    seed: int
    n_nodes: int
    events: tuple[ChaosEvent, ...]
    meta: dict = field(default_factory=dict)

    @property
    def horizon(self) -> int:
        """Last step any event fires at (drive the workload past this)."""
        return max((e.step for e in self.events), default=0)

    @property
    def crashed(self) -> tuple[int, ...]:
        """Ground-truth dead nodes across the whole campaign."""
        return tuple(sorted({n for e in self.events
                             if e.action is ChaosAction.CRASH
                             for n in e.nodes}))

    def at(self, step: int) -> list[ChaosEvent]:
        return [e for e in self.events if e.step == step]

    def injector(self) -> FaultInjector:
        """The CRASH events as a ground-truth :class:`FaultInjector`
        schedule (the non-crash actions are applied by the harness
        through their own channels)."""
        return FaultInjector([
            FailureEvent(node=n, step=e.step, kind=FailureKind.CRASH)
            for e in self.events if e.action is ChaosAction.CRASH
            for n in e.nodes])

    def summary(self) -> str:
        kinds = {}
        for e in self.events:
            kinds[e.action.value] = kinds.get(e.action.value, 0) + 1
        parts = ", ".join(f"{v}×{k}" for k, v in sorted(kinds.items()))
        return (f"campaign({self.scenario}, seed={self.seed}, "
                f"n={self.n_nodes}, events=[{parts}])")


class FaultModel:
    """Generates :class:`FaultCampaign`\\ s from named scenario presets.

    Scenario knobs come from the policy's ``chaos_*`` fields; per-call
    keyword overrides (e.g. ``racks=2``) refine a single campaign.
    """

    SCENARIOS = ("independent", "rack_outage", "network_partition",
                 "transient_flap", "cascade")

    def __init__(self, policy: LegioPolicy | None = None, seed: int = 0):
        self.policy = policy or LegioPolicy()
        self.seed = seed

    def campaign(self, scenario: str, n_nodes: int, *, at_step: int = 3,
                 **knobs) -> FaultCampaign:
        if scenario not in self.SCENARIOS:
            raise ValueError(f"unknown scenario {scenario!r}; "
                             f"choose from {self.SCENARIOS}")
        if n_nodes < 2:
            raise ValueError("chaos campaigns need at least 2 nodes")
        rng = np.random.default_rng(
            (self.seed, self.SCENARIOS.index(scenario), n_nodes))
        events, meta = getattr(self, f"_{scenario}")(
            rng, n_nodes, at_step, **knobs)
        events = tuple(sorted(events, key=lambda e: (e.step, e.action.value,
                                                     e.nodes)))
        return FaultCampaign(scenario=scenario, seed=self.seed,
                            n_nodes=n_nodes, events=events, meta=meta)

    # -- shared topology resolution ---------------------------------------

    def _topo(self, n: int) -> LegionTopology:
        """The *initial* topology the campaign targets are resolved
        against — chaos is scheduled before the workload starts, exactly
        like a real fault plan drawn against the cluster's rack map."""
        return make_topology(list(range(n)), self.policy)

    @staticmethod
    def _interior_legions(topo: LegionTopology) -> list[tuple[int, int]]:
        """``(legion index, top-level subtree)`` for every legion that is
        strictly interior to its level-1 parent group: not the first child
        (its master would also hold the parent mastership, so its death
        climbs out of the subtree) and not the last child (its successor
        POV at level 0 would pull the next group's master in). Killing a
        strictly interior legion keeps every repair participant inside one
        top-level subtree — the property the rack scenario (and the
        healthy-subtree-participation = 0 acceptance bar) is built on."""
        if topo.depth <= 1:
            return []
        out = []
        for parent in topo.levels()[0]:          # level-1 groups
            first, last = min(parent.children), max(parent.children)
            out.extend((ci, topo.subtree_of(ci))
                       for ci in parent.children
                       if ci != first and ci != last)
        return out

    @staticmethod
    def _subtree_members(topo: LegionTopology) -> dict[int, list[int]]:
        """Top-level subtree index -> sorted member node ids."""
        sides: dict[int, list[int]] = {}
        for lg in topo.legions:
            sides.setdefault(topo.subtree_of(lg.index),
                             []).extend(lg.members)
        return {st: sorted(ms) for st, ms in sides.items()}

    # -- presets ------------------------------------------------------------

    def _independent(self, rng, n: int, at_step: int,
                     fraction: float | None = None):
        """Uncorrelated single-node deaths — the pre-PR-6 baseline."""
        frac = (self.policy.chaos_fault_fraction if fraction is None
                else fraction)
        count = min(max(1, round(frac * n)), n - 2)
        victims = sorted(int(v) for v in
                         rng.choice(np.arange(1, n), size=count,
                                    replace=False))
        events = [ChaosEvent(step=at_step + i, action=ChaosAction.CRASH,
                             nodes=(v,))
                  for i, v in enumerate(victims)]
        return events, {"victims": victims}

    def _rack_outage(self, rng, n: int, at_step: int, racks: int = 1):
        """Whole-legion death, rack = interior legion, one distinct
        top-level subtree per rack — disjoint scopes in a single drain."""
        topo = self._topo(n)
        cands = self._interior_legions(topo)
        if not cands:
            raise ValueError(
                f"rack_outage needs a hierarchical topology with interior "
                f"legions (n={n} builds depth {topo.depth} with "
                f"{topo.n_legions} legions)")
        by_subtree: dict[int, list[int]] = {}
        for li, st in cands:
            by_subtree.setdefault(st, []).append(li)
        if racks > len(by_subtree):
            raise ValueError(
                f"{racks} racks need {racks} distinct top-level subtrees "
                f"with interior legions; only {len(by_subtree)} available")
        subtrees = sorted(int(s) for s in
                          rng.choice(sorted(by_subtree), size=racks,
                                     replace=False))
        chosen, members_of = [], {}
        for st in subtrees:
            li = int(rng.choice(sorted(by_subtree[st])))
            chosen.append(li)
            members_of[li] = list(next(lg.members for lg in topo.legions
                                       if lg.index == li))
        events = [ChaosEvent(step=at_step, action=ChaosAction.CRASH,
                             nodes=tuple(members_of[li]))
                  for li in chosen]
        return events, {"racks": [
            {"legion": li, "subtree": st, "members": members_of[li]}
            for li, st in zip(chosen, subtrees)]}

    def _network_partition(self, rng, n: int, at_step: int,
                           fence: bool | None = None):
        """Two-sided suspicion across a subtree boundary; the minority is
        fenced (crashed) so agreement can converge."""
        fence = (self.policy.chaos_partition_fence if fence is None
                 else fence)
        topo = self._topo(n)
        sides = self._subtree_members(topo)
        root_master = min(topo.nodes)
        cands = sorted(st for st, ms in sides.items()
                       if root_master not in ms)
        if cands:
            minority_st = int(rng.choice(cands))
            minority = sides[minority_st]
            meta_side = {"subtree": minority_st}
        else:
            # flat / single-subtree cluster: partition a random quarter off
            count = max(1, n // 4)
            pool = np.asarray([x for x in topo.nodes if x != root_master])
            minority = sorted(int(v) for v in
                              rng.choice(pool, size=min(count, len(pool)),
                                         replace=False))
            meta_side = {"subtree": None}
        majority = sorted(set(topo.nodes) - set(minority))
        events = [
            ChaosEvent(step=at_step, action=ChaosAction.SUSPECT,
                       nodes=tuple(minority), observers=tuple(majority)),
            ChaosEvent(step=at_step, action=ChaosAction.SUSPECT,
                       nodes=tuple(majority), observers=tuple(minority)),
        ]
        if fence:
            events.append(ChaosEvent(step=at_step, action=ChaosAction.CRASH,
                                     nodes=tuple(minority)))
        return events, {"minority": minority, "majority": majority,
                        "fenced": fence, **meta_side}

    def _transient_flap(self, rng, n: int, at_step: int,
                        delay: int | None = None):
        """Crash, repair-out, then a stale return the epoch guard must
        refuse — and which must not burn SpareProvisioner churn budget."""
        delay = (self.policy.chaos_flap_delay_steps if delay is None
                 else delay)
        topo = self._topo(n)
        workers = [m for lg in topo.legions for m in lg.members
                   if m != lg.master]
        pool = workers or [m for m in topo.nodes if m != min(topo.nodes)]
        victim = int(rng.choice(np.asarray(sorted(pool))))
        return_step = at_step + delay
        events = [
            ChaosEvent(step=at_step, action=ChaosAction.CRASH,
                       nodes=(victim,)),
            ChaosEvent(step=return_step, action=ChaosAction.FLAP_RETURN,
                       nodes=(victim,)),
        ]
        return events, {"victim": victim, "return_step": return_step}

    def _cascade(self, rng, n: int, at_step: int,
                 victims: int | None = None, slowdown: float | None = None):
        """Primary master crash whose repair load slows scope neighbours
        past the straggler threshold — secondary soft-fails follow."""
        victims = (self.policy.chaos_cascade_victims if victims is None
                   else victims)
        slowdown = (self.policy.chaos_cascade_slowdown if slowdown is None
                    else slowdown)
        topo = self._topo(n)
        interior = self._interior_legions(topo)
        if interior:
            li = int(rng.choice(sorted(l for l, _ in interior)))
            primary = next(lg.master for lg in topo.legions
                           if lg.index == li)
        else:
            pool = [m for m in topo.nodes if m != min(topo.nodes)]
            primary = int(rng.choice(np.asarray(pool)))
        scope = topo.partition_scopes({primary})[0]
        pool = np.asarray(scope.participants)
        count = min(victims, len(pool))
        secondaries = sorted(int(v) for v in
                             rng.choice(pool, size=count, replace=False)
                             ) if count else []
        events = [ChaosEvent(step=at_step, action=ChaosAction.CRASH,
                             nodes=(primary,))]
        if secondaries:
            events.append(ChaosEvent(
                step=at_step, action=ChaosAction.SLOWDOWN,
                nodes=tuple(secondaries), factor=float(slowdown)))
        return events, {"primary": primary, "secondaries": secondaries,
                        "scope_participants": list(scope.participants),
                        "slowdown": float(slowdown)}
