"""ChaosHarness — run workloads under correlated-failure campaigns and
judge them by invariants, not by survival.

A chaos campaign (:mod:`repro_torch.core.faultmodel`) is pure data; this module
is the machinery that applies it to a live workload and scores the run.
Two drivers share one invariant suite:

  * **train** — a :class:`LegioExecutor` stepping an allreduce workload
    (the paper's training shape: the step-final collective is the fault
    trap);
  * **serve** — a :class:`~repro_torch.serve.engine.ServeEngine` dispatching
    micro-batched requests (the at-least-once/exactly-once surface).

The pass/fail bar is the invariant checklist, evaluated during and after
the run (every ``InvariantCheck`` must hold):

  * **topology coherence** after every drain that repaired something:
    rings closed at every level, a unique master path from every node to
    the single root, member indices coherent;
  * **ledger conservation** on every registered comm:
    ``posted == delivered + discarded + pending``;
  * **one-terminal-action-per-fault**: no node is repaired twice across
    the whole campaign (partition convergence never double-repairs);
  * **exactly-once serving accounting** (serve driver): every submitted
    request id ends in exactly one of completed / parked / abandoned /
    still-pending, and completions are write-once;
  * **scenario-specific postconditions**: rack repairs stay inside their
    top-level subtree with zero healthy-subtree participants, a fenced
    partition's verdict is exactly the minority, a flapped node's stale
    return is refused by the heartbeat epoch guard, a cascade's repairs
    never spill past the primary's scope.

Recovery setups reuse the serving presets (shrink / substitute /
nonblocking / overlap / adaptive — ``repro_torch.serve.engine.recovery_preset``),
so the chaos matrix and the serving benchmarks judge the same
configurations. Chaos clusters run with synthetic replica heartbeats
(``ShardReplicator.heartbeat_every``): even without a checkpointer, small
replica pushes ride the session ledger every other step, so the ledger
conservation invariant is exercised with replication traffic in flight
when a fault lands.
The overlap column (background revoke-then-repair) adds its own invariant:
**zero healthy-subtree sim-clock charge during a disjoint-scope repair** —
``ClusterClock.residual_seconds`` stays 0.0 for the whole campaign, i.e.
every overlapped repair window hid entirely behind the healthy subtrees'
own compute and nobody ever waited on a remote scope's recovery.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.executor import LegioExecutor, VirtualCluster
from repro_torch.core.faultmodel import FaultCampaign, FaultModel
from repro_torch.core.hierarchy import LegionTopology
from repro_torch.core.policy import LegioPolicy
from repro_torch.core.types import ChaosAction, FaultSource, NodeState, RecoveryAction

__all__ = ["ChaosHarness", "ChaosReport", "InvariantCheck",
           "check_topology_coherence"]

RECOVERIES = ("shrink", "substitute", "nonblocking", "overlap", "adaptive")

# synthetic latency fed for a SLOWDOWN target: the straggler detector's
# min_latency floor times the event factor — above the floor and far above
# the healthy median, below it for factor <= 1
_SLOW_BASE = 0.05


@dataclass(frozen=True)
class InvariantCheck:
    name: str
    ok: bool
    detail: str = ""


@dataclass
class ChaosReport:
    """One (scenario, workload, recovery) chaos run, scored by invariants."""

    scenario: str
    workload: str                        # train | serve
    recovery: str   # shrink | substitute | nonblocking | overlap | adaptive
    seed: int
    n_nodes: int
    checks: list[InvariantCheck] = field(default_factory=list)
    counts: dict = field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def failures(self) -> list[InvariantCheck]:
        return [c for c in self.checks if not c.ok]

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario, "workload": self.workload,
            "recovery": self.recovery, "seed": self.seed,
            "n_nodes": self.n_nodes, "passed": self.passed,
            "checks": [{"name": c.name, "ok": c.ok,
                        **({"detail": c.detail} if not c.ok else {})}
                       for c in self.checks],
            "counts": dict(self.counts),
        }

    def summary(self) -> str:
        verdict = "PASS" if self.passed else "FAIL"
        bad = "" if self.passed else \
            " [" + ", ".join(c.name for c in self.failures) + "]"
        return (f"[{verdict}] {self.scenario}/{self.workload}/"
                f"{self.recovery} n={self.n_nodes} "
                f"checks={len(self.checks)}{bad}")


def check_topology_coherence(topo: LegionTopology,
                             label: str = "topology_coherent"
                             ) -> InvariantCheck:
    """Rings closed at every level, unique master path to a single root,
    coherent member indices — the structural half of the paper's
    properties (a)–(c), checked on the live post-repair topology."""
    problems: list[str] = []
    nodes = topo.nodes
    if not nodes:
        return InvariantCheck(label, False, "topology is empty")
    root = min(nodes)
    if set(topo._by_member) != set(nodes):
        problems.append("_by_member index drifted from the member set")
    if not set(nodes) <= set(topo.home):
        problems.append("home map is missing members")
    for node in nodes:
        chain = topo.master_chain(node)
        if chain[-1] != root:
            problems.append(f"master chain of {node} ends at {chain[-1]}, "
                            f"not the root {root}")
            break
    for level in range(max(topo.depth - 1, 1)):
        idxs = [g.index for g in topo.groups(level)]
        if not idxs:
            continue
        cur, seen = idxs[0], []
        for _ in idxs:
            seen.append(cur)
            cur = topo.successor_at(level, cur).index
        if cur != idxs[0] or sorted(seen) != sorted(idxs):
            problems.append(f"successor ring open at level {level}")
        if any(topo.predecessor_at(level,
                                   topo.successor_at(level, gi).index).index
               != gi for gi in idxs):
            problems.append(f"pred/succ disagree at level {level}")
    for level in range(1, topo.depth):
        child_masters = sorted(g.members[0] for g in topo.groups(level - 1))
        members = sorted(m for g in topo.groups(level) for m in g.members)
        if child_masters != members:
            problems.append(f"level {level} membership is not the child "
                            f"masters")
    return InvariantCheck(label, not problems, "; ".join(problems[:3]))


class ChaosHarness:
    """Applies a :class:`FaultCampaign` to a live workload and scores it."""

    def __init__(self, policy: LegioPolicy | None = None, seed: int = 0,
                 *, device: str = "cuda"):
        self.policy = policy or LegioPolicy()
        self.seed = seed
        # the torch data plane's device for every cluster the harness builds
        # ("cuda" by default, which raises without a card; "cpu" on the host)
        self.device = device
        self.model = FaultModel(self.policy, seed=seed)

    def _policy_for(self, recovery: str) -> LegioPolicy:
        from repro_torch.serve.engine import recovery_preset
        return replace(self.policy, **recovery_preset(recovery))

    # -- campaign application ----------------------------------------------

    def _apply_chaos(self, campaign: FaultCampaign, cluster: VirtualCluster,
                     step: int, checks: list[InvariantCheck],
                     state: dict) -> None:
        """Apply this step's non-CRASH events (CRASH rides the injector)
        and sustain active slowdowns while their targets live. ``state``
        carries the cross-step bookkeeping: active slowdown factors and
        flap returns waiting for their repair."""
        slow = state.setdefault("slow", {})
        flaps = state.setdefault("flaps", [])
        for e in campaign.at(step):
            if e.action is ChaosAction.SUSPECT:
                cluster.pipeline.observe_suspicion(e.observers, e.nodes,
                                                   step=step)
            elif e.action is ChaosAction.SLOWDOWN:
                for n in e.nodes:
                    slow[n] = e.factor
            elif e.action is ChaosAction.FLAP_RETURN:
                flaps.extend(e.nodes)
        # a flap models "comes back after the repair already evicted it":
        # the stale return lands once the node is confirmed FAILED. Under
        # serving an idle victim may only be confirmed by the heartbeat
        # timeout several rounds later — the node keeps knocking until then
        for n in list(flaps):
            if cluster.detector.states.get(n) is NodeState.FAILED:
                self._apply_flap(cluster, n, checks)
                flaps.remove(n)
        for n in list(slow):
            if n in cluster.topo.nodes and n not in cluster.failed:
                cluster.straggler.observe(n, _SLOW_BASE * slow[n])
            else:
                del slow[n]          # soft-failed or repaired out: done

    @staticmethod
    def _apply_flap(cluster: VirtualCluster, node: int,
                    checks: list[InvariantCheck]) -> None:
        """A repaired-out node announces itself with its old identity: a
        stale beat plus a stale (epoch-less) re-registration. Both must
        bounce off the HeartbeatDetector's epoch guard."""
        det = cluster.detector
        now = cluster.clock.sim_seconds
        resurrected = det.register(node, now)           # stale: no epoch
        det.beat(node, now)                             # stale beat
        still_dead = (det.states.get(node) is NodeState.FAILED
                      and node not in cluster.topo.nodes)
        checks.append(InvariantCheck(
            "flap_stale_return_refused", (not resurrected) and still_dead,
            f"node {node}: register -> {resurrected}, "
            f"state {det.states.get(node)}"))

    # -- shared invariant suite --------------------------------------------

    @staticmethod
    def _one_terminal_action(actions: list[RecoveryAction]
                             ) -> InvariantCheck:
        seen: dict[int, int] = {}
        for a in actions:
            for n in a.verdict:
                seen[n] = seen.get(n, 0) + 1
        dup = sorted(n for n, c in seen.items() if c != 1)
        return InvariantCheck(
            "one_terminal_action_per_fault", not dup,
            f"nodes repaired more than once: {dup[:5]}")

    @staticmethod
    def _check_flaps_landed(campaign: FaultCampaign, state: dict,
                            checks: list[InvariantCheck]) -> None:
        """Every scheduled flap return must have been applied (victim got
        confirmed FAILED within the run) — a no-op for other scenarios."""
        if any(e.action is ChaosAction.FLAP_RETURN for e in campaign.events):
            leftover = state.get("flaps", [])
            checks.append(InvariantCheck(
                "flap_return_landed", not leftover,
                f"victims never confirmed failed, so the stale return was "
                f"never exercised: {leftover}"))

    @staticmethod
    def _ledgers_conserved(session) -> InvariantCheck:
        bad = [repr(c) for c in session._comms if not c.ledger.conserved()]
        return InvariantCheck(
            "message_ledgers_conserved", not bad,
            f"posted != delivered+discarded+pending on {bad[:2]}")

    @staticmethod
    def _overlap_checks(recovery: str, cluster: VirtualCluster,
                        actions: list[RecoveryAction]
                        ) -> list[InvariantCheck]:
        """Overlap-column invariants: every repair actually deferred its
        charge to a background window, and no healthy subtree was ever
        charged for a disjoint scope's repair (zero residual wait — the
        windows all hid behind the workload's own sim-clock progress)."""
        if recovery != "overlap":
            return []
        clock = cluster.clock
        blocking = [a for a in actions
                    if a.report is not None and not a.overlapped]
        return [
            InvariantCheck(
                "repairs_ran_overlapped", not blocking,
                f"{len(blocking)} repair(s) charged synchronously under "
                f"the overlap preset (steps "
                f"{sorted({a.step for a in blocking})[:4]})"),
            InvariantCheck(
                "healthy_subtree_clock_unaffected",
                clock.residual_seconds == 0.0,
                f"{clock.residual_seconds:.4f} sim-s of repair residual "
                f"charged to the clock during disjoint-scope repairs "
                f"(hidden={clock.hidden_seconds:.4f})"),
        ]

    def _scenario_checks(self, campaign: FaultCampaign,
                         actions: list[RecoveryAction],
                         cluster: VirtualCluster,
                         workload: str) -> list[InvariantCheck]:
        repaired = {n for a in actions for n in a.verdict}
        m, out = campaign.meta, []
        if campaign.scenario == "independent":
            out.append(InvariantCheck(
                "all_victims_repaired", set(m["victims"]) <= repaired,
                f"missing {sorted(set(m['victims']) - repaired)}"))
            out.append(InvariantCheck(
                "no_collateral_repairs", repaired <= set(m["victims"]),
                f"extra {sorted(repaired - set(m['victims']))}"))
        elif campaign.scenario == "rack_outage":
            rack_members = {n for r in m["racks"] for n in r["members"]}
            out.append(InvariantCheck(
                "racks_fully_repaired", rack_members == repaired,
                f"diff {sorted(rack_members ^ repaired)[:6]}"))
            if workload == "train":
                # the step-final collective makes every survivor notice at
                # once, so disjoint racks resolve in a single drain; under
                # serving, idle rack members surface later through the
                # heartbeat channel — one-drain is a train-only guarantee
                steps = {a.step for a in actions}
                out.append(InvariantCheck(
                    "racks_resolved_in_one_drain", len(steps) == 1,
                    f"drains at steps {sorted(steps)}"))
            # participants must stay inside the rack's own top-level
            # subtree — healthy subtrees contribute exactly zero
            sides = FaultModel._subtree_members(
                self.model._topo(campaign.n_nodes))
            outside = 0
            for a in actions:
                rack = next((r for r in m["racks"]
                             if set(a.verdict) <= set(r["members"])), None)
                if rack is None or a.scope is None:
                    continue
                # spares (ids >= n) spliced into the rack's own slots are
                # subtree members by assignment — only original nodes can
                # witness cross-subtree participation
                outside += len(
                    {p for p in a.scope.participants
                     if p < campaign.n_nodes} - set(sides[rack["subtree"]]))
            out.append(InvariantCheck(
                "healthy_subtree_participation_zero", outside == 0,
                f"{outside} participants outside the faulty subtree"))
            # concurrency is claimed per drain: scopes emitted at the same
            # step must have pairwise-disjoint participants (sequential
            # drains may legitimately reuse survivors)
            by_step: dict[int, list[set[int]]] = {}
            for a in actions:
                if a.scope is not None:
                    by_step.setdefault(a.step, []).append(
                        set(a.scope.participants))
            disjoint = all(
                not (parts[i] & parts[j])
                for parts in by_step.values()
                for i in range(len(parts)) for j in range(i + 1, len(parts)))
            out.append(InvariantCheck(
                "rack_scopes_disjoint_per_drain", disjoint,
                "same-drain scope participant sets overlap"))
        elif campaign.scenario == "network_partition":
            minority, majority = set(m["minority"]), set(m["majority"])
            if m["fenced"]:
                out.append(InvariantCheck(
                    "verdict_is_exactly_the_minority", repaired == minority,
                    f"diff {sorted(repaired ^ minority)[:6]}"))
            else:
                # unfenced: the agree stage's majority quorum resolves the
                # split — the minority is condemned exactly once, never the
                # other way around and never both sides
                out.append(InvariantCheck(
                    "minority_repaired_at_most_once",
                    all(sum(1 for a in actions if n in a.verdict) <= 1
                        for n in minority),
                    "a minority node appears in two terminal verdicts"))
            out.append(InvariantCheck(
                "majority_never_repaired", not (repaired & majority),
                f"majority nodes repaired: "
                f"{sorted(repaired & majority)[:6]}"))
        elif campaign.scenario == "transient_flap":
            victim = m["victim"]
            times = sum(1 for a in actions if victim in a.verdict)
            out.append(InvariantCheck(
                "victim_repaired_exactly_once", times == 1,
                f"victim {victim} repaired {times} times"))
            out.append(InvariantCheck(
                "victim_stays_out", victim not in cluster.topo.nodes,
                f"victim {victim} is back in the topology"))
            spliced = {s for r in cluster.repairs
                       for _, s in r.substitutions}
            out.append(InvariantCheck(
                "flap_identity_never_reused_as_spare",
                victim not in spliced,
                f"victim {victim} spliced back in as a spare"))
        elif campaign.scenario == "cascade":
            expected = {m["primary"]} | set(m["secondaries"])
            out.append(InvariantCheck(
                "primary_repaired", m["primary"] in repaired,
                f"primary {m['primary']} never repaired"))
            soft = any(FaultSource.STRAGGLER in a.sources for a in actions)
            out.append(InvariantCheck(
                "secondary_straggler_softfails_fired",
                soft or not m["secondaries"],
                "no STRAGGLER-sourced action despite slowdown targets"))
            out.append(InvariantCheck(
                "no_repairs_outside_primary_scope", repaired <= expected,
                f"extra {sorted(repaired - expected)[:6]}"))
        return out

    # -- drivers -------------------------------------------------------------

    def run_train(self, scenario: str, n_nodes: int,
                  recovery: str = "shrink", steps: int | None = None,
                  **knobs) -> ChaosReport:
        """Drive a training workload (allreduce each step) under the
        campaign; the step-final collective is the fault trap."""
        campaign = self.model.campaign(scenario, n_nodes, **knobs)
        pol = self._policy_for(recovery)
        cluster = VirtualCluster(n_nodes, policy=pol,
                                 injector=campaign.injector(),
                                 device=self.device)
        # synthetic replica pushes every other step: the ledger conservation
        # invariant must hold with replication traffic in flight
        cluster.replicator.heartbeat_every = 2
        ex = LegioExecutor(cluster, work_fn=lambda node, shard, step: 1.0)
        checks: list[InvariantCheck] = []
        actions: list[RecoveryAction] = []
        cluster.pipeline.add_listener(actions.append)
        state: dict = {}
        horizon = steps if steps is not None else campaign.horizon + 6
        for step in range(horizon):
            self._apply_chaos(campaign, cluster, step, checks, state)
            report = ex.run_step(step)
            if report.actions:
                checks.append(check_topology_coherence(
                    cluster.topo, f"topology_coherent_step{step}"))
        checks.append(check_topology_coherence(cluster.topo))
        checks.append(self._one_terminal_action(actions))
        checks.append(self._ledgers_conserved(ex.session))
        self._check_flaps_landed(campaign, state, checks)
        checks.extend(self._scenario_checks(campaign, actions, cluster,
                                            "train"))
        checks.extend(self._overlap_checks(recovery, cluster, actions))
        return ChaosReport(
            scenario=scenario, workload="train", recovery=recovery,
            seed=self.seed, n_nodes=n_nodes, checks=checks,
            counts={
                "steps": horizon,
                "events": len(campaign.events),
                "actions": len(actions),
                "repaired": sorted({n for a in actions for n in a.verdict}),
                "repairs": len(cluster.repairs),
                "survivors": len(cluster.live_nodes),
                "sim_seconds": round(cluster.clock.sim_seconds, 6),
                "hidden_seconds": round(cluster.clock.hidden_seconds, 6),
                "residual_seconds": round(cluster.clock.residual_seconds, 6),
            })

    def run_serve(self, scenario: str, n_nodes: int,
                  recovery: str = "shrink", requests: int | None = None,
                  **knobs) -> ChaosReport:
        """Drive a serving workload under the campaign; the per-round
        result gather is the fault trap, and the exactly-once ledger is
        part of the pass bar."""
        import math as _math

        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.traffic import Arrival

        campaign = self.model.campaign(scenario, n_nodes, **knobs)
        pol = self._policy_for(recovery)
        cluster = VirtualCluster(n_nodes, policy=pol,
                                 injector=campaign.injector(),
                                 device=self.device)
        cluster.replicator.heartbeat_every = 2
        engine = ServeEngine(
            cluster, work_fn=lambda node, batch, step:
            {r.rid: r.rid for r in batch})
        total = requests if requests is not None else 3 * n_nodes
        checks: list[InvariantCheck] = []
        actions: list[RecoveryAction] = []
        cluster.pipeline.add_listener(actions.append)
        state: dict = {}
        # unlike training, serving has no all-hands collective: a victim
        # that dies with no dispatched batch only surfaces through the
        # heartbeat timeout, so the round loop must outlive it
        horizon = campaign.horizon + 4 + int(
            pol.heartbeat_timeout / pol.step_sim_seconds)
        per_round = max(1, total // horizon)
        submitted = 0
        for step in range(horizon):
            if submitted < total:
                batch = min(per_round, total - submitted)
                # alternate payload-less one-tick requests with multi-tick
                # decode-heavy ones, so decode-state migration is exercised
                # by every scenario x recovery cell, not just the benchmark
                engine.submit([
                    Arrival(user=i, slo_class="batch",
                            slo_seconds=_math.inf, prefill_ticks=1,
                            decode_ticks=3) if i % 2 else None
                    for i in range(batch)])
                submitted += batch
            self._apply_chaos(campaign, cluster, step, checks, state)
            report = engine.run_round(step)
            if report.actions:
                checks.append(check_topology_coherence(
                    cluster.topo, f"topology_coherent_step{step}"))
        # drain the backlog to a quiescent state, then account for every id
        drain = engine.serve(max_rounds=50 + 4 * horizon)
        checks.append(check_topology_coherence(cluster.topo))
        checks.append(self._one_terminal_action(actions))
        checks.append(self._ledgers_conserved(engine.session))
        accounted = (len(engine.completed) + len(engine.metrics.parked)
                     + len(engine.metrics.abandoned)
                     + len(engine.metrics.shed) + engine.pending)
        checks.append(InvariantCheck(
            "exactly_once_accounting", accounted == submitted,
            f"{accounted} accounted for, {submitted} submitted "
            f"(completed={len(engine.completed)}, "
            f"parked={len(engine.metrics.parked)}, "
            f"abandoned={len(engine.metrics.abandoned)}, "
            f"shed={len(engine.metrics.shed)}, "
            f"pending={engine.pending})"))
        # decode-state migration must never double-complete: one completion
        # record per client-visible id, migrated or not
        comp_rids = [r.rid for r in engine.metrics.completions]
        checks.append(InvariantCheck(
            "completions_unique", len(comp_rids) == len(set(comp_rids))
            and len(comp_rids) == len(engine.completed),
            f"{len(comp_rids)} completion records over "
            f"{len(set(comp_rids))} unique ids "
            f"({engine.metrics.migrations} migrations)"))
        self._check_flaps_landed(campaign, state, checks)
        checks.extend(self._scenario_checks(campaign, actions, cluster,
                                            "serve"))
        checks.extend(self._overlap_checks(recovery, cluster, actions))
        return ChaosReport(
            scenario=scenario, workload="serve", recovery=recovery,
            seed=self.seed, n_nodes=n_nodes, checks=checks,
            counts={
                "rounds": horizon + drain.rounds,
                "events": len(campaign.events),
                "actions": len(actions),
                "submitted": submitted,
                "completed": len(engine.completed),
                "requeues": engine.metrics.requeues,
                "duplicates_suppressed":
                    engine.metrics.duplicates_suppressed,
                "migrations": engine.metrics.migrations,
                "decode_ticks_preserved":
                    engine.metrics.decode_ticks_preserved,
                "survivors": len(cluster.live_nodes),
                "hidden_seconds": round(cluster.clock.hidden_seconds, 6),
                "residual_seconds": round(cluster.clock.residual_seconds, 6),
            })

    # -- the matrix ----------------------------------------------------------

    def run_matrix(self, n_nodes: int,
                   scenarios: tuple[str, ...] = FaultModel.SCENARIOS,
                   recoveries: tuple[str, ...] = RECOVERIES,
                   workloads: tuple[str, ...] = ("train", "serve"),
                   ) -> list[ChaosReport]:
        """Every (scenario × recovery × workload) cell — the benchmark's
        and CI's pass bar is ``all(r.passed for r in ...)``."""
        out = []
        for scenario in scenarios:
            for recovery in recoveries:
                if "train" in workloads:
                    out.append(self.run_train(scenario, n_nodes,
                                              recovery=recovery))
                if "serve" in workloads:
                    out.append(self.run_serve(scenario, n_nodes,
                                              recovery=recovery))
        return out
