"""Shrink engine: repair plans and the S(x) cost model (paper §V, Fig. 3).

ULFM's ``MPIX_Comm_shrink`` requires *all* processes of the shrunk
communicator to participate; its empirical cost ``S(x)`` grows between
linearly and quadratically with the participant count x (Fenix/LFLR
measurements cited by the paper). The hierarchical topology bounds the
participant set:

    R_H(s, k) = S(k) + 2·S(k+1) + S(s/k)   if a master failed      (Eq. 1)
              = S(k)                        otherwise
    vs. flat:  R_F(s) = S(s)

Repair plan for a failed master (paper Fig. 3):
  1. shrink the failed master's local_comm (its members noticed);
  2. the predecessor's master *notifies* its POV (they could not notice
     directly), then that POV shrinks;
  3. shrink the successor POV (contains the failed master directly);
  4. shrink the global_comm;
  5. *promote* the new lowest rank of the orphaned legion to master and
     *include* it into the global_comm (via the successor POV link);
  6. update the predecessor POV with the new master.

In this framework "shrink" = rebuild the participant set's collective
topology + reshard + (possibly) recompile (the mesh manager comes with
the multi-card slice). The engine
returns a :class:`RepairReport` carrying both the *model* cost (S(x) sum,
simulated seconds) and the measured wall-clock of our repair path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.core.hierarchy import LegionTopology
from repro_torch.core.policy import LegioPolicy
from repro_torch.core.types import RepairReport, RepairStep


@dataclass(frozen=True)
class ShrinkCostModel:
    """S(x) — calibrated between the linear and quadratic empirical bounds.

    ``s_of_x(x) = a·x^p + c``: with p=1 the paper's linear hypothesis, p=2
    the quadratic one. Defaults follow the paper's Fig. 10 scale (~seconds
    for hundreds of ranks; a is per-rank cost, c the constant agreement+
    revoke overhead).
    """

    a: float = 2.5e-3      # per-rank^p seconds
    p: float = 1.0         # 1 = linear (paper's configured hypothesis)
    c: float = 0.12        # constant term: revoke + agree + comm-create

    def s_of_x(self, x: int) -> float:
        if x <= 0:
            return 0.0
        return self.a * (float(x) ** self.p) + self.c

    def flat_cost(self, s: int) -> float:
        return self.s_of_x(s)

    def hierarchical_cost(self, s: int, k: int, master_failed: bool) -> float:
        """Eq. 1. ``s/k`` is the global_comm size (#legions)."""
        if not master_failed:
            return self.s_of_x(k)
        n_masters = max(1, round(s / max(k, 1)))
        return self.s_of_x(k) + 2.0 * self.s_of_x(k + 1) + self.s_of_x(n_masters)


def master_failed_in(topo: LegionTopology, failed: set[int],
                     steps: list[RepairStep]) -> bool:
    """Did this repair lose a master? Hierarchical plans carry an explicit
    promote step; flat topologies need the direct check (shared by the
    shrink and substitute engines — must be evaluated BEFORE mutation)."""
    return any(st.op == "promote" for st in steps) or (
        topo.n_legions == 1
        and any(topo.is_master(n) for n in failed if n in topo.home))


def failures_by_legion(topo: LegionTopology, failed: set[int]) -> dict[int, list[int]]:
    """Group the failed nodes still present in the topology by legion index
    (simultaneous failures fold legion-by-legion — shared by the shrink and
    substitute engines)."""
    by_legion: dict[int, list[int]] = {}
    for node in sorted(failed):
        if node in topo.home and any(node in lg.members for lg in topo.legions):
            by_legion.setdefault(topo.legion_of(node).index, []).append(node)
    return by_legion


class ShrinkEngine:
    """Builds and applies repair plans against a LegionTopology."""

    def __init__(self, policy: LegioPolicy, cost: ShrinkCostModel | None = None):
        self.policy = policy
        self.cost = cost or ShrinkCostModel()

    # ---- plan construction -------------------------------------------------

    def plan(self, topo: LegionTopology, failed: set[int]) -> list[RepairStep]:
        """Repair steps for the failed set under the current topology.

        Multi-failure: the paper treats each failure independently; we fold
        simultaneous failures legion-by-legion (one local shrink per affected
        legion; master steps only for legions that lost their master).

        Scoped repair (Rocco & Palermo): a master failure climbs the levels
        of the recursive topology exactly as far as the dead node held
        masterships — at each affected level the ring neighbours' POVs and
        the *parent group's* comm shrink, never the whole master set. At
        depth 2 the parent group IS the paper's global_comm, reproducing
        Fig. 3 verbatim; at depth >= 3 the participant count is bounded by
        O(k·depth), independent of the cluster size.
        """
        steps: list[RepairStep] = []
        hierarchical = topo.n_legions > 1
        if not hierarchical:
            survivors = tuple(n for n in topo.nodes if n not in failed)
            steps.append(RepairStep(
                op="shrink", comm="world", participants=survivors,
                cost_units=self.cost.s_of_x(topo.size),
            ))
            return steps

        for li, dead in sorted(failures_by_legion(topo, failed).items()):
            lg = next(l for l in topo.legions if l.index == li)
            local_survivors = tuple(n for n in lg.members if n not in failed)
            # 1. local shrink — members noticed directly
            steps.append(RepairStep(
                op="shrink", comm=f"local_{li}", participants=local_survivors,
                cost_units=self.cost.s_of_x(len(lg.members)),
            ))
            if lg.master not in dead:
                continue
            dead_master = lg.master
            level, idx = 0, li
            group_members: tuple[int, ...] = tuple(lg.members)
            promoted: int | None = None    # child master promoted one level down
            while level < topo.depth - 1:
                ring = topo.groups(level)
                k_here = len(group_members)
                succ = None
                if len(ring) > 1:
                    pred = topo.predecessor_at(level, idx)
                    succ = topo.successor_at(level, idx)
                    # 2. predecessor master notifies its POV, then it shrinks
                    pred_pov = tuple(n for n in topo.pov_at(level, pred.index)
                                     if n not in failed)
                    steps.append(RepairStep(
                        op="notify", comm=topo.pov_name(level, pred.index),
                        participants=(pred.master,), cost_units=0.0,
                    ))
                    steps.append(RepairStep(
                        op="shrink", comm=topo.pov_name(level, pred.index),
                        participants=pred_pov,
                        cost_units=self.cost.s_of_x(k_here + 1),
                    ))
                    # 3. own POV shrink (contains the failed master directly)
                    own_pov = tuple(n for n in topo.pov_at(level, idx)
                                    if n not in failed)
                    steps.append(RepairStep(
                        op="shrink", comm=topo.pov_name(level, idx),
                        participants=own_pov,
                        cost_units=self.cost.s_of_x(k_here + 1),
                    ))
                # 4. parent comm shrink — the scope boundary: only the group
                #    that contains the fault, not every master in the cluster
                parent = topo.parent_of(level, idx)
                parent_comm = topo.comm_name(level + 1, parent.index)
                steps.append(RepairStep(
                    op="shrink", comm=parent_comm,
                    participants=tuple(m for m in parent.members
                                       if m not in failed),
                    cost_units=self.cost.s_of_x(len(parent.members)),
                ))
                # 5. promote + include the new master (via succ POV link).
                #    At level >= 1 the master promoted one level down has
                #    just joined this group, so it competes for mastership.
                survivors_here = tuple(n for n in group_members
                                       if n not in failed)
                if promoted is not None:
                    survivors_here = tuple(sorted({*survivors_here, promoted}))
                if survivors_here:
                    new_master = min(survivors_here)
                    promoted = new_master
                    steps.append(RepairStep(
                        op="promote", comm=topo.comm_name(level, idx),
                        participants=(new_master,), cost_units=0.0,
                    ))
                    include = ((new_master, succ.master) if succ is not None
                               else (new_master,))
                    steps.append(RepairStep(
                        op="include", comm=parent_comm,
                        participants=include, cost_units=0.0,
                    ))
                if parent.master != dead_master:
                    break
                # the dead node also mastered the parent group — the repair
                # continues one level up (and only there)
                level, idx = level + 1, parent.index
                group_members = parent.members
        return steps

    # ---- application ---------------------------------------------------------

    def repair(self, topo: LegionTopology, failed: set[int]) -> RepairReport:
        """Plan + mutate the topology. Returns the report (plan, costs, wall)."""
        t0 = time.perf_counter()
        steps = self.plan(topo, failed)
        master_failed = master_failed_in(topo, failed, steps)
        hierarchical = topo.n_legions > 1
        for node in sorted(failed):
            if node in topo.home and any(node in lg.members for lg in topo.legions):
                topo.remove(node)
        topo.compact()
        wall = time.perf_counter() - t0
        return RepairReport(
            trigger=tuple(sorted(failed)),
            hierarchical=hierarchical,
            master_failed=master_failed,
            steps=steps,
            model_cost=sum(st.cost_units for st in steps),
            wall_seconds=wall,
            survivors=topo.size,
        )

    def cost_flat(self, s: int) -> float:
        return self.cost.flat_cost(s)

    def cost_hierarchical(self, s: int, k: int, master_failed: bool) -> float:
        return self.cost.hierarchical_cost(s, k, master_failed)

    def expected_repair_cost(self, s: int, k: int) -> float:
        """E[R_H] under uniform failure probability: P(master) = 1/k."""
        p_master = 1.0 / max(k, 1)
        return (p_master * self.cost.hierarchical_cost(s, k, True)
                + (1 - p_master) * self.cost.hierarchical_cost(s, k, False))
