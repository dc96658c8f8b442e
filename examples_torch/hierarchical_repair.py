"""Anatomy of a hierarchical repair (paper §V, Fig. 3) — narrated.

Builds the paper's exact topology figure (16 processes, k=4), kills a
master, and prints every repair stage with its communicator, participants,
and S(x) model cost — then compares against the flat shrink, sweeps the
cluster size to show the crossover the paper derives in Eq. 2, and shows
the N-level generalization: the same master fault at depth 3 repairs a
bounded subtree instead of dragging in every master.

  PYTHONPATH=src python examples_torch/hierarchical_repair.py
"""
from repro_torch.core import LegioPolicy, ShrinkCostModel, ShrinkEngine
from repro_torch.core.hierarchy import LegionTopology
from repro_torch.core.policy import optimal_k_linear


def main() -> None:
    topo = LegionTopology.build(list(range(16)), 4)
    print("topology: 16 nodes, k=4")
    for lg in topo.legions:
        print(f"  legion {lg.index}: members {lg.members} "
              f"(master {lg.master}, POV {topo.pov(lg.index)})")

    eng = ShrinkEngine(LegioPolicy(), ShrinkCostModel(p=1.0))
    victim = topo.legions[1].master
    print(f"\nkilling node {victim} — master of legion 1. Repair plan:")
    report = eng.repair(topo, {victim})
    for i, step in enumerate(report.steps):
        print(f"  {i + 1}. {step.op:8s} on {step.comm:9s} "
              f"participants={list(step.participants)} "
              f"S(x) cost={step.cost_units:.4f}s")
    print(f"total model cost {report.model_cost:.4f}s "
          f"vs flat shrink {eng.cost_flat(16):.4f}s")
    print(f"new master of legion 1: {topo.legion_of(victim + 1).master}")

    print("\nexpected repair cost vs cluster size (Eq. 1, P(master)=1/k):")
    print(f"{'s':>6} {'k*':>4} {'flat S(s)':>10} {'E[R_H]':>10} {'win':>6}")
    for s in (16, 64, 256, 1024, 4096):
        k = optimal_k_linear(s)
        flat = eng.cost_flat(s)
        hier = eng.expected_repair_cost(s, k)
        print(f"{s:6d} {k:4d} {flat:10.3f} {hier:10.3f} "
              f"{flat / hier:5.1f}x")

    # -- the N-level generalization: scoped repair at depth 3 ---------------
    deep = LegionTopology.build(list(range(64)), 4, depth=3)
    victim = deep.legions[-1].master            # master of legion 15 only
    scope = deep.partition_scopes({victim})[0]
    print(f"\ndepth-3 topology (64 nodes, k=4): killing node {victim} "
          f"(a legion master)")
    print(f"  repair scope: {scope.summary()}")
    print(f"  comms touched: {list(scope.groups)}")
    print("  every node outside those comms keeps computing — at depth 2 "
          "the same fault\n  would shrink the 16-master global_comm; flat, "
          "all 63 survivors")


if __name__ == "__main__":
    main()
