"""Warm spare pool walkthrough — shrink vs substitute vs non-blocking.

Runs the same 16-node / one-fault scenario under the three recovery modes
and narrates what each does at the repair seam:

  shrink                — the paper's discard-and-continue: node 5's shard
                          is gone, every later step computes 15/16 of the
                          batch;
  substitute            — a warm spare from the pool splices into node 5's
                          legion slot during the repair; the next step is
                          back at 16/16;
  non-blocking          — the fault step repairs by shrink (cheap), the
                          spare warms up for one step, then the topology
                          re-expands at the next boundary — repair overlaps
                          useful work.

Then it exhausts the pool to show the substitute_then_shrink fallback.

  PYTHONPATH=src python examples_torch/spare_pool.py               # on the card
  PYTHONPATH=src python examples_torch/spare_pool.py --device cpu  # without one
"""
import argparse

import numpy as np

from repro_torch.core import (
    FaultInjector,
    LegioExecutor,
    LegioPolicy,
    VirtualCluster,
)

N, VICTIM, FAULT_STEP, STEPS = 16, 5, 2, 6
FULL = sum(range(1, N + 1))


def work(node, shard, step):
    return np.ones(1) * (shard + 1)


def narrate(mode: str, policy: LegioPolicy, device: str) -> None:
    cl = VirtualCluster(N, policy=policy,
                        injector=FaultInjector.at([(FAULT_STEP, VICTIM)]),
                        device=device)
    ex = LegioExecutor(cl, work)
    print(f"\n--- recovery_mode={mode} "
          f"(pool: {cl.spare_pool.available or 'none'}) ---")
    for _ in range(STEPS):
        r = ex.run_step()
        line = (f"step {r.step}: reduce={float(r.reduced[0]):6.1f}/{FULL} "
                f"shards={cl.plan.active_shards:2d}/{N}")
        if r.repair is not None:
            line += (f"  REPAIR {r.repair.mode}: "
                     f"survivors={r.repair.survivors}"
                     + (f" spliced={list(r.repair.substitutions)}"
                        if r.repair.substitutions else "")
                     + f" cost={r.repair.model_cost:.3f}s")
        if r.expanded:
            line += f"  RE-EXPANDED {list(r.expanded)} (warmup done)"
        print(line)
    print(f"final: {cl.topo.size} nodes, "
          f"{len(cl.spare_pool)} spare(s) left, "
          f"total repair cost {sum(rep.model_cost for rep in cl.repairs):.3f}s")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    print(f"{N}-node cluster, node {VICTIM} dies at step {FAULT_STEP}")

    narrate("shrink", LegioPolicy(legion_size=4), args.device)
    narrate("substitute", LegioPolicy(
        legion_size=4, recovery_mode="substitute", spare_fraction=0.25), args.device)
    narrate("substitute (non-blocking)", LegioPolicy(
        legion_size=4, recovery_mode="substitute_then_shrink",
        nonblocking_substitution=True, spare_warmup_steps=1,
        spare_fraction=0.25), args.device)

    # pool exhaustion: two faults, one spare — second slot shrinks
    print("\n--- substitute_then_shrink with an undersized pool ---")
    cl = VirtualCluster(
        N,
        policy=LegioPolicy(legion_size=4,
                           recovery_mode="substitute_then_shrink",
                           spare_nodes=1),
        injector=FaultInjector.at([(1, 1), (3, 2)]), device=args.device)
    ex = LegioExecutor(cl, work)
    for r in ex.run(5):
        if r.repair is not None:
            print(f"step {r.step}: {r.repair.summary()}")
    print(f"final: {cl.topo.size}/{N} nodes — first fault substituted, "
          f"second shrunk (pool exhausted); the run never stopped")


if __name__ == "__main__":
    main()
