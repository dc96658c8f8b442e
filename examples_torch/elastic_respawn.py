"""Elastic spare re-spawn — healing a spare-exhausted campaign.

PR 1 left a gap (ROADMAP): the SparePool is provisioned once at cluster
start, so a campaign with more faults than spares ends up degraded forever
under substitute_then_shrink. The SpareProvisioner closes it — the
MPI_Comm_spawn analogue:

  * when the warm pool drains below ``spare_refill_watermark``, replacement
    spares are scheduled (acquiring + booting a node takes
    ``spare_provision_delay_steps`` steps — never free);
  * ``spare_churn_cap`` bounds total re-spawns over the campaign;
  * delivered spares feed back through the SparePool, and slots that had to
    be shrunk during exhaustion (the backlog) heal through the same
    pending-splice path as a non-blocking substitution — assignment
    finality and the lowest-rank master rule hold by construction.

Run:
  PYTHONPATH=src python examples_torch/elastic_respawn.py               # on the card
  PYTHONPATH=src python examples_torch/elastic_respawn.py --device cpu  # without one
"""
import argparse

import numpy as np

from repro_torch.core import FaultInjector, LegioExecutor, LegioPolicy, VirtualCluster


def work(node, shard, step):
    return np.ones(1) * (shard + 1)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    n = 16
    policy = LegioPolicy(
        legion_size=4,
        recovery_mode="substitute_then_shrink",
        spare_nodes=2,                   # provisioned once at start
        spare_refill_watermark=2,        # re-spawn when the pool dips below 2
        spare_provision_delay_steps=2,   # node acquisition + boot
        spare_churn_cap=8,               # never spawn more than 8 replacements
    )
    # 4 simultaneous faults against 2 warm spares: exhaustion by design
    injector = FaultInjector.at([(2, 1), (2, 2), (2, 5), (2, 9)])
    cl = VirtualCluster(n, policy=policy, injector=injector, device=args.device)
    ex = LegioExecutor(cl, work)

    print(f"--- {n} nodes, {len(cl.spare_pool)} warm spares, "
          f"4 faults due at step 2 ---")
    for step in range(12):
        r = ex.run_step()
        notes = []
        if r.failed_now:
            notes.append(f"failed={list(r.failed_now)}")
        if r.repair:
            notes.append(f"repair={r.repair.mode} "
                         f"unfilled={list(r.repair.unfilled)}")
        if r.respawned:
            notes.append(f"re-spawned spares {list(r.respawned)} delivered")
        if r.expanded:
            notes.append(f"healed slots {list(r.expanded)}")
        state = (f"step {r.step}: {len(r.results)}/{n} computing, "
                 f"pool={cl.spare_pool.available or '[]'}")
        print(state + ("   " + "; ".join(notes) if notes else ""))

    print(f"--- campaign over: topology {cl.topo.size}/{n} nodes, "
          f"{cl.plan.active_shards}/{n} shards/step, "
          f"{cl.provisioner.spawned} spares re-spawned "
          f"(cap {policy.spare_churn_cap}) ---")
    assert cl.topo.size == n and cl.plan.active_shards == n
    print("full capacity restored — the exhausted campaign healed itself")


if __name__ == "__main__":
    main()
