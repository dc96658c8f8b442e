"""Quickstart: fault-resilient execution in ~40 lines.

An embarrassingly parallel job (estimate pi by Monte Carlo) runs on a
16-node virtual cluster. Two nodes die mid-run — including a legion master.
The application code below never mentions faults: the LegioExecutor detects,
agrees, repairs, and the estimate converges anyway (on fewer samples —
the paper's "approximate result" trade-off).

  PYTHONPATH=src python examples_torch/quickstart.py               # on the card
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu  # without one
"""
import argparse

import numpy as np

from repro_torch.core import FaultInjector, LegioExecutor, LegioPolicy, VirtualCluster

SAMPLES_PER_SHARD = 100_000


def throw_darts(node: int, shard: int, step: int) -> np.ndarray:
    """[hits, throws] for one shard — pure function of (shard, step)."""
    rng = np.random.default_rng(shard * 1_000_003 + step)
    xy = rng.uniform(-1, 1, (SAMPLES_PER_SHARD, 2))
    hits = np.sum(np.sum(xy * xy, axis=1) <= 1.0)
    return np.array([hits, SAMPLES_PER_SHARD], dtype=np.float64)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cluster = VirtualCluster(
        16,
        policy=LegioPolicy(legion_size=4),
        injector=FaultInjector.at([(3, 9), (6, 4)]),   # node 4 is a master
        device=args.device,
    )
    executor = LegioExecutor(cluster, throw_darts)

    hits = throws = 0.0
    for step in range(10):
        report = executor.run_step()
        hits += report.reduced[0]
        throws += report.reduced[1]
        status = ""
        if report.repair:
            role = "MASTER" if report.repair.master_failed else "worker"
            status = (f"  <- repaired {role} failure of node "
                      f"{report.failed_now}, {report.repair.survivors} survive")
        print(f"step {step}: pi ~= {4 * hits / throws:.5f} "
              f"({int(throws):,} samples){status}")

    err = abs(4 * hits / throws - np.pi)
    print(f"\nfinal: pi ~= {4 * hits / throws:.5f} (|err| = {err:.2e}) "
          f"with {len(cluster.live_nodes)}/16 nodes surviving")
    assert err < 5e-3


if __name__ == "__main__":
    main()
