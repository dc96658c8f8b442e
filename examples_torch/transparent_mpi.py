"""Transparency, demonstrated: an unmodified "plain MPI" loop survives faults.

The paper's claim is that Legio removes *any* integration effort — the app
is written as if nothing ever fails, and the interposition layer behind the
MPI calls repairs the communicator mid-call. The loop below is exactly that
program shape: init a session, compute a local value per rank, allreduce,
repeat. There is **zero fault-handling code in the loop body** — no
try/except, no topology inspection, no repair calls — yet three nodes
(including a legion master) die mid-run and every allreduce completes with
the survivors' exact sum. A point-to-point ring exchange rides along to
show the fault-aware non-collective layer: the ring re-closes around the
dead nodes without a single special case in the app.

  PYTHONPATH=src python examples_torch/transparent_mpi.py               # on the card
  PYTHONPATH=src python examples_torch/transparent_mpi.py --device cpu  # without one
"""
import argparse

import numpy as np

from repro_torch.core import FaultInjector, LegioPolicy
from repro_torch.mpi import Session

STEPS = 10


def local_work(rank: int, step: int) -> np.ndarray:
    """Any embarrassingly parallel kernel; here: rank's share of a sum."""
    return np.array([float(rank + 1), 1.0])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    # --- the ONLY Legio-aware lines: choosing the cluster + fault script ---
    session = Session(
        16,
        policy=LegioPolicy(legion_size=4),
        injector=FaultInjector.at([(2, 9), (5, 4), (7, 11)]),  # 4 is a master
        device=args.device,
    )

    # --- from here on: a plain MPI program -------------------------------
    comm = session.world
    print(f"world size {comm.size}")
    for step in range(STEPS):
        session.advance(step)                     # MPI apps: time passing
        contributions = {
            rank: local_work(rank, step)
            for rank in session.cluster.live_nodes  # ranks that run code
        }
        res = comm.allreduce(contributions)
        total, count = res.data[comm.members[0]]
        print(f"step {step}: sum={total:.0f} over {count:.0f} ranks "
              f"(world size {comm.size})")

    # p2p epilogue: each rank passes a token to its ring successor — the
    # ring is over whatever members survived, no app-side bookkeeping
    members = comm.members
    for i, rank in enumerate(members):
        comm.send(rank, members[(i + 1) % len(members)], f"token-from-{rank}")
    handed = sum(
        comm.probe(rank, members[i - 1]) and
        comm.recv(rank, members[i - 1]).startswith("token")
        for i, rank in enumerate(members)
    )
    print(f"\nring exchange: {handed}/{len(members)} tokens delivered, "
          f"ledger conserved={comm.ledger.conserved()}")

    survivors = comm.size
    print(f"final: {survivors}/16 nodes survive; "
          f"{comm.stats.repair_rounds} faults repaired inside MPI calls; "
          f"loop body contains zero fault-handling code")
    assert survivors == 13 and handed == 13
    session.finalize()


if __name__ == "__main__":
    main()
