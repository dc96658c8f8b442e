"""Virtual-screening fleet: the paper's §VI docking scenario, end to end.

A database of "molecules" is scored against a target by a fleet of nodes
running batched model inference (the screening surrogate is a real model
forward pass — scores are logits energies). Nodes fail mid-screen; Legio
discards them, re-queues their in-flight work (REBALANCE) and the screen
completes with the full database scored — or, with --drop, with exactly the
dead nodes' slices missing (the paper's DROP trade-off).

  PYTHONPATH=src python examples_torch/fleet_screening.py
  PYTHONPATH=src python examples_torch/fleet_screening.py --drop

Add ``--device cpu`` to serve without a card.
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import FaultInjector, LegioPolicy, VirtualCluster
from repro_torch.launch.serve import ResilientServer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--drop", action="store_true",
                    help="abandon failed nodes' requests (paper DROP)")
    ap.add_argument("--molecules", type=int, default=96)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("llama3.2-3b")
    cluster = VirtualCluster(
        args.nodes, policy=LegioPolicy(legion_size=4),
        injector=FaultInjector.at([(1, 2), (2, 6)]), device=args.device)
    server = ResilientServer(
        cfg, cluster, prompt_len=24, decode_tokens=4, batch_per_node=4,
        requeue=not args.drop, device=args.device)

    print(f"[screen] {args.molecules} molecules over {args.nodes} nodes "
          f"({'DROP' if args.drop else 'REBALANCE'} policy), "
          f"2 failures scheduled")
    t0 = time.perf_counter()
    rep = server.run(args.molecules)
    dt = time.perf_counter() - t0

    # "docking scores": mean logit energy of each molecule's generated tokens
    scores = {rid: float(np.mean(tokens)) for rid, tokens in
              server.completed.items()}
    top = sorted(scores.items(), key=lambda kv: kv[1])[:5]
    print(f"[screen] {rep['completed']} scored, {rep['abandoned']} abandoned, "
          f"{rep['survivors']}/{args.nodes} nodes survive, "
          f"{rep['repairs']} repairs, {dt:.1f}s")
    print("[screen] top-5 candidates:", [rid for rid, _ in top])

    if args.drop:
        assert rep["completed"] + rep["abandoned"] == args.molecules
        print("[screen] DROP: result is a valid screen of the surviving slices")
    else:
        assert rep["completed"] == args.molecules
        print("[screen] REBALANCE: full database screened despite failures")


if __name__ == "__main__":
    main()
