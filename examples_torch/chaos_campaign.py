"""Run a chaos campaign against the recovery stack — narrated.

Picks one or more named fault-model presets (the "correlated-failure
zoo" of :mod:`repro_torch.core.faultmodel`), replays each against both a
training and a serving workload under the selected recovery modes, and
prints the invariant checks the harness applies after every drain:
exactly-once serving accounting, message-ledger conservation, topology
coherence, and the per-scenario guarantees (a rack resolves in one
drain, a fenced partition never double-repairs, a flapping node stays
out, ...).

  PYTHONPATH=src python examples_torch/chaos_campaign.py
  PYTHONPATH=src python examples_torch/chaos_campaign.py \
      --preset rack_outage --preset transient_flap --recovery substitute

Add ``--device cpu`` to run the clusters' data plane without a card.

Exits nonzero if any invariant fails — CI runs the two-preset form
above as a smoke test of the whole fault pipeline.
"""
import argparse
import sys

from repro_torch.core import ChaosHarness, FaultModel
from repro_torch.core.chaos import RECOVERIES


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", action="append", dest="presets",
                    choices=FaultModel.SCENARIOS, metavar="NAME",
                    help="scenario preset to run (repeatable; default: all "
                         f"of {', '.join(FaultModel.SCENARIOS)})")
    ap.add_argument("--recovery", action="append", dest="recoveries",
                    choices=RECOVERIES, metavar="MODE",
                    help="recovery mode (repeatable; default: shrink)")
    ap.add_argument("--nodes", type=int, default=64,
                    help="cluster size (default 64 — auto-builds a "
                         "depth-3 topology, so rack presets have real "
                         "subtrees to kill)")
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign seed (same seed -> identical events)")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    presets = tuple(args.presets or FaultModel.SCENARIOS)
    recoveries = tuple(args.recoveries or ("shrink",))

    harness = ChaosHarness(seed=args.seed, device=args.device)
    print(f"chaos campaign: n={args.nodes} seed={args.seed}")
    print(f"  presets:    {', '.join(presets)}")
    print(f"  recoveries: {', '.join(recoveries)}\n")

    failures = 0
    for preset in presets:
        campaign = harness.model.campaign(preset, args.nodes)
        print(f"== {preset} ==")
        print(f"   {campaign.summary()}")
        for ev in campaign.events:
            print(f"   step {ev.step:2d}: {ev.action.name.lower():12s} "
                  f"nodes={list(ev.nodes)}"
                  + (f" observers={len(ev.observers)}" if ev.observers
                     else "")
                  + (f" factor={ev.factor}" if ev.factor != 1.0 else ""))
        for recovery in recoveries:
            for report in (harness.run_train(preset, args.nodes,
                                             recovery=recovery),
                           harness.run_serve(preset, args.nodes,
                                             recovery=recovery)):
                print(f"   {report.summary()}")
                for chk in report.failures:
                    failures += 1
                    print(f"     FAIL {chk.name}: {chk.detail}")
        print()

    if failures:
        print(f"{failures} invariant check(s) FAILED")
        return 1
    print("all invariants held across every preset x recovery x workload")
    return 0


if __name__ == "__main__":
    sys.exit(main())
