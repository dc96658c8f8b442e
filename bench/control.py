"""The readings that ``correct``'s limits are set from, on the card.

  python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 5 \\
      [--fault half_batch|unchanged|token] [--out chiprun_out/control.jsonl]

For each seed, in one process, one run of the cell's driver at the cell's
own sizes with a short window, then the numbers compared for the program
against the plain reference (the lower readings) and for the control, the
reference computed with fp8 operands in the linear layers' products, one
precision below the configuration's bfloat16 (the upper readings). With
``--fault`` the program runs with that fault planted instead: a step that
leaves its state unchanged, half of each batch left out with the mean over
the rest, or one served token altered where it is produced. The benchmark's
own runs never run this. One JSON line a seed goes to ``--out``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=("half_batch", "unchanged", "token"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness, roofline

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    work, config, traffic = harness.cell(bench, args.workload)
    print(f"control: {args.workload} on {roofline.card_line()}", file=sys.stderr, flush=True)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.Context(seed=seed, seconds=args.seconds, trace=False, config=config,
                              traffic=traffic, device=torch.device("cuda", 0),
                              cell=harness.cell_file(work["name"]), t0=t,
                              fault=args.fault, control=args.fault is None)
        out = harness.driver(traffic["driver"]).run(ctx)
        rec = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "checks": {c.name: c.value for c in out["checks"]},
               "correct": all(c.ok for c in out["checks"]),
               "readings": _plain(out["readings"]), "e2e": out["e2e"],
               "setup_s": ctx.setup_s, "peak": out["peak"],
               "run_s": time.perf_counter() - t}
        print(json.dumps({k: rec[k] for k in ("seed", "fault", "checks", "correct", "e2e",
                                              "setup_s", "run_s")}), flush=True)
        print(f"control: seed {seed} readings {json.dumps(summary(rec['readings']))}", flush=True)
        lines.append(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    found = harness.forbidden_modules()
    if found:
        print(f"control: loaded {', '.join(found)}", file=sys.stderr)
        return 2
    return 0


def summary(readings: dict) -> dict:
    """The numbers of the readings, without the per-leaf and per-request detail."""
    keep = {}
    for k, v in readings.items():
        if k in ("program", "reference", "sample"):
            continue
        if isinstance(v, dict):
            v = {a: b for a, b in v.items() if not isinstance(b, (dict, list))}
        keep[k] = v
    return keep


def _plain(x):
    """Readings as JSON: numbers, strings, lists and dicts."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


if __name__ == "__main__":
    sys.exit(main())
