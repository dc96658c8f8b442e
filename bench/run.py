"""The benchmark of ``repro_torch``: one cell, one run, one result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout holding the program (``src/repro_torch``).
The cell's entry in ``BENCHMARK.json`` names its configuration (a JSON file
under ``bench/configs/``) and its traffic (``bench/traffic/<name>.json``,
which names its driver, ``bench/drivers/<driver>.py``); each per-layer
metric is read by ``bench/metrics/<metric>.py``. ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled part of the window. The last line of standard output is the
result; the numbers that decide ``correct`` end standard error.

The run exits without a result (code 2) where there is no CUDA device or
fewer than the cell asks for, where the program is not in the checkout,
and where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return 2


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(bench: dict, work: dict, out: dict, ctx, torch) -> dict:
    """The result: the cell's end-to-end metrics, or its per-layer ones
    read from the trace, and the checks last."""
    from bench import harness

    name = work["name"]
    metrics = {}
    if ctx.trace:
        for m in harness.metrics_of(bench, "per_layer", name):
            value = harness.metric_reader(m["name"]).read(out["trace"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in harness.metrics_of(bench, "end_to_end", name):
            # ``serve_p95_s.hymba`` is the driver's ``serve_p95_s`` under a
            # bound of its own
            value = values[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": work["chips"],
              "memory_peak_bytes": out["peak"]}
    line = {"correct": all(c.ok for c in out["checks"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out["checks"]}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench" / sub)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return fail(f"the program (src/repro_torch) is not in {ROOT}")
    from bench import harness, roofline

    bench = harness.benchmark()
    work, config, traffic = harness.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and has no CPU path")
    if torch.cuda.device_count() < work["chips"]:
        return fail(f"{args.workload} asks for {work['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
    print(f"bench: {args.workload} seed {args.seed} on {roofline.card_line()}; peaks "
          f"{roofline.PEAK_BF16_FLOPS:.4g} bf16 FLOP/s, {roofline.PEAK_BYTES:.4g} B/s",
          file=sys.stderr, flush=True)
    ctx = harness.Context(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          config=config, traffic=traffic, device=torch.device("cuda", 0),
                          cell=harness.cell_file(work["name"]), t0=T0)
    out = harness.driver(traffic["driver"]).run(ctx)
    line = result_line(bench, work, out, ctx, torch)
    found = harness.forbidden_modules()
    if found:
        return fail(f"loaded modules of JAX or the JAX package: {', '.join(found)}")
    print(json.dumps(line), flush=True)
    for c in out["checks"]:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
