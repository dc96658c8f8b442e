"""Runs of the drivers on the CPU at the program's smoke sizes, for the tests.

The drivers' CPU path is the program's own (its kernels' plain versions);
only these tests take it. ``run.py`` itself refuses to run without a card.
"""
from __future__ import annotations

import copy
import dataclasses
import time

from bench import harness

CPU_TRAFFIC = {
    "train": {"rows_per_shard": 1, "seq_len": 32},
    "serve": {"prompt_len": 32},
}
# the cells' configurations at the program's smoke sizes
SMOKE = {"mixtral-8x22b-1l": "mixtral-8x22b", "hymba-1.5b": "hymba-1.5b",
         "granite-4.0-h-small-10l": "granite-4.0-h-small"}


def smoke_config(config_name: str, dtype: str = "bfloat16") -> dict:
    from repro_torch.configs.registry import get_smoke_config

    conf = harness.load_json(harness.BENCH / "configs" / f"{config_name}.json")
    cfg = get_smoke_config(SMOKE[config_name]).replace(dtype=dtype, param_dtype=dtype)
    conf["model"] = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return conf


def cpu_run(cell: str, *, seed: int = 7, seconds: float = 0.5, trace: bool = False,
            fault: str | None = None, control: bool = False, dtype: str = "bfloat16",
            limits: dict | None = None) -> dict:
    """One run of ``cell``'s driver on the CPU at smoke size; returns its result."""
    import torch

    bench = harness.benchmark()
    work, _, traffic = harness.cell(bench, cell)
    traffic = copy.deepcopy(traffic)
    traffic.update(CPU_TRAFFIC[traffic["driver"]])
    ctx = harness.Context(seed=seed, seconds=seconds, trace=trace,
                          config=smoke_config(work["config"], dtype), traffic=traffic,
                          device=torch.device("cpu"),
                          cell=dict(harness.cell_file(cell), **({"limits": limits} if limits else {})),
                          t0=time.perf_counter(),
                          fault=fault, control=control)
    out = harness.driver(traffic["driver"]).run(ctx)
    out["ctx"] = ctx
    return out
