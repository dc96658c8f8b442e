"""The per-layer metrics read from the program's own spans
(``"source": "program_span"``): their entries, and their readings on a
traced CPU run of each cell; without the program's tracer every reader
gives None and raises nothing. The readings cover every ``program_span``
entry of ``BENCHMARK.json``, on every cell it lists, those appended later
too."""
import math
import sys

import pytest

from bench import harness
from bench.tests import support

B = harness.benchmark()
# name: (layer, moves, cells)
SPANS = {
    "repair_ms.train": ("trainer loop and control plane", "train_tokens_per_s",
                        ["mixtral-train"]),
    "batch_ms.train": ("trainer loop and control plane", "train_tokens_per_s",
                       ["mixtral-train"]),
    "sync_ms.train": ("device", "train_tokens_per_s", ["mixtral-train"]),
    "repair_ms.serve": ("serve engine", "serve_p95_s", ["mixtral-serve"]),
    "engine_ms.serve": ("serve engine", "serve_p95_s", ["mixtral-serve"]),
    "sync_ms.serve": ("device", "serve_tokens_per_s", ["mixtral-serve"]),
    "repair_ms.serve.hymba": ("serve engine", "serve_p95_s.hymba",
                              ["hymba-serve", "granite-serve"]),
    "engine_ms.serve.hymba": ("serve engine", "serve_p95_s.hymba",
                              ["hymba-serve", "granite-serve"]),
    "sync_ms.serve.hymba": ("device", "serve_tokens_per_s.hymba",
                            ["hymba-serve", "granite-serve"]),
    "decode_host_ms.serve.hymba": ("model step", "serve_tokens_per_s.hymba",
                                   ["hymba-serve", "granite-serve"]),
}
# every program_span entry of the benchmark, whoever appended it
READ = {m["name"]: m["workloads"] for m in B["per_layer"] if m["source"] == "program_span"}
CELLS = sorted({cell for cells in READ.values() for cell in cells})


def test_entries():
    """Each entry named here, field for field, wherever it sits in
    ``per_layer``."""
    entries = {m["name"]: m for m in B["per_layer"]}
    for name, (layer, moves, cells) in SPANS.items():
        assert entries[name] == {"name": name, "unit": "ms", "better": "lower",
                                 "source": "program_span", "layer": layer,
                                 "moves": moves, "workloads": cells}


@pytest.fixture(scope="module")
def runs():
    return {}


def traced(runs, cell):
    if cell not in runs:
        runs[cell] = support.cpu_run(cell, trace=True, seed=2**31 + 17)
    return runs[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_a_traced_run(runs, cell):
    out = traced(runs, cell)
    trace, ctx = out["trace"], out["ctx"]
    walls = trace.get("steps") or trace["rounds"]
    for name, cells in READ.items():
        if cell not in cells:
            continue
        value = harness.metric_reader(name).read(trace, ctx)
        assert value is not None and math.isfinite(value), (name, value)
        assert value >= 0.0, (name, value)
        if name.startswith("repair_ms."):
            assert 0.0 < value < walls[trace["repair_at"]]["wall_s"] * 1e3, (name, value)


@pytest.mark.parametrize("cell", CELLS)
def test_readers_give_none_without_the_tracer(runs, cell, monkeypatch):
    import repro_torch

    out = traced(runs, cell)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for name, cells in READ.items():
        if cell in cells:
            assert harness.metric_reader(name).read(out["trace"], out["ctx"]) is None, name
