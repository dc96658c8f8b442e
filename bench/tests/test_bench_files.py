"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""
import dataclasses
import re

import pytest

from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
B = harness.benchmark()


def test_top_level():
    assert set(B) == KEYS
    assert 1 <= len(B["command"]) <= 32 and all(TEXT.match(w) for w in B["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in B["paths"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for section in ("end_to_end", "per_layer"):
        for m in B[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in B["workloads"]}) == len(B["workloads"])


def test_metrics_rules():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        mine = [m["name"] for m in harness.metrics_of(B, "end_to_end", cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.metrics_of(B, "per_layer", cell)


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_resolves_to_files(cell):
    work, config, traffic = harness.cell(B, cell)
    assert config["name"] == work["config"]
    assert (harness.BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert harness.cell_file(cell)["limits"]
    harness.reference(config["reference"])
    for m in harness.metrics_of(B, "per_layer", cell):
        assert callable(harness.metric_reader(m["name"]).read)


@pytest.mark.parametrize("conf", B["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_program_config_cut_as_stated(conf):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.registry import get_config

    data = harness.load_json(harness.ROOT / conf["file"])
    assert data["reduced"] == conf["reduced"] and data["source"] == conf["source"]
    model = ModelConfig(**data["model"])
    published = get_config(model.name.replace("-1l", ""))
    changed = {f.name for f in dataclasses.fields(model)
               if getattr(model, f.name) != getattr(published, f.name)} - {"name"}
    # the keys cut, and those where the file takes the released model's
    # value over the program's configuration
    release = data.get("from_release", {})
    assert changed == set(conf["reduced"]) | set(release)
    assert all(getattr(model, k) == v for k, v in release.items())
    for key, value in data["published"].items():
        assert getattr(published, key) == value


def test_files_under_paths_are_named_from_names():
    for p in harness.BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert PATH.match(str(p.relative_to(harness.ROOT))), p
