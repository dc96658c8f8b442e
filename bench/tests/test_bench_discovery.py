"""A cell, a traffic mix and a per-layer metric added as new files run
without any file of the benchmark being edited, and entries appended to
``per_layer`` pass the contract tests as they stand."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

from bench import harness

PROBE = textwrap.dedent('''
    import json, sys, time
    sys.path[:0] = [".", sys.argv[1]]
    import torch
    from bench import harness
    from bench.tests import support
    import importlib.util
    spec = importlib.util.spec_from_file_location("run", "bench/run.py")
    run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
    out = support.cpu_run("probe-train", trace=True, seconds=0.2)
    torch.cuda.get_device_name = lambda i=0: "cpu"
    line = run.result_line(harness.benchmark(), harness.cell(harness.benchmark(), "probe-train")[0],
                           out, out["ctx"], torch)
    print(json.dumps(line["metrics"]))
''')


def test_new_cell_and_metric_run_from_new_files(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    src = bench["workloads"][0]
    traffic = harness.traffic(src["traffic"])
    (tmp_path / "bench" / "traffic" / "probe-mix.json").write_text(json.dumps(traffic))
    (tmp_path / "bench" / "workloads" / "probe-train.json").write_text(
        (harness.BENCH / "workloads" / f"{src['name']}.json").read_text())
    (tmp_path / "bench" / "metrics" / "probe_steps.train.py").write_text(
        "def read(trace, ctx):\n    return float(len(trace['steps']))\n")
    bench["workloads"].append(dict(src, name="probe-train", traffic="probe-mix"))
    for m in bench["end_to_end"]:
        if src["name"] in m.get("workloads", []):
            m["workloads"].append("probe-train")
    bench["per_layer"].append({"name": "probe_steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "trainer loop",
                               "moves": "setup_s", "workloads": ["probe-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = subprocess.run([sys.executable, "-c", PROBE, str(harness.ROOT / "src")],
                          cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["probe_steps.train"]["value"] >= 1
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "bench").rglob("*")
             if p.is_file() and p.relative_to(tmp_path) in before}
    assert after == before


# a reader of each source, appended after the last entry
APPENDED = {
    "probe_region_ms.serve": ("device_trace", "def read(trace, ctx):\n"
                              "    return harness.region_ms(trace, 'model')\n"),
    "probe_span_ms.serve": ("program_span", "def read(trace, ctx):\n"
                            "    return program_spans.median_steady(trace, ctx, 'serve.work')\n"),
}


def test_appended_entries_pass_the_contract_tests(tmp_path):
    """A ``device_trace`` entry and a ``program_span`` entry appended after
    the last one, each with its reader: the contract tests, unedited, pass
    on the benchmark that holds them."""
    shutil.copytree(harness.BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    for name, (source, body) in APPENDED.items():
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": source, "layer": "probe", "moves": "serve_p95_s",
                                   "workloads": ["mixtral-serve"]})
        (tmp_path / "bench" / "metrics" / f"{name}.py").write_text(
            "from bench import harness, program_spans\n\n\n" + body)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT / "src"))
    # the readers on the probes' cell; the other cells' readings are
    # test_bench_tracing's own, and the appended entries change none of them
    tracing = "bench/tests/test_bench_tracing.py::"
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           "-p", "no:randomly", "bench/tests/test_bench_files.py",
                           tracing + "test_entries",
                           tracing + "test_readers_on_a_traced_run[mixtral-serve]",
                           tracing + "test_readers_give_none_without_the_tracer[mixtral-serve]"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert " passed" in proc.stdout and "skipped" not in proc.stdout, proc.stdout[-500:]
