"""No run holds JAX or the JAX package; the reference holds nothing of the program."""
import ast
import shutil
import subprocess
import sys

from bench import harness


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.models", "jaxtyping", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in harness.forbidden_modules()
                if m in ("repro_torch", "repro_torch.models", "jaxtyping", "reprox")]
    for name in ("repro", "repro.core", "jax", "jax.numpy", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = harness.forbidden_modules()
    for name in ("repro", "repro.core", "jax", "jax.numpy", "jaxlib", "flax.linen"):
        assert name in found


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_reference_imports_torch_alone():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in imports(path)}
        assert tops <= {"__future__", "math", "torch"}, (path, tops)


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    cell = harness.benchmark()["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed",
                           "3000000001", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "not in" in proc.stderr


def test_run_refuses_without_a_card(card_absent):
    cell = harness.benchmark()["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed",
                           "3000000002", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
