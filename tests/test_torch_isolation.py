"""The port stands alone: no JAX and nothing of the JAX package.

Every module under ``src/repro_torch/`` (``launch/kernel_roofline.py``
among them), every example twin under ``examples_torch/`` and
``chip_smoke.py`` is parsed and its imports checked; the kernel wrappers, their dispatch and the data
plane's compression path must not catch around a launch (a failed launch
raises, it never falls back).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples_torch").glob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.is_file(), path
    bad = imported_roots(ast.parse(path.read_text())) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_check_sees_a_forbidden_import():
    tree = ast.parse("import os\nfrom repro.models import api\nimport jax.numpy as jnp\n")
    assert imported_roots(tree) & FORBIDDEN == {"repro", "jax"}


@pytest.mark.parametrize("rel", ["kernels/flash_attention.py", "kernels/ssd_scan.py",
                                 "kernels/quantize.py", "kernels/ops.py",
                                 "optim/compression.py", "dist/dataplane.py"])
def test_no_try_around_the_kernel_launch(rel):
    tree = ast.parse((PORT / rel).read_text())
    tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not tries, f"{rel}: try/except at lines {tries}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.kernels.ops, "
            "repro_torch.models.convert, repro_torch.configs, "
            "repro_torch.models.mamba, repro_torch.models.ssd, "
            "repro_torch.core, repro_torch.mpi, repro_torch.dist.dataplane, "
            "repro_torch.checkpoint, repro_torch.optim, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.core.trainer, "
            "repro_torch.checkpoint.store, repro_torch.data.threefry, "
            "repro_torch.serve.engine, repro_torch.core.chaos, "
            "repro_torch.launch.kernel_roofline, repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
