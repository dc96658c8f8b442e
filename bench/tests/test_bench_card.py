"""One short run of each cell on the card: the result line as the contract
has it, and ``correct``. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from bench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed",
                           "3000000021", "--seconds", "3", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
