"""Each plain reference against ``repro_torch`` at its smoke sizes on the
CPU, and ``correct`` coming out false for each fault a cell can have and for
the control.

In fp32 the program and the reference compute the same model, so their
readings are round-off. In bf16 the program's readings stay under limits
set for the smoke sizes (``SMOKE_LIMITS``, from the program's, the
control's and the faults' readings on this CPU over seeds 1-4), while a
planted fault, or the reference computed in fp8 in the program's place,
exceeds them. The cells' own limits are set for their own sizes from runs
on the card (``PERF.md``).
"""
import pytest

from bench import harness
from bench.tests import support

# program (max over seeds 1-3) < limit < the control's and the faults' (min)
SMOKE_LIMITS = {
    "mixtral-train": {"grad_median": 0.004, "change": 0.03, "window_grad_median": 0.003},
    "hymba-serve": {"gap": 0.05},
    "mixtral-serve": {"gap_share": 0.04},
}
CELLS = {w["name"]: harness.traffic(w["traffic"])["driver"]
         for w in harness.benchmark()["workloads"] if w["name"] in SMOKE_LIMITS}
TRAIN = [c for c, d in CELLS.items() if d == "train"]
SERVE = [c for c, d in CELLS.items() if d == "serve"]


def failed(out):
    return sorted(c.name for c in out["checks"] if not c.ok)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_reference_is_the_program_in_fp32(cell):
    out = support.cpu_run(cell, dtype="float32", seed=3000000011, limits=SMOKE_LIMITS[cell])
    gaps = out["readings"]["gaps"]
    assert gaps["loss"] < 1e-6 and gaps["grad"] < 1e-5 and gaps["change"] < 1e-5, gaps
    assert failed(out) == []


@pytest.mark.parametrize("cell", SERVE)
def test_serve_reference_is_the_program_in_fp32(cell):
    out = support.cpu_run(cell, dtype="float32", seed=3000000012, limits=SMOKE_LIMITS[cell])
    assert out["readings"]["gap"] < 1e-4
    assert failed(out) == []


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_program_in_bf16_is_correct(cell):
    out = support.cpu_run(cell, seed=3000000013, limits=SMOKE_LIMITS[cell])
    assert failed(out) == [], out["checks"]


@pytest.mark.parametrize("cell,fault", [
    *[(c, "unchanged") for c in TRAIN],
    *[(c, "half_batch") for c in TRAIN],
    *[(c, "token") for c in SERVE],
])
def test_fault_is_not_correct(cell, fault):
    out = support.cpu_run(cell, seed=3000000014, fault=fault, limits=SMOKE_LIMITS[cell])
    assert failed(out), out["checks"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_is_not_correct(cell):
    out = support.cpu_run(cell, seed=3000000015, control=True, limits=SMOKE_LIMITS[cell])
    assert failed(out), out["checks"]
