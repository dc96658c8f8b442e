"""``examples_torch/resilient_training.py`` against ``examples/``'s, on the
CPU, as ``test_torch_examples.py`` holds the other twins (the reference
under the stand-in data plane, its weights in the port's ``init_params``,
printed output line for line with the wall clock masked): once in fp32,
the losses within 1e-4, and once as written, in bf16, within 2e-2. A file
of its own, so that another test worker takes its two runs.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_examples import (  # noqa: E402,F401
    TRAINING_CASES,
    compare,
    one_thread,
    reference_weights,
)


@pytest.mark.parametrize("case", sorted(TRAINING_CASES))
def test_training_twin_prints_what_the_reference_prints(case, monkeypatch, capsys,
                                                        reference_weights, one_thread,
                                                        tmp_path):
    compare(*TRAINING_CASES[case], monkeypatch, capsys, tmp_path)
